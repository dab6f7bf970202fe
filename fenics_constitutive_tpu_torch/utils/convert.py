"""Carry state and parameters across from the JAX package.

Both packages lay the engines' fields out the same way, so a state is moved
leaf by leaf as numpy arrays: a plastic state reached in JAX can be stepped
by either package. On the structured engine that is stress [6, Q, M],
history {"eps_n": [6, Q, M], "alpha": [1, Q, M]} and node-major
displacements; on the windowed engine stress [6, N], history [h, N] in the
plan's slot order and displacements in the internal layout [vs * M_pad].
The geometry is not carried: the port rebuilds it from the same mesh, and
both packages build identical plans (RCM order, blocks, slots) from it.

Models are carried by ``model_from_jax``: the port's model of the same
class, built from the JAX model's parameters (read as attributes, so this
module imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from ..solver.packed_step import PackedState

__all__ = ["model_from_jax", "params_from_numpy", "state_from_numpy"]


def state_from_numpy(u, stress, histories, t, *, device, dtype: torch.dtype) -> PackedState:
    """The port's PackedState from the leaves of a JAX ``PackedState``.

    ``stress`` and ``histories`` are per-law sequences (arrays, and dicts of
    arrays or None), as in the JAX state; every leaf is copied.
    """
    from ..solver.packed_step import PackedState  # the solver imports utils.timers

    def leaf(x):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    return PackedState(
        u=leaf(u),
        stress=tuple(leaf(s) for s in stress),
        histories=tuple(
            None if h is None else {k: leaf(v) for k, v in h.items()}
            for h in histories
        ),
        t=leaf(t),
    )


def params_from_numpy(params) -> dict[str, float]:
    """Model parameters as Python floats from a JAX model's ``params`` (0-d
    arrays or numpy scalars); pass the result to the port's model class."""
    return {k: float(np.asarray(v).reshape(())) for k, v in params.items()}


#: local Newton controls a model instance may carry (class defaults otherwise)
_NEWTON_CONTROLS = ("newton_tol", "newton_rtol", "newton_max_iter", "newton_atol",
                    "newton_maxit")


def model_from_jax(model):
    """The port's model of the same class as the JAX package's ``model``,
    with the same parameters, constraint and local Newton controls; a
    conversion wrapper is carried with its inner model."""
    from .. import models

    name = type(model).__name__
    cls = getattr(models, name, None)
    if cls is None or name in ("Constraint", "StressStrainConstraint", "IncrSmallStrainModel"):
        msg = f"the port has no model class {name}"
        raise TypeError(msg)
    if name in ("UniaxialStrainFrom3D", "PlaneStrainFrom3D"):
        return cls(model_from_jax(model.model))
    params = params_from_numpy(model.params)
    if name in ("LinearElasticityModel", "SpringKelvinModel", "SpringMaxwellModel"):
        out = cls(params, models.Constraint[model.constraint.name])
    else:
        out = cls(params)
    for key in _NEWTON_CONTROLS:
        if key in vars(model):
            setattr(out, key, vars(model)[key])
    return out
