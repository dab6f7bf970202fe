"""Carry state and parameters across from the JAX package.

Both packages lay the structured engine's fields out the same way (stress
[6, Q, M], history {"eps_n": [6, Q, M], "alpha": [1, Q, M]}, node-major
displacements), so a state is moved leaf by leaf as numpy arrays: a plastic
state reached in JAX can be stepped by either package. The geometry is not
carried: the port rebuilds it from the same mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver.packed_step import PackedState

__all__ = ["params_from_numpy", "state_from_numpy"]


def state_from_numpy(u, stress, histories, t, *, device, dtype: torch.dtype) -> PackedState:
    """The port's PackedState from the leaves of a JAX ``PackedState``.

    ``stress`` and ``histories`` are per-law sequences (arrays, and dicts of
    arrays or None), as in the JAX state; every leaf is copied.
    """

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
