"""Mandel-notation constants: the stress-strain constraint and the host maps
the structured engine folds into its element matrices.

Shear components carry a factor of sqrt(2); a strain computed from a
displacement gradient therefore carries 1/sqrt(2) on the symmetrised shear.
Everything here is a numpy host constant, built once per geometry; the same
convention as ``fenics_constitutive_tpu.ops.mandel``.
"""

from __future__ import annotations

import enum
import math
from functools import lru_cache

import numpy as np

__all__ = [
    "Constraint",
    "projection_dev",
    "projection_vol",
    "sym_identity",
]

_INV_SQRT2 = 1.0 / math.sqrt(2.0)


class Constraint(enum.Enum):
    """Stress-strain constraint; the integer values match the JAX package's."""

    UNIAXIAL_STRAIN = 1
    UNIAXIAL_STRESS = 2
    PLANE_STRAIN = 3
    PLANE_STRESS = 4
    FULL = 5

    @property
    def stress_strain_dim(self) -> int:
        return {
            Constraint.UNIAXIAL_STRAIN: 1,
            Constraint.UNIAXIAL_STRESS: 1,
            Constraint.PLANE_STRAIN: 4,
            Constraint.PLANE_STRESS: 4,
            Constraint.FULL: 6,
        }[self]

    @property
    def geometric_dim(self) -> int:
        return {
            Constraint.UNIAXIAL_STRAIN: 1,
            Constraint.UNIAXIAL_STRESS: 1,
            Constraint.PLANE_STRAIN: 2,
            Constraint.PLANE_STRESS: 2,
            Constraint.FULL: 3,
        }[self]


# Mandel slots 3, 4, 5 of the FULL constraint are the symmetrised
# (0,1), (0,2), (1,2) index pairs.
_SHEAR_PAIRS_3D = ((0, 1), (0, 2), (1, 2))


@lru_cache(maxsize=None)
def _mandel_matrix_map(constraint: Constraint) -> np.ndarray:
    """Host constant ``T[s, i, j]`` with ``tensor_ij = sum_s T[s,i,j] * mandel_s``.

    ``T`` is both the map from a Mandel stress vector to its symmetric tensor
    and the adjoint used in weak-form assembly:
    ``inner(eps_mandel(v), sigma_mandel) == grad(v) : (T . sigma_mandel)``.
    """
    g = constraint.geometric_dim
    s = constraint.stress_strain_dim
    T = np.zeros((s, g, g))
    if constraint in (Constraint.UNIAXIAL_STRAIN, Constraint.UNIAXIAL_STRESS):
        T[0, 0, 0] = 1.0
    elif constraint in (Constraint.PLANE_STRAIN, Constraint.PLANE_STRESS):
        T[0, 0, 0] = 1.0
        T[1, 1, 1] = 1.0
        # slot 2 is zz: no image in 2D
        T[3, 0, 1] = T[3, 1, 0] = _INV_SQRT2
    else:
        for d in range(3):
            T[d, d, d] = 1.0
        for k, (i, j) in enumerate(_SHEAR_PAIRS_3D):
            T[3 + k, i, j] = T[3 + k, j, i] = _INV_SQRT2
    return T


@lru_cache(maxsize=None)
def sym_identity(sdim: int) -> np.ndarray:
    """Mandel second-order identity [1, 1, 1, 0, ...]."""
    out = np.zeros(sdim)
    out[: min(3, sdim)] = 1.0
    return out


@lru_cache(maxsize=None)
def projection_vol(sdim: int) -> np.ndarray:
    """P_vol = 1/3 (I2 x I2)."""
    i2 = sym_identity(sdim)
    return np.outer(i2, i2) / 3.0


@lru_cache(maxsize=None)
def projection_dev(sdim: int) -> np.ndarray:
    """P_dev = I4 - P_vol."""
    return np.eye(sdim) - projection_vol(sdim)
