"""Mandel notation: the stress-strain constraint, the host maps the engines
fold into their element matrices, the elastic tangents, and the pointwise
maps and invariants the constitutive models use.

Shear components carry a factor of sqrt(2); a strain computed from a
displacement gradient therefore carries 1/sqrt(2) on the symmetrised shear.
The constants are numpy host arrays, built once; the pointwise functions
take tensors ``[..., s]`` (or ``[..., g, g]``) and are written as broadcast
multiplies and sums, so none of them runs in TF32 on the card. The same
convention as ``fenics_constitutive_tpu.ops.mandel``.
"""

from __future__ import annotations

import enum
import math
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "SQRT2",
    "Constraint",
    "StressStrainConstraint",
    "device_constant",
    "deviatoric",
    "get_elastic_tangent",
    "get_identity",
    "i1_j2_dev",
    "isotropic_elastic_tangent",
    "isotropic_elastic_tangent_inv",
    "lame_parameters",
    "mandel_to_matrix",
    "matrix_to_mandel",
    "mises_norm",
    "projection_dev",
    "projection_vol",
    "strain_from_grad_u",
    "sym_identity",
    "trace",
    "vol_dev",
]

SQRT2 = math.sqrt(2.0)
_INV_SQRT2 = 1.0 / SQRT2


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


#: the reference's name of the constraint enum
StressStrainConstraint = Constraint


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


def lame_parameters(E: float, nu: float) -> tuple[float, float]:
    """(mu, lam) from Young's modulus and Poisson ratio."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def get_elastic_tangent(E: float, nu: float, constraint: Constraint) -> np.ndarray:
    """Linear-elastic tangent in Mandel notation per constraint (host numpy)."""
    mu, lam = lame_parameters(E, nu)
    if constraint == Constraint.FULL:
        D = lam * np.outer(sym_identity(6), sym_identity(6)) + 2.0 * mu * np.eye(6)
    elif constraint == Constraint.PLANE_STRAIN:
        D = lam * np.outer(sym_identity(4), sym_identity(4)) + 2.0 * mu * np.eye(4)
    elif constraint == Constraint.PLANE_STRESS:
        # rank-deficient: the zz row and column are zero, so sigma_zz = 0
        D = E / (1.0 - nu**2) * np.array(
            [
                [1.0, nu, 0.0, 0.0],
                [nu, 1.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 1.0 - nu],
            ]
        )
    elif constraint == Constraint.UNIAXIAL_STRAIN:
        D = np.array([[E * (1.0 - nu) / ((1.0 + nu) * (1.0 - 2.0 * nu))]])
    else:  # UNIAXIAL_STRESS
        D = np.array([[E]])
    return D


def get_identity(constraint: Constraint) -> np.ndarray:
    """Second-order identity in Mandel notation per constraint (PLANE_STRESS
    has no zz slot in it)."""
    I2 = np.zeros(constraint.stress_strain_dim)
    n_ones = {
        Constraint.FULL: 3,
        Constraint.PLANE_STRAIN: 3,
        Constraint.PLANE_STRESS: 2,
        Constraint.UNIAXIAL_STRAIN: 1,
        Constraint.UNIAXIAL_STRESS: 1,
    }[constraint]
    I2[:n_ones] = 1.0
    return I2


def strain_from_grad_u(grad_u: torch.Tensor, constraint: Constraint) -> torch.Tensor:
    """Mandel strain ``[..., s]`` from a (generally non-symmetric)
    displacement gradient ``[..., g, g]``; the plane constraints' zz slot is
    zero."""
    g = constraint.geometric_dim
    if tuple(grad_u.shape[-2:]) != (g, g):
        msg = f"grad_u trailing shape {tuple(grad_u.shape[-2:])} != ({g},{g}) for {constraint}"
        raise ValueError(msg)
    if constraint in (Constraint.UNIAXIAL_STRAIN, Constraint.UNIAXIAL_STRESS):
        return grad_u[..., 0, 0:1]
    if constraint in (Constraint.PLANE_STRAIN, Constraint.PLANE_STRESS):
        return torch.stack(
            [
                grad_u[..., 0, 0],
                grad_u[..., 1, 1],
                torch.zeros_like(grad_u[..., 0, 0]),
                _INV_SQRT2 * (grad_u[..., 0, 1] + grad_u[..., 1, 0]),
            ],
            dim=-1,
        )
    comps = [grad_u[..., 0, 0], grad_u[..., 1, 1], grad_u[..., 2, 2]]
    for i, j in _SHEAR_PAIRS_3D:
        comps.append(_INV_SQRT2 * (grad_u[..., i, j] + grad_u[..., j, i]))
    return torch.stack(comps, dim=-1)


#: host constants on a CUDA device, by (bytes, shape, dtype, device)
_DEVICE_CONSTANTS: dict = {}


def device_constant(a, dtype: torch.dtype, device) -> torch.Tensor:
    """The host array ``a`` as a tensor of ``dtype`` on ``device`` (read
    only). On a CUDA device it is uploaded once and kept: the eager warm-up
    of a compiled step uploads it, and its capture then reads the kept
    tensor, where a copy from pageable host memory cannot be captured."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type != "cuda" or isinstance(a, torch.Tensor):
        return torch.as_tensor(a, dtype=dtype, device=device)
    a = np.asarray(a)
    key = (a.tobytes(), a.shape, a.dtype.str, dtype, device)
    hit = _DEVICE_CONSTANTS.get(key)
    if hit is None:
        hit = _DEVICE_CONSTANTS[key] = torch.as_tensor(a, dtype=dtype, device=device)
    return hit


def mandel_to_matrix(mandel: torch.Tensor, constraint: Constraint) -> torch.Tensor:
    """Mandel vector ``[..., s]`` -> symmetric tensor ``[..., g, g]``."""
    T = device_constant(_mandel_matrix_map(constraint), mandel.dtype, mandel.device)
    return (mandel[..., :, None, None] * T).sum(dim=-3)


def matrix_to_mandel(tensor: torch.Tensor, constraint: Constraint) -> torch.Tensor:
    """Symmetric tensor ``[..., g, g]`` -> Mandel vector ``[..., s]``; the
    inverse of ``mandel_to_matrix`` on symmetric input."""
    return strain_from_grad_u(tensor, constraint)


def trace(mandel: torch.Tensor) -> torch.Tensor:
    """First invariant I1 = tr(sigma) of ``[..., s]``, s in {1, 4, 6}."""
    return mandel[..., : min(3, mandel.shape[-1])].sum(dim=-1)


def deviatoric(mandel: torch.Tensor) -> torch.Tensor:
    """Deviatoric part in Mandel notation."""
    n = min(3, mandel.shape[-1])
    vol = trace(mandel)[..., None] / 3.0
    return torch.cat([mandel[..., :n] - vol, mandel[..., n:]], dim=-1)


def vol_dev(mandel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(volumetric scalar tr/3, deviatoric vector)."""
    return trace(mandel) / 3.0, deviatoric(mandel)


def i1_j2_dev(mandel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(I1, J2, dev) with J2 = dev:dev / 2, a plain dot in Mandel notation."""
    dev = deviatoric(mandel)
    return trace(mandel), 0.5 * (dev * dev).sum(dim=-1), dev


def mises_norm(mandel: torch.Tensor) -> torch.Tensor:
    """sqrt(3 J2)."""
    return torch.sqrt(3.0 * i1_j2_dev(mandel)[1])


def isotropic_elastic_tangent(mu: float, kappa: float, sdim: int = 6, *, dtype=torch.float64,
                              device=None) -> torch.Tensor:
    """2 mu P_dev + 3 kappa P_vol in Mandel notation, ``[sdim, sdim]``."""
    pdev = device_constant(projection_dev(sdim), dtype, device)
    pvol = device_constant(projection_vol(sdim), dtype, device)
    return 2.0 * mu * pdev + 3.0 * kappa * pvol


def isotropic_elastic_tangent_inv(mu: float, kappa: float, sdim: int = 6, *,
                                  dtype=torch.float64, device=None) -> torch.Tensor:
    """The closed-form inverse of ``isotropic_elastic_tangent``: the same form
    at (1 / (4 mu), 1 / (9 kappa))."""
    return isotropic_elastic_tangent(1.0 / (4.0 * mu), 1.0 / (9.0 * kappa), sdim,
                                     dtype=dtype, device=device)
