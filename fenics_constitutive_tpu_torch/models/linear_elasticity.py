"""Linear elasticity for all five stress-strain constraints."""

from __future__ import annotations

import torch

from ..ops import mandel
from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .packed_models import _factored_when_full, _linear_elasticity_evaluate_packed

__all__ = ["LinearElasticityModel", "elastic_tangent"]


def elastic_tangent(E, nu, constraint: Constraint, *, dtype, device=None) -> torch.Tensor:
    """The elastic tangent D [s, s] (Mandel) of a constraint; E and nu are
    floats or 0-d tensors."""
    mu = E / (2.0 * (1.0 + nu))
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    def const(a):
        return mandel.device_constant(a, dtype, device)

    if constraint in (Constraint.FULL, Constraint.PLANE_STRAIN):
        s = constraint.stress_strain_dim
        pdev = const(mandel.projection_dev(6)[:s, :s])
        ones = const(3.0 * mandel.projection_vol(6)[:s, :s])
        # 2 mu P_dev + (lam + 2/3 mu) (I2 x I2)
        return 2.0 * mu * pdev + (lam + 2.0 * mu / 3.0) * ones
    if constraint == Constraint.PLANE_STRESS:
        # rank-deficient: the zz row and column are zero, so sigma_zz = 0
        fac = E / (1.0 - nu**2)
        rows = [[fac, fac * nu, 0.0, 0.0], [fac * nu, fac, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, fac * (1.0 - nu)]]
        return torch.stack([torch.stack([const(v) for v in row]) for row in rows])
    if constraint == Constraint.UNIAXIAL_STRAIN:
        return const(E * (1.0 - nu) / ((1.0 + nu) * (1.0 - 2.0 * nu))).reshape(1, 1)
    return const(E).reshape(1, 1)  # UNIAXIAL_STRESS


def apply_matrix(x: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``x @ D.T`` for x [Q, s] as a broadcast multiply and sum (never TF32)."""
    return (x[:, None, :] * D).sum(dim=-1)


class LinearElasticityModel(IncrSmallStrainModel):
    """Hooke's law per constraint: ``stress += D : eps``, tangent D, no
    history. FULL runs its SoA twin on the engines; the other constraints run
    through the generic dense-tangent adapter.

    Args:
        parameters: "E" (Young's modulus) and "nu" (Poisson ratio).
        constraint: the stress-strain constraint.
    """

    def __init__(self, parameters: dict[str, float], constraint: Constraint):
        self._constraint = constraint
        self.params = {"E": float(parameters["E"]), "nu": float(parameters["nu"])}

    def tangent_matrix(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """The constraint's elastic tangent D [s, s] (Mandel)."""
        return elastic_tangent(self.params["E"], self.params["nu"], self._constraint,
                               dtype=dtype, device=device)

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t, del_t
        eps = mandel.strain_from_grad_u(grad_del_u, self._constraint)
        D = self.tangent_matrix(eps.dtype, eps.device)
        stress_new = stress + apply_matrix(eps, D)
        return stress_new, D.expand(eps.shape[0], *D.shape), history

    @property
    def constraint(self) -> Constraint:
        return self._constraint

    @property
    def history_dim(self) -> None:
        return None

    evaluate_packed = _linear_elasticity_evaluate_packed
    factored_tangent = _factored_when_full
