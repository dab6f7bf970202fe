"""Standard-linear-solid viscoelasticity: spring-Kelvin and spring-Maxwell
forms, for every constraint. Deviatoric 3D generalisation of the 1D
three-parameter models, a backward-Euler update of the viscous strain,
history ``{"strain_visco": [Q, s], "strain": [Q, s]}``. The FULL constraint
runs a SoA twin with a factored tangent on the engines; the others run
through the generic dense-tangent adapter."""

from __future__ import annotations

import torch

from ..ops import mandel
from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .linear_elasticity import apply_matrix, elastic_tangent
from .packed_models import (
    _factored_when_full,
    _spring_kelvin_evaluate_packed,
    _spring_maxwell_evaluate_packed,
)

__all__ = ["SpringKelvinModel", "SpringMaxwellModel"]


class _SLSBase(IncrSmallStrainModel):
    """The two three-parameter models' parameters and history.

    Args:
        parameters: "E0", "E1" (spring moduli), "tau" (relaxation time) and
            "nu" (Poisson ratio; 0 under UNIAXIAL_STRESS, where it is not
            read).
        constraint: the stress-strain constraint.
    """

    def __init__(self, parameters: dict[str, float], constraint: Constraint):
        self._constraint = constraint
        nu = 0.0 if constraint == Constraint.UNIAXIAL_STRESS else float(parameters["nu"])
        self.params = {
            "E0": float(parameters["E0"]),
            "E1": float(parameters["E1"]),
            "tau": float(parameters["tau"]),
            "nu": nu,
        }

    @property
    def constraint(self) -> Constraint:
        return self._constraint

    @property
    def history_dim(self) -> dict[str, int]:
        s = self.stress_strain_dim
        return {"strain_visco": s, "strain": s}

    def _tangent(self, E, like: torch.Tensor) -> torch.Tensor:
        return elastic_tangent(E, self.params["nu"], self._constraint, dtype=like.dtype,
                               device=like.device)


class SpringKelvinModel(_SLSBase):
    """A spring in series with a Kelvin body::

                              |--- E_1: spring ---|
          --- E_0: spring  ---|                   |--
                              |--- eta: damper ---|
    """

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t
        c = self._constraint
        E0, E1, tau, nu = (self.params[k] for k in ("E0", "E1", "tau", "nu"))
        mu0 = E0 / (2.0 * (1.0 + nu))
        lam0 = E0 * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
        mu1 = E1 / (2.0 * (1.0 + nu))
        D0 = self._tangent(E0, stress)

        eps = mandel.strain_from_grad_u(grad_del_u, c)
        strain_visco_n = history["strain_visco"]
        I2 = mandel.device_constant(mandel.get_identity(c), stress.dtype, stress.device)
        # trace over the geometric diagonal only
        tr_eps = eps[:, : c.geometric_dim].sum(dim=1, keepdim=True)

        factor = 1.0 / del_t + 1.0 / tau + mu0 / (tau * mu1)
        deps_visko = 1.0 / factor * (
            1.0 / (tau * 2.0 * mu1) * stress
            - 1.0 / tau * strain_visco_n
            + mu0 / (tau * mu1) * eps
            + lam0 / (tau * 2.0 * mu1) * tr_eps * I2
        )
        stress_new = stress + apply_matrix(eps, D0) - 2.0 * mu0 * deps_visko
        D = (1.0 - mu0 / (tau * mu1 * factor)) * D0
        history_new = {
            "strain_visco": strain_visco_n + deps_visko,
            "strain": history["strain"] + eps,
        }
        return stress_new, D.expand(eps.shape[0], *D.shape), history_new

    evaluate_packed = _spring_kelvin_evaluate_packed
    factored_tangent = _factored_when_full


class SpringMaxwellModel(_SLSBase):
    """A spring in parallel with a Maxwell branch::

            |----------- E_0: spring  ----------|
          --|                                   |--
            |--- E_1: spring --- eta: damper ---|
    """

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t
        c = self._constraint
        E1, tau, nu = self.params["E1"], self.params["tau"], self.params["nu"]
        mu1 = E1 / (2.0 * (1.0 + nu))
        D0 = self._tangent(self.params["E0"], stress)
        D1 = self._tangent(E1, stress)

        eps = mandel.strain_from_grad_u(grad_del_u, c)
        strain_visco_n = history["strain_visco"]
        strain_total = history["strain"] + eps
        factor = 1.0 / del_t + 1.0 / tau
        deps_visko = 1.0 / factor * (
            1.0 / (tau * 2.0 * mu1) * apply_matrix(strain_total, D1)
            - 1.0 / tau * strain_visco_n
        )
        stress_new = stress + (apply_matrix(eps, D0 + D1) - 2.0 * mu1 * deps_visko)
        D = D0 + (1.0 - 1.0 / (tau * factor)) * D1
        history_new = {
            "strain_visco": strain_visco_n + deps_visko,
            "strain": strain_total,
        }
        return stress_new, D.expand(eps.shape[0], *D.shape), history_new

    evaluate_packed = _spring_maxwell_evaluate_packed
    factored_tangent = _factored_when_full
