"""Drucker-Prager plasticity, the classic cone and the hyperbolically
smoothed apex, through the implicit return map of ``plasticity_general``:

  * classic:     f = sqrt(J2) + b I1 - a
  * hyperbolic:  f = sqrt(J2 + d^2) + b I1 - a
  * flow: associated when b_flow == b, else b_flow I2 + d sqrt(J2)/d sigma
    (a purely deviatoric return at b_flow = 0).

J2 has a floor of 1e-30 in the classic cone, so the flow direction stays
finite at a zero deviator. At the cone's tip the local Newton stops at its
trip cap with non-finite values; the hyperbolic surface is smooth there.
Both laws have no SoA twin: the engines run them through the generic
dense-tangent adapter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import mandel
from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .plasticity_general import implicit_return_map

__all__ = ["DruckerPrager3D", "DruckerPragerHyperbolic3D"]


class _DruckerPragerBase(IncrSmallStrainModel):
    _param_names: tuple[str, ...]
    host_sync = ("the general return map's local Newton takes its active points by "
                 "nonzero() and reads their count back once a trip")

    def __init__(self, parameters):
        self.params = {
            k: float(np.asarray(parameters[k]).reshape(())) for k in self._param_names
        }
        #: local Newton controls: absolute and relative tolerance, trip cap
        self.newton_atol = 1e-10
        self.newton_rtol = 1e-10
        self.newton_maxit = 25
        #: points still active on each trip of the last ``evaluate``'s local Newton
        self.last_active_per_trip: list[int] = []

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self) -> dict[str, int]:
        return {"alpha": 1, "plastic_strain": 6}

    @property
    def symmetric_tangent(self) -> bool:
        """False under non-associated flow, where the tangent is not symmetric."""
        return self.params["b"] == self.params["b_flow"]

    def _j2_term(self, j2: torch.Tensor) -> torch.Tensor:
        """The J2 term under the square root of the yield function."""
        raise NotImplementedError

    def _f(self, sigma, kappa):
        del kappa  # no hardening feedback
        i1, j2, _ = mandel.i1_j2_dev(sigma)
        return torch.sqrt(self._j2_term(j2)) + self.params["b"] * i1 - self.params["a"]

    def _g(self, sigma, kappa, i2):
        # b_flow I2 + d sqrt(J2 term)/d sigma: df/dsigma when b_flow == b
        del kappa
        _, j2, s = mandel.i1_j2_dev(sigma)
        return self.params["b_flow"] * i2 + (0.5 / torch.sqrt(self._j2_term(j2))) * s

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t, del_t
        C = mandel.isotropic_elastic_tangent(self.params["mu"], self.params["kappa"],
                                             dtype=stress.dtype, device=stress.device)
        i2 = torch.as_tensor(mandel.sym_identity(6), dtype=stress.dtype, device=stress.device)
        eps = mandel.strain_from_grad_u(grad_del_u, Constraint.FULL)
        self.last_active_per_trip = []
        sigma_1, tangent, alpha_1, del_eps_p = implicit_return_map(
            self._f,
            lambda sigma, kappa: self._g(sigma, kappa, i2),
            C,
            stress,
            eps,
            history["alpha"],
            atol=self.newton_atol,
            rtol=self.newton_rtol,
            maxit=self.newton_maxit,
            active_per_trip=self.last_active_per_trip,
        )
        history_new = {
            "alpha": alpha_1,
            "plastic_strain": history["plastic_strain"] + del_eps_p,
        }
        return sigma_1, tangent, history_new


class DruckerPrager3D(_DruckerPragerBase):
    """The classic cone f = sqrt(J2) + b I1 - a. Parameters: mu, kappa, a, b,
    b_flow (b_flow = b for associated flow, 0 for a deviatoric return)."""

    _param_names = ("mu", "kappa", "a", "b", "b_flow")

    def _j2_term(self, j2):
        return torch.clamp(j2, min=1e-30)


class DruckerPragerHyperbolic3D(_DruckerPragerBase):
    """The smoothed apex f = sqrt(J2 + d^2) + b I1 - a. Parameters: mu,
    kappa, a, b, d, b_flow."""

    _param_names = ("mu", "kappa", "a", "b", "d", "b_flow")

    def _j2_term(self, j2):
        return j2 + self.params["d"] ** 2
