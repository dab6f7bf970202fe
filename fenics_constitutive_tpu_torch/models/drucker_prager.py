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
dense-tangent adapter. On CUDA tensors of float32 or float64 the return map
is one launch of K9 (``ops/cuda_return_map.py``), one thread a point; on the
CPU it is the plain ``implicit_return_map``. Neither reads anything back to
the host, so a step over them is captured in a CUDA graph
(``solver/compiled.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import cuda_return_map, mandel
from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .plasticity_general import implicit_return_map

__all__ = ["DruckerPrager3D", "DruckerPragerHyperbolic3D"]


class _DruckerPragerBase(IncrSmallStrainModel):
    _param_names: tuple[str, ...]

    def __init__(self, parameters):
        self.params = {
            k: float(np.asarray(parameters[k]).reshape(())) for k in self._param_names
        }
        #: local Newton controls: absolute and relative tolerance, trip cap
        self.newton_atol = 1e-10
        self.newton_rtol = 1e-10
        self.newton_maxit = 25

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

    @staticmethod
    def _invariants(sigma):
        """(I1 [1], J2 [1], dev [1, 6]) of one point's stress [6], one point
        deep: under torch.func's jacfwd a Python number that meets a 0-d
        tensor turns its tangent float64, so a float32 stress would give a
        float64 Jacobian."""
        return mandel.i1_j2_dev(sigma[None])

    def _f(self, sigma, kappa):
        del kappa  # no hardening feedback
        i1, j2, _ = self._invariants(sigma)
        return (torch.sqrt(self._j2_term(j2)) + self.params["b"] * i1 - self.params["a"])[0]

    def _g(self, sigma, kappa, i2):
        # b_flow I2 + d sqrt(J2 term)/d sigma: df/dsigma when b_flow == b
        del kappa
        _, j2, s = self._invariants(sigma)
        half_inv = 0.5 / torch.sqrt(self._j2_term(j2))
        return (self.params["b_flow"] * i2 + half_inv[:, None] * s)[0]

    def _plain_return_map(self, stress, eps, alpha):
        """The plain map (``implicit_return_map``): K9's twin, the CPU's path."""
        C = mandel.isotropic_elastic_tangent(self.params["mu"], self.params["kappa"],
                                             dtype=stress.dtype, device=stress.device)
        i2 = mandel.device_constant(mandel.sym_identity(6), stress.dtype, stress.device)
        return implicit_return_map(
            self._f,
            lambda sigma, kappa: self._g(sigma, kappa, i2),
            C,
            stress,
            eps,
            alpha,
            atol=self.newton_atol,
            rtol=self.newton_rtol,
            maxit=self.newton_maxit,
        )

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t, del_t
        eps = mandel.strain_from_grad_u(grad_del_u, Constraint.FULL)
        if cuda_return_map.dp_return_map_form(self, stress):
            sigma_1, tangent, alpha_1, del_eps_p = cuda_return_map.dp_return_map(
                self, stress, eps, history["alpha"])
        else:
            sigma_1, tangent, alpha_1, del_eps_p = self._plain_return_map(
                stress, eps, history["alpha"])
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
