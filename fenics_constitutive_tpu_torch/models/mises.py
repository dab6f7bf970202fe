"""Von Mises plasticity: nonlinear (saturating exponential) and linear
isotropic hardening. Both use Mandel notation throughout; deviatoric norms
are plain dots."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import mandel
from ..ops.mandel import Constraint
from .interfaces import History, IncrSmallStrainModel
from .packed_models import (
    _mises_linear_evaluate_packed,
    _vonmises_evaluate_packed,
    device_while,
    newton_controls,
)

__all__ = ["MisesPlasticityLinearHardening3D", "VonMises3D"]

_SQ23 = math.sqrt(2.0 / 3.0)


class VonMises3D(IncrSmallStrainModel):
    r"""Von Mises plasticity with exponential isotropic hardening; FULL
    constraint only.

    Yield: :math:`\|\sigma'\| - \sqrt{2/3}\,(y_0 + (y_\infty - y_0)(1 - e^{-\omega\alpha}))`.

    Args:
        param: ``p_ka`` bulk modulus, ``p_mu`` shear modulus, ``p_y0`` initial
            yield stress, ``p_y00`` final yield stress, ``p_w`` saturation rate.
    """

    #: local Newton controls: absolute and relative tolerance, iteration cap
    newton_tol = 1e-12
    newton_rtol = 1e-8
    newton_max_iter = 100

    def __init__(self, param: dict[str, float]):
        self.params = {
            k: float(param[k]) for k in ("p_ka", "p_mu", "p_y0", "p_y00", "p_w")
        }

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self) -> dict[str, int]:
        return {"eps_n": 6, "alpha": 1}

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        """The radial return on AoS fields [Q, 6]: a batched Newton with the
        reference's iteration scheme (gamma_prev <- gamma, residual and slope
        at gamma_prev, update). A point stays active while it is plastic and
        neither its residual nor its increment has met the tolerance; the
        loop is a ``device_while``: eagerly it reads ``any(active)`` back once
        per trip, inside a captured step it runs on the card. A point that diverges
        stops at the trip cap with non-finite state (``diverged_mask``)."""
        del t, del_t
        ka = self.params["p_ka"]
        mu = self.params["p_mu"]
        y0 = self.params["p_y0"]
        y00 = self.params["p_y00"]
        w = self.params["p_w"]

        eps = mandel.strain_from_grad_u(grad_del_u, Constraint.FULL)
        alpha = history["alpha"][:, 0]
        eps_p_n = history["eps_n"]

        tr_eps = mandel.trace(eps)
        del_sigtr = 2.0 * mu * mandel.deviatoric(eps)
        sigtr = mandel.deviatoric(stress) + del_sigtr
        sigtrn = torch.sqrt((sigtr * sigtr).sum(dim=-1))

        def hardening(a):
            return y0 + (y00 - y0) * (1.0 - torch.exp(-w * a))

        plastic = sigtrn - _SQ23 * hardening(alpha) > 0.0
        safe = torch.where(sigtrn > 0.0, sigtrn, torch.ones_like(sigtrn))
        xn = torch.where(plastic[:, None], sigtr / safe[:, None], torch.zeros_like(sigtr))

        def f(x):
            return sigtrn - 2.0 * mu * x - _SQ23 * hardening(alpha + _SQ23 * x)

        def df(x):
            return -2.0 * mu - (2.0 / 3.0) * (y00 - y0) * w * torch.exp(-w * (alpha + _SQ23 * x))

        eps_m = torch.finfo(stress.dtype).eps
        tol, tol_rel, max_it = newton_controls(self, stress.dtype)
        tol_abs = torch.clamp(8.0 * eps_m * (y0 + sigtrn), min=tol)

        def active(gamma_prev, gamma, xr):
            return (plastic & ~(xr.abs() <= tol_abs)
                    & ~((gamma - gamma_prev).abs() <= tol_rel * gamma.abs()))

        # JAX's lax.while_loop: a device loop inside a captured step
        def cond(carry):
            return active(*carry[:3]).any() & (carry[3] <= max_it)

        def body(carry):
            gamma_prev, gamma, xr, it = carry
            act = active(gamma_prev, gamma, xr)
            g0 = torch.where(act, gamma, gamma_prev)
            xr_new = f(g0)
            gamma_new = g0 - xr_new / df(g0)
            return (g0, torch.where(act, gamma_new, gamma), torch.where(act, xr_new, xr),
                    it + 1)

        one = torch.ones_like(sigtrn)
        it0 = torch.zeros((), dtype=torch.int32, device=sigtrn.device)
        _, gamma, _, _ = device_while(cond, body, (one, torch.zeros_like(sigtrn), one, it0),
                                      reads=(), name="law.trip")
        gamma = torch.where(plastic, gamma, torch.zeros_like(gamma))

        xg = df(gamma)
        zero = torch.zeros_like(xg)
        xc1 = torch.where(plastic, -1.0 / xg, zero)
        xc2 = torch.where(plastic, gamma / safe, zero)

        stress_new = stress + (
            (ka * tr_eps)[:, None] * _i2(stress) + del_sigtr - 2.0 * mu * gamma[:, None] * xn
        )
        ioi = _const(3.0 * mandel.projection_vol(6), stress)
        pdev = _const(mandel.projection_dev(6), stress)
        tangent = (
            ka * ioi
            + (2.0 * mu * (1.0 - 2.0 * mu * xc2))[:, None, None] * pdev
            + (4.0 * mu * mu * (xc2 - xc1))[:, None, None] * xn[:, :, None] * xn[:, None, :]
        )
        history_new = {"eps_n": eps_p_n + gamma[:, None] * xn,
                       "alpha": (alpha + _SQ23 * gamma)[:, None]}
        return stress_new, tangent, history_new

    @staticmethod
    def diverged_mask(history: History) -> torch.Tensor:
        """True where the local Newton produced a non-finite state."""
        return ~torch.isfinite(history["alpha"])

    evaluate_packed = _vonmises_evaluate_packed
    factored_tangent = True


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return mandel.device_constant(a, like.dtype, like.device)


def _i2(like: torch.Tensor) -> torch.Tensor:
    return _const(mandel.sym_identity(6), like)


class MisesPlasticityLinearHardening3D(IncrSmallStrainModel):
    r"""Von Mises with linear isotropic hardening; closed-form radial return.

    Yield: :math:`\sqrt{3/2\, s:s} - (y_0 + h\,\alpha)`.

    Args:
        parameters: ``mu`` shear modulus, ``kappa`` bulk modulus, ``y_0``
            initial yield stress, ``h`` hardening modulus (floats or arrays
            of size 1).
    """

    def __init__(self, parameters: dict[str, float]):
        self.params = {
            k: float(np.asarray(parameters[k]).reshape(())) for k in ("mu", "kappa", "y_0", "h")
        }

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self) -> dict[str, int]:
        return {"alpha": 1, "plastic_strain": 6}

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t, del_t
        mu = self.params["mu"]
        kappa = self.params["kappa"]
        y_0 = self.params["y_0"]
        h = self.params["h"]

        eps = mandel.strain_from_grad_u(grad_del_u, Constraint.FULL)
        alpha = history["alpha"][:, 0]
        eps_p = history["plastic_strain"]

        p_0, s_0 = mandel.vol_dev(stress)
        p_1 = p_0 + kappa * mandel.trace(eps)
        s_tr = s_0 + 2.0 * mu * mandel.deviatoric(eps)
        s_tr_eq = mandel.mises_norm(s_tr)
        sigma_y = y_0 + h * alpha

        plastic = s_tr_eq >= sigma_y
        safe = torch.where(s_tr_eq > 0.0, s_tr_eq, torch.ones_like(s_tr_eq))
        zero, one = torch.zeros_like(s_tr_eq), torch.ones_like(s_tr_eq)
        del_alpha = torch.where(plastic, (s_tr_eq - sigma_y) / (3.0 * mu + h), zero)
        theta = torch.where(plastic, 1.0 - (3.0 * mu * del_alpha) / safe, one)
        n = torch.where(plastic[:, None], s_tr / safe[:, None], torch.zeros_like(s_tr))

        stress_new = p_1[:, None] * _i2(stress) + theta[:, None] * s_tr
        # the consistent tangent of sigma_dev = theta(eps) s_tr(eps) for n =
        # s_tr / q_eq: -3 mu theta_bar on n (x) n (the reference's +2 mu
        # theta_bar costs Newton its quadratic convergence)
        theta_bar = torch.where(plastic, 1.0 / (1.0 + h / (3.0 * mu)) - (1.0 - theta), zero)
        tangent = (
            kappa * _const(3.0 * mandel.projection_vol(6), stress)
            + (2.0 * mu * theta)[:, None, None] * _const(mandel.projection_dev(6), stress)
            - (3.0 * mu * theta_bar)[:, None, None] * n[:, :, None] * n[:, None, :]
        )
        # flow rule del_eps_p = 1.5 del_alpha n, so that s_new = s_tr - 2 mu
        # del_eps_p holds exactly
        history_new = {
            "alpha": (alpha + del_alpha)[:, None],
            "plastic_strain": eps_p + 1.5 * del_alpha[:, None] * n,
        }
        return stress_new, tangent, history_new

    evaluate_packed = _mises_linear_evaluate_packed
    factored_tangent = True
