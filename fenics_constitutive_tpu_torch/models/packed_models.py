"""Packed (SoA) constitutive updates: component axis leading ([s, *qp]
stress, [h, *qp] history) and factored isotropic tangents, so the CG
operator never touches a dense [6, 6, N] field."""

from __future__ import annotations

import math

import torch

from ..ops.packed import IsotropicTangent

__all__ = [
    "_linear_elasticity_evaluate_packed",
    "_vonmises_evaluate_packed",
    "newton_controls",
]

_SQ23 = math.sqrt(2.0 / 3.0)


def _dev_soa(x: torch.Tensor):
    """(trace, deviator) of a Mandel SoA field [6, *qp]."""
    tr = x[:3].sum(dim=0)
    return tr, torch.cat([x[:3] - tr / 3.0, x[3:]], dim=0)


def newton_controls(model, dtype: torch.dtype) -> tuple[float, float, int]:
    """(absolute tolerance floor, relative tolerance, trip cap) of the local
    Newton in this working type: the model's controls, with the relative
    tolerance raised to 8 eps and, in float32, at most 32 trips."""
    eps = torch.finfo(dtype).eps
    max_it = model.newton_max_iter if eps < 1e-10 else min(model.newton_max_iter, 32)
    return model.newton_tol, max(model.newton_rtol, 8.0 * eps), max_it


def _vonmises_evaluate_packed(self, t, dt, eps, stress, history):
    """Radial return of ``VonMises3D`` (exponential hardening) on SoA fields.

    The local Newton runs batched with a per-QP active mask: a point that
    has converged keeps its value while others iterate, up to the trip cap.
    Tolerances follow the dtype (the reference's 1e-12/1e-8 are unreachable
    in float32), and float32 caps the trips at 32 so that a few points
    oscillating at round-off cannot pin the batch at 100.

    The loop tests ``any(active)`` on the host once per trip; the fused
    kernel (ops/cuda_eval.py) runs the same rule per thread with no sync.
    """
    del t, dt
    ka = self.params["p_ka"]
    mu = self.params["p_mu"]
    y0 = self.params["p_y0"]
    y00 = self.params["p_y00"]
    w = self.params["p_w"]

    alpha = history["alpha"][0]
    eps_p_n = history["eps_n"]

    tr_eps, eps_dev = _dev_soa(eps)
    del_sigtr = 2.0 * mu * eps_dev
    _, s_n = _dev_soa(stress)
    sigtr = s_n + del_sigtr
    sigtrn = torch.sqrt((sigtr * sigtr).sum(dim=0))

    phitr = sigtrn - _SQ23 * (y0 + (y00 - y0) * (1.0 - torch.exp(-w * alpha)))
    plastic = phitr > 0.0
    safe = torch.where(sigtrn > 0.0, sigtrn, torch.ones_like(sigtrn))
    xn = torch.where(plastic, sigtr / safe, torch.zeros_like(sigtr))

    def fdf(x):
        e = torch.exp(-w * (alpha + _SQ23 * x))
        fx = sigtrn - 2.0 * mu * x - _SQ23 * (y0 + (y00 - y0) * (1.0 - e))
        dfx = -2.0 * mu - (2.0 / 3.0) * (y00 - y0) * w * e
        return fx, dfx

    eps_m = torch.finfo(stress.dtype).eps
    tol, tol_rel, max_it = newton_controls(self, stress.dtype)
    tol_abs = torch.clamp(8.0 * eps_m * (y0 + sigtrn), min=tol)

    # act_{k+1} = act_k & not-converged: a lane that stops stays stopped
    g = torch.zeros_like(sigtrn)
    act = plastic & (1.0 > tol_abs)
    for _ in range(max_it + 1):
        if not bool(act.any()):
            break
        g0 = g
        xr, dfv = fdf(g0)
        g = torch.where(act, g0 - xr / dfv, g)
        act = act & (xr.abs() > tol_abs) & ((g - g0).abs() > tol_rel * g.abs())
    gamma = torch.where(plastic, g, torch.zeros_like(g))

    xg = fdf(gamma)[1]
    xc1 = torch.where(plastic, -1.0 / xg, torch.zeros_like(xg))
    xc2 = torch.where(plastic, gamma / safe, torch.zeros_like(gamma))

    vol = torch.cat([(ka * tr_eps).expand(3, *tr_eps.shape), torch.zeros_like(eps[3:])])
    stress_new = stress + vol + del_sigtr - 2.0 * mu * gamma * xn
    history_new = {
        "eps_n": eps_p_n + gamma * xn,
        "alpha": (alpha + _SQ23 * gamma)[None],
    }
    tangent = IsotropicTangent(
        kappa=ka,
        beta=2.0 * mu * (1.0 - 2.0 * mu * xc2),
        gamma=4.0 * mu * mu * (xc2 - xc1),
        n=xn,
    )
    return stress_new, tangent, history_new


def _linear_elasticity_evaluate_packed(self, t, dt, eps, stress, history):
    """Hooke's law (FULL constraint): stress += kappa tr(eps) I2 + 2 mu
    dev(eps); the tangent is the constant elastic one, with no history."""
    del t, dt
    E, nu = self.params["E"], self.params["nu"]
    mu = E / (2.0 * (1.0 + nu))
    ka = E / (3.0 * (1.0 - 2.0 * nu))
    tr_e, e_dev = _dev_soa(eps)
    vol = torch.cat([(ka * tr_e).expand(3, *tr_e.shape), torch.zeros_like(eps[3:])])
    stress_new = stress + vol + 2.0 * mu * e_dev
    tangent = IsotropicTangent(
        kappa=ka,
        beta=2.0 * mu * torch.ones_like(tr_e),
        gamma=torch.zeros_like(tr_e),
        n=torch.zeros_like(eps),
    )
    return stress_new, tangent, history
