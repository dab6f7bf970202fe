"""Packed (SoA) constitutive updates of the hot models: component axis
leading ([s, *qp] stress, [h, *qp] history) and factored isotropic tangents,
so the CG operator never touches a dense [6, 6, N] field. A law outside the
FULL constraint runs through the generic dense-tangent adapter
(``IncrSmallStrainModel.evaluate_packed``)."""

from __future__ import annotations

import math

import torch

from ..ops.mandel import Constraint
from ..ops.packed import IsotropicTangent
from .interfaces import IncrSmallStrainModel

__all__ = [
    "_factored_when_full",
    "_linear_elasticity_evaluate_packed",
    "_mises_linear_evaluate_packed",
    "_spring_kelvin_evaluate_packed",
    "_spring_maxwell_evaluate_packed",
    "_vonmises_evaluate_packed",
    "device_while",
    "newton_controls",
]

_SQ23 = math.sqrt(2.0 / 3.0)


def _dev_soa(x: torch.Tensor):
    """(trace, deviator) of a Mandel SoA field [6, *qp]."""
    tr = x[:3].sum(dim=0)
    return tr, torch.cat([x[:3] - tr / 3.0, x[3:]], dim=0)


def _on_diagonal(x: torch.Tensor) -> torch.Tensor:
    """x I2 for a scalar field x [*qp]: x on the three diagonal Mandel slots
    of a [6, *qp] field, zero on the shear slots."""
    return torch.cat([x.expand(3, *x.shape), torch.zeros_like(x).expand(3, *x.shape)])


def _uniform_tangent(kappa, beta, like: torch.Tensor) -> IsotropicTangent:
    """A tangent without the n (x) n term, the same at every point."""
    return IsotropicTangent(
        kappa=kappa,
        beta=beta,
        gamma=torch.zeros((), dtype=like.dtype, device=like.device),
        n=torch.zeros((6,) + (1,) * (like.dim() - 1), dtype=like.dtype, device=like.device),
    )


@property
def _factored_when_full(self) -> bool:
    """``factored_tangent`` of a model whose SoA twin serves the FULL
    constraint only: the others run through the generic adapter."""
    return self.constraint == Constraint.FULL


def newton_controls(model, dtype: torch.dtype) -> tuple[float, float, int]:
    """(absolute tolerance floor, relative tolerance, trip cap) of the local
    Newton in this working type: the model's controls, with the relative
    tolerance raised to 8 eps and, in float32, at most 32 trips."""
    eps = torch.finfo(dtype).eps
    max_it = model.newton_max_iter if eps < 1e-10 else min(model.newton_max_iter, 32)
    return model.newton_tol, max(model.newton_rtol, 8.0 * eps), max_it


def device_while(cond, body, carry, *, name, reads=None):
    """``solver.compiled.device_while`` (imported at the call: the solver
    package imports the models)."""
    from ..solver.compiled import device_while as loop

    return loop(cond, body, carry, reads=reads, name=name)


def _vonmises_evaluate_packed(self, t, dt, eps, stress, history):
    """Radial return of ``VonMises3D`` (exponential hardening) on SoA fields.

    The local Newton runs batched with a per-QP active mask: a point that
    has converged keeps its value while others iterate, up to the trip cap.
    Tolerances follow the dtype (the reference's 1e-12/1e-8 are unreachable
    in float32), and float32 caps the trips at 32 so that a few points
    oscillating at round-off cannot pin the batch at 100.

    The loop runs while any point is active and the cap is not reached, as
    a ``device_while`` (JAX's ``lax.while_loop``): eagerly it reads
    ``any(active)`` back once per trip, inside a captured step it is a CUDA
    graph while node and stops at the same trip. The fused kernel
    (ops/cuda_eval.py) runs the same rule per thread.
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
    def cond(carry):
        _, act, it = carry
        return act.any() & (it <= max_it)

    def body(carry):
        g0, act, it = carry
        xr, dfv = fdf(g0)
        g = torch.where(act, g0 - xr / dfv, g0)
        act = act & (xr.abs() > tol_abs) & ((g - g0).abs() > tol_rel * g.abs())
        return g, act, it + 1

    it0 = torch.zeros((), dtype=torch.int32, device=sigtrn.device)
    g, _, _ = device_while(cond, body, (torch.zeros_like(sigtrn), plastic & (1.0 > tol_abs),
                                        it0), reads=(), name="law.trip")
    gamma = torch.where(plastic, g, torch.zeros_like(g))

    xg = fdf(gamma)[1]
    xc1 = torch.where(plastic, -1.0 / xg, torch.zeros_like(xg))
    xc2 = torch.where(plastic, gamma / safe, torch.zeros_like(gamma))

    stress_new = stress + _on_diagonal(ka * tr_eps) + del_sigtr - 2.0 * mu * gamma * xn
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


def _mises_linear_evaluate_packed(self, t, dt, eps, stress, history):
    """Closed-form radial return of ``MisesPlasticityLinearHardening3D`` on
    SoA fields, with the corrected consistent tangent of its AoS update."""
    del t, dt
    mu = self.params["mu"]
    kappa = self.params["kappa"]
    y_0 = self.params["y_0"]
    h = self.params["h"]

    alpha = history["alpha"][0]
    eps_p = history["plastic_strain"]

    tr_s, s_0 = _dev_soa(stress)
    tr_e, e_dev = _dev_soa(eps)
    p_1 = tr_s / 3.0 + kappa * tr_e

    s_tr = s_0 + 2.0 * mu * e_dev
    s_tr_eq = torch.sqrt(1.5 * (s_tr * s_tr).sum(dim=0))
    sigma_y = y_0 + h * alpha
    plastic = s_tr_eq >= sigma_y
    safe = torch.where(s_tr_eq > 0.0, s_tr_eq, torch.ones_like(s_tr_eq))
    zero, one = torch.zeros_like(s_tr_eq), torch.ones_like(s_tr_eq)

    del_alpha = torch.where(plastic, (s_tr_eq - sigma_y) / (3.0 * mu + h), zero)
    theta = torch.where(plastic, 1.0 - (3.0 * mu * del_alpha) / safe, one)
    n = torch.where(plastic, s_tr / safe, torch.zeros_like(s_tr))
    theta_bar = torch.where(plastic, 1.0 / (1.0 + h / (3.0 * mu)) - (1.0 - theta), zero)

    stress_new = _on_diagonal(p_1) + theta * s_tr
    history_new = {
        "alpha": (alpha + del_alpha)[None],
        "plastic_strain": eps_p + 1.5 * del_alpha * n,
    }
    tangent = IsotropicTangent(kappa=kappa, beta=2.0 * mu * theta,
                               gamma=-3.0 * mu * theta_bar, n=n)
    return stress_new, tangent, history_new


def _linear_elasticity_evaluate_packed(self, t, dt, eps, stress, history):
    """Hooke's law (FULL constraint): stress += kappa tr(eps) I2 + 2 mu
    dev(eps); the tangent is the constant elastic one, with no history.
    Other constraints run through the generic adapter."""
    if self.constraint != Constraint.FULL:
        return IncrSmallStrainModel.evaluate_packed(self, t, dt, eps, stress, history)
    E, nu = self.params["E"], self.params["nu"]
    mu = E / (2.0 * (1.0 + nu))
    ka = E / (3.0 * (1.0 - 2.0 * nu))
    tr_e, e_dev = _dev_soa(eps)
    stress_new = stress + _on_diagonal(ka * tr_e) + 2.0 * mu * e_dev
    tangent = IsotropicTangent(
        kappa=ka,
        beta=2.0 * mu * torch.ones_like(tr_e),
        gamma=torch.zeros_like(tr_e),
        n=torch.zeros_like(eps),
    )
    return stress_new, tangent, history


def _sls_moduli(self) -> tuple[float, float, float, float, float]:
    """(mu0, lam0, ka0, mu1, ka1) of a standard linear solid."""
    E0, E1, nu = self.params["E0"], self.params["E1"], self.params["nu"]
    mu0 = E0 / (2.0 * (1.0 + nu))
    lam0 = E0 * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu1 = E1 / (2.0 * (1.0 + nu))
    lam1 = E1 * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu0, lam0, lam0 + 2.0 * mu0 / 3.0, mu1, lam1 + 2.0 * mu1 / 3.0


def _spring_kelvin_evaluate_packed(self, t, dt, eps, stress, history):
    """SoA twin of ``SpringKelvinModel.evaluate`` (FULL constraint) with a
    factored tangent: the SLS tangent is scale * D0, isotropic with kappa =
    scale ka0 and beta = scale 2 mu0. Other constraints run through the
    generic adapter."""
    if self.constraint != Constraint.FULL:
        return IncrSmallStrainModel.evaluate_packed(self, t, dt, eps, stress, history)
    tau = self.params["tau"]
    mu0, lam0, ka0, mu1, _ = _sls_moduli(self)
    sv_n = history["strain_visco"]
    strain_n = history["strain"]
    tr_eps, e_dev = _dev_soa(eps)

    factor = 1.0 / dt + 1.0 / tau + mu0 / (tau * mu1)
    deps_v = (1.0 / factor) * (
        stress / (2.0 * tau * mu1)
        - sv_n / tau
        + (mu0 / (tau * mu1)) * eps
        + _on_diagonal((lam0 / (2.0 * tau * mu1)) * tr_eps)
    )
    stress_new = stress + _on_diagonal(ka0 * tr_eps) + 2.0 * mu0 * e_dev - 2.0 * mu0 * deps_v
    scale = 1.0 - mu0 / (tau * mu1 * factor)
    history_new = {"strain_visco": sv_n + deps_v, "strain": strain_n + eps}
    return stress_new, _uniform_tangent(scale * ka0, scale * 2.0 * mu0, eps), history_new


def _spring_maxwell_evaluate_packed(self, t, dt, eps, stress, history):
    """SoA twin of ``SpringMaxwellModel.evaluate`` (FULL constraint) with a
    factored tangent: kappa = ka0 + f ka1, beta = 2 mu0 + f 2 mu1. Other
    constraints run through the generic adapter."""
    if self.constraint != Constraint.FULL:
        return IncrSmallStrainModel.evaluate_packed(self, t, dt, eps, stress, history)
    tau = self.params["tau"]
    mu0, _, ka0, mu1, ka1 = _sls_moduli(self)
    sv_n = history["strain_visco"]
    strain_n = history["strain"]

    tr_st, st_dev = _dev_soa(strain_n + eps)
    factor = 1.0 / dt + 1.0 / tau
    # D1 : strain_total in factored form
    d1_st = _on_diagonal(ka1 * tr_st) + 2.0 * mu1 * st_dev
    deps_v = (1.0 / factor) * (d1_st / (2.0 * tau * mu1) - sv_n / tau)

    tr_eps, e_dev = _dev_soa(eps)
    stress_new = (
        stress
        + _on_diagonal((ka0 + ka1) * tr_eps)
        + 2.0 * (mu0 + mu1) * e_dev
        - 2.0 * mu1 * deps_v
    )
    f = 1.0 - 1.0 / (tau * factor)
    history_new = {"strain_visco": sv_n + deps_v, "strain": strain_n + eps}
    return stress_new, _uniform_tangent(ka0 + f * ka1, 2.0 * mu0 + f * 2.0 * mu1, eps), history_new
