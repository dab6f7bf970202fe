"""Implicit return mapping for isotropic plasticity with a general yield
function ``f(sigma, kappa)``, flow direction ``g(sigma, kappa)`` and a
hardening measure: a full Newton on the (7 + K) unknowns (stress, plastic
multiplier, internal variables) per point, with the algorithmically
consistent tangent.

The residual is written once and ``torch.func.jacfwd`` gives its exact
Jacobian, batched over points with ``torch.func.vmap``; each trip solves the
batch's (7 + K)^2 systems with one batched ``torch.linalg.solve_ex`` that
checks nothing on the host. The hardening residual is ``kappa - kappa0 -
lam sqrt(2/3) |g|`` (the form the reference's own Newton matrix
linearises). A point that does not converge stops after ``maxit`` trips.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import jacfwd, vmap

from ..utils.timers import scope
from .packed_models import device_while

__all__ = ["implicit_return_map"]

_SQ23 = math.sqrt(2.0 / 3.0)


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A X = B, batched, with no error check (so no read back to the host):
    a singular system gives non-finite values, which the caller selects away."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def implicit_return_map(
    f_fn: Callable,
    g_fn: Callable,
    C: torch.Tensor,
    sigma_0: torch.Tensor,
    del_eps: torch.Tensor,
    kappa_0: torch.Tensor,
    *,
    atol: float = 1e-8,
    rtol: float = 1e-8,
    maxit: int = 25,
):
    """Vectorised implicit return map (the scope ``law.return_map``).

    Args:
        f_fn: ``f(sigma [6], kappa [K]) -> []``, the yield function.
        g_fn: ``g(sigma [6], kappa [K]) -> [6]``, the flow direction.
        C: [6, 6] elastic tangent.
        sigma_0: [Q, 6] committed stress; del_eps: [Q, 6] strain increment;
            kappa_0: [Q, K] committed internal variables.

    Returns ``(sigma_1 [Q, 6], tangent [Q, 6, 6], kappa_1 [Q, K],
    del_plastic_strain [Q, 6])``.

    The local Newton is the per-point loop of the JAX package under
    ``vmap``: a point is active while it is plastic, its stored residual
    (computed at the iterate before the last update) has norm >= ``atol``,
    some component of its last increment exceeds ``atol + rtol |sol|``, and
    it has made fewer than ``maxit`` trips. A point that stops keeps its
    iterate, so every point stops at the same iterate as in JAX.

    The trips are a ``device_while`` (``law.trip``) that runs while any
    point is active: each evaluates the residual, the Jacobian and the solve
    at every point, and only the active points take the update. The
    consistent tangent and the plastic strain increment are likewise
    computed at every point and kept where it is plastic. Nothing is read
    back to the host, so a captured step replays the loop as a CUDA graph
    while node. The values of a point that takes no update (a singular or
    non-finite solve among them) only ever meet ``torch.where``.
    """
    with scope("law.return_map"):
        Q, K = kappa_0.shape
        dtype, device = sigma_0.dtype, sigma_0.device

        def residual(sol, sigma_tr, kappa0):
            sigma, lam, kappa = sol[:6], sol[6], sol[7:]
            g = g_fn(sigma, kappa)
            # C g a column at a time: batched over the points and jacfwd's 8
            # directions, C * g would hold a [Q, 8, 6, 6] temporary (1.2 GB
            # at 529k points in float64)
            Cg = C[:, 0] * g[0]
            for j in range(1, 6):
                Cg = Cg + C[:, j] * g[j]
            res_sigma = sigma - sigma_tr + lam * Cg
            res_f = f_fn(sigma, kappa)
            # hardening: del_kappa = lam sqrt(2/3) |g|. The norm keeps its
            # axis: under jacfwd a Python number times a 0-d tensor gives a
            # float64 tangent whatever the field's dtype
            g_norm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
            res_kappa = kappa - kappa0 - lam * (_SQ23 * g_norm)
            return torch.cat([res_sigma, res_f[None], res_kappa])

        batched_res = vmap(residual)
        batched_jac = vmap(jacfwd(residual))

        sigma_tr = sigma_0 + (C * del_eps[:, None, :]).sum(dim=-1)
        plastic = vmap(f_fn)(sigma_tr, kappa_0) > 0.0

        def active(sol, sol_prev, res, it):
            return (
                plastic
                & ~(torch.linalg.vector_norm(res, dim=1) < atol)
                & ~((sol - sol_prev).abs() <= atol + rtol * sol.abs()).all(dim=1)
                & (it < maxit)
            )

        def cond(carry):
            return carry[-1].any()

        def body(carry):
            sol, sol_prev, res, it, act = carry
            r = batched_res(sol, sigma_tr, kappa_0)
            step = _solve(batched_jac(sol, sigma_tr, kappa_0), r)
            take = act[:, None]
            sol, sol_prev, res = (torch.where(take, sol - step, sol),
                                  torch.where(take, sol, sol_prev),
                                  torch.where(take, r, res))
            it = it + act.to(it.dtype)
            return sol, sol_prev, res, it, active(sol, sol_prev, res, it)

        sol = torch.cat([sigma_tr, torch.zeros((Q, 1), dtype=dtype, device=device), kappa_0],
                        dim=1)
        sol_prev = sol + 1.0  # the first increment test must pass
        res = batched_res(sol, sigma_tr, kappa_0)
        it = torch.zeros(Q, dtype=torch.int32, device=device)
        sol = device_while(cond, body, (sol, sol_prev, res, it, active(sol, sol_prev, res, it)),
                           reads=(C, sigma_tr, kappa_0, plastic), name="law.trip")[0]

        keep = plastic[:, None]
        sigma_1 = torch.where(keep, sol[:, :6], sigma_tr)
        kappa_1 = torch.where(keep, sol[:, 7:], kappa_0)

        # consistent tangent: solve J X = [C; 0] and take the stress block
        # where the point is plastic; elastic points keep C
        J = batched_jac(sol, sigma_tr, kappa_0)
        rhs = torch.cat([C, torch.zeros((1 + K, 6), dtype=dtype, device=device)])
        X = _solve(J, rhs.expand(Q, 7 + K, 6))
        tangent = torch.where(plastic[:, None, None], X[:, :6, :], C)
        dsig = sigma_1 - sigma_0
        eps_e = _solve(C.expand(Q, 6, 6), dsig)
        del_eps_p = torch.where(keep, del_eps - eps_e, torch.zeros_like(del_eps))
        return sigma_1, tangent, kappa_1, del_eps_p
