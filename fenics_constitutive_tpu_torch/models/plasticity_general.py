"""Implicit return mapping for isotropic plasticity with a general yield
function ``f(sigma, kappa)``, flow direction ``g(sigma, kappa)`` and a
hardening measure: a full Newton on the (7 + K) unknowns (stress, plastic
multiplier, internal variables) per point, with the algorithmically
consistent tangent.

The residual is written once and ``torch.func.jacfwd`` gives its exact
Jacobian, batched over points with ``torch.func.vmap``; each trip solves the
batch's (7 + K)^2 systems with one batched ``torch.linalg.solve``. The
hardening residual is ``kappa - kappa0 - lam sqrt(2/3) |g|`` (the form the
reference's own Newton matrix linearises). A point that does not converge
stops after ``maxit`` trips.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch.func import jacfwd, vmap

__all__ = ["implicit_return_map"]

_SQ23 = math.sqrt(2.0 / 3.0)


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
    active_per_trip: list[int] | None = None,
):
    """Vectorised implicit return map.

    Args:
        f_fn: ``f(sigma [6], kappa [K]) -> []``, the yield function.
        g_fn: ``g(sigma [6], kappa [K]) -> [6]``, the flow direction.
        C: [6, 6] elastic tangent.
        sigma_0: [Q, 6] committed stress; del_eps: [Q, 6] strain increment;
            kappa_0: [Q, K] committed internal variables.

    Returns ``(sigma_1 [Q, 6], tangent [Q, 6, 6], kappa_1 [Q, K],
    del_plastic_strain [Q, 6])``.

    The local Newton runs batched with a carried active mask, which is the
    per-point loop of the JAX package under ``vmap``: a point is active
    while it is plastic, its stored residual (computed at the iterate
    before the last update) has norm >= ``atol``, some component of its last
    increment exceeds ``atol + rtol |sol|``, and it has made fewer than
    ``maxit`` trips. A point that stops keeps its iterate, so every point
    stops at the same iterate as in JAX. Each trip reads the number of
    active points back to the host once (the loop ends when it is 0) and
    evaluates the residual, Jacobian and solve on the active points only.
    Where the caller passes a list as ``active_per_trip``, each trip's count
    of active points is appended to it (the counts read back anyway).
    """
    Q, K = kappa_0.shape
    dtype, device = sigma_0.dtype, sigma_0.device

    def residual(sol, sigma_tr, kappa0):
        sigma, lam, kappa = sol[:6], sol[6], sol[7:]
        g = g_fn(sigma, kappa)
        res_sigma = sigma - sigma_tr + lam * (C * g).sum(dim=-1)
        res_f = f_fn(sigma, kappa)
        # hardening: del_kappa = lam sqrt(2/3) |g|
        res_kappa = kappa - kappa0 - lam * (_SQ23 * torch.linalg.vector_norm(g))
        return torch.cat([res_sigma, res_f[None], res_kappa])

    batched_res = vmap(residual)
    batched_jac = vmap(jacfwd(residual))

    sigma_tr = sigma_0 + (C * del_eps[:, None, :]).sum(dim=-1)
    plastic = vmap(f_fn)(sigma_tr, kappa_0) > 0.0

    sol = torch.cat([sigma_tr, torch.zeros((Q, 1), dtype=dtype, device=device), kappa_0], dim=1)
    sol_prev = sol + 1.0  # the first increment test must pass
    res = batched_res(sol, sigma_tr, kappa_0)
    it = torch.zeros(Q, dtype=torch.int32, device=device)
    trips = [] if active_per_trip is None else active_per_trip
    while True:
        act = (
            plastic
            & ~(torch.linalg.vector_norm(res, dim=1) < atol)
            & ~((sol - sol_prev).abs() <= atol + rtol * sol.abs()).all(dim=1)
            & (it < maxit)
        )
        idx = act.nonzero().squeeze(1)
        if idx.numel() == 0:
            break
        trips.append(int(idx.numel()))
        s_a, tr_a, k_a = sol[idx], sigma_tr[idx], kappa_0[idx]
        r_a = batched_res(s_a, tr_a, k_a)
        step = torch.linalg.solve(batched_jac(s_a, tr_a, k_a), r_a)
        sol_prev = sol_prev.index_copy(0, idx, s_a)
        sol = sol.index_copy(0, idx, s_a - step)
        res = res.index_copy(0, idx, r_a)
        it = it.index_add(0, idx, torch.ones_like(idx, dtype=torch.int32))

    sigma_1 = torch.where(plastic[:, None], sol[:, :6], sigma_tr)
    kappa_1 = torch.where(plastic[:, None], sol[:, 7:], kappa_0)

    # consistent tangent of the plastic points: solve J X = [C; 0], take the
    # stress block; elastic points keep C
    tangent = C.expand(Q, 6, 6).clone()
    del_eps_p = torch.zeros_like(del_eps)
    pidx = plastic.nonzero().squeeze(1)
    if pidx.numel():
        J = batched_jac(sol[pidx], sigma_tr[pidx], kappa_0[pidx])
        rhs = torch.cat([C, torch.zeros((1 + K, 6), dtype=dtype, device=device)])
        X = torch.linalg.solve(J, rhs.expand(pidx.numel(), 7 + K, 6))
        tangent[pidx] = X[:, :6, :]
        dsig = (sigma_1 - sigma_0)[pidx]
        del_eps_p[pidx] = del_eps[pidx] - torch.linalg.solve(C, dsig.T).T
    return sigma_1, tangent, kappa_1, del_eps_p
