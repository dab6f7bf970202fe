"""Matrix-free preconditioned conjugate-gradient solver."""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["cg_solve"]


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    diag: torch.Tensor | None = None,
    *,
    rtol: float = 1e-14,
    atol: float = 0.0,
    maxiter: int | None = None,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    flexible: bool = False,
    reduce_dtype: torch.dtype | None = None,
    fixed_iters: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve A x = b with preconditioned CG.

    Args:
        matvec: SPD operator action.
        b: right-hand side.
        diag: diagonal of A for Jacobi preconditioning (None = identity).
        precond: explicit M^-1 apply (e.g. a multigrid V-cycle); overrides diag.
        flexible: use the Polak-Ribiere beta ``z.(r - r_prev)/rz_prev``
            (flexible CG). It restores convergence where float32 round-off or
            a nonconstant preconditioner breaks exact conjugacy.
        reduce_dtype: accumulate the dot products in this dtype (e.g.
            ``torch.float64`` for a float32 solve).
        fixed_iters: run exactly this many iterations with no convergence
            test. No value is read back to the host, so the loop never waits
            for the device; the caller verifies the residual downstream.
            Otherwise the loop tests ``r.r > tol`` on the host each iteration.

    Returns:
        (x, n_iterations) with n_iterations an int32 tensor.
    """
    if reduce_dtype is not None:
        def dot(a, c):
            return torch.dot(a.to(reduce_dtype), c.to(reduce_dtype))
    else:
        def dot(a, c):
            return torch.dot(a, c)
    n = b.shape[0]
    maxiter = maxiter if maxiter is not None else 10 * n
    if precond is None:
        if diag is None:
            def precond(r):
                return r
        else:
            inv_diag = torch.where(diag != 0.0, 1.0 / diag, torch.ones_like(diag))

            def precond(r):
                return r * inv_diag

    wdtype = b.dtype

    def safe(d):
        return torch.where(d != 0.0, d, torch.ones_like(d))

    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = dot(r, z)

    def body():
        nonlocal x, r, z, p, rz
        q = matvec(p)
        alpha = (rz / safe(dot(p, q))).to(wdtype)
        x = x + alpha * p
        r_new = r - alpha * q
        z = precond(r_new)
        rz_new = dot(r_new, z)
        num = dot(z, r_new - r) if flexible else rz_new
        beta = (num / safe(rz)).to(wdtype)
        p = z + beta * p
        r, rz = r_new, rz_new

    if fixed_iters is not None:
        for _ in range(fixed_iters):
            body()
        return x, torch.tensor(fixed_iters, dtype=torch.int32)

    tol2 = max(rtol * rtol * float(dot(b, b)), atol * atol)
    k = 0
    while k < maxiter and float(dot(r, r)) > tol2:
        body()
        k += 1
    return x, torch.tensor(k, dtype=torch.int32)
