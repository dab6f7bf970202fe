"""Matrix-free preconditioned conjugate-gradient solver."""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.timers import scope

__all__ = ["cg_solve"]


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    diag: torch.Tensor | None = None,
    *,
    rtol: float = 1e-14,
    atol: float = 0.0,
    maxiter: int | None = None,
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
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
        dot: the inner product of every reduction (e.g. one that sums the
            ranks' parts); None = ``torch.dot``, in ``reduce_dtype`` if set.
        precond: explicit M^-1 apply (e.g. a multigrid V-cycle); overrides diag.
        flexible: use the Polak-Ribiere beta ``z.(r - r_prev)/rz_prev``
            (flexible CG). It restores convergence where float32 round-off or
            a nonconstant preconditioner breaks exact conjugacy.
        reduce_dtype: accumulate the dot products in this dtype (e.g.
            ``torch.float64`` for a float32 solve).
        fixed_iters: run exactly this many iterations with no convergence
            test, unrolled into the caller's program. Otherwise the loop
            runs while ``dot(r, r) > tol2`` and ``k < maxiter`` as a
            ``device_while`` (solver/compiled.py): eagerly it reads that
            predicate back once an iteration; inside a captured step it is a
            CUDA graph while node, and the host reads nothing.

    Profiler scopes (``utils.timers.scope``): the whole call is ``cg.solve``,
    each iteration ``cg.iter``, each ``matvec`` call ``cg.operator`` and each
    ``precond`` call ``cg.precond`` (the one before the loop too).

    Returns:
        (x, n_iterations) with n_iterations an int32 tensor on b's device.
    """
    from .compiled import device_while

    with scope("cg.solve"):
        if dot is None and reduce_dtype is not None:
            def dot(a, c):
                return torch.dot(a.to(reduce_dtype), c.to(reduce_dtype))
        elif dot is None:
            dot = torch.dot
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

        def body(carry):
            x, r, p, rz, k = carry
            with scope("cg.operator"):
                q = matvec(p)
            alpha = (rz / safe(dot(p, q))).to(wdtype)
            x = x + alpha * p
            r_new = r - alpha * q
            with scope("cg.precond"):
                z = precond(r_new)
            rz_new = dot(r_new, z)
            num = dot(z, r_new - r) if flexible else rz_new
            beta = (num / safe(rz)).to(wdtype)
            p = z + beta * p
            return x, r_new, p, rz_new, None if k is None else k + 1

        with scope("cg.precond"):
            z = precond(b)
        carry = (torch.zeros_like(b), b, z, dot(b, z))
        if fixed_iters is not None:
            for _ in range(fixed_iters):
                with scope("cg.iter"):
                    carry = body((*carry, None))[:4]
            return carry[0], torch.full((), fixed_iters, dtype=torch.int32, device=b.device)
        carry = (*carry, torch.zeros((), dtype=torch.int32, device=b.device))

        # JAX's tol2 = max(rtol^2 (b.b), atol^2), on the device in the dot's type
        tol2 = torch.clamp((rtol * rtol) * dot(b, b), min=atol * atol)

        def cond(carry):
            _, r, _, _, k = carry
            return (dot(r, r) > tol2) & (k < maxiter)

        x, _, _, _, k = device_while(cond, body, carry, reads=(b,), name="cg.iter")
        return x, k
