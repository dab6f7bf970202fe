"""A whole load step as one function on the AoS law data.

``IncrSmallStrainProblem.solve()`` keeps its state on the problem;
``make_load_step`` builds a pure ``step(models, state, bc_dofs, bc_vals,
f_ext, dt) -> (state', stats)`` over the problem's static structure (law
data, constraint, sizes) for production stepping: constitutive evaluation,
assembly, Jacobi diagonal and CG, with the committed state threaded through
``StepState``. Newton runs on the host and reads ||r|| back once per
iteration to test convergence.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..fem.assembly import assemble_jacobi_diag, assemble_residual, grad_at_qp, tangent_matvec
from .linear import cg_solve

__all__ = ["StepState", "make_load_step"]


@dataclass(frozen=True)
class StepState:
    """Committed state threaded through load steps."""

    u: torch.Tensor  # [ndofs]
    stress: torch.Tensor  # [C, Q, s]
    histories: tuple  # per-law dicts of [Q_l, ...] (or None)
    t: torch.Tensor  # scalar time


def make_load_step(
    problem,
    *,
    newton_rtol: float = 1e-12,
    newton_atol: float = 1e-10,
    max_newton: int = 25,
    cg_rtol: float = 1e-14,
    cg_maxiter: int | None = None,
):
    """Build ``step(models, state, bc_dofs, bc_vals, f_ext, dt) -> (state, stats)``.

    ``problem`` (an ``IncrSmallStrainProblem``, either engine) supplies the
    AoS law data, the constraint and the sizes. ``stats``: ``newton_iters``,
    ``r_norm`` and ``r0_norm`` as tensors, as in the JAX package. The step
    runs in one process: a sharded problem raises ValueError.
    """
    if problem._shard is not None:
        msg = "make_load_step steps one process's AoS state; the problem is sharded"
        raise ValueError(msg)
    constraint = problem.constraint
    ndofs = problem.ndofs
    law_data = problem._law_data
    sdim = constraint.stress_strain_dim
    g = constraint.geometric_dim
    maxiter = cg_maxiter if cg_maxiter is not None else 4 * ndofs

    def eval_assemble(models, u, u_prev, stress_prev, histories, f_ext, t, dt):
        du = u - u_prev
        r = -f_ext
        stress_new = stress_prev.clone()
        tangents, hists = [], []
        for model, (dofmap, geo, cells), hist in zip(models, law_data, histories):
            grad = grad_at_qp(du, dofmap, geo)
            n_l, Q = grad.shape[0], grad.shape[1]
            s_new, tg, h_new = model.evaluate(
                t, dt, grad.reshape(n_l * Q, g, g),
                stress_prev[cells].reshape(n_l * Q, sdim), hist,
            )
            s_blk = s_new.reshape(n_l, Q, sdim)
            stress_new[cells] = s_blk
            r = r + assemble_residual(s_blk, dofmap, geo, constraint, ndofs)
            tangents.append(tg.reshape(n_l, Q, sdim, sdim))
            hists.append(h_new)
        return r, stress_new, tuple(tangents), tuple(hists)

    def linear_solve(tangents, r, free):
        zero = r.new_zeros(())
        diag = None
        for (dofmap, geo, _), tg in zip(law_data, tangents):
            d = assemble_jacobi_diag(tg, dofmap, geo, constraint, ndofs)
            diag = d if diag is None else diag + d

        def matvec(v):
            vm = torch.where(free, v, zero)
            out = None
            for (dofmap, geo, _), tg in zip(law_data, tangents):
                mv = tangent_matvec(vm, tg, dofmap, geo, constraint, ndofs)
                out = mv if out is None else out + mv
            return torch.where(free, out, v)

        return cg_solve(matvec, torch.where(free, r, zero),
                        torch.where(free, diag, r.new_ones(())), rtol=cg_rtol, maxiter=maxiter)

    def step(models, state: StepState, bc_dofs, bc_vals, f_ext, dt):
        u0 = state.u
        bc_dofs = torch.as_tensor(bc_dofs, dtype=torch.int64, device=u0.device)
        free = torch.ones(ndofs, dtype=torch.bool, device=u0.device)
        free[bc_dofs] = False
        u = u0.clone()
        u[bc_dofs] = torch.as_tensor(bc_vals, dtype=u.dtype, device=u.device)
        f_ext = torch.as_tensor(f_ext, dtype=u.dtype, device=u.device)

        def fnorm(r):
            return torch.linalg.vector_norm(torch.where(free, r, r.new_zeros(())))

        def evaluate(u_w):
            return eval_assemble(models, u_w, u0, state.stress, state.histories, f_ext,
                                 state.t, dt)

        # each Newton iteration evaluates the models once: the evaluation at
        # the new iterate is the next iteration's residual and tangent
        r, stress, tangents, hists = evaluate(u)
        r0_norm = fnorm(r)
        thresh = max(newton_atol, newton_rtol * float(r0_norm))
        niter = 0
        while niter < max_newton and float(fnorm(r)) > thresh:
            delta, _ = linear_solve(tangents, r, free)
            u = u - delta
            r, stress, tangents, hists = evaluate(u)
            niter += 1
        new_state = StepState(u=u, stress=stress, histories=hists, t=state.t + dt)
        stats = {"newton_iters": torch.tensor(niter, dtype=torch.int32), "r_norm": fnorm(r),
                 "r0_norm": r0_norm}
        return new_state, stats

    return step
