"""Newton-Krylov load step on the structured engine (grid-major SoA fields).

``make_packed_step`` builds ``step(models, state, bc_dofs, bc_vals, f_ext,
dt) -> (state', stats)`` for one law on a box mesh. The whole Newton loop
runs on grid-major dof vectors; the node-major public layout is converted
once at the step boundary.

Host synchronisation: with ``max_newton=1`` and ``cg_fixed_iters`` set (the
benchmark configuration) a step reads nothing back to the host, so the
device runs ahead of Python for the whole step. The Newton test is then
applied as a mask (a step whose first residual already meets the tolerance
keeps its state). With ``max_newton > 1`` the loop reads the residual norm
back once per iteration to decide whether to go on.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.packed import IsotropicTangent
from ..ops.structured import StructuredGeometry, build_structured_geometry
from . import linear

__all__ = ["PackedState", "build_packed_problem", "make_packed_step"]


@dataclass(frozen=True)
class PackedState:
    u: torch.Tensor  # [ndofs] node-major
    stress: tuple  # per-law [s, Q, M]
    histories: tuple  # per-law dict of [h, Q, M] (or None)
    t: torch.Tensor  # scalar

    def clone(self) -> PackedState:
        """A deep copy (the step never mutates its input, but callers may)."""
        return PackedState(
            u=self.u.clone(),
            stress=tuple(s.clone() for s in self.stress),
            histories=tuple(
                None if h is None else {k: v.clone() for k, v in h.items()}
                for h in self.histories
            ),
            t=self.t.clone(),
        )


def build_packed_problem(space, law, q_degree: int, *, device, dtype: torch.dtype):
    """Geometry and zero initial state for one law on a box mesh of P1 hexes
    (or quads). Returns ``(geos, models, state0)`` with one-element tuples."""
    geo = build_structured_geometry(
        space, q_degree, law.constraint, device=device, dtype=dtype
    )
    sdim = law.constraint.stress_strain_dim

    def zeros(k):
        return torch.zeros(geo.qp_shape(k), dtype=dtype, device=device)

    history = (
        None if law.history_dim is None
        else {k: zeros(d) for k, d in law.history_dim.items()}
    )
    state = PackedState(
        u=torch.zeros(space.ndofs, dtype=dtype, device=device),
        stress=(zeros(sdim),),
        histories=(history,),
        t=torch.zeros((), dtype=dtype, device=device),
    )
    return (geo,), (law,), state


def _select(cond: torch.Tensor, new, old):
    """Elementwise choice between two step results of the same structure."""
    if isinstance(new, torch.Tensor):
        return torch.where(cond, new, old)
    if isinstance(new, tuple):
        return tuple(_select(cond, a, b) for a, b in zip(new, old))
    if isinstance(new, dict):
        return {k: _select(cond, new[k], old[k]) for k in new}
    if isinstance(new, IsotropicTangent):
        return IsotropicTangent(
            *(_select(cond, getattr(new, f), getattr(old, f))
              for f in ("kappa", "beta", "gamma", "n"))
        )
    if new is None or isinstance(new, float):
        return new
    msg = f"cannot select between values of type {type(new).__name__}"
    raise TypeError(msg)


def _require_cuda(geo: StructuredGeometry) -> None:
    if geo.device.type != "cuda":
        msg = (
            "matvec_impl/eval_impl='kernel' launch CUDA kernels; the geometry "
            f"lives on {geo.device}. Use 'plain' off the card."
        )
        raise ValueError(msg)


def make_packed_step(
    geos: tuple,
    *,
    newton_rtol: float = 1e-12,
    newton_atol: float = 1e-10,
    max_newton: int = 25,
    cg_rtol: float = 1e-14,
    cg_maxiter: int = 1000,
    preconditioner=None,
    matvec_impl: str = "plain",
    cg_flexible: bool = False,
    cg_reduce_dtype: torch.dtype | None = None,
    cg_fixed_iters: int | None = None,
    eval_impl: str = "plain",
):
    """Build ``step(models, state, bc_dofs, bc_vals, f_ext, dt) -> (state', stats)``.

    ``geos``: a one-element tuple holding the law's StructuredGeometry.
    ``preconditioner``: optional callable M^-1 on grid-major vectors (a
    MultigridPreconditioner or its ``bpx``); None = Jacobi.
    ``matvec_impl``: "plain" (StructuredGeometry.matvec_gm) or "kernel" (the
    CUDA operator of ops/cuda_matvec.py; the geometry must be on a CUDA
    device). ``eval_impl``: "plain" (strain -> model.evaluate_packed ->
    residual) or "kernel" (the fused VonMises3D kernel of ops/cuda_eval.py,
    CUDA only). ``cg_flexible``/``cg_reduce_dtype``/``cg_fixed_iters``: see
    solver.linear.cg_solve.

    ``stats``: newton_iters, r_norm (free-dof residual norm at the end),
    r0_norm (at the start) and cg_iters_last, as tensors.
    """
    for name, impl in (("matvec_impl", matvec_impl), ("eval_impl", eval_impl)):
        if impl not in ("plain", "kernel"):
            msg = f"{name} must be 'plain' or 'kernel', got {impl!r}"
            raise ValueError(msg)
    if len(geos) != 1 or not isinstance(geos[0], StructuredGeometry):
        msg = "make_packed_step supports one law on a StructuredGeometry"
        raise ValueError(msg)
    geo = geos[0]
    M, vs, ndofs = geo.M, geo.vs, geo.ndofs
    if "kernel" in (matvec_impl, eval_impl):
        _require_cuda(geo)

    cg_opts = dict(
        flexible=cg_flexible, reduce_dtype=cg_reduce_dtype, fixed_iters=cg_fixed_iters
    )

    kernel_mv = None
    if matvec_impl == "kernel":
        from ..ops.cuda_matvec import build_cuda_matvec

        kernel_mv = build_cuda_matvec(geo)

    kernel_evals: dict = {}

    def eval_assemble(model, u_gm, u_prev_gm, stress, history, t, f_ext_gm, dt):
        if eval_impl == "kernel":
            from ..ops.cuda_eval import build_cuda_eval

            if id(model) not in kernel_evals:
                kernel_evals[id(model)] = (model, build_cuda_eval(geo, model))
            fused = kernel_evals[id(model)][1]
            F, s_new, (beta, gmm, nf), h_new = fused(u_gm - u_prev_gm, stress, history)
            tg = IsotropicTangent(
                kappa=model.params["p_ka"], beta=beta, gamma=gmm, n=nf
            )
            r = geo._scatter_corners(F).reshape(-1) - f_ext_gm
            return r, s_new, tg, h_new
        eps = geo.strain_gm(u_gm - u_prev_gm)
        s_new, tg, h_new = model.evaluate_packed(t, dt, eps, stress, history)
        return geo.residual_gm(s_new) - f_ext_gm, s_new, tg, h_new

    def solve(tg, r_gm, free_gm):
        zero = r_gm.new_zeros(())
        r_gm = torch.where(free_gm, r_gm, zero)

        def apply_op(v):
            return kernel_mv(v, tg) if kernel_mv is not None else geo.matvec_gm(v, tg)

        def matvec(v):
            vm = torch.where(free_gm, v, zero)
            return torch.where(free_gm, apply_op(vm), v)

        if preconditioner is not None:
            def precond(rr):
                z = preconditioner(torch.where(free_gm, rr, zero))
                return torch.where(free_gm, z, rr)

            return linear.cg_solve(
                matvec, r_gm, rtol=cg_rtol, maxiter=cg_maxiter, precond=precond,
                **cg_opts,
            )
        diag = torch.where(free_gm, geo.jacobi_diag_gm(tg), r_gm.new_ones(()))
        return linear.cg_solve(
            matvec, r_gm, diag, rtol=cg_rtol, maxiter=cg_maxiter, **cg_opts
        )

    def step(models, state: PackedState, bc_dofs, bc_vals, f_ext, dt):
        model = models[0]
        bc_dofs = torch.as_tensor(bc_dofs, dtype=torch.int64, device=geo.device)
        bc_gm = (bc_dofs % vs) * M + bc_dofs // vs
        free_gm = torch.ones(ndofs, dtype=torch.bool, device=geo.device)
        free_gm[bc_gm] = False
        u_prev_gm = geo.to_grid_major(state.u)
        f_ext_gm = geo.to_grid_major(f_ext)
        u = u_prev_gm.clone()
        u[bc_gm] = torch.as_tensor(bc_vals, dtype=u.dtype, device=u.device)

        def fnorm(r):
            return torch.linalg.vector_norm(torch.where(free_gm, r, r.new_zeros(())))

        def evaluate(u_gm):
            return eval_assemble(
                model, u_gm, u_prev_gm, state.stress[0], state.histories[0],
                state.t, f_ext_gm, dt,
            )

        r, s, tg, h = evaluate(u)
        r0_norm = fnorm(r)
        thresh = torch.clamp(newton_rtol * r0_norm, min=newton_atol)
        niter = torch.zeros((), dtype=torch.int32, device=geo.device)
        cg_k = torch.zeros((), dtype=torch.int32)
        synced = max_newton > 1
        for _ in range(max_newton):
            active = fnorm(r) > thresh
            if synced and not bool(active):
                break
            delta, cg_k = solve(tg, r, free_gm)
            u_new = u - delta
            new = (u_new, *evaluate(u_new))
            if synced:
                u, r, s, tg, h = new
            else:
                u, r, s, tg, h = _select(active, new, (u, r, s, tg, h))
            niter = niter + active.to(torch.int32)
        new_state = PackedState(
            u=geo.to_node_major(u), stress=(s,), histories=(h,), t=state.t + dt
        )
        stats = {
            "newton_iters": niter,
            "r_norm": fnorm(r),
            "r0_norm": r0_norm,
            "cg_iters_last": cg_k,
        }
        return new_state, stats

    return step
