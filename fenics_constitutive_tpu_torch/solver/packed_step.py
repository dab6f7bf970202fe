"""Newton-Krylov load step on the structured, windowed and gather engines
(SoA fields).

``build_packed_problem`` picks the engine for a mesh, as the JAX package
does: the structured engine for a box of hexes or quads, the structured-tet
engine for a Kuhn box of tets or triangles, the lattice engine for a
degree-2 space on a whole box of hexes or quads (grid-major dof vectors each
way), the windowed exchange engine (ops/windowed.py) for a general mesh of at
least ``WINDOWED_MIN_CELLS`` cells, and the gather engine (ops/packed.py) for
every other mesh: small imported meshes, interval bars. ``make_packed_step``
builds ``step(models, state, bc_dofs, bc_vals, f_ext, dt) -> (state',
stats)`` for one law or several laws on cell subsets, on any engine (masked
views of one grid on a box; plans of the cell subsets on one shared RCM order
on a windowed mesh; a gather geometry per law otherwise). The whole Newton
loop runs on the engine's working layout: grid-major vectors on the
structured engines, converted from the node-major public layout once at the
step boundary; on the windowed engine ``state.u`` and ``f_ext`` already live
in the internal layout (RCM-permuted, component-major, tile-padded), so the
step pays no permutation at all; the gather engine works node-major.

Host synchronisation: the Newton loop (JAX's ``lax.while_loop`` over
``(u, it, r, s, tg, h, cg_k)`` while ``||r|| > max(atol, rtol ||r0||)`` and
``it < max_newton``), the adaptive CG and the laws' local Newtons (Mises',
and the general return map of the Drucker-Prager laws) are
``solver.compiled.device_while`` loops. Run eagerly each reads its
predicate back once a trip; in a compiled step (``compile_step``) they are
CUDA graph while nodes and the step reads nothing back. With
``max_newton=1`` the Newton loop makes at most one trip (a step whose first
residual already meets the tolerance keeps its state).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..models.interfaces import IncrSmallStrainModel, flat_history_dim
from ..ops.packed import IsotropicTangent, build_packed_geometry
from ..ops.structured import (
    build_lattice_geometry,
    build_structured_geometry,
    build_structured_tet_geometry,
    restrict_structured_geometry,
    restrict_structured_tet_geometry,
)
from ..ops.windowed import (
    WindowedGeometry,
    build_windowed_geometry,
    reverse_cuthill_mckee,
)
from ..utils.timers import scope
from . import linear
from .compiled import device_while

__all__ = [
    "WINDOWED_MIN_CELLS",
    "PackedState",
    "build_packed_problem",
    "make_packed_step",
    "resolve_engine",
]

#: general (non-box) meshes of at least this many cells default to the
#: windowed engine, as in the JAX package; smaller ones, and interval
#: meshes, go to the gather engine
WINDOWED_MIN_CELLS = 4096


@dataclass(frozen=True)
class PackedState:
    u: torch.Tensor  # [ndofs] node-major, or [vs * M_pad] internal (windowed)
    stress: tuple  # per-law [s, qp_layout, M] (structured) or [s, N] (windowed, gather)
    histories: tuple  # per-law dict of [h, ...] like stress (or None)
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


def resolve_engine(space, engine: str = "auto", whole_mesh: bool = True) -> str:
    """The engine ``build_packed_problem`` runs ``space`` on: "structured"
    (a box of hexes or quads), "structured_tet" (a Kuhn box of tets or
    triangles), "lattice" (a degree-2 space on a whole box of hexes or
    quads), "windowed" or "gather". Box meshes keep their structured or
    lattice engine whatever ``engine`` says, as in the JAX package; a
    degree-2 law on a cell subset of a box takes the windowed or gather
    engine by cell count."""
    if engine not in ("auto", "windowed", "gather"):
        msg = f"engine must be 'auto', 'windowed' or 'gather', got {engine!r}"
        raise ValueError(msg)
    mesh = space.mesh
    box = mesh.structured_shape is not None
    if box and space.degree == 1:
        if mesh.cell_type in ("hex", "quad"):
            return "structured"
        if mesh.cell_type in ("tetra", "triangle"):
            return "structured_tet"
    if box and whole_mesh and space.degree == 2 and mesh.cell_type in ("hex", "quad"):
        return "lattice"
    if engine == "windowed" or (
        engine == "auto"
        and mesh.num_cells >= WINDOWED_MIN_CELLS
        and mesh.cell_type != "interval"
    ):
        return "windowed"
    return "gather"


def build_packed_problem(
    space, laws, q_degree: int, *, device="cuda", dtype: torch.dtype, engine: str = "auto"
):
    """Geometry and zero initial state for one law, or several on cell subsets.

    ``laws``: a model (on every cell) or a list of ``(model, cells)``. On a
    box every law gets a masked view of ONE shared structured geometry
    (``restrict_structured_geometry``, ``restrict_structured_tet_geometry``),
    so all laws run on the same grid-major vectors. On the windowed engine
    every law gets a WindowedGeometry of its own cells on ONE whole-mesh RCM
    order, computed once, so all laws share the internal layout (``M_pad``,
    ``vs``); on the gather engine a PackedGeometry of its cells.

    ``engine``: "auto" takes the structured engine on a box of hexes or
    quads, the structured-tet engine on a Kuhn box of tets or triangles, the
    lattice engine for one degree-2 law on a whole box of hexes or quads, the
    windowed engine on a general mesh of at least ``WINDOWED_MIN_CELLS``
    cells (not intervals) and the gather engine on every other mesh;
    "windowed" or "gather" force that engine on a general mesh of any size
    (``resolve_engine``). Box meshes keep their structured engine.

    History entries with a ``(rows, cols)`` shape are stored flattened,
    ``[rows * cols, *qp]``. Returns ``(geos, models, state0)``, one entry per
    law; on the windowed engine ``state0.u`` is in the internal layout.
    """
    if isinstance(laws, IncrSmallStrainModel):
        laws = [(laws, np.arange(space.mesh.num_cells))]
    if not laws:
        msg = "build_packed_problem needs at least one law"
        raise ValueError(msg)
    mesh = space.mesh
    kind = resolve_engine(space, engine, whole_mesh=len(laws) == 1
                          and len(laws[0][1]) == mesh.num_cells)
    models = tuple(m for m, _ in laws)
    constraint = models[0].constraint
    opts = dict(device=device, dtype=dtype)

    def whole(cells) -> bool:
        return len(cells) == mesh.num_cells

    if kind in ("structured", "structured_tet"):
        if kind == "structured":
            build, restrict = build_structured_geometry, restrict_structured_geometry
        else:
            build, restrict = build_structured_tet_geometry, restrict_structured_tet_geometry
        full = build(space, q_degree, constraint, **opts)
        geos = tuple(full if whole(cells) else restrict(full, cells) for _, cells in laws)
    elif kind == "lattice":
        geos = (build_lattice_geometry(space, q_degree, constraint, **opts),)
    elif kind == "gather":
        geos = tuple(
            build_packed_geometry(space, q_degree, constraint,
                                  None if whole(cells) else np.asarray(cells, np.int64), **opts)
            for _, cells in laws
        )
    else:
        # one whole-mesh RCM order for every law's plan
        t0 = time.perf_counter()
        perm = reverse_cuthill_mckee(space.cell_dof_nodes, space.n_dof_nodes)
        rcm_s = time.perf_counter() - t0
        geos = tuple(
            build_windowed_geometry(
                space, q_degree, constraint,
                None if whole(cells) else np.asarray(cells, np.int64),
                perm=perm, **opts,
            )
            for _, cells in laws
        )
        for g in geos:  # each plan's build seconds name the shared order's
            g.build_seconds["rcm"] = rcm_s
    for g, (_, cells) in zip(geos, laws):
        # what parallel.shard_packed_state rebuilds a rank's part of the law from
        g.law_source = (space, q_degree, np.asarray(cells, np.int64))
    sdim = constraint.stress_strain_dim

    def zeros(geo, k):
        return torch.zeros(geo.qp_shape(k), dtype=dtype, device=device)

    histories = tuple(
        None if m.history_dim is None
        else {k: zeros(g, flat_history_dim(d)) for k, d in m.history_dim.items()}
        for m, g in zip(models, geos)
    )
    geo = geos[0]
    n_u = geo.ndofs_int if isinstance(geo, WindowedGeometry) else space.ndofs
    state = PackedState(
        u=torch.zeros(n_u, dtype=dtype, device=device),
        stress=tuple(zeros(g, sdim) for g in geos),
        histories=histories,
        t=torch.zeros((), dtype=dtype, device=device),
    )
    return geos, models, state


def _require_cuda(geo) -> None:
    if geo.device.type != "cuda":
        msg = (
            "matvec_impl/eval_impl='kernel' launch CUDA kernels; the geometry "
            f"lives on {geo.device}. Use 'plain' off the card."
        )
        raise ValueError(msg)


def require_factored(model) -> None:
    """Raise unless the law declares a factored tangent (``factored_tangent``),
    the only kind the CUDA operator applies."""
    if not model.factored_tangent:
        msg = (
            "matvec_impl='kernel' applies a factored (IsotropicTangent) tangent; "
            f"{type(model).__name__} returns a DenseTangent on the engines: use "
            "'plain' or 'auto'"
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

    ``geos``: one geometry per law, as ``build_packed_problem`` returns them:
    StructuredGeometry (or StructuredTetGeometry) views of one grid, one
    LatticeGeometry (grid-major, like the structured engines),
    WindowedGeometry plans of cell subsets on one shared node order, or
    PackedGeometry (gather engine) geometries of one space (one or several
    laws each way).
    Several laws run per-law strain -> evaluate -> residual sweeps, summed,
    and per-law operator and Jacobi-diagonal sums. A law's tangent is an
    IsotropicTangent (the hot laws' SoA twins) or a DenseTangent (the
    generic adapter); the plain operators take either.
    ``preconditioner``: optional callable M^-1 on the engine's working
    vectors (structured: grid-major, a MultigridPreconditioner or its
    ``bpx``; windowed: internal, e.g. ``WindowedAmgPreconditioner.
    wrap_internal``; gather: node-major, e.g. an ``AmgPreconditioner``);
    None = Jacobi (the per-law diagonals summed).
    ``matvec_impl``: "plain" (StructuredGeometry.matvec_gm) or "kernel" (the
    CUDA operator of ops/cuda_matvec.py; the geometry must be on a CUDA
    device; the law must declare a factored tangent, or the step raises
    ValueError). ``eval_impl``: "plain" (strain ->
    model.evaluate_packed -> residual) or "kernel" (the fused VonMises3D
    kernel of ops/cuda_eval.py, CUDA only). Both kernels serve one law on the
    structured hex engine; the windowed engine takes "plain" and launches
    its own kernels (gather, scatter, BSR SpMV, and K7 for the cells of an
    IsotropicTangent) whenever its tensors are on a CUDA device; the
    lattice engine takes "plain" and, as the windowed engine launches K7,
    launches K8 (``ops/cuda_lattice.py``) for its operator on CUDA tensors
    where ``lattice_apply_form`` holds (an IsotropicTangent on 27-node
    hexes); the gather engine takes "plain" (plain PyTorch gathers and
    gather-sums, as in the JAX package).
    ``cg_flexible``/``cg_reduce_dtype``/``cg_fixed_iters``: see
    solver.linear.cg_solve.

    On the windowed engine ``state.u`` and ``f_ext`` are INTERNAL vectors
    [vs * M_pad] (build_packed_problem initialises the state that way), and
    the new state's ``u`` stays internal.

    ``stats``: newton_iters, r_norm (free-dof residual norm at the end),
    r0_norm (at the start) and cg_iters_last, as tensors.
    """
    for name, impl in (("matvec_impl", matvec_impl), ("eval_impl", eval_impl)):
        if impl not in ("plain", "kernel"):
            msg = f"{name} must be 'plain' or 'kernel', got {impl!r}"
            raise ValueError(msg)
    geo = geos[0] if geos else None
    # by the engine each geometry serves, so that the wrappers of a sharded
    # problem (parallel/sharding.py) run here as they are
    engines = {g.engine for g in geos}
    windowed = engines == {"windowed"} and len({(g.ndofs_int, g.vs) for g in geos}) == 1
    lattice = len(geos) == 1 and engines == {"lattice"}
    structured = lattice or (
        engines <= {"structured", "structured_tet"} and len({(g.M, g.vs) for g in geos}) == 1
    )
    gather = engines == {"gather"} and len({(g.ndofs, g.vs) for g in geos}) == 1
    if not geos or not (structured or windowed or gather):
        msg = (
            "make_packed_step supports StructuredGeometry views of one grid, one "
            "LatticeGeometry, WindowedGeometry plans on one shared node order (the "
            "same (M_pad, vs)) or PackedGeometry geometries of one space; build "
            "several laws through build_packed_problem"
        )
        raise ValueError(msg)
    if "kernel" in (matvec_impl, eval_impl):
        if windowed or gather or lattice:
            msg = (
                "matvec_impl/eval_impl='kernel' are the structured hex engine's kernels; "
                "the windowed engine launches its own kernels on CUDA tensors, and "
                "the gather and lattice engines run 'plain'"
            )
            raise ValueError(msg)
        if len(geos) > 1:
            msg = "matvec_impl/eval_impl='kernel' take one law; several laws run 'plain'"
            raise ValueError(msg)
        if getattr(geo, "sharded", False):
            msg = "matvec_impl/eval_impl='kernel' take a whole box; a sharded geometry runs 'plain'"
            raise ValueError(msg)
        _require_cuda(geo)

    if windowed or gather:
        # the windowed engine's internal layout, or the gather engine's
        # node-major one, throughout: no conversion at the step boundary
        def to_work(u):
            return u

        from_work = to_work

        def boundary(bc_dofs):
            if windowed:
                return geo.bc_internal(bc_dofs), geo.free_internal(bc_dofs)
            free = torch.ones(geo.ndofs, dtype=torch.bool, device=geo.device)
            free[bc_dofs] = False
            return bc_dofs, free

        ops = [(g.strain, g.residual, g.matvec, g.jacobi_diag) for g in geos]
    else:
        M, vs, ndofs = geo.M, geo.vs, geo.ndofs
        to_work, from_work = geo.to_grid_major, geo.to_node_major

        def boundary(bc_dofs):
            bc_gm = (bc_dofs % vs) * M + bc_dofs // vs
            free_gm = torch.ones(ndofs, dtype=torch.bool, device=geo.device)
            free_gm[bc_gm] = False
            return bc_gm, free_gm

        ops = [(g.strain_gm, g.residual_gm, g.matvec_gm, g.jacobi_diag_gm) for g in geos]

    cg_opts = dict(
        flexible=cg_flexible, reduce_dtype=cg_reduce_dtype, fixed_iters=cg_fixed_iters
    )

    kernel_mv = None
    if matvec_impl == "kernel":
        from ..ops.cuda_matvec import build_cuda_matvec

        kernel_mv = build_cuda_matvec(geo)

    kernel_evals: dict = {}

    def eval_kernel(model, du, stress, history):
        from ..ops.cuda_eval import build_cuda_eval

        if id(model) not in kernel_evals:
            kernel_evals[id(model)] = (model, build_cuda_eval(geo, model))
        fused = kernel_evals[id(model)][1]
        r, s_new, (beta, gmm, nf), h_new = fused(du, stress, history)
        tg = IsotropicTangent(kappa=model.params["p_ka"], beta=beta, gamma=gmm, n=nf)
        return r, s_new, tg, h_new

    def eval_assemble(models, u_w, u_prev_w, stresses, hists, t, f_ext_w, dt):
        """Per-law strain -> evaluate -> residual, summed with -f_ext (the
        scope ``newton.assemble``; each law's update is ``law.eval``)."""
        with scope("newton.assemble"):
            du = u_w - u_prev_w
            r, ss, tgs, hh = None, [], [], []
            for model, (strain, residual, _, _), sig0, h0 in zip(models, ops, stresses, hists):
                if eval_impl == "kernel":
                    with scope("law.eval"):
                        rl, s_new, tg, h_new = eval_kernel(model, du, sig0, h0)
                else:
                    eps = strain(du)
                    with scope("law.eval"):
                        s_new, tg, h_new = model.evaluate_packed(t, dt, eps, sig0, h0)
                    rl = residual(s_new)
                r = rl if r is None else r + rl
                ss.append(s_new)
                tgs.append(tg)
                hh.append(h_new)
            return r - f_ext_w, tuple(ss), tuple(tgs), tuple(hh)

    def solve(tgs, r_w, free):
        zero = r_w.new_zeros(())
        r_w = torch.where(free, r_w, zero)

        def apply_op(v):
            if kernel_mv is not None:
                return kernel_mv(v, tgs[0])
            out = None
            for (_, _, operator, _), tg in zip(ops, tgs):
                mv = operator(v, tg)
                out = mv if out is None else out + mv
            return out

        def matvec(v):
            vm = torch.where(free, v, zero)
            return torch.where(free, apply_op(vm), v)

        if preconditioner is not None:
            def precond(rr):
                z = preconditioner(torch.where(free, rr, zero))
                return torch.where(free, z, rr)

            return linear.cg_solve(
                matvec, r_w, rtol=cg_rtol, maxiter=cg_maxiter, precond=precond,
                **cg_opts,
            )
        diag = None
        for (_, _, _, jacobi_diag), tg in zip(ops, tgs):
            d = jacobi_diag(tg)
            diag = d if diag is None else diag + d
        diag = torch.where(free, diag, r_w.new_ones(()))
        return linear.cg_solve(
            matvec, r_w, diag, rtol=cg_rtol, maxiter=cg_maxiter, **cg_opts
        )

    def prepare(bc_dofs):
        """The step's boundary from the Dirichlet dofs: (dofs in the
        working layout, free mask). Built outside a captured step, once per
        Dirichlet set (``solver/compiled.py``)."""
        return boundary(torch.as_tensor(bc_dofs, dtype=torch.int64, device=geo.device))

    def run(models, state: PackedState, bnd, bc_vals: torch.Tensor, f_ext, dt):
        """The step on a prepared boundary and a ``bc_vals`` tensor of the
        state's dtype and device: what a CUDA graph captures."""
        bc_w, free = bnd
        u_prev_w = to_work(state.u)
        f_ext_w = to_work(f_ext)
        u = u_prev_w.clone()
        u[bc_w] = bc_vals

        def fnorm(r):
            return torch.linalg.vector_norm(torch.where(free, r, r.new_zeros(())))

        def evaluate(u_w):
            return eval_assemble(
                models, u_w, u_prev_w, state.stress, state.histories, state.t, f_ext_w, dt
            )

        if kernel_mv is not None:
            require_factored(models[0])
        r, s, tg, h = evaluate(u)
        r0_norm = fnorm(r)
        thresh = torch.clamp(newton_rtol * r0_norm, min=newton_atol)

        # JAX's lax.while_loop over (u, it, r, s, tg, h, cg_k): a device
        # loop under capture, one predicate read a Newton iteration eagerly
        def cond(carry):
            _, it, r, *_ = carry
            return (fnorm(r) > thresh) & (it < max_newton)

        def body(carry):
            u, it, r, s, tg, h, _ = carry
            delta, cg_k = solve(tg, r, free)
            u_new = u - delta
            return (u_new, it + 1, *evaluate(u_new), cg_k)

        zero = torch.zeros((), dtype=torch.int32, device=geo.device)
        # the initial carry is handed over (its fresh tensors become the
        # loop's static buffers); the body also reads the step's inputs
        u, niter, r, s, _, h, cg_k = device_while(
            cond, body, (u, zero, r, s, tg, h, zero.clone()),
            reads=(state, u_prev_w, f_ext_w), name="newton.iter")
        new_state = PackedState(u=from_work(u), stress=s, histories=h, t=state.t + dt)
        stats = {
            "newton_iters": niter,
            "r_norm": fnorm(r),
            "r0_norm": r0_norm,
            "cg_iters_last": cg_k,
        }
        return new_state, stats

    def step(models, state: PackedState, bc_dofs, bc_vals, f_ext, dt):
        vals = torch.as_tensor(bc_vals, dtype=state.u.dtype, device=state.u.device)
        return run(models, state, prepare(bc_dofs), vals, f_ext, dt)

    syncs = []
    if any(getattr(g, "sharded", False) for g in geos):
        syncs.append("a sharded geometry all-reduces through the host (gloo)")
    step.prepare, step.run, step.device = prepare, run, geo.device
    #: why the step cannot be captured in a CUDA graph (empty: it can)
    step.host_syncs = tuple(syncs)
    return step
