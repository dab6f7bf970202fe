"""PackedSimulation: the user-facing time stepper.

Mutable BC values and external load, ``solve() -> (niter, converged)`` per
load step (with optional adaptive substepping), ``solve_schedule`` for a
whole load path, checkpoints of the committed state and observation
properties; each step runs ``make_packed_step``. On a box of hexes it runs
the structured engine with an optional multigrid, BPX or AMG preconditioner
and, on a CUDA device, the fused CUDA kernels; on a Kuhn box of tets the
structured-tet engine with the same preconditioners; on a general (imported)
mesh the windowed engine with the smoothed-aggregation AMG, or, under 4096
cells and on interval bars, the gather engine. Each takes one law or several
on cell subsets.

Example::

    laws = [(LinearElasticityModel({"E": 150e3, "nu": 0.3}, Constraint.FULL), soft),
            (VonMises3D(mat), hard)]
    sim = PackedSimulation(laws, V, bcs, 2, preconditioner="vcycle",
                           mg_options={"fused_smoothing": True},
                           device="cuda", dtype=torch.float64)
    for disp in np.linspace(0.0004, 0.004, 10):
        bc_move.value = disp
        niter, converged = sim.solve()
    sigma = sim.stress  # [C, Q, s] numpy, mesh cell order
    save_checkpoint("state.npz", sim.state_dict())
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.bcs import combine_bcs
from ..models.interfaces import IncrSmallStrainModel
from ..ops.cuda_matvec import build_cuda_matvec, hot_path_geometry
from ..ops.structured import build_structured_geometry, build_structured_tet_geometry
from ..ops.windowed import WindowedGeometry
from ..utils.checkpoint import restore_like
from ..utils.timers import timed, timing
from .amg import build_amg
from .compiled import compile_step
from .multigrid import build_multigrid, build_p2_node_preconditioner, refined_p1_geometry
from .packed_step import (
    PackedState,
    build_packed_problem,
    make_packed_step,
    require_factored,
)

__all__ = ["PackedSimulation"]


class PackedSimulation:
    """Time stepper on a box mesh (structured or structured-tet engine) or a
    general mesh (windowed or gather engine; ``engine`` says which it
    resolved to).

    Args:
        laws: a model, or a list of ``(model, cells)``: on a box mesh every
            law is a masked view of one grid, on a windowed mesh a plan of
            its cells on one shared RCM order, on the gather engine a
            geometry of its cells; the preconditioner is one whole-mesh
            hierarchy with the first law's moduli.
        space: displacement FunctionSpace.
        bcs: Dirichlet BCs (values may be mutated between steps).
        q_degree: quadrature degree.
        del_t: time increment (mutable attribute).
        preconditioner: "auto" (default), None (Jacobi), "vcycle" or "bpx"
            (the geometric hierarchy of solver/multigrid.py; box meshes
            only, below a tet fine level on a Kuhn box) or "amg" (the
            smoothed-aggregation hierarchy of solver/amg.py: windowed levels
            on the windowed engine and, on a CUDA device, on the others;
            ELL levels on the others off the card; applied grid-major on a
            box). "auto" resolves to "amg" on the windowed engine and to
            None elsewhere. Elastic moduli come from
            ``elastic_moduli`` or the (first) law's parameters.
        matvec_impl: "plain", "kernel" or "auto": the CUDA operator on a
            CUDA device for one law that declares a factored tangent
            (``factored_tangent``: an IsotropicTangent) on the 3D hex hot
            path, the plain one elsewhere (a DenseTangent law, e.g.
            Drucker-Prager or a non-FULL law, takes "plain"; "kernel" raises
            for it). With the kernel, the V-cycle's fine level applies it
            too, unless ``mg_options["fused_smoothing"]`` is set: then every
            level smooths with the K3 chains and the CG operator alone
            follows ``matvec_impl``.
        eval_impl: "plain" or "kernel" (the fused VonMises3D kernel, CUDA,
            one law).
        engine: "auto", "windowed" or "gather", the general-mesh engine
            choice of ``build_packed_problem`` (box meshes keep their
            structured engine).
        max_subdivisions: retry a failed load step as 2, 4, ..., 2^k
            substeps with BC values, external load and dt interpolated from
            the committed state (0 = off).
        f_ext: optional [ndofs] node-major external (Neumann) load vector,
            e.g. from ``fem.assemble_facet_traction``; the ``f_ext``
            attribute may be reassigned between steps.
        device, dtype: where and in what type the state lives; the card
            ("cuda") unless the caller asks for the CPU.
        newton/cg options are forwarded to make_packed_step. By default a
            float32 state uses flexible CG with float64 dot products.
        mg_options: keyword overrides for build_multigrid or build_amg.
    """

    def __init__(
        self,
        laws,
        space,
        bcs,
        q_degree: int,
        del_t: float = 1.0,
        *,
        device="cuda",
        dtype: torch.dtype,
        preconditioner: str | None = "auto",
        matvec_impl: str = "auto",
        eval_impl: str = "plain",
        elastic_moduli: tuple[float, float] | None = None,
        newton_rtol: float = 1e-8,
        newton_atol: float = 1e-8,
        max_newton: int = 25,
        cg_rtol: float = 1e-6,
        cg_maxiter: int = 1000,
        cg_flexible: bool | None = None,
        cg_reduce_dtype: torch.dtype | None = None,
        cg_fixed_iters: int | None = None,
        max_subdivisions: int = 0,
        mg_options: dict | None = None,
        f_ext=None,
        engine: str = "auto",
    ):
        self.space = space
        self.bcs = bcs
        self.del_t = del_t
        self.device = torch.device(device)
        if isinstance(laws, IncrSmallStrainModel):
            self._law_cells = (np.arange(space.mesh.num_cells),)
        else:
            self._law_cells = tuple(np.asarray(c, np.int64) for _, c in laws)
        geos, models, state = build_packed_problem(
            space, laws, q_degree, device=self.device, dtype=dtype, engine=engine
        )
        self._geos, self._models = geos, models
        self.state: PackedState = state
        geo = geos[0]
        #: the engine the mesh resolved to: "structured", "structured_tet",
        #: "lattice", "windowed" or "gather"
        self.engine = geo.engine
        windowed = self.engine == "windowed"
        box = self.engine in ("structured", "structured_tet", "lattice")
        # one degree-2 law on a cell subset of a box of hexes or quads (the
        # windowed or gather engine): the refined-P1 hierarchy on node-major
        # vectors (build_p2_node_preconditioner)
        mesh = space.mesh
        p2_subset = (
            not box and len(geos) == 1 and space.degree == 2
            and mesh.structured_shape is not None and mesh.cell_type in ("hex", "quad")
        )
        zeros = torch.zeros(space.ndofs, dtype=dtype, device=self.device)
        #: external load, node-major [ndofs] (reassign between steps)
        self.f_ext = zeros if f_ext is None else torch.as_tensor(
            f_ext, dtype=dtype, device=self.device
        )
        # the load of the committed state, where a substepped retry ramps
        # from: zero until a step commits, whatever the constructor's f_ext
        self._f_ext_committed = zeros

        if preconditioner == "auto":
            preconditioner = "amg" if windowed else None
        allowed = (None, "vcycle", "bpx", "amg") if box or p2_subset else (None, "amg")
        if preconditioner not in allowed:
            msg = (
                f"preconditioner {preconditioner!r} on the {self.engine} engine; "
                f"choose one of {allowed} or 'auto'"
            )
            raise ValueError(msg)
        #: the preconditioner the options resolved to (None = Jacobi)
        self.preconditioner = preconditioner
        if matvec_impl == "auto":
            on_card = self.device.type == "cuda"
            single = len(geos) == 1 and box
            matvec_impl = "kernel" if (
                on_card and single and hot_path_geometry(geo) and models[0].factored_tangent
            ) else "plain"
        elif matvec_impl == "kernel" and box:
            require_factored(models[0])

        pc = mg = None
        if preconditioner is not None:
            mu, kappa = (
                elastic_moduli if elastic_moduli is not None else _estimate_moduli(models[0])
            )
            bc_dofs, _ = combine_bcs(bcs)
            free = torch.ones(space.ndofs, dtype=torch.bool)
            free[torch.as_tensor(bc_dofs, dtype=torch.int64)] = False
            opts = dict(mg_options or {})
            if preconditioner == "amg" and windowed:
                # frozen on the engine's own RCM order, so the V-cycle
                # consumes the step's internal vectors directly
                mg = build_amg(
                    space, mu, kappa, free.numpy(), q_degree=q_degree, spmv="windowed",
                    node_perm=geo.ex.perm, device=self.device, dtype=dtype, **opts,
                )
                pc = mg.wrap_internal(geo.ex.M_pad)
            elif preconditioner == "amg":
                # node-major vectors (grid-major on a box). On the card K6
                # applies the windowed levels, exact in float32 as ELL is
                # (chip_smoke.py phase 17 times both formats of one
                # hierarchy); off the card the windowed format's path is
                # K6's plain twin, a padded take, and the ELL row sum the
                # plain SpMV
                spmv = "windowed" if self.device.type == "cuda" else "ell"
                mg = build_amg(space, mu, kappa, free.numpy(), q_degree=q_degree, spmv=spmv,
                               device=self.device, dtype=dtype, **{"select_passes": 3, **opts})
                pc = (lambda r: geo.to_grid_major(mg(geo.to_node_major(r)))) if box else mg
            else:
                if preconditioner == "vcycle":
                    # V(3,3) with lighter coarse smoothing and a direct
                    # coarsest solve: the configuration of the benchmark
                    opts = {"nu": 3, "nu_coarse": 2, "coarse_direct": True, **opts}
                if p2_subset:
                    # node-major vectors, permuted onto the refined P1 grid
                    p2pc = build_p2_node_preconditioner(
                        space, mu, kappa, free, device=self.device, dtype=dtype,
                        use_bpx=preconditioner == "bpx", **opts,
                    )
                    pc = (lambda r: geo.to_internal(p2pc(geo.from_internal(r)))) if windowed \
                        else p2pc
                else:
                    if self.engine == "lattice":
                        # the refined-P1 hierarchy on the same dof lattice: the
                        # grid-major vectors coincide, no permutation
                        geo_mg, _ = refined_p1_geometry(space, geo.constraint,
                                                        device=self.device, dtype=dtype)
                    elif len(geos) == 1:
                        geo_mg = geo
                    else:
                        # several laws: one whole-grid hierarchy (an elastic
                        # surrogate either way)
                        build = (build_structured_geometry if self.engine == "structured"
                                 else build_structured_tet_geometry)
                        geo_mg = build(space, q_degree, geo.constraint, device=self.device,
                                       dtype=dtype)
                    # the K3 chains replace the fine apply
                    fine_mv = None
                    if matvec_impl == "kernel" and not opts.get("fused_smoothing", False):
                        fine_mv = build_cuda_matvec(geo)
                    mg = build_multigrid(
                        geo_mg, mu, kappa, free, device=self.device, dtype=dtype,
                        fine_matvec=fine_mv, **opts,
                    )
                    pc = {"bpx": mg.bpx, "vcycle": mg}[preconditioner]
        self._mg = mg

        if cg_flexible is None:
            cg_flexible = dtype == torch.float32
        if cg_reduce_dtype is None and dtype == torch.float32:
            cg_reduce_dtype = torch.float64

        self._newton_rtol = newton_rtol
        self._newton_atol = newton_atol
        self._max_subdivisions = max_subdivisions
        # the counterpart of the JAX package's jax.jit(step): on the card the
        # step, its loops included, is captured in a CUDA graph and replayed
        self._step = compile_step(make_packed_step(
            geos,
            newton_rtol=newton_rtol,
            newton_atol=newton_atol,
            max_newton=max_newton,
            cg_rtol=cg_rtol,
            cg_maxiter=cg_maxiter,
            preconditioner=pc,
            matvec_impl=matvec_impl,
            cg_flexible=cg_flexible,
            cg_reduce_dtype=cg_reduce_dtype,
            cg_fixed_iters=cg_fixed_iters,
            eval_impl=eval_impl,
        ), models=models)
        #: True when each step replays one captured CUDA graph (its Newton,
        #: CG and local Newton loops as graph while nodes); False when it runs
        #: eagerly: off the card, or where the step reads values back to the
        #: host (``host_syncs``: a sharded geometry, a law with a ``host_sync``)
        self.captured = self._step.captured
        #: why the step is not captured (empty when it is, or could be)
        self.host_syncs = self._step.host_syncs
        self.last_stats: dict | None = None

    # -- stepping -------------------------------------------------------------------

    def _load(self, f) -> torch.Tensor:
        """A node-major load as a tensor of the state's dtype and device."""
        return torch.as_tensor(f, dtype=self.state.u.dtype, device=self.device)

    def _to_engine(self, f: torch.Tensor) -> torch.Tensor:
        """Node-major load -> the step's layout (internal on the windowed engine)."""
        geo = self._geos[0]
        return geo.to_internal(f) if isinstance(geo, WindowedGeometry) else f

    def _converged(self, r_norm, r0_norm):
        return r_norm <= np.maximum(self._newton_atol, self._newton_rtol * r0_norm)

    def _dirichlet(self) -> tuple[np.ndarray, np.ndarray]:
        """The Dirichlet dofs and values of ``bcs`` on the host
        (``combine_bcs``); the compiled step uploads the dofs once per capture."""
        return combine_bcs(self.bcs)

    def _inputs(self, bc_vals, f_ext) -> tuple[torch.Tensor, torch.Tensor]:
        """The step's BC values (a tensor of the state's dtype and device)
        and its external load (in the engine's layout)."""
        vals = torch.as_tensor(bc_vals, dtype=self.state.u.dtype, device=self.device)
        return vals, self._to_engine(f_ext)

    def _attempt(self, bc_dofs, bc_vals, f_ext, dt) -> tuple[int, bool]:
        """One step from the committed state on ``_inputs``; commits it if it
        converged to a finite state. Returns (niter, ok)."""
        new_state, stats = self._step(self._models, self.state, bc_dofs, bc_vals, f_ext, dt)
        with timing("solve.read_back"):
            self.last_stats = {k: v.item() for k, v in stats.items()}
            self.last_stats["captured"] = self.captured
            r_norm = self.last_stats["r_norm"]
            ok = bool(self._converged(r_norm, self.last_stats["r0_norm"]))
            ok = ok and bool(np.isfinite(r_norm)) and bool(torch.isfinite(new_state.u).all())
            if ok:
                self.state = new_state
        return int(self.last_stats["newton_iters"]), ok

    @timed("solve")
    def solve(self) -> tuple[int, bool]:
        """One load/time step: solve and commit. Returns (niter, converged).

        Converged means the residual tolerance held and the state is finite;
        an unconverged step leaves the committed state unchanged. With
        ``max_subdivisions > 0`` a failed step is retried as 2, 4, ...,
        2^k substeps whose BC values and external load ramp linearly from
        the committed state's and whose dt is ``del_t / n``; niter is then
        the sum over the substeps.

        Profiler scopes (``utils.timers.timing``): the call is ``solve``;
        the Dirichlet set and the uploads ``solve.inputs``; the read-backs,
        the finiteness check and the commit ``solve.read_back``.
        """
        with timing("solve.inputs"):
            bc_dofs, bc_vals = self._dirichlet()
            f_ext = self._load(self.f_ext)
            inputs = self._inputs(bc_vals, f_ext)
        niter, ok = self._attempt(bc_dofs, *inputs, self.del_t)
        if ok or self._max_subdivisions == 0:
            if ok:
                self._f_ext_committed = f_ext
            return niter, ok

        state0 = self.state
        geo = self._geos[0]
        idx = torch.as_tensor(bc_dofs, dtype=torch.int64, device=self.device)
        if isinstance(geo, WindowedGeometry):
            idx = geo.bc_internal(idx)
        start_vals = state0.u[idx].cpu().numpy().astype(np.float64)
        f_start = self._f_ext_committed
        for level in range(1, self._max_subdivisions + 1):
            n_sub = 2**level
            self.state = state0
            total = 0
            for k in range(1, n_sub + 1):
                frac = k / n_sub
                with timing("solve.inputs"):
                    inputs = self._inputs(start_vals + frac * (bc_vals - start_vals),
                                          f_start + frac * (f_ext - f_start))
                niter, ok = self._attempt(bc_dofs, *inputs, self.del_t / n_sub)
                total += niter
                if not ok:
                    break
            if ok:
                self._f_ext_committed = f_ext
                return total, True
        self.state = state0
        return niter, False

    @timed("solve")
    def solve_schedule(self, bc_values, dts=None, f_ext_scales=None) -> dict:
        """Run a whole load path and commit its final state.

        Args:
            bc_values: [K, n_bc] Dirichlet values per step, in the
                ``combine_bcs(self.bcs)`` dof order, or a callable
                ``f(step_index) -> [n_bc]`` (K is then ``len(dts)``).
            dts: optional [K] time increments (default ``del_t`` each).
            f_ext_scales: optional [K] scalars multiplying ``self.f_ext``, or
                [K, ndofs] per-step load vectors; default ``self.f_ext`` at
                every step.

        Every step starts from the one before, converged or not (no
        substepping; use ``solve()`` for that). No value is read back until
        the last step, so a captured step (``captured``) runs ahead of Python
        for the whole path.

        Returns per-step numpy arrays ``newton_iters``, ``r_norm``,
        ``r0_norm``, ``cg_iters_last`` and ``converged`` (the residual
        tolerance of ``solve()``, and a finite residual).

        Profiler scopes as in ``solve()``: ``solve`` for the call,
        ``solve.read_back`` for the read-backs and the commit.
        """
        if callable(bc_values):
            if dts is None:
                msg = "a callable bc_values needs dts for the number of steps"
                raise ValueError(msg)
            bc_values = np.stack([np.asarray(bc_values(i)) for i in range(len(dts))])
        bc_dofs, _ = self._dirichlet()
        dtype = self.state.u.dtype
        vals = torch.as_tensor(np.asarray(bc_values), dtype=dtype, device=self.device)
        K = vals.shape[0]
        if K == 0:
            return {
                "newton_iters": np.zeros(0, np.int32), "r_norm": np.zeros(0),
                "r0_norm": np.zeros(0), "cg_iters_last": np.zeros(0, np.int32),
                "converged": np.zeros(0, bool),
            }
        dts = [self.del_t] * K if dts is None else [float(d) for d in np.asarray(dts)]
        if len(dts) != K:
            msg = f"{len(dts)} time increments for {K} steps"
            raise ValueError(msg)
        f_base = self._load(self.f_ext)
        if f_ext_scales is None:
            loads = [f_base] * K
        else:
            scales = self._load(np.asarray(f_ext_scales))
            if scales.shape[0] != K or scales.dim() not in (1, 2):
                msg = f"f_ext_scales must be [K] or [K, ndofs] with K={K}, got {tuple(scales.shape)}"
                raise ValueError(msg)
            if scales.dim() == 2 and scales.shape[1] != self.space.ndofs:
                msg = f"f_ext_scales rows have {scales.shape[1]} values, not {self.space.ndofs}"
                raise ValueError(msg)
            loads = [f_base * s if scales.dim() == 1 else s for s in scales]
        st, rows = self.state, []
        for i in range(K):
            st, stats = self._step(
                self._models, st, bc_dofs, vals[i], self._to_engine(loads[i]), dts[i]
            )
            rows.append(stats)
        with timing("solve.read_back"):
            self.state = st
            self._f_ext_committed = loads[-1]
            out = {k: torch.stack([r[k].reshape(()).cpu() for r in rows]).numpy()
                   for k in rows[0]}
            out["converged"] = self._converged(out["r_norm"], out["r0_norm"]) & np.isfinite(
                out["r_norm"]
            )
            self.last_stats = {k: v[-1] for k, v in out.items()}
            self.last_stats["captured"] = self.captured
        return out

    # -- checkpoints ----------------------------------------------------------------
    # The committed PackedState determines the next step. state_dict() is a
    # plain tree for utils.save_checkpoint / load_checkpoint, with an engine
    # marker ("structured", "structured_tet", "windowed" or "gather");
    # restore needs the same engine and mesh (the windowed engine's u is its
    # internal vector and its QP fields are in plan-slot order).

    def state_dict(self) -> dict:
        return {
            "engine": self.engine,
            "u": self.state.u,
            "stress": tuple(self.state.stress),
            "histories": tuple(self.state.histories),
            "t": self.state.t,
        }

    def load_state_dict(self, st: dict) -> None:
        """Restore a ``state_dict`` (or ``load_checkpoint`` of one) against
        this simulation's own state: the tree's structure, every leaf's shape
        and the engine marker must match, or it raises ValueError. A tree
        without a marker (a JAX package checkpoint) is held to the shapes
        alone."""
        marker = st.get("engine")
        if marker is not None and str(np.asarray(marker)) != self.engine:
            msg = f"checkpoint of the {np.asarray(marker)} engine, simulation on {self.engine}"
            raise ValueError(msg)

        cur = self.state
        self.state = PackedState(
            u=restore_like(st["u"], cur.u, "u"),
            stress=restore_like(st["stress"], cur.stress, "stress"),
            histories=restore_like(st["histories"], cur.histories, "histories"),
            t=restore_like(st["t"], cur.t, "t"),
        )

    # -- observation ----------------------------------------------------------------

    @property
    def u(self) -> torch.Tensor:
        """Displacements in the public node-major dof order (the windowed
        engine keeps ``state.u`` internal; this converts on observation)."""
        geo = self._geos[0]
        if isinstance(geo, WindowedGeometry):
            return geo.from_internal(self.state.u)
        return self.state.u

    @property
    def stress(self) -> np.ndarray:
        """Committed Mandel stress in [C, Q, s] order (mesh cell order), every
        law's cells filled from its own field."""
        g0 = self._geos[0]
        out = np.zeros((self.space.mesh.num_cells, g0.n_qp, g0.constraint.stress_strain_dim))
        for geo, cells, s in zip(self._geos, self._law_cells, self.state.stress):
            out[cells] = geo.extract_cells(s).permute(2, 1, 0).cpu().numpy()
        return out

    @property
    def histories(self):
        return self.state.histories

    @property
    def time(self) -> float:
        return float(self.state.t)


def _estimate_moduli(model) -> tuple[float, float]:
    """(mu, kappa) for the multilevel hierarchy from common parameter names."""
    p = getattr(model, "params", {})

    def get(*names):
        for n in names:
            if n in p:
                return float(p[n])
        return None

    mu = get("p_mu", "mu")
    kappa = get("p_ka", "kappa")
    if mu is None or kappa is None:
        E, nu = get("E0", "E"), get("nu")
        if E is not None and nu is not None:
            mu = E / (2 * (1 + nu))
            kappa = E / (3 * (1 - 2 * nu))
    if mu is None or kappa is None:
        msg = "cannot infer elastic moduli; pass elastic_moduli=(mu, kappa)"
        raise ValueError(msg)
    return mu, kappa
