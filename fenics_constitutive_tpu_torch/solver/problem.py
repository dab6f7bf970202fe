"""IncrSmallStrainProblem: the incremental small-strain nonlinear problem, the
reference-parity user entry point.

* Load steps follow the double-buffering of stress and history: ``solve()``
  produces the trial state from the committed one, ``update()`` commits it.
  Every evaluation starts from the committed state, so repeated evaluations
  within a step give the same answer.
* Several laws on cell subsets are per-law cell-index arrays, gathered from
  and scattered into the global ``[C, Q, s]`` stress.
* Dirichlet BCs are lifted on the increment: ``u[dofs]`` is set to the BC
  value before each solve and the Newton correction is zero there.

Two engines run under the same Newton loop: "packed" (the default through
"auto"), the port's SoA engines of ``solver/packed_step.py`` (structured,
structured-tet, lattice, windowed or gather, whichever the mesh resolves
to), and "aos", the reference-parity ``[C, Q, ...]`` layouts assembled by
``fem/assembly.py``. The problem lives on the card unless the caller asks
for the CPU (``device``).

``parallel.shard_problem`` splits a problem's cells over the ranks of a
process group in place (``_shard``): every assembly then ends in one
all-reduce (``_all_reduce``; inside the wrapped geometries on the packed
engine), and every observation gathers the whole problem (``_whole_law``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ..fem.assembly import (
    assemble_jacobi_diag,
    assemble_residual,
    build_cell_dofmap,
    device_geometry,
    grad_at_qp,
    tangent_matvec,
)
from ..fem.bcs import combine_bcs
from ..fem.kinematics import precompute_geometry
from ..models.interfaces import IncrSmallStrainModel
from .linear import cg_solve

__all__ = ["IncrSmallStrainProblem", "SimulationTime"]


@dataclass
class SimulationTime:
    """Current time and time increment of a problem."""

    dt: float
    current: float = 0.0

    def advance(self) -> None:
        self.current += self.dt


def _node_major_ops(geo):
    """(strain, residual, matvec, jacobi_diag) of a packed geometry on
    node-major dof vectors: the structured engines convert to and from
    their grid-major layout, the gather engine works node-major."""
    if hasattr(geo, "matvec_gm"):
        gm, nm = geo.to_grid_major, geo.to_node_major
        return (
            lambda u: geo.strain_gm(gm(u)),
            lambda s: nm(geo.residual_gm(s)),
            lambda v, tg: nm(geo.matvec_gm(gm(v), tg)),
            lambda tg: nm(geo.jacobi_diag_gm(tg)),
        )
    return geo.strain, geo.residual, geo.matvec, geo.jacobi_diag


class IncrSmallStrainProblem:
    """Incremental small-strain problem over a FunctionSpace.

    Args:
        laws: a model (every cell) or a list of ``(model, cells)`` that
            partitions the cells.
        space: the displacement FunctionSpace (value size = geometric dim).
        bcs: Dirichlet BCs (values may be mutated between steps).
        q_degree: quadrature degree.
        del_t: time increment (mutable through ``del_t``/``_del_t``).
        engine: "auto" (= "packed") or "aos". "packed" runs the SoA engines
            of ``solver/packed_step.py`` under this Newton loop; "aos" keeps
            the reference-parity ``[C, Q, ...]`` layouts.
        preconditioner: None (Jacobi on the consistent tangent, the
            reference default), "amg" (the smoothed-aggregation elastic
            hierarchy of ``solver/amg.py``, any mesh, moduli from the first
            law) or a callable M^-1 on node-major dof vectors (one that
            carries ``internal_layout = True`` takes the windowed engine's
            internal vectors instead).
        pc_options: keyword options of ``build_amg``. Without ``spmv`` the
            level format follows the device, as in ``PackedSimulation``:
            the windowed levels (K6) on the card, ELL off it.
        device, dtype: where and in what type the problem lives.
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
        engine: str = "auto",
        preconditioner=None,
        pc_options: dict | None = None,
    ):
        mesh = space.mesh
        if isinstance(laws, IncrSmallStrainModel):
            laws = [(laws, np.arange(mesh.num_cells))]
        constraint = laws[0][0].constraint
        if any(law.constraint != constraint for law, _ in laws):
            msg = "all laws must have the same constraint"
            raise ValueError(msg)
        if space.value_size != constraint.geometric_dim:
            msg = (f"space value_size {space.value_size} != geometric_dim "
                   f"{constraint.geometric_dim} of {constraint}")
            raise ValueError(msg)
        covered = np.concatenate([np.asarray(c) for _, c in laws])
        if len(covered) != mesh.num_cells or len(np.unique(covered)) != mesh.num_cells:
            msg = "the law cell sets must partition the mesh"
            raise ValueError(msg)
        if engine == "auto":
            engine = "packed"
        if engine not in ("packed", "aos"):
            msg = f"engine must be 'auto', 'packed' or 'aos', got {engine!r}"
            raise ValueError(msg)
        if mesh.cell_type in ("hex", "quad") and q_degree < 2:
            warnings.warn(
                "q_degree=1 on hex/quad cells is 1-point reduced integration with "
                "hourglass (zero-energy) modes: the tangent is singular and the "
                "displacements non-unique. Use q_degree>=2 unless reduced "
                "integration is intended.",
                stacklevel=2,
            )
        self.engine = engine
        self.space = space
        self.constraint = constraint
        self.q_degree = q_degree
        self.bcs = bcs
        self.sim_time = SimulationTime(dt=del_t)
        self.device = torch.device(device)
        self.dtype = dtype
        self._models = tuple(law for law, _ in laws)
        self._law_cells = tuple(np.asarray(c, np.int64) for _, c in laws)
        self.ndofs = space.ndofs
        self._law_data_cache = None
        self._dxm = None
        self._shard = None  # parallel.sharding.ProblemShard once sharded

        zeros = torch.zeros(self.ndofs, dtype=dtype, device=self.device)
        self.u = zeros.clone()
        self.u_prev = zeros.clone()
        self.f_ext = zeros.clone()  # external (Neumann) load, node-major
        self._tangents = None
        self.last_stats: dict | None = None

        if engine == "packed":
            from .packed_step import build_packed_problem

            geos, _, pstate = build_packed_problem(
                space, list(zip(self._models, self._law_cells)), q_degree,
                device=self.device, dtype=dtype,
            )
            self._pk_geos = geos
            self._n_qp = int(geos[0].n_qp)
            self._stress_prev = pstate.stress  # committed, per law
            self._histories = pstate.histories
        else:
            self._pk_geos = None
            self._n_qp = int(self._law_data[0][1].n_qp)
            shape = (mesh.num_cells, self._n_qp, constraint.stress_strain_dim)
            self._stress_prev = torch.zeros(shape, dtype=dtype, device=self.device)
            self._histories = tuple(
                model.init_history(len(cells) * self._n_qp, dtype=dtype, device=self.device)
                for model, cells in zip(self._models, self._law_cells)
            )
        self._stress_curr = self._stress_prev  # trial
        self._histories_trial = self._histories
        self._pc = self._build_preconditioner(preconditioner, pc_options)

    def _build_preconditioner(self, preconditioner, pc_options):
        if preconditioner is None or callable(preconditioner):
            return preconditioner
        if preconditioner != "amg":
            msg = f"preconditioner must be None, 'amg' or a callable, got {preconditioner!r}"
            raise ValueError(msg)
        from .amg import build_amg
        from .simulation import _estimate_moduli

        bc_dofs, _ = combine_bcs(self.bcs)
        free = np.ones(self.ndofs, bool)
        free[np.asarray(bc_dofs, np.int64)] = False
        mu, kappa = _estimate_moduli(self._models[0])
        opts = dict(pc_options or {})
        # the level format of PackedSimulation: windowed levels (K6) on the
        # card, exact in float32; ELL off it. On the windowed engine the
        # levels take its own node order and its internal vectors
        opts.setdefault("spmv", "windowed" if self.device.type == "cuda" else "ell")
        geo = self._pk_geos[0] if self._pk_geos is not None else None
        internal = geo is not None and geo.engine == "windowed" and opts["spmv"] == "windowed"
        if opts["spmv"] == "windowed":
            opts.setdefault("select_passes", 3)
            if internal:
                opts.setdefault("node_perm", geo.ex.perm)
        amg = build_amg(self.space, mu, kappa, free, q_degree=self.q_degree,
                        device=self.device, dtype=self.dtype, **opts)
        return amg.wrap_internal(geo.ex.M_pad) if internal else amg

    # -- AoS tabulated data: built on first use, so the packed engine pays for
    #    the [C, Q, n, g] tables only when an observation needs them ----------

    @property
    def _law_data(self):
        """Per law ``(CellDofmap, Geometry of tensors, rows)`` of its cells
        (a sharded problem's: this rank's), ``rows`` their rows of the AoS
        stress (mesh cells in one process, the rank's own rows sharded)."""
        if self._law_data_cache is None:
            dofmap = np.asarray(self.space.dofmap)
            data, start = [], 0
            for law, cells in enumerate(self._law_cells):
                rows = cells
                if self._shard is not None:
                    cells = cells[self._shard.laws[law].mine]
                    rows = np.arange(start, start + len(cells))
                    start += len(cells)
                data.append((
                    build_cell_dofmap(dofmap[cells], self.ndofs, device=self.device),
                    device_geometry(precompute_geometry(self.space, self.q_degree, cells),
                                    dtype=self.dtype, device=self.device),
                    torch.as_tensor(rows, device=self.device),
                ))
            self._law_data_cache = tuple(data)
        return self._law_data_cache

    # -- the sharded problem's two hooks ----------------------------------------------

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """A rank's assembled dof vector summed over the ranks."""
        return x if self._shard is None else self._shard.mesh.all_reduce(x)

    def _whole_law(self, law: int, x: torch.Tensor) -> torch.Tensor:
        """Rows ``[n, ...]`` of this rank's cells of a law -> the whole law's
        rows, in its cell order."""
        return x if self._shard is None else self._shard.laws[law].gather(x)

    @property
    def dxm(self) -> torch.Tensor:
        """Quadrature measure weights, w |det J| [C, Q] in mesh cell order
        (the reference's dxm)."""
        if self._dxm is None:
            w = torch.zeros((self.space.mesh.num_cells, self._n_qp), dtype=self.dtype,
                            device=self.device)
            for law, (_, geo, _) in enumerate(self._law_data):
                w[self._cells_dev(law)] = self._whole_law(law, geo.w_detJ)
            self._dxm = w
        return self._dxm

    def _cells_dev(self, law: int) -> torch.Tensor:
        return torch.as_tensor(self._law_cells[law], device=self.device)

    @property
    def f_ext(self) -> torch.Tensor:
        return self._f_ext

    @f_ext.setter
    def f_ext(self, value) -> None:
        self._f_ext = torch.as_tensor(value, dtype=self.dtype, device=self.device)

    # -- evaluation and assembly -------------------------------------------------

    def _eval_assemble_aos(self, u, t, dt):
        g = self.constraint.geometric_dim
        sdim = self.constraint.stress_strain_dim
        du = u - self.u_prev
        r = None
        stress_new = self._stress_prev.clone()
        tangents, hists = [], []
        for model, (dofmap, geo, cells), hist in zip(self._models, self._law_data,
                                                      self._histories):
            grad = grad_at_qp(du, dofmap, geo)  # [C_l, Q, g, g]
            n_l, Q = grad.shape[0], grad.shape[1]
            s_new, tg, h_new = model.evaluate(
                t, dt, grad.reshape(n_l * Q, g, g),
                self._stress_prev[cells].reshape(n_l * Q, sdim), hist,
            )
            s_blk = s_new.reshape(n_l, Q, sdim)
            stress_new[cells] = s_blk
            rl = assemble_residual(s_blk, dofmap, geo, self.constraint, self.ndofs)
            r = rl if r is None else r + rl
            tangents.append(tg.reshape(n_l, Q, sdim, sdim))
            hists.append(h_new)
        return -self.f_ext + self._all_reduce(r), stress_new, tuple(tangents), tuple(hists)

    def _eval_assemble_packed(self, u, t, dt):
        geos = self._pk_geos
        du = u - self.u_prev
        win = geos[0].engine == "windowed"
        if win:  # the windowed engine's kinematics run on internal vectors
            du = geos[0].to_internal(du)
        r = None
        stresses, tangents, hists = [], [], []
        for model, geo, sig0, h0 in zip(self._models, geos, self._stress_prev, self._histories):
            strain, residual = (geo.strain, geo.residual) if win else _node_major_ops(geo)[:2]
            s_new, tg, h_new = model.evaluate_packed(t, dt, strain(du), sig0, h0)
            rl = residual(s_new)
            r = rl if r is None else r + rl
            stresses.append(s_new)
            tangents.append(tg)
            hists.append(h_new)
        if win:
            r = geos[0].from_internal(r)
        return r - self.f_ext, tuple(stresses), tuple(tangents), tuple(hists)

    # -- linear solves -----------------------------------------------------------

    def _linear_solve_packed(self, tangents, r, free, cg):
        """The packed engine's three routes: grid-major on one structured
        law, the internal layout on the windowed engine, node-major
        otherwise."""
        geos, pc = self._pk_geos, self._pc
        zero = r.new_zeros(())
        if len(geos) == 1 and hasattr(geos[0], "matvec_gm"):
            # the transposes happen once per solve, not twice per CG iteration
            geo, tg = geos[0], tangents[0]
            free_gm = geo.to_grid_major(free)
            r_gm = geo.to_grid_major(torch.where(free, r, zero))

            def matvec(v):
                return torch.where(free_gm, geo.matvec_gm(torch.where(free_gm, v, zero), tg), v)

            if pc is not None:
                def precond(rr):
                    z = pc(geo.to_node_major(torch.where(free_gm, rr, zero)))
                    return torch.where(free_gm, geo.to_grid_major(z), rr)

                delta, k = cg_solve(matvec, r_gm, precond=precond, **cg)
            else:
                diag = torch.where(free_gm, geo.jacobi_diag_gm(tg), r.new_ones(()))
                delta, k = cg_solve(matvec, r_gm, diag, **cg)
            return geo.to_node_major(delta), k

        if geos[0].engine == "windowed":
            # the whole CG loop on internal vectors
            g0 = geos[0]
            fi = g0.to_internal(free.to(r.dtype)) == 1.0  # pads -> False
            b = g0.to_internal(torch.where(free, r, zero))

            def apply(v):
                out = None
                for geo, tg in zip(geos, tangents):
                    mv = geo.matvec(v, tg)
                    out = mv if out is None else out + mv
                return out

            def matvec(v):
                return torch.where(fi, apply(torch.where(fi, v, zero)), v)

            if pc is not None:
                if getattr(pc, "internal_layout", False):
                    def precond(rr):
                        return torch.where(fi, pc(torch.where(fi, rr, zero)), rr)
                else:
                    def precond(rr):
                        z = pc(g0.from_internal(torch.where(fi, rr, zero)))
                        return torch.where(fi, g0.to_internal(z), rr)

                delta, k = cg_solve(matvec, b, precond=precond, **cg)
            else:
                diag = None
                for geo, tg in zip(geos, tangents):
                    d = geo.jacobi_diag(tg)
                    diag = d if diag is None else diag + d
                delta, k = cg_solve(matvec, b, torch.where(fi, diag, r.new_ones(())), **cg)
            return g0.from_internal(delta), k

        ops = [_node_major_ops(geo) for geo in geos]

        def matvec(v):
            vm = torch.where(free, v, zero)
            out = None
            for (_, _, op, _), tg in zip(ops, tangents):
                mv = op(vm, tg)
                out = mv if out is None else out + mv
            return torch.where(free, out, v)

        b = torch.where(free, r, zero)
        if pc is not None:
            def precond(rr):
                return torch.where(free, pc(torch.where(free, rr, zero)), rr)

            return cg_solve(matvec, b, precond=precond, **cg)
        diag = None
        for (_, _, _, jd), tg in zip(ops, tangents):
            d = jd(tg)
            diag = d if diag is None else diag + d
        return cg_solve(matvec, b, torch.where(free, diag, r.new_ones(())), **cg)

    def _linear_solve_aos(self, tangents, r, free, cg):
        zero = r.new_zeros(())
        c, n = self.constraint, self.ndofs

        def matvec(v):
            vm = torch.where(free, v, zero)
            out = None
            for (dofmap, geo, _), tg in zip(self._law_data, tangents):
                mv = tangent_matvec(vm, tg, dofmap, geo, c, n)
                out = mv if out is None else out + mv
            return torch.where(free, self._all_reduce(out), v)

        b = torch.where(free, r, zero)
        if self._pc is not None:
            pc = self._pc

            def precond(rr):
                return torch.where(free, pc(torch.where(free, rr, zero)), rr)

            return cg_solve(matvec, b, precond=precond, **cg)
        diag = None
        for (dofmap, geo, _), tg in zip(self._law_data, tangents):
            d = assemble_jacobi_diag(tg, dofmap, geo, c, n)
            diag = d if diag is None else diag + d
        diag = self._all_reduce(diag)
        return cg_solve(matvec, b, torch.where(free, diag, r.new_ones(())), **cg)

    # -- public API ----------------------------------------------------------------

    def solve(
        self,
        *,
        max_iter: int = 50,
        rtol: float = 1e-12,
        atol: float = 1e-10,
        cg_rtol: float = 1e-14,
        cg_maxiter: int | None = None,
        cg_flexible: bool = False,
    ) -> tuple[int, bool]:
        """Newton solve of the current load/time step; returns
        ``(n_newton_iterations, converged)``.

        Each iteration takes one linear solve and evaluates the full step;
        if that does not lower ||r||, it halves the step (scales 1, 1/2, 1/4
        and 1/8, while the candidate's norm is not below the current one and
        the scale is above 0.2), and if no candidate lowers the residual it
        keeps the full step. The accepted candidate's evaluation is the next
        iteration's residual and tangent. The loop runs on the host and reads
        ||r|| back once per candidate (and the adaptive CG once per CG
        iteration). ``cg_flexible`` switches CG to the Polak-Ribiere beta.
        """
        bc_dofs, bc_vals = combine_bcs(self.bcs)
        bc_idx = torch.as_tensor(np.asarray(bc_dofs, np.int64), device=self.device)
        free = torch.ones(self.ndofs, dtype=torch.bool, device=self.device)
        free[bc_idx] = False
        cg = dict(rtol=cg_rtol, maxiter=cg_maxiter if cg_maxiter is not None else 4 * self.ndofs,
                  flexible=cg_flexible)
        t, dt = float(self.sim_time.current), float(self.sim_time.dt)
        packed = self.engine == "packed"
        evaluate = self._eval_assemble_packed if packed else self._eval_assemble_aos
        linear_solve = self._linear_solve_packed if packed else self._linear_solve_aos

        def fnorm(r):
            return float(torch.linalg.vector_norm(torch.where(free, r, r.new_zeros(()))))

        # the BC lift, once: the Newton correction is zero on constrained dofs
        u = self.u.clone()
        u[bc_idx] = torch.as_tensor(np.asarray(bc_vals), dtype=u.dtype, device=u.device)
        r, stress, tangents, hists = evaluate(u, t, dt)
        r_norm = r0_norm = fnorm(r)
        converged = r_norm <= max(atol, rtol * r0_norm)
        niter = cg_total = 0
        while not converged and niter < max_iter:
            delta, k = linear_solve(tangents, r, free, cg)
            cg_total += int(k)

            def try_at(scale):
                u_try = u - scale * delta
                r_t, s_t, tg_t, h_t = evaluate(u_try, t, dt)
                return u_try, r_t, fnorm(r_t), s_t, tg_t, h_t

            full = cand = try_at(1.0)
            scale = 1.0
            while cand[2] >= r_norm and scale > 0.2:
                scale *= 0.5
                cand = try_at(scale)
            if not cand[2] < r_norm:  # nothing helped: keep the full step
                cand = full
            u, r, r_norm, stress, tangents, hists = cand
            niter += 1
            converged = r_norm <= max(atol, rtol * r0_norm)

        self.u = u
        self._stress_curr = stress
        self._histories_trial = hists
        self._tangents = tangents
        self.last_stats = {"niter": niter, "converged": converged, "r_norm": r_norm,
                           "r0_norm": r0_norm, "cg_iters": cg_total}
        return niter, converged

    def update(self) -> None:
        """Commit displacement, stress and history, and advance time."""
        self.u_prev = self.u
        self._stress_prev = self._stress_curr
        self._histories = self._histories_trial
        self.sim_time.advance()

    # -- packed layout -> reference layout -----------------------------------------

    def _pk_stress_to_cqs(self, stresses: tuple) -> torch.Tensor:
        """Per-law packed stress fields -> [C, Q, s] in mesh cell order."""
        sdim = self.constraint.stress_strain_dim
        out = torch.zeros((self.space.mesh.num_cells, self._n_qp, sdim), dtype=self.dtype,
                          device=self.device)
        for law, (geo, s) in enumerate(zip(self._pk_geos, stresses)):
            out[self._cells_dev(law)] = self._whole_law(law, geo.extract_cells(s).permute(2, 1, 0))
        return out

    def _pk_hist_to_aos(self, law, model, geo, h):
        """Packed history {k: [d, *qp]} -> AoS {k: [N_l, *entry]} in the
        cell-major QP order of the AoS engine."""
        if h is None:
            return None
        hd = model.history_dim
        out = {}
        for k, v in h.items():
            blk = geo.extract_cells(v)  # [d, Q, C_l]
            flat = self._whole_law(law, blk.permute(2, 1, 0)).reshape(-1, blk.shape[0])
            dim = hd[k]
            out[k] = flat if isinstance(dim, int) else flat.reshape(flat.shape[0], *dim)
        return out

    def _aos_whole_stress(self, stress: torch.Tensor) -> torch.Tensor:
        """The AoS stress rows -> [C, Q, s] in mesh cell order."""
        if self._shard is None:
            return stress
        out = stress.new_zeros((self.space.mesh.num_cells, *stress.shape[1:]))
        for law, (_, _, rows) in enumerate(self._law_data):
            out[self._cells_dev(law)] = self._whole_law(law, stress[rows])
        return out

    # -- observation surface ---------------------------------------------------------

    @property
    def stress_0(self) -> torch.Tensor:
        """Committed Mandel stress [C, Q, s]."""
        if self.engine == "packed":
            return self._pk_stress_to_cqs(self._stress_prev)
        return self._aos_whole_stress(self._stress_prev)

    @property
    def stress_1(self) -> torch.Tensor:
        """Trial Mandel stress [C, Q, s] of the step in progress."""
        if self.engine == "packed":
            return self._pk_stress_to_cqs(self._stress_curr)
        return self._aos_whole_stress(self._stress_curr)

    @property
    def _u(self) -> torch.Tensor:
        return self.u

    @property
    def _u0(self) -> torch.Tensor:
        return self.u_prev

    def _aos_histories(self, histories) -> list:
        if self.engine == "packed":
            return [self._pk_hist_to_aos(law, m, g, h)
                    for law, (m, g, h) in enumerate(zip(self._models, self._pk_geos, histories))]
        if self._shard is None:
            return list(histories)
        Q = self._n_qp

        def whole(law, v):
            blk = v.reshape(-1, Q, *v.shape[1:])
            return self._whole_law(law, blk).reshape(-1, *v.shape[1:])

        return [None if h is None else {k: whole(law, v) for k, v in h.items()}
                for law, h in enumerate(histories)]

    @property
    def _history_0(self) -> list:
        return self._aos_histories(self._histories)

    @property
    def _history_1(self) -> list:
        return self._aos_histories(self._histories_trial)

    @property
    def _time(self) -> float:
        return self.sim_time.current

    @_time.setter
    def _time(self, value: float) -> None:
        self.sim_time.current = value

    @property
    def del_t(self) -> float:
        return self.sim_time.dt

    @del_t.setter
    def del_t(self, value: float) -> None:
        self.sim_time.dt = value

    _del_t = del_t  # the reference's name

    @property
    def _del_grad_u(self) -> list:
        """Per-law gradients of the displacement increment at the QPs,
        [C_l, Q, g, g] each. The windowed engine has no gradient of its own
        and reads them from the AoS tables."""
        du = self.u - self.u_prev
        geos = self._pk_geos
        if geos is None or geos[0].engine == "windowed":
            return [self._whole_law(law, grad_at_qp(du, dofmap, geo))
                    for law, (dofmap, geo, _) in enumerate(self._law_data)]
        g, vs = self.constraint.geometric_dim, self.space.value_size
        out = []
        for law, geo in enumerate(geos):
            # a sharded geometry observes through its rank-local part
            loc = getattr(geo, "local", geo)
            grad = loc.grad(geo.local_nodes(du) if loc is not geo else du)  # [g, vs, N]
            if hasattr(loc, "cell_index"):  # a cell-at-origin layout
                grad = loc.extract_cells(grad.reshape(g * vs, loc.qp_layout, loc.M))
            grad = grad.reshape(g, vs, self._n_qp, -1)
            out.append(self._whole_law(law, grad.permute(3, 2, 0, 1)))
        return out
