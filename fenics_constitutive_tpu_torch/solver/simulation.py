"""PackedSimulation: the user-facing time stepper.

Mutable BC values, ``solve() -> (niter, converged)`` per load step, and
observation properties; each step runs ``make_packed_step``. On a box of
hexes it runs the structured engine with an optional multigrid or BPX
preconditioner and, on a CUDA device, the fused CUDA operator; on a general
(imported) mesh the windowed engine with the smoothed-aggregation AMG.

Example::

    mesh = read_gmsh("part.msh")
    V = FunctionSpace(mesh, 1, 3)
    sim = PackedSimulation(law, V, bcs, 2, device="cuda", dtype=torch.float32)
    for disp in np.linspace(0.0005, 0.05, 100):
        bc_move.value = disp
        niter, converged = sim.solve()
    sigma = sim.stress  # [C, Q, s] numpy, mesh cell order
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.bcs import combine_bcs
from ..ops.cuda_matvec import build_cuda_matvec, hot_path_geometry
from ..ops.windowed import WindowedGeometry
from .amg import build_amg
from .multigrid import build_multigrid
from .packed_step import PackedState, build_packed_problem, make_packed_step

__all__ = ["PackedSimulation"]


class PackedSimulation:
    """Time stepper for one law on a box mesh (structured engine) or a
    general mesh (windowed engine).

    Args:
        law: the constitutive model.
        space: displacement FunctionSpace.
        bcs: Dirichlet BCs (values may be mutated between steps).
        q_degree: quadrature degree.
        del_t: time increment (mutable attribute).
        preconditioner: "auto" (default), None (Jacobi), "vcycle" or "bpx"
            (the geometric hierarchy of solver/multigrid.py; box meshes
            only) or "amg" (the smoothed-aggregation hierarchy of
            solver/amg.py; windowed engine only). "auto" resolves to "amg"
            on the windowed engine and to None on the structured engine.
            Elastic moduli come from ``elastic_moduli`` or the law's
            parameters.
        matvec_impl: "plain", "kernel" or "auto": the CUDA operator on a
            CUDA device for the 3D hex hot path, the plain one elsewhere. With
            the kernel, the V-cycle's fine level applies it too.
        eval_impl: "plain" or "kernel" (the fused VonMises3D kernel, CUDA).
        engine: "auto" or "windowed", the general-mesh engine choice of
            ``build_packed_problem`` (box meshes keep the structured engine).
        device, dtype: where and in what type the state lives.
        newton/cg options are forwarded to make_packed_step. By default a
            float32 state uses flexible CG with float64 dot products.
        mg_options: keyword overrides for build_multigrid or build_amg.
    """

    def __init__(
        self,
        law,
        space,
        bcs,
        q_degree: int,
        del_t: float = 1.0,
        *,
        device,
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
        mg_options: dict | None = None,
        engine: str = "auto",
    ):
        self.space = space
        self.bcs = bcs
        self.del_t = del_t
        self.device = torch.device(device)
        geos, models, state = build_packed_problem(
            space, law, q_degree, device=self.device, dtype=dtype, engine=engine
        )
        self._geos, self._models = geos, models
        self.state: PackedState = state
        geo = geos[0]
        windowed = isinstance(geo, WindowedGeometry)
        #: the engine the mesh resolved to: "structured" or "windowed"
        self.engine = "windowed" if windowed else "structured"

        if preconditioner == "auto":
            preconditioner = "amg" if windowed else None
        if preconditioner == "amg" and not windowed:
            msg = (
                "preconditioner='amg' on the structured engine needs the ELL AMG "
                "levels, which are not ported yet (ROADMAP.md Queue 1)"
            )
            raise NotImplementedError(msg)
        allowed = (None, "amg") if windowed else (None, "vcycle", "bpx")
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
            matvec_impl = (
                "kernel" if on_card and not windowed and hot_path_geometry(geo) else "plain"
            )

        pc = mg = None
        if preconditioner is not None:
            mu, kappa = (
                elastic_moduli if elastic_moduli is not None else _estimate_moduli(law)
            )
            bc_dofs, _ = combine_bcs(bcs)
            free = torch.ones(space.ndofs, dtype=torch.bool)
            free[torch.as_tensor(bc_dofs, dtype=torch.int64)] = False
            opts = dict(mg_options or {})
            if preconditioner == "amg":
                # frozen on the engine's own RCM order, so the V-cycle
                # consumes the step's internal vectors directly
                mg = build_amg(
                    space, mu, kappa, free.numpy(), q_degree=q_degree,
                    node_perm=geo.ex.perm, device=self.device, dtype=dtype, **opts,
                )
                pc = mg.wrap_internal(geo.ex.M_pad)
            else:
                if preconditioner == "vcycle":
                    # V(3,3) with lighter coarse smoothing and a direct
                    # coarsest solve: the configuration of the benchmark
                    opts = {"nu": 3, "nu_coarse": 2, "coarse_direct": True, **opts}
                fine_mv = build_cuda_matvec(geo) if matvec_impl == "kernel" else None
                mg = build_multigrid(
                    geo, mu, kappa, free, device=self.device, dtype=dtype,
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
        self._step = make_packed_step(
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
        )
        self.last_stats: dict | None = None

    def solve(self) -> tuple[int, bool]:
        """One load/time step: solve and commit. Returns (niter, converged).

        Converged means the residual tolerance held and the state is finite;
        an unconverged step leaves the committed state unchanged.
        """
        bc_dofs, bc_vals = combine_bcs(self.bcs)
        dtype = self.state.u.dtype
        new_state, stats = self._step(
            self._models,
            self.state,
            torch.as_tensor(bc_dofs, dtype=torch.int64, device=self.device),
            torch.as_tensor(bc_vals, dtype=dtype, device=self.device),
            torch.zeros_like(self.state.u),  # no external load (internal layout if windowed)
            self.del_t,
        )
        self.last_stats = {k: v.item() for k, v in stats.items()}
        niter = int(self.last_stats["newton_iters"])
        r_norm = self.last_stats["r_norm"]
        converged = r_norm <= max(
            self._newton_atol, self._newton_rtol * self.last_stats["r0_norm"]
        )
        finite = bool(np.isfinite(r_norm)) and bool(torch.isfinite(new_state.u).all())
        ok = converged and finite
        if ok:
            self.state = new_state
        return niter, ok

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
        """Committed Mandel stress in [C, Q, s] order (mesh cell order)."""
        geo = self._geos[0]
        return geo.extract_cells(self.state.stress[0]).permute(2, 1, 0).cpu().numpy()

    @property
    def histories(self):
        return self.state.histories


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
