"""Geometric multigrid preconditioner for the structured engine.

A matrix-free V-cycle on the node grid:

  * level operators: the CONSTANT-COEFFICIENT elastic operator per level
    (2 mu P_dev + 3 kappa P_vol), spectrally equivalent to the consistent
    elastoplastic tangent (plastic softening is bounded), which is what a
    preconditioner needs;
  * transfer: trilinear prolongation (weights [1/2, 1, 1/2] per axis) and
    its adjoint R = P^T as restriction, written as strided and shifted
    slices per axis: no convolution, so no cuDNN and no TF32;
  * smoother: damped Jacobi with the level's constant elastic diagonal, or
    Chebyshev on the Jacobi-preconditioned operator (``smoother=
    "chebyshev"``); with ``fused_smoothing`` the whole V-cycle (chains,
    transfers, coarse solve) runs as ops/cuda_smoother.py's FusedVcycle:
    the K3 kernels on a CUDA device, a handful of launches per cycle;
  * Dirichlet dofs are carried to the coarse levels by injection;
  * coarsest level: damped Jacobi sweeps, or a dense inverse
    (``coarse_direct``) rescaled by kappa0/kappa under ``with_moduli``.

Every vector is grid-major ([vs, *node_grid] flattened).

Degree-2 spaces on a box take the same hierarchy on the refined P1 grid:
on a tensor grid the P2 dof nodes are exactly the nodes of the twice
refined P1 grid, and the P1 operator there is spectrally equivalent to the
P2 one (``refined_p1_geometry``; ``build_p2_node_preconditioner`` for
node-major vectors of a P2 space on another engine).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from ..ops.cuda_smoother import coarse_len, prolong_gm, restrict_gm
from ..ops.mandel import Constraint
from ..ops.packed import IsotropicTangent
from ..ops.structured import StructuredGeometry, _matmul

__all__ = [
    "MultigridPreconditioner",
    "build_multigrid",
    "build_p2_node_preconditioner",
    "refined_p1_geometry",
    "space_constraint",
]


class MultigridPreconditioner(nn.Module):
    """V-cycle / BPX preconditioner. Level data are registered buffers:
    ``diag_kappa_<l>``/``diag_beta_<l>`` (the Jacobi diagonal is kappa *
    diag_kappa + 2 mu * diag_beta), ``free_<l>`` (bool free-dof masks) and
    ``coarse_inv`` (or None); the level geometries are submodules.

    ``mu``/``kappa`` are floats or 0-d tensors (``with_moduli``); ``fused``
    holds the per-level K3 chains ({"pre", "post"} or {"coarse"}), baked at
    the build-time moduli, dtype and device, or None; ``fused_cycle`` the
    FusedVcycle over them, which runs every cycle that smooths the
    constant-coefficient operator on level 0.
    """

    def __init__(
        self,
        *,
        geos,
        diag_kappa,
        diag_beta,
        frees,
        mu,
        kappa,
        node_grids,
        omega: float,
        nu: int,
        nu_coarse: int | None,
        coarse_iters: int,
        coarse_inv: torch.Tensor | None,
        fine_matvec=None,
        smoother: str = "jacobi",
        lmax: tuple = (),
        fused: tuple | None = None,
        fused_cycle=None,
    ):
        super().__init__()
        self.geos = nn.ModuleList(geos)
        for lvl, (dk, db, fr) in enumerate(zip(diag_kappa, diag_beta, frees)):
            self.register_buffer(f"diag_kappa_{lvl}", dk)
            self.register_buffer(f"diag_beta_{lvl}", db)
            self.register_buffer(f"free_{lvl}", fr)
        self.register_buffer("coarse_inv", coarse_inv)
        self.mu = mu
        self.kappa = kappa
        #: build-time kappa, the reference of coarse_inv's kappa0/kappa rescale
        self.kappa0 = float(kappa)
        self.node_grids = tuple(node_grids)
        self.vs = geos[0].vs
        self.n_levels = len(geos)
        self.omega = omega
        self.nu = nu
        self.nu_coarse = nu_coarse
        self.coarse_iters = coarse_iters
        #: optional fused fine-level operator apply (e.g. the CUDA matvec),
        #: signature (v_gm, IsotropicTangent) -> r_gm; None = elastic_matvec_gm
        self.fine_matvec = fine_matvec
        #: "jacobi" or "chebyshev" (degree-nu polynomial over [lmax/4, lmax])
        self.smoother = smoother
        #: per-level upper bounds on lambda_max(D^-1 A) from the build
        self.lmax = tuple(lmax)
        self.fused = fused
        self.fused_cycle = fused_cycle

    def with_moduli(self, mu, kappa) -> MultigridPreconditioner:
        """A preconditioner with new moduli (floats or 0-d tensors, never read
        back to the host), sharing the level data. The fused chains are
        dropped: their element matrices are baked at the build-time moduli."""
        new = copy.copy(self)
        new.mu, new.kappa, new.fused, new.fused_cycle = mu, kappa, None, None
        return new

    def free(self, lvl: int) -> torch.Tensor:
        return getattr(self, f"free_{lvl}")

    def _diag(self, lvl: int) -> torch.Tensor:
        return (
            self.kappa * getattr(self, f"diag_kappa_{lvl}")
            + 2.0 * self.mu * getattr(self, f"diag_beta_{lvl}")
        )

    def _tangent(self, dtype, device) -> IsotropicTangent:
        return IsotropicTangent(
            kappa=self.kappa,
            beta=2.0 * self.mu,
            gamma=0.0,
            n=torch.zeros((self.geos[0].sdim, 1, 1), dtype=dtype, device=device),
        )

    # -- transfers ------------------------------------------------------------------

    def restrict(self, x_fine: torch.Tensor, lvl: int) -> torch.Tensor:
        """fine level lvl -> coarse level lvl+1, R = P^T exactly (residuals
        are integrated functionals, so no 1/2^d scaling)."""
        return restrict_gm(x_fine, self.node_grids[lvl])

    def prolong(self, x_coarse: torch.Tensor, lvl: int) -> torch.Tensor:
        """coarse level lvl+1 -> fine level lvl (trilinear interpolation)."""
        return prolong_gm(x_coarse, self.node_grids[lvl + 1], self.node_grids[lvl])

    # -- cycles ---------------------------------------------------------------------

    def vcycle(self, lvl: int, b: torch.Tensor, fine_tangent=None, fine_diag=None):
        """One V-cycle from level ``lvl``. With ``fine_tangent`` (and its
        grid-major Jacobi diagonal ``fine_diag``) level 0 smooths the given
        consistent tangent with damped Jacobi (see ``prepared``). With the
        fused chains every other cycle (and the levels below a true-tangent
        level 0) runs as the FusedVcycle, which masks b itself and reads no
        diagonal of this module."""
        true_tangent = lvl == 0 and fine_tangent is not None
        if self.fused_cycle is not None and not true_tangent:
            return self.fused_cycle(b, lvl)
        geo = self.geos[lvl]
        free = self.free(lvl)
        zero, one = b.new_zeros(()), b.new_ones(())
        if true_tangent:
            diag = torch.where(free, fine_diag, one)
        else:
            diag = torch.where(free, self._diag(lvl).to(b.dtype), one)
        inv_d = self.omega / diag
        b = torch.where(free, b, zero)

        if lvl == 0 and self.fine_matvec is not None:
            tg = fine_tangent if true_tangent else self._tangent(b.dtype, b.device)

            def apply_op(v):
                return self.fine_matvec(v, tg)
        elif true_tangent:
            def apply_op(v):
                return geo.matvec_gm(v, fine_tangent)
        else:
            def apply_op(v):
                return geo.elastic_matvec_gm(v, self.kappa, 2.0 * self.mu)

        def A(v):
            # constrained (identity-row) elastic operator at this level
            vm = torch.where(free, v, zero)
            return torch.where(free, apply_op(vm), v)

        # Chebyshev smooths only the constant-coefficient operator its lmax
        # bound was estimated for; the prepared() true-tangent fine level
        # keeps damped Jacobi
        if self.smoother == "chebyshev" and lvl < self.n_levels - 1 and not true_tangent:
            inv_d_raw = 1.0 / diag
            lmax_s = 1.1 * self.lmax[lvl]
            lmin_s = lmax_s / 4.0
            theta = 0.5 * (lmax_s + lmin_s)
            delta = 0.5 * (lmax_s - lmin_s)
            sigma = theta / delta

            def smooth(x, b_, iters):
                # degree-`iters` Chebyshev on D^-1 A over [lmax/4, lmax];
                # x=None starts from zero (initial residual b_)
                if iters <= 0:
                    return torch.zeros_like(b_) if x is None else x
                rho = 1.0 / sigma
                if x is None:
                    x = torch.zeros_like(b_)
                    r = torch.where(free, b_, zero)
                else:
                    r = torch.where(free, b_ - A(x), zero)
                d = torch.where(free, inv_d_raw * r / theta, zero)
                for _ in range(iters - 1):
                    x = x + d
                    r = r - torch.where(free, A(d), zero)
                    rho_new = 1.0 / (2.0 * sigma - rho)
                    d = (rho_new * rho) * d + torch.where(
                        free, (2.0 * rho_new / delta) * inv_d_raw * r, zero
                    )
                    rho = rho_new
                return x + d
        else:
            def smooth(x, b_, iters):
                # x=None starts from zero: the first sweep is omega D^-1 b
                if iters <= 0:
                    return torch.zeros_like(b_) if x is None else x
                if x is None:
                    x = torch.where(free, inv_d * b_, zero)
                    iters -= 1
                for _ in range(iters):
                    x = x + torch.where(free, inv_d * (b_ - A(x)), zero)
                return x

        if lvl == self.n_levels - 1:
            if self.coarse_inv is not None:
                # the inverse was built at kappa0; a common rescale of the
                # moduli scales the operator by kappa/kappa0
                scale = self.kappa0 / self.kappa
                if isinstance(scale, torch.Tensor):
                    scale = scale.to(b.dtype)
                z = _matmul(self.coarse_inv.to(b.dtype), b) * scale
                return torch.where(free, z, zero)
            return smooth(None, b, self.coarse_iters)

        nu = self.nu if lvl == 0 or self.nu_coarse is None else self.nu_coarse
        x = smooth(None, b, nu)
        r = torch.where(free, b - A(x), zero)
        xc = self.vcycle(lvl + 1, self.restrict(r, lvl))
        x = x + torch.where(free, self.prolong(xc, lvl), zero)
        return smooth(x, b, nu)

    def bpx(self, r_gm: torch.Tensor) -> torch.Tensor:
        """Additive (BPX) multilevel apply: M^-1 = sum_l P_(0..l) D_l^-1
        R_(l..0). No fine-level operator applies, only transfers and
        diagonals."""
        contribs = []
        r = r_gm
        zero = r.new_zeros(())
        for lvl in range(self.n_levels):
            free = self.free(lvl)
            r = torch.where(free, r, zero)
            d = torch.where(free, self._diag(lvl).to(r.dtype), r.new_ones(()))
            contribs.append(torch.where(free, r / d, zero))
            if lvl < self.n_levels - 1:
                r = self.restrict(r, lvl)
        z = contribs[-1]
        for lvl in range(self.n_levels - 2, -1, -1):
            z = contribs[lvl] + torch.where(self.free(lvl), self.prolong(z, lvl), zero)
        return z

    def prepared(self, fine_tangent, fine_diag_gm: torch.Tensor):
        """V-cycle closure that smooths level 0 with the given consistent
        tangent and its grid-major Jacobi diagonal. A softening tangent can
        make that diagonal indefinite and break CG's SPD assumption; this is
        for SPD heterogeneous tangents."""
        return lambda r_gm: self.vcycle(0, r_gm, fine_tangent, fine_diag_gm)

    def forward(self, r_gm: torch.Tensor) -> torch.Tensor:
        """V-cycle apply M^-1 r at the fine level (grid-major vectors)."""
        return self.vcycle(0, r_gm)


def build_multigrid(
    geo: StructuredGeometry,
    mu: float,
    kappa: float,
    free_mask=None,
    *,
    device="cuda",
    dtype: torch.dtype,
    omega: float = 0.6,
    nu: int = 2,
    coarse_iters: int = 20,
    min_size: int = 4,
    fine_matvec=None,
    smoother: str = "jacobi",
    nu_coarse: int | None = None,
    coarse_direct: bool = False,
    fused_smoothing: bool = False,
) -> MultigridPreconditioner:
    """Build the elastic V-cycle hierarchy below a fine StructuredGeometry.

    ``free_mask``: bool [ndofs] (node-major) with False at Dirichlet dofs.
    Constraints reach the coarse levels by injection (every other node), which
    keeps each level's operator nonsingular.
    ``smoother``: "jacobi" or "chebyshev" (per-level lmax by 50 power
    iterations at the build-time moduli).
    ``fused_smoothing``: run the V-cycle as ops/cuda_smoother.py's
    FusedVcycle over one K3 chain per level and pass (pre: sweeps and
    residual; post: sweeps; coarsest without ``coarse_direct``: sweeps),
    with the transfers and the coarse solve, the element matrices baked at
    the build-time moduli. It takes the Jacobi smoother and no
    ``fine_matvec``.
    """
    from ..fem.mesh import unit_cube_mesh, unit_square_mesh
    from ..fem.spaces import FunctionSpace
    from ..ops.structured import build_structured_geometry

    if smoother not in ("jacobi", "chebyshev"):
        msg = f"smoother must be 'jacobi' or 'chebyshev', got {smoother!r}"
        raise ValueError(msg)
    if fused_smoothing and smoother != "jacobi":
        msg = "fused smoothing implements the Jacobi chain (smoother='jacobi')"
        raise ValueError(msg)
    if fused_smoothing and fine_matvec is not None:
        msg = "fused smoothing replaces the fine apply: pass no fine_matvec"
        raise ValueError(msg)

    vs, gdim = geo.vs, geo.gdim
    node_grids = [tuple(g + 1 for g in geo.grid)]
    while min(node_grids[-1]) > min_size + 1:
        node_grids.append(tuple(coarse_len(L) for L in node_grids[-1]))
    cell_grids = [tuple(L - 1 for L in ng) for ng in node_grids]

    def synth_geo(cells):
        # uniform box with the same physical extent (h scales per level)
        m = unit_cube_mesh(*cells, "hex") if gdim == 3 else unit_square_mesh(*cells, "quad")
        return build_structured_geometry(
            FunctionSpace(m, 1, vs), 2, geo.constraint, device=device, dtype=dtype
        )

    geos = [geo] + [synth_geo(c) for c in cell_grids[1:]]
    if free_mask is None:
        free_mask = torch.ones(geo.ndofs, dtype=torch.bool)
    free0 = torch.as_tensor(free_mask, dtype=torch.bool, device=device)
    frees = [geo.to_grid_major(free0)]
    for lvl in range(1, len(node_grids)):
        fine = frees[-1].reshape((vs, *node_grids[lvl - 1]))
        frees.append(fine[(slice(None),) + (slice(None, None, 2),) * gdim].reshape(-1))

    def unit(k, b):
        return IsotropicTangent(
            kappa=k, beta=b, gamma=0.0,
            n=torch.zeros((geo.sdim, 1, 1), dtype=dtype, device=device),
        )

    diag_kappa = [g.jacobi_diag_gm(unit(1.0, 0.0)) for g in geos]
    diag_beta = [g.jacobi_diag_gm(unit(0.0, 1.0)) for g in geos]
    ka0, beta0 = float(kappa), 2.0 * float(mu)
    zero = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)

    lmax = ()
    if smoother == "chebyshev":
        # lambda_max(D^-1 A) per level by power iteration at the build-time
        # moduli; D^-1 A is invariant under a common scaling of (mu, kappa),
        # so the bound survives with_moduli. 50 iterations approach it from
        # below; the smoother's 1.1 margin covers the rest.
        tangent0 = unit(ka0, beta0)
        ests = []
        for lvl, g in enumerate(geos):
            free = frees[lvl]
            d = torch.where(free, ka0 * diag_kappa[lvl] + beta0 * diag_beta[lvl], one)
            v = torch.sin(torch.arange(d.shape[0], dtype=dtype, device=device) * 0.7) + 0.01
            v = v / torch.linalg.vector_norm(v)
            nrm = one
            for _ in range(50):
                w = torch.where(free, g.matvec_gm(torch.where(free, v, zero), tangent0), v) / d
                nrm = torch.linalg.vector_norm(w)
                v = w / nrm
            ests.append(float(nrm))
        lmax = tuple(ests)

    coarse_inv = None
    if coarse_direct:
        # dense inverse of the coarsest constrained elastic operator (tiny:
        # vs * prod(coarsest grid) dofs), one operator apply per column
        gC, freeC = geos[-1], frees[-1]
        tangC = unit(ka0, beta0)
        cols = []
        for i in range(gC.ndofs):
            e = torch.zeros(gC.ndofs, dtype=dtype, device=device)
            e[i] = 1.0
            cols.append(torch.where(freeC, gC.matvec_gm(torch.where(freeC, e, zero), tangC), e))
        A = torch.stack(cols, dim=1).cpu().numpy().astype(np.float64)
        coarse_inv = torch.as_tensor(np.linalg.inv(A), dtype=dtype, device=device)

    fused = fused_cycle = None
    if fused_smoothing:
        from ..ops.cuda_smoother import FusedVcycle, build_fused_smoother

        entries = []
        for lvl, g in enumerate(geos):
            # Ke = beta0 KE_I + (kappa0 - beta0/3) KE_V, from float64 on the host
            ke = beta0 * g.KE_I.double().cpu().numpy() + (ka0 - beta0 / 3.0) * (
                g.KE_V.double().cpu().numpy()
            )
            d = ka0 * diag_kappa[lvl] + beta0 * diag_beta[lvl]
            inv_d = torch.where(frees[lvl], omega / d, zero).to(dtype)
            lvl_nu = nu if lvl == 0 or nu_coarse is None else nu_coarse

            def mk(n, zs, res, g=g, ke=ke, inv_d=inv_d):
                return build_fused_smoother(g, ke, inv_d, g.mask, nu=n, zero_start=zs,
                                            emit_residual=res)

            if lvl == len(geos) - 1:
                entries.append({"coarse": mk(coarse_iters, True, False)})
            else:
                entries.append({"pre": mk(lvl_nu, True, True), "post": mk(lvl_nu, False, False)})
        fused = tuple(entries)
        fused_cycle = FusedVcycle(fused, node_grids, coarse_inv)

    return MultigridPreconditioner(
        geos=geos,
        diag_kappa=diag_kappa,
        diag_beta=diag_beta,
        frees=frees,
        mu=float(mu),
        kappa=float(kappa),
        node_grids=node_grids,
        omega=omega,
        nu=nu,
        nu_coarse=nu_coarse,
        coarse_iters=coarse_iters,
        coarse_inv=coarse_inv,
        fine_matvec=fine_matvec,
        smoother=smoother,
        lmax=lmax,
        fused=fused,
        fused_cycle=fused_cycle,
    )


def space_constraint(space) -> Constraint:
    """The constraint of the elastic operator a multigrid hierarchy of
    ``space`` needs (its block structure): FULL for a 3-component space,
    PLANE_STRAIN otherwise."""
    return Constraint.FULL if space.value_size == 3 else Constraint.PLANE_STRAIN


def refined_p1_geometry(space, constraint, *, device="cuda", dtype: torch.dtype):
    """The P1 structured geometry on the degree-times refined box of a
    degree-2 ``space`` on a box of hexes or quads, and its space: its node
    grid is the P2 dof lattice, node for node (2-point Gauss rule)."""
    from ..fem.mesh import unit_cube_mesh, unit_square_mesh
    from ..fem.spaces import FunctionSpace
    from ..ops.structured import build_structured_geometry

    mesh = space.mesh
    grid = mesh.structured_shape
    if space.degree != 2 or grid is None or mesh.cell_type not in ("hex", "quad"):
        msg = "the refined-P1 hierarchy needs a degree-2 space on a box of hexes or quads"
        raise ValueError(msg)
    refined = tuple(2 * g for g in grid)
    m1 = unit_cube_mesh(*refined, "hex") if len(grid) == 3 else unit_square_mesh(*refined, "quad")
    V1 = FunctionSpace(m1, 1, space.value_size)
    return build_structured_geometry(V1, 2, constraint, device=device, dtype=dtype), V1


def build_p2_node_preconditioner(
    space,
    mu: float,
    kappa: float,
    free_mask,
    *,
    device="cuda",
    dtype: torch.dtype,
    use_bpx: bool = False,
    **mg_kwargs,
):
    """Multilevel preconditioner for a degree-2 space on a box mesh, on
    NODE-MAJOR dof vectors of that space (the layout of the windowed and
    gather engines' public boundary).

    The P1 hierarchy on the refined grid (``refined_p1_geometry``) is built
    with ``build_multigrid(**mg_kwargs)``; a lattice node and a P2 dof node
    are matched by their quantized coordinates (exact: both lattices lie on
    the same box), which permutes the free mask onto the lattice and every
    vector in and out. ``use_bpx`` applies ``mg.bpx`` instead of the
    V-cycle. Returns ``precond(r) -> z``.
    """
    vs = space.value_size
    geo1, V1 = refined_p1_geometry(space, space_constraint(space), device=device, dtype=dtype)
    if V1.n_dof_nodes != space.n_dof_nodes:
        msg = "the P2 dof lattice and the refined P1 grid differ in size"
        raise ValueError(msg)

    def keys(a):
        k = np.ascontiguousarray(np.round(np.asarray(a, float) * 1e10).astype(np.int64))
        return k.view([("", k.dtype)] * k.shape[1]).ravel()

    k2, k1 = keys(space.dof_coords), keys(V1.mesh.nodes)
    order = np.argsort(k2)
    pos = np.clip(np.searchsorted(k2, k1, sorter=order), 0, len(k2) - 1)
    if not (k2[order[pos]] == k1).all():
        msg = "the P2 dof lattice is not the refined P1 lattice"
        raise ValueError(msg)
    perm = order[pos]  # the P2 dof node of each lattice node
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(len(perm))
    perm_t = torch.as_tensor(perm, dtype=torch.int64, device=device)
    inv_t = torch.as_tensor(inv_perm, dtype=torch.int64, device=device)

    free = torch.as_tensor(np.asarray(free_mask, bool), device=device)
    free_lat = free.reshape(-1, vs)[perm_t].reshape(-1)
    mg = build_multigrid(geo1, mu, kappa, free_lat, device=device, dtype=dtype, **mg_kwargs)
    inner = mg.bpx if use_bpx else mg

    def precond(r: torch.Tensor) -> torch.Tensor:
        """node-major P2 dof vector -> node-major preconditioned vector."""
        r_lat = r.reshape(-1, vs)[perm_t].reshape(-1)
        z_lat = geo1.to_node_major(inner(geo1.to_grid_major(r_lat)))
        return z_lat.reshape(-1, vs)[inv_t].reshape(-1)

    return precond
