"""Geometric multigrid preconditioner for the structured engine.

A matrix-free V-cycle on the node grid:

  * level operators: the CONSTANT-COEFFICIENT elastic operator per level
    (2 mu P_dev + 3 kappa P_vol), spectrally equivalent to the consistent
    elastoplastic tangent (plastic softening is bounded), which is what a
    preconditioner needs;
  * transfer: trilinear prolongation (weights [1/2, 1, 1/2] per axis) and
    its adjoint R = P^T as restriction, written as strided and shifted
    slices per axis: no convolution, so no cuDNN and no TF32;
  * smoother: damped Jacobi with the level's constant elastic diagonal;
  * Dirichlet dofs are carried to the coarse levels by injection;
  * coarsest level: damped Jacobi sweeps, or a dense inverse
    (``coarse_direct``).

Every vector is grid-major ([vs, *node_grid] flattened).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.packed import IsotropicTangent
from ..ops.structured import StructuredGeometry, _matmul

__all__ = ["MultigridPreconditioner", "build_multigrid"]


def _coarse_len(L: int) -> int:
    return (L - 1) // 2 + 1


def _restrict_last(x: torch.Tensor) -> torch.Tensor:
    """1D restriction along the last axis: out[i] = x[2i-1]/2 + x[2i] + x[2i+1]/2
    (zero outside), of length (L - 1)//2 + 1."""
    L = x.shape[-1]
    out = x[..., 0::2].clone()
    odd = 0.5 * x[..., 1::2]  # odd[i] = x[2i+1] / 2
    n_odd = odd.shape[-1]
    out[..., :n_odd] += odd
    out[..., 1 : 1 + n_odd] += odd[..., : _coarse_len(L) - 1]
    return out


def _prolong_last(x: torch.Tensor, Lf: int) -> torch.Tensor:
    """1D trilinear interpolation along the last axis onto Lf nodes:
    out[2i] = x[i], out[2i+1] = (x[i] + x[i+1]) / 2 with x past the end read
    as 0. On a non-nested level (Lf = 2 Lc) the last fine node is x[-1]/2,
    the extra row of the JAX package's (1, Lf - 2 Lc + 2) padding."""
    Lc = x.shape[-1]
    out = x.new_zeros((*x.shape[:-1], Lf))
    out[..., 0::2] = x[..., : (Lf + 1) // 2]
    half = 0.5 * x
    n_odd = Lf // 2
    out[..., 1::2] = half[..., :n_odd]
    out[..., 1 : 2 * (Lc - 1) : 2] += half[..., 1:Lc]
    return out


class MultigridPreconditioner(nn.Module):
    """V-cycle / BPX preconditioner. Level data are registered buffers:
    ``diag_kappa_<l>``/``diag_beta_<l>`` (the Jacobi diagonal is kappa *
    diag_kappa + 2 mu * diag_beta), ``free_<l>`` (bool free-dof masks) and
    ``coarse_inv`` (or None); the level geometries are submodules."""

    def __init__(
        self,
        *,
        geos,
        diag_kappa,
        diag_beta,
        frees,
        mu: float,
        kappa: float,
        node_grids,
        omega: float,
        nu: int,
        nu_coarse: int | None,
        coarse_iters: int,
        coarse_inv: torch.Tensor | None,
        fine_matvec=None,
    ):
        super().__init__()
        self.geos = nn.ModuleList(geos)
        for lvl, (dk, db, fr) in enumerate(zip(diag_kappa, diag_beta, frees)):
            self.register_buffer(f"diag_kappa_{lvl}", dk)
            self.register_buffer(f"diag_beta_{lvl}", db)
            self.register_buffer(f"free_{lvl}", fr)
        self.register_buffer("coarse_inv", coarse_inv)
        self.mu = float(mu)
        self.kappa = float(kappa)
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
            n=torch.zeros((6, 1, 1), dtype=dtype, device=device),
        )

    # -- transfers ------------------------------------------------------------------

    def restrict(self, x_fine: torch.Tensor, lvl: int) -> torch.Tensor:
        """fine level lvl -> coarse level lvl+1, R = P^T exactly (residuals
        are integrated functionals, so no 1/2^d scaling)."""
        g = x_fine.reshape((self.vs, *self.node_grids[lvl]))
        for d in range(1, g.dim()):
            g = _restrict_last(g.movedim(d, -1)).movedim(-1, d)
        return g.reshape(-1)

    def prolong(self, x_coarse: torch.Tensor, lvl: int) -> torch.Tensor:
        """coarse level lvl+1 -> fine level lvl (trilinear interpolation)."""
        g = x_coarse.reshape((self.vs, *self.node_grids[lvl + 1]))
        for d, Lf in enumerate(self.node_grids[lvl], start=1):
            g = _prolong_last(g.movedim(d, -1), Lf).movedim(-1, d)
        return g.reshape(-1)

    # -- cycles ---------------------------------------------------------------------

    def vcycle(self, lvl: int, b: torch.Tensor) -> torch.Tensor:
        geo = self.geos[lvl]
        free = self.free(lvl)
        zero = b.new_zeros(())
        diag = torch.where(free, self._diag(lvl).to(b.dtype), b.new_ones(()))
        inv_d = self.omega / diag
        b = torch.where(free, b, zero)

        if lvl == 0 and self.fine_matvec is not None:
            tg = self._tangent(b.dtype, b.device)

            def apply_op(v):
                return self.fine_matvec(v, tg)
        else:
            def apply_op(v):
                return geo.elastic_matvec_gm(v, self.kappa, 2.0 * self.mu)

        def A(v):
            # constrained (identity-row) elastic operator at this level
            vm = torch.where(free, v, zero)
            return torch.where(free, apply_op(vm), v)

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
                return torch.where(free, _matmul(self.coarse_inv.to(b.dtype), b), zero)
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

    def forward(self, r_gm: torch.Tensor) -> torch.Tensor:
        """V-cycle apply M^-1 r at the fine level (grid-major vectors)."""
        return self.vcycle(0, r_gm)


def build_multigrid(
    geo: StructuredGeometry,
    mu: float,
    kappa: float,
    free_mask=None,
    *,
    device,
    dtype: torch.dtype,
    omega: float = 0.6,
    nu: int = 2,
    coarse_iters: int = 20,
    min_size: int = 4,
    fine_matvec=None,
    nu_coarse: int | None = None,
    coarse_direct: bool = False,
) -> MultigridPreconditioner:
    """Build the elastic V-cycle hierarchy below a fine StructuredGeometry.

    ``free_mask``: bool [ndofs] (node-major) with False at Dirichlet dofs.
    Constraints reach the coarse levels by injection (every other node), which
    keeps each level's operator nonsingular.
    """
    from ..fem.mesh import unit_cube_mesh, unit_square_mesh
    from ..fem.spaces import FunctionSpace
    from ..ops.structured import build_structured_geometry

    vs, gdim = geo.vs, geo.gdim
    node_grids = [tuple(g + 1 for g in geo.grid)]
    while min(node_grids[-1]) > min_size + 1:
        node_grids.append(tuple(_coarse_len(L) for L in node_grids[-1]))
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
            n=torch.zeros((6, 1, 1), dtype=dtype, device=device),
        )

    diag_kappa = [g.jacobi_diag_gm(unit(1.0, 0.0)) for g in geos]
    diag_beta = [g.jacobi_diag_gm(unit(0.0, 1.0)) for g in geos]

    coarse_inv = None
    if coarse_direct:
        # dense inverse of the coarsest constrained elastic operator (tiny:
        # vs * prod(coarsest grid) dofs), one operator apply per column
        gC, freeC = geos[-1], frees[-1]
        tangC = unit(float(kappa), 2.0 * float(mu))
        cols = []
        for i in range(gC.ndofs):
            e = torch.zeros(gC.ndofs, dtype=dtype, device=device)
            e[i] = 1.0
            vm = torch.where(freeC, e, torch.zeros((), dtype=dtype, device=device))
            cols.append(torch.where(freeC, gC.matvec_gm(vm, tangC), e))
        A = torch.stack(cols, dim=1).cpu().numpy().astype(np.float64)
        coarse_inv = torch.as_tensor(np.linalg.inv(A), dtype=dtype, device=device)

    return MultigridPreconditioner(
        geos=geos,
        diag_kappa=diag_kappa,
        diag_beta=diag_beta,
        frees=frees,
        mu=mu,
        kappa=kappa,
        node_grids=node_grids,
        omega=omega,
        nu=nu,
        nu_coarse=nu_coarse,
        coarse_iters=coarse_iters,
        coarse_inv=coarse_inv,
        fine_matvec=fine_matvec,
    )
