"""Structured-grid engine: flat index-space FEM on a box mesh.

The node grid is flattened to ONE minor axis of length ``M = prod(grid+1)``.
On a translation-invariant grid every corner stencil is a CONSTANT flat
offset ``off_a = dx*SY + dy*SZ + dz``, so:

  * corner gather:  ``U[(a,j), n] = u[j, n + off_a]``, 2^d static slices of a
    right-padded ``[vs, M]`` array;
  * strain:         ``e[(s,q), n] = KEPS_c @ U``, one ``[s*Q, n*vs] x
    [n*vs, M]`` product (Mandel map and reference gradients folded into the
    constant matrix);
  * divergence:     ``F[(a,j), n] = KDIV_c @ sig`` (weights folded), then
    ``r[j, n] = sum_a F[(a,j), n - off_a]``, 2^d static shifted adds taken in
    the fixed order a = 0..2^d-1, so assembly is deterministic.

Cell and quadrature fields live on the NODE-grid footprint (``[k, Q, M]``):
cell (x,y,z) sits at its origin node's flat index; origins on the high faces
are invalid and masked. ``extract_cells``/``cell_index`` map to dense
per-cell arrays for observation.

Dof vectors on the hot path are GRID-MAJOR: ``[vs, M]`` flattened, component
slowest. The public node-major layout is ``[M, vs]`` flattened;
``to_grid_major``/``to_node_major`` convert once per Newton solve.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_nn
from torch import nn

from . import mandel
from .mandel import Constraint

__all__ = [
    "StructuredGeometry",
    "build_structured_geometry",
    "restrict_structured_geometry",
]


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full precision: a CUDA float32 product never runs in TF32.

    TF32 keeps about three decimal digits; a CG operator perturbed at that
    level stalls the outer Newton iteration, so the flag is forced off here
    whatever the process-wide setting is.
    """
    if a.is_cuda and a.dtype == torch.float32:
        flags = torch.backends.cuda.matmul
        if flags.allow_tf32:
            flags.allow_tf32 = False
            try:
                return a @ b
            finally:
                flags.allow_tf32 = True
    return a @ b


class StructuredGeometry(nn.Module):
    """Uniform-cell tensor-grid geometry, flat index-space formulation.

    Buffers (on the geometry's device, in its dtype):
      KEPS_c: [s*Q, n*vs]  corner dofs -> Mandel strain channels
      KDIV_c: [n*vs, s*Q]  weighted stress channels -> per-corner nodal forces
      KE_I, KE_V: [n*vs, n*vs] quadrature-folded constant-coefficient element
          matrices: Ke(kappa, beta) = beta*KE_I + (kappa - beta/3)*KE_V is
          sum_q w_q B_q^T C B_q for C = kappa (I2 x I2) + beta P_dev
      mask: [M]  1 at valid cell origins, 0 on the high faces
      cell_index: [C] (int64)  flat node index of each cell's origin, in
          mesh cell order
    Host constants: ``offsets`` (per-corner flat offsets), ``dN_host``
    ([n, g, Q] physical gradients) and ``w_host`` ([Q] weights).
    """

    KEPS_c: torch.Tensor
    KDIV_c: torch.Tensor
    KE_I: torch.Tensor
    KE_V: torch.Tensor
    mask: torch.Tensor
    cell_index: torch.Tensor

    def __init__(
        self,
        *,
        KEPS_c: torch.Tensor,
        KDIV_c: torch.Tensor,
        KE_I: torch.Tensor,
        KE_V: torch.Tensor,
        mask: torch.Tensor,
        cell_index: torch.Tensor,
        grid: tuple,
        vs: int,
        ndofs: int,
        constraint: Constraint,
        n_nodes: int,
        n_qp: int,
        n_cells: int,
        offsets: tuple,
        dN_host: np.ndarray,
        w_host: np.ndarray,
    ):
        super().__init__()
        self.register_buffer("KEPS_c", KEPS_c)
        self.register_buffer("KDIV_c", KDIV_c)
        self.register_buffer("KE_I", KE_I)
        self.register_buffer("KE_V", KE_V)
        self.register_buffer("mask", mask)
        self.register_buffer("cell_index", cell_index)
        self.grid = tuple(grid)
        self.vs = vs
        self.ndofs = ndofs
        self.constraint = constraint
        self.n_nodes = n_nodes
        self.n_qp = n_qp
        self.n_cells = n_cells
        self.M = int(np.prod([g + 1 for g in grid]))
        self.offsets = tuple(offsets)
        self.dN_host = dN_host
        self.w_host = w_host

    @property
    def N(self) -> int:
        """Logical QP count (valid cells only; flat fields carry Q*M slots)."""
        return self.n_qp * self.n_cells

    @property
    def gdim(self) -> int:
        return len(self.grid)

    @property
    def sdim(self) -> int:
        return self.constraint.stress_strain_dim

    @property
    def maxoff(self) -> int:
        return max(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.KEPS_c.dtype

    @property
    def device(self) -> torch.device:
        return self.KEPS_c.device

    def qp_shape(self, k: int) -> tuple:
        """Shape of a k-component QP field in this engine's layout."""
        return (k, self.n_qp, self.M)

    # -- layout plumbing --------------------------------------------------------

    def to_grid_major(self, u: torch.Tensor) -> torch.Tensor:
        return u.reshape(self.M, self.vs).T.reshape(-1)

    def to_node_major(self, u_gm: torch.Tensor) -> torch.Tensor:
        return u_gm.reshape(self.vs, self.M).T.reshape(-1)

    def _corner_dofs(self, u_cm: torch.Tensor) -> torch.Tensor:
        """[vs, M] component-major nodes -> [n*vs, M] corner dof channels."""
        up = F_nn.pad(u_cm, (0, self.maxoff))
        return torch.cat([up[:, off : off + self.M] for off in self.offsets], dim=0)

    def _scatter_corners(self, F: torch.Tensor) -> torch.Tensor:
        """[n*vs, M] per-corner forces -> [vs, M] component-major nodes.

        r[j, n] = sum_a F[(a,j), n - off_a], summed in the order a = 0, 1, ...
        """
        mo = self.maxoff
        Fp = F_nn.pad(F, (mo, 0))
        out = None
        for a, off in enumerate(self.offsets):
            sl = Fp[a * self.vs : (a + 1) * self.vs, mo - off : mo - off + self.M]
            out = sl if out is None else out + sl
        return out

    # -- grid-major hot-path ops --------------------------------------------------

    def strain_gm(self, u_gm: torch.Tensor) -> torch.Tensor:
        """Mandel strain of a grid-major dof vector: [s, Q, M] (masked)."""
        U = self._corner_dofs(u_gm.reshape(self.vs, self.M))
        e = _matmul(self.KEPS_c.to(U.dtype), U)
        return e.reshape(self.sdim, self.n_qp, self.M) * self.mask.to(U.dtype)

    def _corner_forces(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, M] -> masked per-corner forces [n*vs, M] (pre-scatter)."""
        sig = (sigma.reshape(self.sdim, self.n_qp, self.M) * self.mask.to(sigma.dtype))
        sig = sig.reshape(self.sdim * self.n_qp, self.M)
        return _matmul(self.KDIV_c.to(sig.dtype), sig)

    def residual_gm(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, M] -> grid-major assembled force [vs*M]."""
        return self._scatter_corners(self._corner_forces(sigma)).reshape(-1)

    def matvec_gm(self, v_gm: torch.Tensor, tangent) -> torch.Tensor:
        """Tangent operator apply on a grid-major vector."""
        return self.residual_gm(tangent.apply(self.strain_gm(v_gm)))

    def elastic_matvec_gm(self, v_gm: torch.Tensor, kappa, beta) -> torch.Tensor:
        """Constant-coefficient elastic operator apply, quadrature folded.

        Equal to ``matvec_gm(v, IsotropicTangent(kappa, beta, 0, 0))`` but as
        ONE [n*vs, n*vs] x [n*vs, M] product on corner-dof blocks, with no
        [s*Q, M] strain or stress intermediates."""
        U = self._corner_dofs(v_gm.reshape(self.vs, self.M))
        U = U * self.mask.to(U.dtype)
        Ke = (beta * self.KE_I + (kappa - beta / 3.0) * self.KE_V).to(U.dtype)
        return self._scatter_corners(_matmul(Ke, U)).reshape(-1)

    def jacobi_diag_gm(self, tangent) -> torch.Tensor:
        """diag(A) in grid-major layout via per-corner B^T C B, for an
        IsotropicTangent or a DenseTangent. The small contractions are
        broadcast multiplies and sums, so none runs in TF32 on the card."""
        dtype, device = self.dtype, self.device
        M_map = torch.as_tensor(
            mandel._mandel_matrix_map(self.constraint), dtype=dtype, device=device
        )
        dN = torch.as_tensor(self.dN_host, dtype=dtype, device=device)  # [n, g, Q]
        w = torch.as_tensor(self.w_host, dtype=dtype, device=device)  # [Q]
        rows = []
        for a in range(self.n_nodes):
            # B_a[s, j, q] = sum_i M[s, i, j] dN[a, i, q]; [s, vs, Q, 1]
            # broadcasts against tangent fields [Q, M]
            B_a = (M_map[:, :, :, None] * dN[a][None, :, None, :]).sum(dim=1)[..., None]
            q = tangent.quad_diag(B_a) * w[:, None]
            q = q.expand(self.vs, self.n_qp, self.M)
            rows.append(q.sum(dim=1) * self.mask)
        return self._scatter_corners(torch.cat(rows, dim=0)).reshape(-1)

    # -- observation ---------------------------------------------------------------

    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        """[k, Q, M] cell-at-origin field -> dense [k, Q, C] in mesh cell order."""
        return field[:, :, self.cell_index]


def restrict_structured_geometry(geo: StructuredGeometry, cells) -> StructuredGeometry:
    """The masked view of a law on a subset of the mesh's cells.

    Every engine op multiplies by the valid-origin ``mask`` and observes
    through ``cell_index``, so a law on a cell subset is the same dense sweep
    over the whole grid with the mask zeroed at the other cells' origins: its
    strain is zero there and its history stays zero. The view shares every
    other buffer with ``geo``.
    """
    cells = np.asarray(cells, np.int64)
    own = geo.cell_index.cpu().numpy()[cells]
    mask = np.zeros(geo.M)
    mask[own] = 1.0
    return StructuredGeometry(
        KEPS_c=geo.KEPS_c,
        KDIV_c=geo.KDIV_c,
        KE_I=geo.KE_I,
        KE_V=geo.KE_V,
        mask=torch.as_tensor(mask, dtype=geo.dtype, device=geo.device),
        cell_index=torch.as_tensor(own, dtype=torch.int64, device=geo.device),
        grid=geo.grid,
        vs=geo.vs,
        ndofs=geo.ndofs,
        constraint=geo.constraint,
        n_nodes=geo.n_nodes,
        n_qp=geo.n_qp,
        n_cells=len(cells),
        offsets=geo.offsets,
        dN_host=geo.dN_host,
        w_host=geo.w_host,
    )


def _corner_offsets(gdim: int):
    """local node a = dx + 2 dy + 4 dz (x fastest), matching mesh.py."""
    return [tuple((a >> d) & 1 for d in range(gdim)) for a in range(2**gdim)]


def build_structured_geometry(
    space, q_degree: int, constraint: Constraint, *, device="cuda", dtype: torch.dtype
) -> StructuredGeometry:
    """Flat-index geometry for a box mesh from unit_cube_mesh('hex') /
    unit_square_mesh('quad') (requires mesh.structured_shape metadata)."""
    from ..fem.elements import tabulate_element
    from ..fem.kinematics import _geometry_grad_at

    mesh = space.mesh
    grid = mesh.structured_shape
    if grid is None or mesh.cell_type not in ("hex", "quad"):
        msg = "the structured engine needs a box mesh of hex or quad cells"
        raise ValueError(msg)
    if space.degree != 1:
        msg = "the structured engine supports degree-1 spaces only"
        raise ValueError(msg)

    elem, quad = tabulate_element(mesh.cell_type, space.degree, q_degree)
    verts = mesh.nodes[mesh.cells[0]]
    geom_dN = _geometry_grad_at(mesh.cell_type, quad.points)
    J = np.einsum("vi,qvj->qij", verts, geom_dN)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    dN = np.einsum("qaj,qji->aiq", elem.dN_dxi, Jinv)  # [n, g, Q]
    w = quad.weights * detJ  # [Q]

    gdim = len(grid)
    sdim = constraint.stress_strain_dim
    n = elem.N.shape[1]
    Q = quad.points.shape[0]
    vs = space.value_size
    offs = _corner_offsets(gdim)
    M_map = mandel._mandel_matrix_map(constraint)  # [s, g, g]

    node_grid = tuple(g + 1 for g in grid)
    # flat strides, row-major [X+1, Y+1, Z+1] with z minor (mesh.py order)
    strides = [1]
    for L in reversed(node_grid[1:]):
        strides.append(strides[-1] * L)
    strides = list(reversed(strides))
    flat_offsets = tuple(
        int(sum(o * s for o, s in zip(off, strides))) for off in offs
    )

    # coef[(s,q), (a,j)] = sum_i M[s,i,j] dN[a,i,q]
    KEPS_c = np.zeros((sdim * Q, n * vs))
    for a in range(n):
        for s in range(sdim):
            for q in range(Q):
                for j in range(vs):
                    KEPS_c[s * Q + q, a * vs + j] = sum(
                        M_map[s, i, j] * dN[a, i, q] for i in range(gdim)
                    )
    # KDIV folds the quadrature weights: F = (w .* sig)^T contraction
    KDIV_c = KEPS_c.T.copy()
    for q in range(Q):
        KDIV_c[:, [s * Q + q for s in range(sdim)]] *= w[q]

    # B_q [s, n*vs] are the per-QP rows of KEPS_c; i2 spans the first three
    # Mandel (diagonal) slots
    KE_I = np.zeros((n * vs, n * vs))
    KE_V = np.zeros((n * vs, n * vs))
    n_diag = min(3, sdim)
    for q in range(Q):
        B_q = KEPS_c[[s * Q + q for s in range(sdim)], :]
        KE_I += w[q] * (B_q.T @ B_q)
        bv = B_q[:n_diag].sum(axis=0)
        KE_V += w[q] * np.outer(bv, bv)

    # valid-origin mask and cell origin indices (mesh cell order: row-major
    # over the cell grid, z fastest, i.e. the node flat order on origins)
    idx_nd = np.indices(node_grid)
    valid = np.ones(node_grid, bool)
    for d in range(gdim):
        valid &= idx_nd[d] < grid[d]
    mask = valid.reshape(-1).astype(np.float64)
    cell_index = np.flatnonzero(mask)

    def dev(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    return StructuredGeometry(
        KEPS_c=dev(KEPS_c),
        KDIV_c=dev(KDIV_c),
        KE_I=dev(KE_I),
        KE_V=dev(KE_V),
        mask=dev(mask),
        cell_index=dev(cell_index, torch.int64),
        grid=tuple(grid),
        vs=vs,
        ndofs=space.ndofs,
        constraint=constraint,
        n_nodes=n,
        n_qp=Q,
        n_cells=int(np.prod(grid)),
        offsets=flat_offsets,
        dN_host=dN,
        w_host=w,
    )
