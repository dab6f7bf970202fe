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
    "LatticeGeometry",
    "StructuredGeometry",
    "StructuredTetGeometry",
    "build_lattice_geometry",
    "build_structured_geometry",
    "build_structured_tet_geometry",
    "restrict_structured_geometry",
    "restrict_structured_tet_geometry",
    "slab_geometry",
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

    #: the engine this geometry serves (``PackedSimulation.engine``)
    engine = "structured"

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
        # the Jacobi diagonal's constants, uploaded once here: a step
        # captured in a CUDA graph uploads nothing
        opts = dict(dtype=KEPS_c.dtype, device=KEPS_c.device)
        for name, host in (("diag_M_map", mandel._mandel_matrix_map(constraint)),
                           ("diag_dN", dN_host), ("diag_w", w_host)):
            self.register_buffer(name, torch.as_tensor(host, **opts), persistent=False)

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

    @property
    def qp_layout(self) -> int:
        """Second axis of the [k, qp_layout, M] field layout: n_qp here; the
        structured-tet engine stacks its cell classes along it."""
        return self.n_qp

    def qp_shape(self, k: int) -> tuple:
        """Shape of a k-component QP field in this engine's layout."""
        return (k, self.qp_layout, self.M)

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

    def _qp_mask(self, dtype: torch.dtype) -> torch.Tensor:
        """Valid-QP mask broadcastable to [s, qp_layout, M]: the cell-origin
        ``mask`` [M] here; the tet engine's subset views mask per class."""
        return self.mask.to(dtype)

    def strain_gm(self, u_gm: torch.Tensor) -> torch.Tensor:
        """Mandel strain of a grid-major dof vector: [s, Q, M] (masked)."""
        U = self._corner_dofs(u_gm.reshape(self.vs, self.M))
        e = _matmul(self.KEPS_c.to(U.dtype), U)
        return e.reshape(self.sdim, self.qp_layout, self.M) * self._qp_mask(U.dtype)

    def _corner_forces(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, M] -> masked per-corner forces [n*vs, M] (pre-scatter)."""
        sig = sigma.reshape(self.sdim, self.qp_layout, self.M) * self._qp_mask(sigma.dtype)
        sig = sig.reshape(self.sdim * self.qp_layout, self.M)
        return _matmul(self.KDIV_c.to(sig.dtype), sig)

    def assemble_gm(self, F: torch.Tensor) -> torch.Tensor:
        """Per-cell arrays [n*vs, M] (``element_forces_gm``,
        ``element_diag_gm``; one column per cell origin) -> the grid-major
        assembled vector [vs*M]."""
        return self._scatter_corners(F).reshape(-1)

    def element_forces_gm(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, M] -> masked per-corner forces [n*vs, M], before assembly."""
        return self._corner_forces(sigma)

    def residual_gm(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, M] -> grid-major assembled force [vs*M]."""
        return self.assemble_gm(self.element_forces_gm(sigma))

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
        IsotropicTangent or a DenseTangent."""
        return self.assemble_gm(self.element_diag_gm(tangent))

    def element_diag_gm(self, tangent) -> torch.Tensor:
        """The per-corner diagonal blocks [n*vs, M] before assembly. The
        small contractions are broadcast multiplies and sums, so none runs in
        TF32 on the card."""
        M_map, dN, w = self.diag_M_map, self.diag_dN, self.diag_w  # [s, g, g], [n, g, Q], [Q]
        rows = []
        for a in range(self.n_nodes):
            # B_a[s, j, q] = sum_i M[s, i, j] dN[a, i, q]; [s, vs, Q, 1]
            # broadcasts against tangent fields [Q, M]
            B_a = (M_map[:, :, :, None] * dN[a][None, :, None, :]).sum(dim=1)[..., None]
            q = tangent.quad_diag(B_a) * w[:, None]
            q = q.expand(self.vs, self.n_qp, self.M)
            rows.append(q.sum(dim=1) * self.mask)
        return torch.cat(rows, dim=0)

    # -- observation ---------------------------------------------------------------

    def grad(self, u: torch.Tensor) -> torch.Tensor:
        """Displacement gradient [g, vs, Q*M] of a node-major dof vector
        (observation path; zero at invalid origins)."""
        U = self._corner_dofs(self.to_grid_major(u).reshape(self.vs, self.M))
        U = U.reshape(self.n_nodes, self.vs, self.M) * self.mask.to(u.dtype)
        dN = torch.as_tensor(self.dN_host, dtype=u.dtype, device=u.device)  # [n, g, Q]
        # [g, vs, Q, M]: sum_a dN[a, i, q] U[a, j, m]
        out = (dN[:, :, None, :, None] * U[:, None, :, None, :]).sum(dim=0)
        return out.reshape(self.gdim, self.vs, self.n_qp * self.M)

    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        """[k, Q, M] cell-at-origin field -> dense [k, Q, C] in mesh cell order."""
        return field[:, :, self.cell_index]

    def insert_cells(self, dense: torch.Tensor, dtype=None) -> torch.Tensor:
        """Dense [k, Q, C] per-cell field -> the [k, Q, M] cell-at-origin layout
        (of ``dtype``, default the field's)."""
        k, Q, _ = dense.shape
        out = dense.new_zeros((k, Q, self.M), dtype=dtype)
        out[:, :, self.cell_index] = dense.to(out.dtype)
        return out


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
    return StructuredGeometry(**_base_fields(
        geo,
        mask=torch.as_tensor(mask, dtype=geo.dtype, device=geo.device),
        cell_index=torch.as_tensor(own, dtype=torch.int64, device=geo.device),
        n_cells=len(cells),
    ))


def _base_fields(geo: StructuredGeometry, **override) -> dict:
    """The constructor arguments of ``geo``'s StructuredGeometry part."""
    out = dict(
        KEPS_c=geo.KEPS_c, KDIV_c=geo.KDIV_c, KE_I=geo.KE_I, KE_V=geo.KE_V, mask=geo.mask,
        cell_index=geo.cell_index, grid=geo.grid, vs=geo.vs, ndofs=geo.ndofs,
        constraint=geo.constraint, n_nodes=geo.n_nodes, n_qp=geo.n_qp, n_cells=geo.n_cells,
        offsets=geo.offsets, dN_host=geo.dN_host, w_host=geo.w_host,
    )
    out.update(override)
    return out


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


# ---------------------------------------------------------------------------
# Kuhn simplex boxes: the structured-tet engine
# ---------------------------------------------------------------------------


class StructuredTetGeometry(StructuredGeometry):
    """Gather-free engine for Kuhn-subdivided box simplex meshes (6 tets per
    cube in 3D, 2 triangles per square in 2D).

    ``unit_cube_mesh(..., "tetra")`` splits every cube into the same K
    classes of simplex, so every simplex vertex is one of its cube's corners
    and the mesh is translation-invariant per class. The classes fold into
    the hex engine's corner channels: one corner gather of static slices,
    one [s*K*Q, 2^d*vs] strain product whose rows stack the classes along
    the QP-layout axis, one weighted divergence product and one shifted-add
    scatter, with no gather.

    Fields are [k, K*Q, M] (``qp_layout = n_classes * n_qp``) on the
    cube-origin footprint; ``n_qp`` is the per-simplex count and ``n_cells``
    the simplex count, so ``extract_cells``/``insert_cells`` give dense
    per-simplex fields with simplex t = cube * K + class. ``n_nodes`` counts
    the cube's corner channels, and ``KE_I``/``KE_V`` are the cube's element
    matrices over them (every class folded in). Extra buffers of a subset
    view (``restrict_structured_tet_geometry``): ``class_mask`` [K, M], 1
    where the law owns simplex (class, cube origin), and ``tet_index`` (the
    owned simplices in mesh order); both None on the whole mesh. Host
    constants: ``class_dN_host`` (per class, dN/dx [gdim+1, g, Q]) and
    ``class_channels`` (per class, the corner channel of each vertex).
    """

    #: the engine this geometry serves (``PackedSimulation.engine``)
    engine = "structured_tet"

    class_mask: torch.Tensor | None
    tet_index: torch.Tensor | None

    def __init__(self, *, n_classes: int, class_dN_host, class_channels, class_mask=None,
                 tet_index=None, **base):
        super().__init__(**base)
        self.n_classes = n_classes
        self.class_dN_host = tuple(class_dN_host)
        self.class_channels = tuple(tuple(c) for c in class_channels)
        self.register_buffer("class_mask", class_mask)
        self.register_buffer("tet_index", tet_index)

    @property
    def qp_layout(self) -> int:
        return self.n_classes * self.n_qp

    def _qp_mask(self, dtype: torch.dtype) -> torch.Tensor:
        if self.class_mask is None:
            return self.mask.to(dtype)
        # [K, M] ownership -> [K*Q, M] rows of the class-stacked QP layout
        cm = self.class_mask.to(dtype)[:, None, :]
        return cm.expand(self.n_classes, self.n_qp, self.M).reshape(self.qp_layout, self.M)

    # -- observation -----------------------------------------------------------

    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        """[k, K*Q, M] -> dense [k, Q, C] in mesh cell order (simplex t = cube
        * K + class, cubes in the hex engine's cell order)."""
        k = field.shape[0]
        blk = field.reshape(k, self.n_classes, self.n_qp, self.M)[:, :, :, self.cell_index]
        dense = blk.permute(0, 2, 3, 1).reshape(k, self.n_qp, -1)
        return dense if self.tet_index is None else dense[:, :, self.tet_index]

    def insert_cells(self, dense: torch.Tensor, dtype=None) -> torch.Tensor:
        """Dense [k, Q, C] per-simplex field -> the [k, K*Q, M] layout (of
        ``dtype``, default the field's)."""
        k, Q, _ = dense.shape
        dense = dense.to(dtype or dense.dtype)
        if self.tet_index is not None:  # a subset view: expand to every simplex
            full = dense.new_zeros((k, Q, self.cell_index.shape[0] * self.n_classes))
            full[:, :, self.tet_index] = dense
            dense = full
        d = dense.reshape(k, Q, -1, self.n_classes).permute(0, 3, 1, 2)  # [k, K, Q, Ncube]
        out = dense.new_zeros((k, self.n_classes, Q, self.M))
        out[:, :, :, self.cell_index] = d
        return out.reshape(k, self.qp_layout, self.M)

    def grad(self, u: torch.Tensor) -> torch.Tensor:
        """Displacement gradient [g, vs, K*Q*M] of a node-major dof vector
        (observation path; masked where the view owns no simplex)."""
        dtype, device = u.dtype, u.device
        U = self._corner_dofs(self.to_grid_major(u).reshape(self.vs, self.M))
        U = U.reshape(self.n_nodes, self.vs, self.M)
        parts = []
        for kls in range(self.n_classes):
            m = self.mask if self.class_mask is None else self.class_mask[kls]
            dN = torch.as_tensor(self.class_dN_host[kls], dtype=dtype, device=device)
            Uk = torch.stack([U[c] for c in self.class_channels[kls]]) * m.to(dtype)
            # [g, vs, Q, M]: sum_a dN[a, i, q] Uk[a, j, m]
            parts.append((dN[:, :, None, :, None] * Uk[:, None, :, None, :]).sum(dim=0))
        return torch.stack(parts, dim=2).reshape(self.gdim, self.vs, self.qp_layout * self.M)

    # -- Jacobi diagonal from the folded strain rows ----------------------------

    def element_diag_gm(self, tangent) -> torch.Tensor:
        """The per-corner diagonal blocks [n*vs, M] before assembly, B^T C B
        with B the per-corner columns of KEPS_c (broadcast multiplies and
        sums)."""
        B = self.KEPS_c.reshape(self.sdim, self.qp_layout, self.n_nodes * self.vs)
        w = self.diag_w  # [K*Q]
        qpm = self._qp_mask(self.dtype)
        rows = []
        for a in range(self.n_nodes):
            # B_a [s, vs, K*Q, 1] broadcasts against tangent fields [K*Q, M]
            B_a = B[:, :, a * self.vs : (a + 1) * self.vs].permute(0, 2, 1)[..., None]
            q = tangent.quad_diag(B_a) * w[:, None]
            q = q.expand(self.vs, self.qp_layout, self.M) * qpm
            rows.append(q.sum(dim=1))
        return torch.cat(rows, dim=0)


def restrict_structured_tet_geometry(
    geo: StructuredTetGeometry, cells
) -> StructuredTetGeometry:
    """The masked view of a law on a subset of a Kuhn box's simplices.

    Simplex t = cube * K + class, so a law's cells become a per-class
    ownership mask [K, M] over the cube origins, applied by every engine op
    through ``_qp_mask``: the simplex analog of
    ``restrict_structured_geometry``. The view shares every other buffer.
    """
    cells = np.asarray(cells, np.int64)
    K = geo.n_classes
    origins = geo.cell_index.cpu().numpy()
    cm = np.zeros((K, geo.M))
    cm[cells % K, origins[cells // K]] = 1.0
    return StructuredTetGeometry(
        n_classes=K,
        class_dN_host=geo.class_dN_host,
        class_channels=geo.class_channels,
        class_mask=torch.as_tensor(cm, dtype=geo.dtype, device=geo.device),
        tet_index=torch.as_tensor(cells, dtype=torch.int64, device=geo.device),
        **_base_fields(geo, n_cells=len(cells)),
    )


def build_structured_tet_geometry(
    space, q_degree: int, constraint: Constraint, *, device="cuda", dtype: torch.dtype
) -> StructuredTetGeometry:
    """Flat-index geometry for the Kuhn simplex boxes of unit_cube_mesh
    ('tetra', 6 classes) and unit_square_mesh('triangle', 2 classes), with
    mesh.structured_shape set. Raises ValueError for any other mesh,
    including a box that is not the unit one."""
    from ..fem.elements import tabulate_element
    from ..fem.kinematics import _geometry_grad_at

    mesh = space.mesh
    grid = mesh.structured_shape
    if grid is None or mesh.cell_type not in ("tetra", "triangle"):
        msg = "the structured-tet engine needs a Kuhn box mesh of tetra or triangle cells"
        raise ValueError(msg)
    if space.degree != 1:
        msg = "the structured-tet engine supports degree-1 spaces only"
        raise ValueError(msg)

    elem, quad = tabulate_element(mesh.cell_type, space.degree, q_degree)
    geom_dN = _geometry_grad_at(mesh.cell_type, quad.points)
    gdim = len(grid)
    sdim = constraint.stress_strain_dim
    Q = quad.points.shape[0]
    vs = space.value_size
    M_map = mandel._mandel_matrix_map(constraint)

    node_grid = tuple(g + 1 for g in grid)
    strides = [1]
    for L in reversed(node_grid[1:]):
        strides.append(strides[-1] * L)
    strides = list(reversed(strides))
    offs = _corner_offsets(gdim)  # channel a = dx + 2 dy + 4 dz
    flat_offsets = tuple(int(sum(o * st for o, st in zip(off, strides))) for off in offs)

    # the first K mesh cells are the K classes of box (0, .., 0); every other
    # box repeats them translated (fem/mesh.py orderings)
    K = mesh.num_cells // int(np.prod(grid))
    n_ch = len(offs)
    KEPS_c = np.zeros((sdim * K * Q, n_ch * vs))
    w_flat = np.zeros(K * Q)
    class_dN, class_channels = [], []
    for k in range(K):
        verts = mesh.nodes[mesh.cells[k]]  # [gdim + 1, gdim]
        # box-corner bit pattern of each vertex -> channel a = sum_d bit_d << d
        scaled = verts * np.asarray(grid)
        bits = np.rint(scaled).astype(int)
        if bits.min() < 0 or bits.max() > 1 or not np.allclose(scaled, bits, atol=1e-9):
            msg = (
                "build_structured_tet_geometry: the first box's vertices scaled by the "
                "grid are not 0/1 corner bits, so the mesh is not a unit-domain Kuhn box "
                "(unit_cube_mesh/unit_square_mesh orderings); run it on the gather or "
                "windowed engine (a mesh without structured_shape)"
            )
            raise ValueError(msg)
        channels = [int(sum(int(b[d]) << d for d in range(gdim))) for b in bits]
        J = np.einsum("vi,qvj->qij", verts, geom_dN)
        detJ = np.abs(np.linalg.det(J))
        dN = np.einsum("qaj,qji->aiq", elem.dN_dxi, np.linalg.inv(J))  # [gdim+1, g, Q]
        class_dN.append(dN)
        class_channels.append(tuple(channels))
        # strain rows (s, k, q) of the class: sum_i M[s, i, j] dN[v, i, q] on
        # the channel of vertex v
        Bk = np.einsum("sij,viq->sqvj", M_map, dN)  # [s, Q, gdim+1, vs]
        rows = KEPS_c.reshape(sdim, K, Q, n_ch, vs)
        for v, a in enumerate(channels):
            rows[:, k, :, a, :] += Bk[:, :, v, :]
        w_flat[k * Q : (k + 1) * Q] = quad.weights * detJ

    KDIV_c = KEPS_c.T.copy()
    for kq in range(K * Q):
        KDIV_c[:, [s * (K * Q) + kq for s in range(sdim)]] *= w_flat[kq]
    KE_I = np.zeros((n_ch * vs, n_ch * vs))
    KE_V = np.zeros((n_ch * vs, n_ch * vs))
    n_diag = min(3, sdim)
    for kq in range(K * Q):
        B_q = KEPS_c[[s * (K * Q) + kq for s in range(sdim)], :]
        KE_I += w_flat[kq] * (B_q.T @ B_q)
        bv = B_q[:n_diag].sum(axis=0)
        KE_V += w_flat[kq] * np.outer(bv, bv)

    idx_nd = np.indices(node_grid)
    valid = np.ones(node_grid, bool)
    for d in range(gdim):
        valid &= idx_nd[d] < grid[d]
    mask = valid.reshape(-1).astype(np.float64)

    def dev(x, dt=dtype):
        return torch.as_tensor(x, dtype=dt, device=device)

    return StructuredTetGeometry(
        n_classes=K,
        class_dN_host=class_dN,
        class_channels=class_channels,
        KEPS_c=dev(KEPS_c),
        KDIV_c=dev(KDIV_c),
        KE_I=dev(KE_I),
        KE_V=dev(KE_V),
        mask=dev(mask),
        cell_index=dev(np.flatnonzero(mask), torch.int64),
        grid=tuple(grid),
        vs=vs,
        ndofs=space.ndofs,
        constraint=constraint,
        n_nodes=n_ch,  # the cube's corner channels, not the simplex's vertices
        n_qp=Q,  # per simplex
        n_cells=int(K * np.prod(grid)),
        offsets=flat_offsets,
        dN_host=np.zeros((0,)),  # the hex tabulation; class_dN_host replaces it
        w_host=w_flat,
    )


# ---------------------------------------------------------------------------
# Degree-2 spaces on box meshes: the lattice engine
# ---------------------------------------------------------------------------


class LatticeGeometry(nn.Module):
    """Degree-d tensor-product stencil engine on a box of hexes or quads whose
    dof nodes are lattice-ordered (``FunctionSpace`` renumbers degree-2 dofs
    row-major, x slowest, so they form the node lattice of the d-times
    refined grid, ``lattice = d * grid + 1`` per axis).

    A cell's local node a sits at lattice offset ``_local_offset(a)`` (x
    fastest digit, the element's tensor ordering) from its origin ``d * c``,
    so the element gather is the (d+1)^gdim STATIC STRIDED SLICES of the
    [vs, *lattice] grid (``_cell_slices``), taken as one strided view, and
    the scatter its transpose, d + 1 strided adds per axis in a fixed order:
    no gather, no atomics, deterministic.

      * strain:   ``e = KEPS_c @ U``, U [n*vs, C] the stacked slices;
      * residual: ``F = KDIV_c @ sigma`` (weights folded), then the slice adds.

    Both products go through ``_matmul`` (never TF32) and nothing is a
    convolution, so cuDNN (TF32 by default, atomics in its backward-data
    algorithms) is never called. Cell and quadrature fields are DENSE
    ``[k, Q, C]`` in mesh cell order, so the observation maps are identities.

    The operator ``matvec_gm`` of an IsotropicTangent on 3D 27-node hexes
    with 27 Gauss points (FULL) runs on CUDA tensors as the hand-written
    kernel K8 (``ops/cuda_lattice.py``: one launch, sum-factorised, no
    intermediate in device memory); the products above are its plain twin,
    which CPU tensors, quads, DenseTangents and every other op run.

    Buffers: KEPS_c [s*Q, n*vs], KDIV_c [n*vs, s*Q], w [Q] (quadrature weight
    x |det J|, for the Jacobi diagonal). Host constant: ``dN_host`` ([n, g,
    Q] physical gradients).
    """

    #: the engine this geometry serves (``PackedSimulation.engine``)
    engine = "lattice"

    KEPS_c: torch.Tensor
    KDIV_c: torch.Tensor
    w: torch.Tensor

    def __init__(self, *, KEPS_c, KDIV_c, w, grid, degree, vs, ndofs, constraint, n_nodes,
                 n_qp, dN_host):
        super().__init__()
        self.register_buffer("KEPS_c", KEPS_c)
        self.register_buffer("KDIV_c", KDIV_c)
        self.register_buffer("w", w)
        self.grid = tuple(grid)
        self.degree = degree
        self.lattice = tuple(degree * g + 1 for g in grid)
        self.vs = vs
        self.ndofs = ndofs
        self.constraint = constraint
        self.n_nodes = n_nodes
        self.n_qp = n_qp
        self.n_cells = int(np.prod(grid))
        self.dN_host = dN_host

    @property
    def gdim(self) -> int:
        return len(self.grid)

    @property
    def sdim(self) -> int:
        return self.constraint.stress_strain_dim

    @property
    def M(self) -> int:
        return int(np.prod(self.lattice))

    @property
    def N(self) -> int:
        return self.n_qp * self.n_cells

    @property
    def dtype(self) -> torch.dtype:
        return self.KEPS_c.dtype

    @property
    def device(self) -> torch.device:
        return self.KEPS_c.device

    def qp_shape(self, k: int) -> tuple:
        return (k, self.n_qp, self.n_cells)

    # dense mesh-order cell fields: the observation maps are identities
    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        return field

    def insert_cells(self, dense: torch.Tensor, dtype=None) -> torch.Tensor:
        return dense if dtype is None else dense.to(dtype)

    # -- layout plumbing --------------------------------------------------------

    def to_grid_major(self, u: torch.Tensor) -> torch.Tensor:
        return u.reshape(self.M, self.vs).T.reshape(-1)

    def to_node_major(self, u_gm: torch.Tensor) -> torch.Tensor:
        return u_gm.reshape(self.vs, self.M).T.reshape(-1)

    def _local_offset(self, a: int) -> tuple:
        """Local node a -> its lattice offsets from the cell origin (x fastest
        digit, the element's tensor ordering)."""
        nb = self.degree + 1
        rem, locs = a, []
        for _ in range(self.gdim):
            locs.append(rem % nb)
            rem //= nb
        return tuple(locs)

    def _cell_slices(self, a: int) -> tuple:
        """Per axis, the lattice slice that holds local node a of every cell."""
        off, d = self._local_offset(a), self.degree
        return tuple(slice(off[k], off[k] + d * (self.grid[k] - 1) + 1, d)
                     for k in range(self.gdim))

    def _elem_dofs_cm(self, u_cm: torch.Tensor) -> torch.Tensor:
        """[vs, M] component-major -> [n*vs, C] element dof blocks.

        Every ``_cell_slices(a)`` at once: one strided view of the lattice,
        [o_{g-1}, .., o_0, j, c_0, .., c_{g-1}] (row (a, j) with a = o_0 +
        (d+1) o_1 + .., the cell's offset d c_k + o_k along axis k), copied
        in one pass."""
        g = u_cm.reshape((self.vs, *self.lattice)).contiguous()
        st = g.stride()
        nb, d, gdim = self.degree + 1, self.degree, self.gdim
        view = g.as_strided(
            (nb,) * gdim + (self.vs, *self.grid),
            tuple(st[k + 1] for k in reversed(range(gdim))) + (st[0],)
            + tuple(d * st[k + 1] for k in range(gdim)),
            g.storage_offset(),
        )
        return view.reshape(self.n_nodes * self.vs, self.n_cells)

    def _scatter_nodes(self, F: torch.Tensor) -> torch.Tensor:
        """[n*vs, C] per-node forces -> grid-major [vs*M]: the transpose of
        ``_elem_dofs_cm``, one axis at a time. Along axis k the cells' local
        offsets o_k = 0..d land at lattice index d c_k + o_k; they are added in
        the order o_k = 0, 1, .., d (d + 1 strided adds per axis, each lattice
        node's terms in a fixed order, no atomics)."""
        d, gdim = self.degree, self.gdim
        # [o_{g-1}, .., o_0, j, c...] -> [j, o_0, .., o_{g-1}, c_0, .., c_{g-1}]
        X = F.reshape((d + 1,) * gdim + (self.vs, *self.grid))
        X = X.permute((gdim, *range(gdim - 1, -1, -1), *range(gdim + 1, 2 * gdim + 1)))
        for k in range(gdim):
            # X: [j, o_k, .., o_{g-1}, L_0, .., L_{k-1}, c_k, ..]; c_k sits at dim gdim of X[:, o]
            shape = list(X.shape[:1] + X.shape[2:])
            shape[gdim] = self.lattice[k]
            Y = X.new_zeros(shape)
            for o in range(d + 1):
                sl = (slice(None),) * gdim + (slice(o, o + d * (self.grid[k] - 1) + 1, d),)
                Y[sl] += X[:, o]
            X = Y
        return X.reshape(-1)

    # -- grid-major hot-path ops --------------------------------------------------

    def strain_gm(self, u_gm: torch.Tensor) -> torch.Tensor:
        """Mandel strain of a grid-major dof vector: [s, Q, C]."""
        U = self._elem_dofs_cm(u_gm.reshape(self.vs, self.M))
        e = _matmul(self.KEPS_c.to(U.dtype), U)
        return e.reshape(self.sdim, self.n_qp, self.n_cells)

    def assemble_gm(self, F: torch.Tensor) -> torch.Tensor:
        """Per-cell arrays [n*vs, C] (``element_forces_gm``,
        ``element_diag_gm``) -> the grid-major assembled vector [vs*M]."""
        return self._scatter_nodes(F)

    def element_forces_gm(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, C] -> per-node forces [n*vs, C], before assembly."""
        sig = sigma.reshape(self.sdim * self.n_qp, self.n_cells)
        return _matmul(self.KDIV_c.to(sig.dtype), sig)

    def residual_gm(self, sigma: torch.Tensor) -> torch.Tensor:
        """sigma [s, Q, C] -> grid-major assembled force [vs*M]."""
        return self.assemble_gm(self.element_forces_gm(sigma))

    def matvec_gm(self, v_gm: torch.Tensor, tangent) -> torch.Tensor:
        """The tangent operator on grid-major vectors [vs*M] -> [vs*M]. On a
        CUDA vector where ``cuda_lattice.lattice_apply_form`` holds (an
        IsotropicTangent on 3D 27-node hexes with 27 Gauss points, FULL) it
        runs as ONE launch of K8 (``ops/cuda_lattice.py::lattice_apply``);
        everywhere else as the strain, the tangent's ``apply`` and the
        residual below, K8's twin."""
        if v_gm.is_cuda:
            from .cuda_lattice import lattice_apply, lattice_apply_form

            if lattice_apply_form(self, tangent):
                return lattice_apply(self, v_gm.reshape(-1), tangent)
        return self.residual_gm(tangent.apply(self.strain_gm(v_gm)))

    def jacobi_diag_gm(self, tangent) -> torch.Tensor:
        """diag(A) in grid-major layout via per-node B^T C B."""
        return self.assemble_gm(self.element_diag_gm(tangent))

    def element_diag_gm(self, tangent) -> torch.Tensor:
        """The per-node diagonal blocks [n*vs, C] before assembly, B the
        node's columns of KEPS_c: broadcast multiplies and sums, never a
        product that could run in TF32."""
        KE = self.KEPS_c.reshape(self.sdim, self.n_qp, self.n_nodes, self.vs)
        rows = []
        for a in range(self.n_nodes):
            B_a = KE[:, :, a, :].permute(0, 2, 1)[..., None]  # [s, vs, Q, 1]
            q = tangent.quad_diag(B_a).expand(self.vs, self.n_qp, self.n_cells)
            rows.append((q * self.w[None, :, None]).sum(dim=1))
        return torch.cat(rows, dim=0)

    # -- node-major engine interface ---------------------------------------------

    def strain(self, u: torch.Tensor) -> torch.Tensor:
        return self.strain_gm(self.to_grid_major(u))

    def residual(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.to_node_major(self.residual_gm(sigma))

    def matvec(self, v: torch.Tensor, tangent) -> torch.Tensor:
        return self.to_node_major(self.matvec_gm(self.to_grid_major(v), tangent))

    def jacobi_diag(self, tangent) -> torch.Tensor:
        return self.to_node_major(self.jacobi_diag_gm(tangent))

    def grad(self, u: torch.Tensor) -> torch.Tensor:
        """Full displacement gradient [g, vs, Q*C] of a node-major dof vector
        (observation path)."""
        U = self._elem_dofs_cm(self.to_grid_major(u).reshape(self.vs, self.M))
        U = U.reshape(self.n_nodes, self.vs, self.n_cells)
        dN = torch.as_tensor(self.dN_host, dtype=u.dtype, device=u.device)  # [n, g, Q]
        out = (dN[:, :, None, :, None] * U[:, None, :, None, :]).sum(dim=0)  # [g, vs, Q, C]
        return out.reshape(self.gdim, self.vs, self.N)


def build_lattice_geometry(
    space, q_degree: int, constraint: Constraint, *, device="cuda", dtype: torch.dtype
) -> LatticeGeometry:
    """Lattice stencil engine for a degree-2 space on a box mesh of hexes
    (unit_cube_mesh) or quads (unit_square_mesh) with lattice-ordered dofs."""
    from ..fem.elements import tabulate_element
    from ..fem.kinematics import _geometry_grad_at

    mesh = space.mesh
    grid = mesh.structured_shape
    if grid is None or mesh.cell_type not in ("hex", "quad"):
        msg = "the lattice engine needs a box mesh of hex or quad cells"
        raise ValueError(msg)
    d = space.degree
    if d < 2:
        msg = "the lattice engine takes degree >= 2; degree 1 runs on the structured engine"
        raise ValueError(msg)

    elem, quad = tabulate_element(mesh.cell_type, d, q_degree)
    verts = mesh.nodes[mesh.cells[0]]
    geom_dN = _geometry_grad_at(mesh.cell_type, quad.points)
    J = np.einsum("vi,qvj->qij", verts, geom_dN)
    detJ = np.abs(np.linalg.det(J))
    dN = np.einsum("qaj,qji->aiq", elem.dN_dxi, np.linalg.inv(J))  # [n, g, Q]
    w = quad.weights * detJ  # [Q]

    sdim = constraint.stress_strain_dim
    n = elem.N.shape[1]
    Q = quad.points.shape[0]
    vs = space.value_size
    M_map = mandel._mandel_matrix_map(constraint)

    KE = np.einsum("sij,aiq->sqaj", M_map, dN)  # [s, Q, n, vs]
    KEPS_c = KE.reshape(sdim * Q, n * vs)
    KDIV_c = (KE * w[None, :, None, None]).reshape(sdim * Q, n * vs).T.copy()

    lattice = tuple(d * g + 1 for g in grid)
    if space.n_dof_nodes != int(np.prod(lattice)) or not np.allclose(
        space.dof_coords[0], mesh.nodes.min(axis=0)
    ):
        msg = "the space's dof nodes are not lattice-ordered (FunctionSpace on a box mesh)"
        raise ValueError(msg)

    def dev(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return LatticeGeometry(
        KEPS_c=dev(KEPS_c), KDIV_c=dev(KDIV_c), w=dev(w), grid=tuple(grid), degree=d, vs=vs,
        ndofs=space.ndofs, constraint=constraint, n_nodes=n, n_qp=Q, dN_host=dN,
    )


# ---------------------------------------------------------------------------
# Slabs of a box: the rank-local geometries of a sharded problem
# ---------------------------------------------------------------------------


def slab_geometry(geo, x0: int, x1: int) -> tuple:
    """The geometry of the cells ``x0 <= ix < x1`` of a box, as a box of its own.

    Axis 0 is the slowest axis of the flat node order (and of the mesh's cell
    order), so the slab's nodes are ONE contiguous range ``[lo, lo + M_s)`` of
    ``geo``'s grid-major vectors: ``u_gm.reshape(vs, M)[:, lo:lo + M_s]`` is
    the slab's own grid-major vector, and its assembled forces go back into
    the same range. The slab shares every constant (the corner offsets do not
    depend on axis 0) and sweeps its own nodes only: its fields are ``[k,
    qp_layout, M_s]`` (StructuredGeometry, StructuredTetGeometry) or ``[k, Q,
    C_s]`` (LatticeGeometry). A subset view keeps the law's cells that fall in
    the slab. Returns ``(slab, lo, pos)``: ``pos`` indexes ``geo``'s dense cell
    axis (``extract_cells`` order) at the cells the slab keeps, in the slab's
    own order.
    """
    X = geo.grid[0]
    if not 0 <= x0 < x1 <= X:
        msg = f"slab [{x0}, {x1}) is not a non-empty cell range of axis 0 (0..{X})"
        raise ValueError(msg)
    grid = (x1 - x0, *geo.grid[1:])
    n_plane = int(np.prod(geo.grid[1:]))  # cells of one x layer
    if isinstance(geo, LatticeGeometry):
        plane = int(np.prod(geo.lattice[1:]))
        slab = LatticeGeometry(
            KEPS_c=geo.KEPS_c, KDIV_c=geo.KDIV_c, w=geo.w, grid=grid, degree=geo.degree,
            vs=geo.vs, ndofs=geo.vs * (geo.degree * (x1 - x0) + 1) * plane,
            constraint=geo.constraint, n_nodes=geo.n_nodes, n_qp=geo.n_qp, dN_host=geo.dN_host,
        )
        return slab, geo.degree * x0 * plane, np.arange(x0 * n_plane, x1 * n_plane)
    plane = int(np.prod([g + 1 for g in geo.grid[1:]]))  # nodes of one x plane
    lo, M_s = x0 * plane, (x1 - x0 + 1) * plane
    top = (x1 - x0) * plane  # the slab's last node plane holds no cell origin

    def cut(t: torch.Tensor) -> torch.Tensor:
        out = t[..., lo : lo + M_s].clone()
        out[..., top:] = 0
        return out

    ci = geo.cell_index.cpu().numpy()
    keep = (ci >= lo) & (ci < lo + top)
    cell_index = torch.as_tensor(ci[keep] - lo, dtype=torch.int64, device=geo.device)
    base = _base_fields(geo, grid=grid, mask=cut(geo.mask), cell_index=cell_index,
                        ndofs=geo.vs * M_s)
    if not isinstance(geo, StructuredTetGeometry):
        return StructuredGeometry(**{**base, "n_cells": int(keep.sum())}), lo, np.flatnonzero(keep)
    K = geo.n_classes
    first = x0 * n_plane  # the slab's first cube in mesh order
    if geo.tet_index is None:
        tet_index, pos = None, np.arange(first * K, x1 * n_plane * K)
    else:
        t = geo.tet_index.cpu().numpy()
        cube = t // K
        sel = (cube >= first) & (cube < x1 * n_plane)
        pos = np.flatnonzero(sel)
        tet_index = torch.as_tensor((cube[sel] - first) * K + t[sel] % K, dtype=torch.int64,
                                    device=geo.device)
    slab = StructuredTetGeometry(
        n_classes=K, class_dN_host=geo.class_dN_host, class_channels=geo.class_channels,
        class_mask=None if geo.class_mask is None else cut(geo.class_mask),
        tet_index=tet_index, **{**base, "n_cells": len(pos)},
    )
    return slab, lo, pos
