"""Windowed exchange engine: gather/scatter for GENERAL unstructured meshes.

The port of ``fenics_constitutive_tpu.ops.windowed``. An imported mesh has
no grid to stencil over, so the element dof gather and the assembly scatter
are index ops. The plan keeps them local:

1.  **Reverse Cuthill-McKee** orders the dof-nodes so every cell's nodes span
    a narrow index window (the mesh bandwidth).
2.  Nodes are split into **tiles of T**; each cell is assigned to a
    tile-block whose **window** ``[b*T, b*T + W)`` covers all its nodes, with
    a greedy rebalance that keeps the per-block cell padding low.
3.  Per block, the cell-local rows ``[K, n*C_B]`` (node-slot-major, row =
    a*C_B + r) hold the window-local node index ``loc`` of every (slot,
    cell); ``-1`` marks a padded cell.

The gather ``out[b, k, r] = u[k, b*T + loc[b, r]]`` and its transpose, the
scatter, run as the hand-written CUDA kernels K4/K5 of ``ops/cuda_window.py``
on CUDA tensors and as the plain versions ``gather_ref``/``scatter_ref`` on
CPU tensors. For the scatter the plan also holds a node-major transpose
(``node_ptr``/``node_rows``: the (b, r) rows feeding each padded node in
ascending order), so the kernel sums each node's contributions in a fixed
order, with no float atomics.

The engine's internal dof vector is component-major over RCM-permuted,
tile-padded nodes, ``idx = comp * M_pad + rcm_node``. ``WindowedGeometry``
is the solver-facing geometry on that layout.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from ..utils.timers import scope
from . import mandel
from .mandel import Constraint
from .packed import CellSlots, DenseTangent
from .structured import _matmul

__all__ = [
    "WindowedExchange",
    "WindowedGeometry",
    "build_windowed_exchange",
    "build_windowed_geometry",
    "reverse_cuthill_mckee",
]


def reverse_cuthill_mckee(cell_nodes: np.ndarray, n_nodes: int) -> np.ndarray:
    """RCM ordering of the node graph induced by shared-cell adjacency.

    Returns ``perm_old2new`` with ``perm_old2new[old_id] = new_id``; the new
    numbering has small bandwidth ``max |new(a) - new(b)|`` over cell edges.
    Host-side, runs once per mesh. Handles disconnected components.
    """
    _C, n = cell_nodes.shape
    # undirected edge list: all node pairs within a cell
    ii, jj = np.triu_indices(n, k=1)
    a = cell_nodes[:, ii].reshape(-1)
    b = cell_nodes[:, jj].reshape(-1)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    edges = np.unique(lo.astype(np.int64) * n_nodes + hi)
    lo = (edges // n_nodes).astype(np.int64)
    hi = (edges % n_nodes).astype(np.int64)
    # CSR adjacency (both directions)
    src = np.concatenate([lo, hi])
    dst = np.concatenate([hi, lo])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(src, minlength=n_nodes)
    starts = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    degree = counts

    # neighbours of each node pre-sorted by (degree, id), so the BFS append
    # is a filtered slice
    key = degree[dst] * np.int64(n_nodes) + dst
    for v in range(n_nodes):
        s, e = starts[v], starts[v + 1]
        sub = np.argsort(key[s:e], kind="stable")
        dst[s:e] = dst[s:e][sub]

    visited = np.zeros(n_nodes, bool)
    order_new = np.empty(n_nodes, np.int64)
    pos = 0
    remaining = np.argsort(degree, kind="stable")  # component seeds by degree
    seed_ptr = 0
    while pos < n_nodes:
        while visited[remaining[seed_ptr]]:
            seed_ptr += 1
        root = remaining[seed_ptr]
        visited[root] = True
        order_new[pos] = root
        head, pos = pos, pos + 1
        while head < pos:
            v = order_new[head]
            head += 1
            nbrs = dst[starts[v] : starts[v + 1]]
            new = nbrs[~visited[nbrs]]
            if len(new):
                # dedup while keeping the degree-sorted order
                _, first = np.unique(new, return_index=True)
                new = new[np.sort(first)]
                visited[new] = True
                order_new[pos : pos + len(new)] = new
                pos += len(new)
    order_new = order_new[::-1]  # the "reverse" in RCM
    perm = np.empty(n_nodes, np.int64)
    perm[order_new] = np.arange(n_nodes)
    return perm


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class WindowedExchange(nn.Module):
    """Blocked exchange plan between node rows ``[K, M_pad]`` and cell-local
    rows ``[B, K, n * C_B]`` (node-slot-major within a block: row = a*C_B+r).

    Buffers:
      loc: [B, n * C_B] int32, window-local node index of each (slot, cell)
          row, -1 for padded cells (reads give 0, writes drop).
      node_ptr: [M_pad + 1] int32 and node_rows: [nnz] int32, the node-major
          transpose of ``loc``: the flat rows ``b * Rn + r`` that feed padded
          node m are ``node_rows[node_ptr[m]:node_ptr[m + 1]]``, ascending.
    Host numpy: ``perm`` (old node -> RCM id) and ``cell_order`` (plan cell
    slot -> original cell id, -1 padding).
    """

    loc: torch.Tensor
    node_ptr: torch.Tensor
    node_rows: torch.Tensor

    def __init__(self, *, loc, node_ptr, node_rows, T, W, P, B, C_B, n, M, M_pad,
                 n_cells, perm, cell_order, pad_ratio):
        super().__init__()
        self.register_buffer("loc", loc)
        self.register_buffer("node_ptr", node_ptr)
        self.register_buffer("node_rows", node_rows)
        self.T, self.W, self.P, self.B, self.C_B, self.n = T, W, P, B, C_B, n
        self.M, self.M_pad, self.n_cells = M, M_pad, n_cells
        self.perm = perm
        self.cell_order = cell_order
        self.pad_ratio = pad_ratio

    @property
    def C_pad(self) -> int:
        return self.B * self.C_B

    @property
    def Rn(self) -> int:
        return self.n * self.C_B

    # -- plain versions (CPU tensors; the CUDA kernels' references) ----------

    def _global_idx(self) -> torch.Tensor:
        base = torch.arange(self.B, device=self.loc.device)[:, None] * self.T
        g = self.loc.long() + base
        return torch.where(self.loc >= 0, g, self.M_pad)  # [B, Rn] in [0, M_pad]

    def gather_ref(self, u2: torch.Tensor) -> torch.Tensor:
        """[K, M_pad] node rows -> [B, K, Rn] cell-local rows (pads 0)."""
        gi = self._global_idx()
        u_ext = torch.cat([u2, u2.new_zeros((u2.shape[0], 1))], dim=1)
        return u_ext[:, gi].permute(1, 0, 2)

    def scatter_ref(self, f: torch.Tensor) -> torch.Tensor:
        """[B, K, Rn] cell-local rows -> [K, M_pad] node rows (dups summed)."""
        gi = self._global_idx().reshape(-1)
        K = f.shape[1]
        out = f.new_zeros((K, self.M_pad + 1))
        out.index_add_(1, gi, f.permute(1, 0, 2).reshape(K, -1))
        return out[:, : self.M_pad]

    # -- dispatch: the kernel on the card, the plain version on the CPU ------

    def gather(self, u2: torch.Tensor) -> torch.Tensor:
        """[K, M_pad] node rows -> [B, K, Rn] cell-local rows."""
        if u2.is_cuda:
            from .cuda_window import windowed_gather

            return windowed_gather(self, u2)
        return self.gather_ref(u2)

    def scatter(self, f: torch.Tensor) -> torch.Tensor:
        """[B, K, Rn] cell-local rows -> [K, M_pad] node rows (dups summed)."""
        if f.is_cuda:
            from .cuda_window import windowed_scatter

            return windowed_scatter(self, f)
        return self.scatter_ref(f)

    # -- layout helpers ---------------------------------------------------------

    def cells_to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """[n, K, C_pad] (slot-major cell data) -> [B, K, Rn] block rows."""
        n, K, _ = x.shape
        x4 = x.reshape(n, K, self.B, self.C_B)
        return x4.permute(2, 1, 0, 3).reshape(self.B, K, self.Rn)

    def rows_to_cells(self, r: torch.Tensor) -> torch.Tensor:
        """[B, K, Rn] block rows -> [n, K, C_pad]."""
        K = r.shape[1]
        r4 = r.reshape(self.B, K, self.n, self.C_B)
        return r4.permute(2, 1, 0, 3).reshape(self.n, K, self.C_pad)


def build_windowed_exchange(
    cell_nodes: np.ndarray,
    n_nodes: int,
    *,
    device,
    tile: int = 1024,
    max_pad_ratio: float = 4.0,
    perm: np.ndarray | None = None,
) -> WindowedExchange:
    """Build the blocked window plan for ``cell_nodes`` [C, n].

    tile: nodes per block (T); windows are W = ceil((T + span_max)/T) * T.
    max_pad_ratio: a plan with more padded cell slots than this per cell
        warns.
    perm: precomputed node ordering (old -> new); default computes RCM of
        ``cell_nodes``.
    """
    cell_nodes = np.asarray(cell_nodes, np.int64)
    C, n = cell_nodes.shape
    T = int(tile)

    if perm is None:
        perm = reverse_cuthill_mckee(cell_nodes, n_nodes)
    else:
        perm = np.asarray(perm, np.int64)
    cn = perm[cell_nodes]  # [C, n] RCM-relabelled
    lo = cn.min(axis=1)
    hi = cn.max(axis=1)
    span_max = int((hi - lo).max()) + 1 if C else 1

    M = n_nodes
    B = _round_up(M, T) // T
    M_pad = B * T
    P = min(1 + -(-span_max // T), B)  # window covers P tiles
    W = P * T

    # feasible block range per cell: window [bT, bT+W) must contain [lo, hi]
    b_hi = np.minimum(lo // T, B - 1)
    b_lo = np.maximum(0, (hi - W) // T + 1)

    # greedy balance: sweep cells by lo; within each b_hi group, spill to the
    # least-filled feasible earlier block
    counts = np.zeros(B, np.int64)
    assign = np.empty(C, np.int64)
    order = np.argsort(lo, kind="stable")
    for c in order:
        blo, bhi = int(b_lo[c]), int(b_hi[c])
        k = int(np.argmin(counts[blo : bhi + 1]))  # earliest least-filled
        assign[c] = blo + k
        counts[blo + k] += 1

    # block capacity rounded to 128 cells (the JAX package's lane alignment;
    # kept so that both packages build identical plans)
    C_B = _round_up(max(int(counts.max()), 1), 128)
    pad_ratio = (B * C_B) / max(C, 1)
    if pad_ratio > max_pad_ratio:
        import warnings

        warnings.warn(
            f"windowed exchange: block padding ratio {pad_ratio:.2f} "
            f"(B={B} x C_B={C_B} slots for {C} cells): the mesh ordering "
            "bunches cells; expect wasted compute. Consider a different "
            "tile size.",
            stacklevel=2,
        )

    # slot table: cells grouped by block (stable in lo-order), slot r = rank
    # within the group
    grp = np.argsort(assign[order], kind="stable")
    cells_grouped = order[grp]  # cells sorted by (block, lo)
    blocks_sorted = assign[cells_grouped]
    group_start = np.searchsorted(blocks_sorted, np.arange(B))
    r_in_block = np.arange(C) - group_start[blocks_sorted]
    slot = blocks_sorted * C_B + r_in_block  # [C] flat (b, r) slot

    cell_order = np.full(B * C_B, -1, np.int64)
    cell_order[slot] = cells_grouped

    loc = np.full((B, n, C_B), -1, np.int32)
    base = (blocks_sorted * T)[:, None]
    loc[blocks_sorted, :, r_in_block] = (cn[cells_grouped] - base).astype(np.int32)
    loc = loc.reshape(B, n * C_B)
    if loc.max() >= W or (loc < -1).any():
        msg = "windowed exchange: a cell's nodes fall outside its block window"
        raise RuntimeError(msg)

    # node-major transpose for the deterministic scatter: the flat rows
    # b * Rn + r feeding each padded node, ascending (pads in no list)
    flat = np.flatnonzero(loc.reshape(-1) >= 0)
    g = (loc + (np.arange(B) * T)[:, None]).reshape(-1)[flat]
    node_rows = flat[np.argsort(g, kind="stable")]
    node_ptr = np.zeros(M_pad + 1, np.int64)
    np.cumsum(np.bincount(g, minlength=M_pad), out=node_ptr[1:])

    def idx(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=device)

    return WindowedExchange(
        loc=idx(loc), node_ptr=idx(node_ptr), node_rows=idx(node_rows),
        T=T, W=W, P=P, B=B, C_B=C_B, n=n, M=M, M_pad=M_pad, n_cells=C,
        perm=perm, cell_order=cell_order, pad_ratio=float(pad_ratio),
    )


# =============================================================================
# WindowedGeometry: the general-unstructured-mesh engine
# =============================================================================


class WindowedGeometry(nn.Module):
    """SoA geometry for GENERAL (imported/unstructured) meshes.

    QP fields are stored q-major over the plan's padded sorted cell order
    (``N = n_qp * ex.C_pad``; padded slots carry zero weights and
    gradients). The internal dof vector is component-major over RCM-permuted,
    tile-padded nodes, ``idx = comp * M_pad + rcm_node``; ``to_internal`` /
    ``from_internal`` convert at the public boundary.

    Buffers: ``dN`` [n, g, C_pad] (affine cells: one copy per cell, shared by
    its QPs) or [n, g, N], ``w`` [N] (weight x |detJ|), ``perm_dev`` [M] (old
    node -> rcm id), ``invperm_dev`` [M], ``slot_of_cell`` [n_cells] (original
    cell -> plan slot), ``mandel_T`` [s, g, g] (the Mandel map of
    ``ops/mandel.py``); the exchange plan ``ex`` is a submodule.
    """

    #: the engine this geometry serves (``PackedSimulation.engine``)
    engine = "windowed"

    dN: torch.Tensor
    w: torch.Tensor
    mandel_T: torch.Tensor
    perm_dev: torch.Tensor
    invperm_dev: torch.Tensor
    slot_of_cell: torch.Tensor

    def __init__(self, *, ex: WindowedExchange, dN, w, perm_dev, invperm_dev,
                 slot_of_cell, n_qp: int, n_nodes: int, vs: int, ndofs: int,
                 M: int, n_cells: int, constraint: Constraint):
        super().__init__()
        self.ex = ex
        self.register_buffer("dN", dN)
        self.register_buffer("w", w)
        self.register_buffer("perm_dev", perm_dev)
        self.register_buffer("invperm_dev", invperm_dev)
        self.register_buffer("slot_of_cell", slot_of_cell)
        self.n_qp, self.n_nodes, self.vs = n_qp, n_nodes, vs
        self.ndofs, self.M, self.n_cells = ndofs, M, n_cells
        self.constraint = constraint
        T = mandel._mandel_matrix_map(constraint)
        self.register_buffer("mandel_T", torch.as_tensor(T, dtype=w.dtype, device=w.device))
        #: host seconds of the build: rcm, plan, geometry (tabulation, upload)
        self.build_seconds: dict[str, float] = {}

    @property
    def N(self) -> int:
        return self.n_qp * self.ex.C_pad

    @property
    def ndofs_int(self) -> int:
        return self.vs * self.ex.M_pad

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def device(self) -> torch.device:
        return self.w.device

    @property
    def compact(self) -> bool:
        """True when dN holds one copy per cell (affine elements)."""
        return self.dN.shape[2] != self.N

    def qp_shape(self, k: int) -> tuple:
        return (k, self.N)

    # -- boundary transforms ---------------------------------------------------

    def to_internal(self, u: torch.Tensor) -> torch.Tensor:
        """External node-major [ndofs] -> internal [vs * M_pad]."""
        u2 = u.reshape(self.M, self.vs).T  # [vs, M]
        out = u.new_zeros((self.vs, self.ex.M_pad))
        out[:, : self.M] = u2[:, self.invperm_dev]
        return out.reshape(-1)

    def from_internal(self, ui: torch.Tensor) -> torch.Tensor:
        """Internal [vs * M_pad] -> external node-major [ndofs]."""
        u2 = ui.reshape(self.vs, self.ex.M_pad)
        return u2[:, self.perm_dev].T.reshape(-1)

    def bc_internal(self, bc_dofs: torch.Tensor) -> torch.Tensor:
        node = bc_dofs // self.vs
        comp = bc_dofs % self.vs
        return comp * self.ex.M_pad + self.perm_dev[node]

    def free_internal(self, bc_dofs: torch.Tensor) -> torch.Tensor:
        """True on real, non-Dirichlet internal slots (pads excluded)."""
        valid = torch.zeros(self.ex.M_pad, dtype=torch.bool, device=self.device)
        valid[: self.M] = True
        free = valid.repeat(self.vs)
        free[self.bc_internal(bc_dofs)] = False
        return free

    # -- kinematics / assembly (internal layout) --------------------------------
    # The tiny contractions (n <= 10 nodes, g = vs <= 3, s <= 6) are written
    # as broadcast multiplies and sums, and the Mandel map as a product that
    # never runs in TF32 (structured._matmul). For affine cells the gradient
    # is formed once per cell and broadcast to its QPs.

    def _to_qp(self, x: torch.Tensor) -> torch.Tensor:
        """[..., C_pad] per-cell values -> [..., N] q-major (identical per QP)."""
        lead = x.shape[:-1]
        return x[..., None, :].expand(*lead, self.n_qp, self.ex.C_pad).reshape(
            *lead, self.N
        )

    def _u_cells(self, ui: torch.Tensor) -> torch.Tensor:
        rows = self.ex.gather(ui.reshape(self.vs, self.ex.M_pad))
        return self.ex.rows_to_cells(rows)  # [n, vs, C_pad]

    def strain(self, du: torch.Tensor) -> torch.Tensor:
        """Internal [vs*M_pad] -> Mandel strain [s, N]."""
        u_e = self._u_cells(du)
        if not self.compact:
            u_e = self._to_qp(u_e)
        # grad[i, j] = sum_a dN[a, i] u[a, j]
        grad = (self.dN[:, :, None, :] * u_e[:, None, :, :]).sum(dim=0)
        T = self.mandel_T.to(du.dtype)
        s, g = T.shape[0], T.shape[1]
        eps = _matmul(T.reshape(s, g * g), grad.reshape(g * self.vs, -1))
        return self._to_qp(eps) if self.compact else eps

    def residual(self, sigma: torch.Tensor) -> torch.Tensor:
        """Mandel stress [s, N] -> internal residual [vs*M_pad]."""
        return self.ex.scatter(self.cell_forces(sigma)).reshape(-1)

    def cell_forces(self, sigma: torch.Tensor) -> torch.Tensor:
        """Mandel stress [s, N] -> each cell's nodal forces as the block rows
        [B, vs, Rn] the scatter (K5) sums."""
        T = self.mandel_T.to(sigma.dtype)
        s, g = T.shape[0], T.shape[1]
        # sig_t[i, j] = w * sum_s T[s, i, j] sigma[s]
        sig_t = _matmul(T.reshape(s, g * g).T, sigma) * self.w
        sig_t = sig_t.reshape(g, g, self.n_qp, self.ex.C_pad)
        if self.compact:
            # f[a, j] = sum_i dN[a, i] sum_q sig_t[i, j, q]
            S = sig_t.sum(dim=2)
            f_e = (self.dN[:, :, None, :] * S[None]).sum(dim=1)
        else:
            dN = self.dN.reshape(self.n_nodes, g, 1, self.n_qp, self.ex.C_pad)
            f_e = (dN * sig_t[None]).sum(dim=(1, 3))
        return self.ex.cells_to_rows(f_e)

    def cell_apply_ref(self, u2: torch.Tensor, tangent) -> torch.Tensor:
        """[vs, M_pad] node rows -> each cell's forces A_e u_e as block rows
        [B, vs, Rn]: gather, strain, tangent and divergence in plain PyTorch
        (K7's twin, ``ops/cuda_window.py::cell_apply_plain``)."""
        return self.cell_forces(tangent.apply(self.strain(u2.reshape(-1))))

    def matvec(self, v: torch.Tensor, tangent) -> torch.Tensor:
        """The tangent operator: [vs*M_pad] -> [vs*M_pad]. The cells' part
        runs as K7 on CUDA tensors where ``cuda_window.cell_apply_form``
        holds (an IsotropicTangent on affine P1 tets of 3 components), in
        plain PyTorch otherwise (the scope ``cg.operator.dense`` for a
        DenseTangent); the scatter (K5 on the card) sums it onto the nodes."""
        from .cuda_window import cell_apply_form, windowed_cell_apply

        u2 = v.reshape(self.vs, self.ex.M_pad)
        if v.is_cuda and cell_apply_form(self, tangent):
            f = windowed_cell_apply(self, u2, tangent)
        elif isinstance(tangent, DenseTangent):
            with scope("cg.operator.dense"):
                f = self.cell_apply_ref(u2, tangent)
        else:
            f = self.cell_apply_ref(u2, tangent)
        return self.ex.scatter(f).reshape(-1)

    def jacobi_diag(self, tangent) -> torch.Tensor:
        """diag(A) in the internal layout via per-node B^T C B."""
        T = self.mandel_T
        cols = []
        for a in range(self.n_nodes):
            # B_a[s, j] = sum_i T[s, i, j] dN[a, i]
            B_a = (T[:, :, :, None] * self.dN[a][None, :, None, :]).sum(dim=1)
            if self.compact:
                B_a = self._to_qp(B_a)
            q = tangent.quad_diag(B_a)  # [vs, N]
            cols.append((q * self.w).reshape(self.vs, self.n_qp, self.ex.C_pad).sum(dim=1))
        d_e = torch.stack(cols, dim=0)  # [n, vs, C_pad]
        return self.ex.scatter(self.ex.cells_to_rows(d_e)).reshape(-1)

    # -- observation -----------------------------------------------------------

    @property
    def slots(self) -> CellSlots:
        """The QP fields' cell layout: the plan's slots, padded."""
        return CellSlots(self.n_qp, self.ex.C_pad, self.slot_of_cell)

    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        """QP field [k, N] -> [k, Q, n_cells] in original cell order."""
        return self.slots.extract_cells(field)

    def insert_cells(self, dense: torch.Tensor, dtype=None) -> torch.Tensor:
        """[k, Q, n_cells] in original cell order -> the QP field [k, N]
        (zero on padded slots)."""
        return self.slots.insert_cells(dense, dtype)


def build_windowed_geometry(
    space,
    q_degree: int,
    constraint: Constraint,
    cells: np.ndarray | None = None,
    *,
    device,
    dtype: torch.dtype,
    tile: int = 1024,
    perm: np.ndarray | None = None,
    node_range: tuple | None = None,
) -> WindowedGeometry:
    """Tabulate the windowed SoA geometry (host-side, once per mesh or law).

    ``cells``: the mesh cells of one law (default: every cell); the plan
    holds those cells only, and ``slot_of_cell``/``extract_cells`` index them
    in the given order. ``perm``: a precomputed node ordering (old -> new),
    the whole mesh's RCM that several laws share; by default the RCM of the
    plan's cells. The internal layout spans every node of the space either
    way, so laws built on one ``perm`` share ``M_pad``.

    ``node_range``: ``(n0, n1)``, a window of ``perm``'s order that holds
    every node of ``cells`` (a rank's part of a sharded mesh). The plan and
    the internal layout then span the nodes ``n0 <= perm[node] < n1`` only,
    renumbered from 0 in that order: the window is the contiguous range
    ``[n0, n1)`` of each component of the whole layout.
    """
    from ..fem.elements import tabulate_element
    from ..fem.kinematics import _geometry_grad_at

    mesh = space.mesh
    elem, quad = tabulate_element(mesh.cell_type, space.degree, q_degree)
    cell_ids = np.arange(mesh.num_cells) if cells is None else np.asarray(cells, np.int64)
    C = len(cell_ids)
    Q = quad.points.shape[0]
    cell_nodes = space.cell_dof_nodes[cell_ids]  # [C, n] dof-node ids
    M = space.n_dof_nodes

    t0 = time.perf_counter()
    if perm is None:
        perm = reverse_cuthill_mckee(cell_nodes, M)
    if node_range is not None:
        n0, n1 = node_range
        cell_nodes = np.asarray(perm, np.int64)[cell_nodes] - n0
        if cell_nodes.min() < 0 or cell_nodes.max() >= n1 - n0:
            msg = f"build_windowed_geometry: cells with nodes outside node_range {node_range}"
            raise ValueError(msg)
        M, perm = n1 - n0, np.arange(n1 - n0)
    t1 = time.perf_counter()
    ex = build_windowed_exchange(cell_nodes, M, device=device, tile=tile, perm=perm)
    t2 = time.perf_counter()

    verts = mesh.nodes[mesh.cells[cell_ids]]
    geom_dN = _geometry_grad_at(mesh.cell_type, quad.points)  # [Q, nv, r]
    J = np.einsum("cvi,qvj->cqij", verts, geom_dN)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    dN_dx = np.einsum("qaj,cqji->cqai", elem.dN_dxi, Jinv)  # [C, Q, n, g]
    w = quad.weights[None, :] * detJ  # [C, Q]

    n = elem.N.shape[1]
    g = dN_dx.shape[3]
    co = ex.cell_order  # [C_pad] -> cell id or -1
    valid = co >= 0
    dN_pad = np.zeros((ex.C_pad, Q, n, g))
    dN_pad[valid] = dN_dx[co[valid]]
    w_pad = np.zeros((ex.C_pad, Q))
    w_pad[valid] = w[co[valid]]

    slot_of_cell = np.empty(C, np.int64)
    slot_of_cell[co[valid]] = np.nonzero(valid)[0]

    # affine elements (P1 simplices): dN is identical across a cell's QPs
    # (exact equality, not a tolerance), so store ONE copy per cell
    if Q > 1 and bool((dN_pad == dN_pad[:, :1]).all()):
        dN_h = dN_pad[:, 0].transpose(1, 2, 0)  # [n, g, C_pad]
    else:
        dN_h = dN_pad.transpose(2, 3, 1, 0).reshape(n, g, -1)  # [n, g, N] q-major

    def dev(x, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    geo = WindowedGeometry(
        ex=ex,
        dN=dev(dN_h),
        w=dev(w_pad.T.reshape(-1)),
        perm_dev=dev(ex.perm, torch.int64),
        invperm_dev=dev(np.argsort(ex.perm), torch.int64),
        slot_of_cell=dev(slot_of_cell, torch.int64),
        n_qp=Q,
        n_nodes=n,
        vs=space.value_size,
        ndofs=space.value_size * M,
        M=M,
        n_cells=C,
        constraint=constraint,
    )
    t3 = time.perf_counter()
    geo.build_seconds = {"rcm": t1 - t0, "plan": t2 - t1, "geometry": t3 - t2}
    return geo
