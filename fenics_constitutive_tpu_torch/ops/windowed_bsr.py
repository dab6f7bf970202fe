"""Windowed block-sparse (BSR) matvec for the AMG levels.

The port of ``fenics_constitutive_tpu.ops.windowed_bsr``. A sparse level
operator is frozen into a plan of fixed row tiles:

* rows and columns are grouped into NODES of ``br``/``bc`` dofs (3 for the
  fine elastic operator, the rigid-mode count for coarse levels);
* row-nodes and col-nodes are each put in a banded order (the mesh RCM for
  the fine level; aggregates ordered by their smallest fine node below), so
  each row tile's block-columns span a narrow window;
* a row tile of ``T_r`` row-nodes holds ``k`` block slots per row: the
  window-local column node ``loc`` (-1 = padding) and the ``br x bc`` block
  values, with the window start ``jb`` in units of ``_GRAN`` column nodes;
* each row owns its output: the SpMV needs no scatter.

The plan carries the same operator twice. The windowed layout above
(``loc``/``vals``/``jb``) is the JAX package's plan, bit for bit, and feeds
``matvec_ref``, the plain version. The row layout (``row_ptr``/``col``/
``blk``: the permuted BSR matrix, blocks in row order) feeds the CUDA kernel
K6, which spreads each row's blocks over ``lanes`` threads. On CUDA tensors
``matvec`` launches K6 (``ops/cuda_window.py``); on CPU tensors it runs
``matvec_ref``. ``select_passes=1`` rounds every gathered float32 ``x`` to bfloat16
(round to nearest even) before the product, as the AMG levels of the JAX
package do; ``3`` is exact. float64 is never rounded.

Vector layout: component-major over permuted nodes, ``x[j*NC_pad + cnode]``
(the windowed engine's internal layout), so the fine level runs directly on
``WindowedGeometry`` internal vectors built with the same permutation.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = ["WindowedBsr", "bsr_lanes", "build_windowed_bsr"]

_W2 = 128  # column sub-tile width of the JAX package's plan
_GRAN = 8 * _W2  # column window granule (1024 column nodes)
#: blocks each K6 thread takes on a row of mean length, below the cap of a
#: warp: one, which gives the best lanes, or lanes within 15% of the best,
#: on every AMG level operator of the 35^3 tet bench (the sweep of
#: chip_smoke.py phase 8 on an H100)
_BLOCKS_PER_LANE = 1


def _round_up(x: int, m: int) -> int:
    return -(-max(x, 1) // m) * m


def bsr_lanes(mean_blocks_per_row: float) -> int:
    """Threads per row of K6 for a plan whose real rows hold this many
    blocks on average: a power of two from 1 to 32 (a warp)."""
    want = max(1, math.ceil(mean_blocks_per_row / _BLOCKS_PER_LANE))
    return min(32, 1 << (want - 1).bit_length())


class WindowedBsr(nn.Module):
    """y[br * NR_pad] = A @ x[bc * NC_pad], component-major node layouts.

    Buffers of the windowed layout (the JAX package's plan; ``matvec_ref``):
      loc:  [B, k, T_r] int32 window-local col-node index per slot (-1 pad)
      vals: [B, k * br * bc, T_r] block entries, slot-major then (jr, jc)
      jb:   [B] int32 window start in ``_GRAN``-col-node granules
    Buffers of the row layout (the kernel K6; None in a plan built without):
      row_ptr: [NR_pad + 1] int32, the blocks of row node r are
          ``row_ptr[r]:row_ptr[r + 1]`` (pad rows empty)
      col:  [nnzb] int32 permuted col node of each block
          (= ``jb[b] * _GRAN + loc[b, a, t]`` of its slot)
      blk:  [nnzb, br * bc] block entries, rows in order, (jr, jc) within
    ``lanes`` (``bsr_lanes`` of the mean blocks per real row) is K6's
    threads per row.
    """

    loc: torch.Tensor
    vals: torch.Tensor
    jb: torch.Tensor
    row_ptr: torch.Tensor | None
    col: torch.Tensor | None
    blk: torch.Tensor | None

    def __init__(self, *, loc, vals, jb, br: int, bc: int, k: int, T_r: int, P: int,
                 B: int, n_rnodes: int, n_cnodes: int, NR_pad: int, NC_pad: int,
                 select_passes: int = 3, row_ptr=None, col=None, blk=None):
        super().__init__()
        if select_passes not in (1, 3):
            msg = f"select_passes must be 1 or 3, got {select_passes}"
            raise ValueError(msg)
        if (row_ptr is None) != (col is None) or (col is None) != (blk is None):
            msg = "row_ptr, col and blk come together or not at all"
            raise ValueError(msg)
        self.register_buffer("loc", loc)
        self.register_buffer("vals", vals)
        self.register_buffer("jb", jb)
        self.register_buffer("row_ptr", row_ptr)
        self.register_buffer("col", col)
        self.register_buffer("blk", blk)
        self.br, self.bc, self.k, self.T_r, self.P, self.B = br, bc, k, T_r, P, B
        self.n_rnodes, self.n_cnodes = n_rnodes, n_cnodes
        self.NR_pad, self.NC_pad = NR_pad, NC_pad
        #: 3 = exact; 1 = float32 x rounded to bfloat16 in the column select
        self.select_passes = select_passes
        #: K6 threads per row (None without the row layout)
        self.lanes = None if col is None else bsr_lanes(col.numel() / max(n_rnodes, 1))

    @property
    def n_rows(self) -> int:
        return self.br * self.n_rnodes

    @property
    def n_cols(self) -> int:
        return self.bc * self.n_cnodes

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """x [bc * NC_pad] -> y [br * NR_pad] (pads zero)."""
        if x.is_cuda:
            from .cuda_window import windowed_bsr_matvec

            return windowed_bsr_matvec(self, x)
        return self.matvec_ref(x)

    def matvec_ref(self, x: torch.Tensor) -> torch.Tensor:
        """Plain version of the kernel: an indexed take over the same plan."""
        x2 = x.reshape(self.bc, self.NC_pad)
        base = (self.jb.long() * _GRAN)[:, None, None]
        gi = torch.where(self.loc >= 0, self.loc.long() + base, self.NC_pad)
        x_ext = torch.cat([x2, x2.new_zeros((self.bc, 1))], dim=1)
        sel = x_ext[:, gi]  # [bc, B, k, T_r]
        if self.select_passes == 1 and sel.dtype == torch.float32:
            sel = sel.to(torch.bfloat16).to(torch.float32)
        v5 = self.vals.reshape(self.B, self.k, self.br, self.bc, self.T_r)
        # contrib[b, a, jr, t] = sum_jc v * x, then summed over the slots a
        contrib = (v5 * sel.permute(1, 2, 0, 3)[:, :, None]).sum(dim=3)
        y = contrib.sum(dim=1)  # [B, br, T_r]
        return y.permute(1, 0, 2).reshape(-1)


def build_windowed_bsr(
    A,
    br: int,
    bc: int,
    row_perm: np.ndarray | None = None,
    col_perm: np.ndarray | None = None,
    *,
    device,
    dtype: torch.dtype,
    tile_rows: int = 512,
    n_pad_rows: int | None = None,
    n_pad_cols: int | None = None,
    select_passes: int = 3,
) -> WindowedBsr:
    """Freeze a scipy sparse matrix into the windowed BSR plan.

    A: [n_rows, n_cols] with n_rows = br * n_rnodes, n_cols = bc * n_cnodes,
       dofs node-major (dof = node * bs + comp).
    row_perm/col_perm: node orderings old -> new (banded, e.g. RCM);
       identity if None. The result operates on permuted component-major
       vectors (see module docstring).
    """
    import scipy.sparse as sp

    A = sp.csr_matrix(A)
    n_rows, n_cols = A.shape
    if n_rows % br or n_cols % bc:
        msg = f"a {n_rows} x {n_cols} matrix has no {br} x {bc} node blocks"
        raise ValueError(msg)
    NRn, NCn = n_rows // br, n_cols // bc
    rp = np.arange(NRn) if row_perm is None else np.asarray(row_perm)
    cp = np.arange(NCn) if col_perm is None else np.asarray(col_perm)

    # permute to the banded node orders (node-major dof permutation)
    rdof = (np.argsort(rp)[:, None] * br + np.arange(br)).reshape(-1)
    cdof = (np.argsort(cp)[:, None] * bc + np.arange(bc)).reshape(-1)
    Ap = A[rdof][:, cdof].tobsr(blocksize=(br, bc))
    Ap.sort_indices()

    indptr, indices, data = Ap.indptr, Ap.indices, Ap.data  # blocks [nnzb, br, bc]
    nnz_row = np.diff(indptr)
    k = max(1, int(nnz_row.max()))

    T_r = int(tile_rows)
    NR_pad = _round_up(NRn, T_r)
    if n_pad_rows is not None:  # caller-fixed level size (AMG hierarchies)
        if n_pad_rows < NR_pad or n_pad_rows % T_r:
            msg = f"n_pad_rows={n_pad_rows} must be a multiple of {T_r} >= {NR_pad}"
            raise ValueError(msg)
        NR_pad = n_pad_rows
    B = NR_pad // T_r

    NC_pad = _round_up(NCn, _GRAN)
    if n_pad_cols is not None:
        if n_pad_cols < NC_pad or n_pad_cols % _GRAN:
            msg = f"n_pad_cols={n_pad_cols} must be a multiple of {_GRAN} >= {NC_pad}"
            raise ValueError(msg)
        NC_pad = n_pad_cols

    # per-tile window: cover all block-cols of the tile's rows, in granules
    jb = np.zeros(B, np.int64)
    wmax = 1
    for b in range(B):
        r0, r1 = b * T_r, min((b + 1) * T_r, NRn)
        cols_b = indices[indptr[r0] : indptr[r1]] if r0 < NRn else indices[:0]
        if len(cols_b):
            lo, hi = int(cols_b.min()), int(cols_b.max())
        else:
            lo = hi = 0
        jb[b] = lo // _GRAN
        wmax = max(wmax, hi // _GRAN - jb[b] + 1)
    # clamp windows into the fixed col space (small/dense levels: the window
    # may be the whole col space)
    P = min(int(wmax), NC_pad // _GRAN)
    jb = jb - np.maximum(jb + P - NC_pad // _GRAN, 0)

    loc = np.full((B, k, T_r), -1, np.int32)
    vals = np.zeros((B, k, br, bc, T_r))
    rows = np.repeat(np.arange(NRn), nnz_row)
    pos = np.arange(len(indices)) - indptr[rows]
    b_of = rows // T_r
    t_of = rows % T_r
    loc[b_of, pos, t_of] = (indices - jb[b_of] * _GRAN).astype(np.int32)
    vals[b_of, pos, :, :, t_of] = data
    if loc.max() >= P * _GRAN or (loc < -1).any():
        msg = "windowed BSR: a row tile's columns fall outside its window"
        raise RuntimeError(msg)

    # the row layout of K6: the same blocks in row order, pad rows empty
    row_ptr = np.concatenate([indptr, np.full(NR_pad - NRn, indptr[-1])])

    def dev(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=device)

    return WindowedBsr(
        loc=dev(loc, torch.int32),
        vals=dev(vals.reshape(B, k * br * bc, T_r), dtype),
        jb=dev(jb, torch.int32),
        br=br, bc=bc, k=k, T_r=T_r, P=P, B=B,
        n_rnodes=NRn, n_cnodes=NCn, NR_pad=NR_pad, NC_pad=NC_pad,
        select_passes=select_passes,
        row_ptr=dev(row_ptr, torch.int32),
        col=dev(indices, torch.int32),
        blk=dev(data.reshape(-1, br * bc), dtype),
    )
