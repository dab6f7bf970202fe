"""The row layout of the windowed BSR plan (``row_ptr``/``col``/``blk``, what
the CUDA kernel K6 reads) against the windowed layout and the JAX package
(a shuffled 6^3 tet box, the AMG hierarchy of ``test_torch_amg.py``: row
tiles of 128 and a coarse limit of 100, for graph and geometric
aggregation; float64 unless a test says otherwise).

* Every A, P and R level's row layout holds exactly the blocks of its
  windowed layout, in slot order.
* ``bsr_rows_plain`` (the product K6 computes, in plain PyTorch) matches
  ``matvec_ref`` and the JAX package's ``matvec_ref`` to 1e-14 of the
  largest entry (sums in another order) and gives exact zeros on pad rows;
  in float32 it matches ``matvec_ref`` to 1e-6 with ``select_passes`` 3
  and 1 (x rounded to bfloat16 on both sides).
* The lanes rule gives each level a power of two up to 32 from its mean
  blocks per row; ``.double()`` casts the block values only.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.solver.amg import build_amg as jax_build_amg
from fenics_constitutive_tpu_torch.ops import WindowedBsr
from fenics_constitutive_tpu_torch.ops.cuda_window import bsr_rows_plain
from fenics_constitutive_tpu_torch.ops.windowed_bsr import _GRAN, bsr_lanes
from fenics_constitutive_tpu_torch.solver import build_amg

MU, KAPPA = 80769.0, 175000.0
F64 = torch.float64
OPTS = dict(tile_rows=128, max_coarse=100)


@pytest.fixture(scope="module")
def hierarchies(tets):
    pair = tets(6)
    (Vj, bj), (Vt, _) = pair["jax"], pair["torch"]
    free = np.ones(Vj.ndofs, bool)
    free[jax_combine(bj)[0]] = False
    out = {}
    for agg in ("graph", "geometric"):
        aj = jax_build_amg(Vj, MU, KAPPA, free, spmv="windowed", aggregation=agg, nu=3, **OPTS)
        at = build_amg(Vt, MU, KAPPA, free, device="cpu", dtype=F64, aggregation=agg, nu=3,
                       spmv="windowed", **OPTS)
        out[agg] = (aj, at)
    return out


def level_ops(aj, at):
    for lvl in range(at.n_levels - 1):
        for name in ("A_win", "P_win", "R_win"):
            yield f"{name}{lvl}", getattr(aj, name)[lvl], getattr(at, name)[lvl]


def close(got, ref, rtol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("agg", ["graph", "geometric"])
def test_row_layout_holds_the_windowed_operator(hierarchies, agg):
    _, at = hierarchies[agg]
    for lvl in range(at.n_levels - 1):
        for name in ("A_win", "P_win", "R_win"):
            w, label = getattr(at, name)[lvl], f"{name}{lvl}"
            rp = w.row_ptr.numpy()
            assert rp.shape == (w.NR_pad + 1,) and rp[0] == 0, label
            counts = np.diff(rp)
            assert (counts[w.n_rnodes:] == 0).all(), label  # pad rows empty
            assert w.col.shape == (rp[-1],) and w.blk.shape == (rp[-1], w.br * w.bc), label
            # slot a of row r in the windowed layout is block rp[r] + a
            r = np.repeat(np.arange(w.NR_pad), counts)
            a = np.arange(rp[-1]) - rp[r]
            b, t = r // w.T_r, r % w.T_r
            loc, jb = w.loc.numpy(), w.jb.numpy()
            np.testing.assert_array_equal(w.col.numpy(), jb[b] * _GRAN + loc[b, a, t],
                                          err_msg=label)
            vals = w.vals.numpy().reshape(w.B, w.k, w.br * w.bc, w.T_r)
            np.testing.assert_array_equal(w.blk.numpy(), vals[b, a, :, t], err_msg=label)
            # and the windowed layout holds nothing else
            assert (loc >= 0).sum() == rp[-1], label


@pytest.mark.parametrize("agg", ["graph", "geometric"])
def test_bsr_rows_plain_matches_matvec_ref_and_jax(hierarchies, agg):
    aj, at = hierarchies[agg]
    rng = np.random.default_rng(3)
    for label, wj, wt in level_ops(aj, at):
        x = rng.normal(size=wt.bc * wt.NC_pad)
        y = bsr_rows_plain(wt, torch.tensor(x))
        close(y, wt.matvec_ref(torch.tensor(x)), 1e-14, label)
        close(y, wj.matvec_ref(jnp.asarray(x)), 1e-14, label)
        pad = y.reshape(wt.br, wt.NR_pad)[:, wt.n_rnodes:]
        assert torch.equal(pad, torch.zeros_like(pad)), label


@pytest.mark.parametrize("passes", [3, 1])
def test_bsr_rows_plain_f32_matches_matvec_ref(hierarchies, passes):
    _, at = hierarchies["graph"]
    rng = np.random.default_rng(5)
    for lvl in range(at.n_levels - 1):
        for name in ("A_win", "P_win", "R_win"):
            w32 = copy.deepcopy(getattr(at, name)[lvl]).float()
            w32.select_passes = passes
            x = torch.tensor(rng.normal(size=w32.bc * w32.NC_pad).astype(np.float32))
            y = bsr_rows_plain(w32, x)
            assert y.dtype == torch.float32
            close(y, w32.matvec_ref(x), 1e-6, f"{name}{lvl} select_passes={passes}")


@pytest.mark.parametrize("agg", ["graph", "geometric"])
def test_lanes_follow_the_mean_blocks_per_row(hierarchies, agg):
    _, at = hierarchies[agg]
    seen = set()
    for lvl in range(at.n_levels - 1):
        for name in ("A_win", "P_win", "R_win"):
            w = getattr(at, name)[lvl]
            assert w.lanes in (1, 2, 4, 8, 16, 32)
            assert w.lanes == bsr_lanes(w.col.numel() / w.n_rnodes)
            seen.add(w.lanes)
    assert len(seen) > 1  # the levels of one hierarchy differ


@pytest.mark.parametrize(("mean", "lanes"), [(0.0, 1), (1.0, 1), (4.04, 8), (14.3, 16),
                                             (31.9, 32), (204.7, 32)])
def test_bsr_lanes_values(mean, lanes):
    assert bsr_lanes(mean) == lanes


def test_double_and_float_cast_block_values_only(hierarchies):
    _, at = hierarchies["graph"]
    w = at.R_win[0]
    for cast, dtype in ((torch.nn.Module.double, torch.float64),
                        (torch.nn.Module.float, torch.float32)):
        wc = cast(copy.deepcopy(w))
        assert wc.blk.dtype == wc.vals.dtype == dtype
        assert wc.row_ptr.dtype == wc.col.dtype == torch.int32
        assert torch.equal(wc.row_ptr, w.row_ptr) and torch.equal(wc.col, w.col)
        assert wc.lanes == w.lanes


def test_plan_without_row_layout(hierarchies):
    _, at = hierarchies["graph"]
    w = at.A_win[0]
    keep = dict(loc=w.loc, vals=w.vals, jb=w.jb, br=w.br, bc=w.bc, k=w.k, T_r=w.T_r, P=w.P,
                B=w.B, n_rnodes=w.n_rnodes, n_cnodes=w.n_cnodes, NR_pad=w.NR_pad,
                NC_pad=w.NC_pad)
    bare = WindowedBsr(**keep)
    assert bare.blk is None and bare.lanes is None
    x = torch.ones(w.bc * w.NC_pad, dtype=F64)
    assert torch.equal(bare.matvec(x), w.matvec(x))  # the CPU path needs no row layout
    with pytest.raises(ValueError, match="together"):
        WindowedBsr(**keep, row_ptr=w.row_ptr, col=w.col)
