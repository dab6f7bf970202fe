"""The windowed BSR level format and the smoothed-aggregation AMG against the
JAX package (shuffled tet boxes, float64 unless a test says otherwise).

* Plans: every A, P and R level of the hierarchy, for graph and for forced
  geometric aggregation, has the JAX package's ``loc`` and ``jb`` bit for bit
  and its ``vals`` to 1e-15 (the same host numpy/scipy build).
* The plain SpMV ``matvec_ref`` matches JAX's to 1e-14 of the largest entry
  (float64, sums in another order). In float32 it matches JAX's Pallas
  kernel in interpret mode with ``select_passes`` 3 (exact select) and 1
  (x rounded to bfloat16 on both sides) to 1e-6 of the largest entry.
* The V-cycle (``__call__`` and ``wrap_internal``) matches JAX's to 1e-12.
* The ELL levels (``spmv="ell"``, the default): every A, P and R level has
  the JAX package's ELL values and columns exactly, and one V-cycle matches
  JAX's to 1e-12. ``preconditioner="amg"`` through PackedSimulation on a 3^3
  box (ELL levels applied grid-major) and on the gather engine (node-major)
  converges to JAX's states within the BVP tolerance (rtol 1e-7).
* The two level formats of one hierarchy give the same V-cycle on
  node-major vectors (a hex box, tets, an interval bar): PackedSimulation
  takes the ELL levels off the card and the windowed ones (K6) on it.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.ops.pallas_window import windowed_bsr_matvec
from fenics_constitutive_tpu.solver.amg import build_amg as jax_build_amg
from fenics_constitutive_tpu_torch.solver import (
    AmgPreconditioner,
    PackedSimulation,
    WindowedAmgPreconditioner,
    build_amg,
)

MU, KAPPA = 80769.0, 175000.0
F64 = torch.float64
# small tiles and coarse limits, so that levels have several row tiles and
# the hierarchy has three levels at 6^3
OPTS = dict(tile_rows=128, max_coarse=100)


def free_mask(V, bcs):
    free = np.ones(V.ndofs, bool)
    free[jax_combine(bcs)[0]] = False
    return free


@pytest.fixture(scope="module")
def hierarchies(tets):
    out = {}
    pair = tets(6)
    (Vj, bj), (Vt, _) = pair["jax"], pair["torch"]
    free = free_mask(Vj, bj)
    for agg in ("graph", "geometric"):
        aj = jax_build_amg(Vj, MU, KAPPA, free, spmv="windowed", aggregation=agg, nu=3, **OPTS)
        at = build_amg(Vt, MU, KAPPA, free, device="cpu", dtype=F64, aggregation=agg, nu=3,
                       spmv="windowed", **OPTS)
        out[agg] = (aj, at, free)
    return out


def level_ops(aj, at):
    for lvl in range(at.n_levels - 1):
        for name in ("A_win", "P_win", "R_win"):
            yield f"{name}{lvl}", getattr(aj, name)[lvl], getattr(at, name)[lvl]


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("agg", ["graph", "geometric"])
def test_hierarchy_plans_match_jax(hierarchies, agg):
    aj, at, _ = hierarchies[agg]
    assert isinstance(at, WindowedAmgPreconditioner)
    assert at.n_levels == aj.n_levels >= 3
    for attr in ("nc", "bsc", "NPc", "vs", "n_nodes0", "NP0", "nu"):
        assert getattr(at, attr) == getattr(aj, attr), attr
    assert any(w.B > 1 for _, _, w in level_ops(aj, at))
    for label, wj, wt in level_ops(aj, at):
        for attr in ("br", "bc", "k", "T_r", "P", "B", "NR_pad", "NC_pad", "select_passes"):
            assert getattr(wt, attr) == getattr(wj, attr), (label, attr)
        np.testing.assert_array_equal(wt.loc.numpy(), np.asarray(wj.loc), err_msg=label)
        np.testing.assert_array_equal(wt.jb.numpy(), np.asarray(wj.jb), err_msg=label)
        np.testing.assert_allclose(wt.vals.numpy(), np.asarray(wj.vals), rtol=0,
                                   atol=1e-15 * np.abs(np.asarray(wj.vals)).max(), err_msg=label)
    for lvl in range(at.n_levels - 1):
        close(getattr(at, f"dinv_{lvl}"), aj.dinv_int[lvl], 1e-15, f"dinv {lvl}")
    close(at.coarse_inv, aj.coarse_inv, 1e-15, "coarse inverse")
    np.testing.assert_array_equal(at.perm_dev.numpy(), np.asarray(aj.perm_dev))


@pytest.mark.parametrize("agg", ["graph", "geometric"])
def test_bsr_matvec_ref_matches_jax(hierarchies, agg):
    aj, at, _ = hierarchies[agg]
    rng = np.random.default_rng(3)
    for label, wj, wt in level_ops(aj, at):
        x = rng.normal(size=wt.bc * wt.NC_pad)
        close(wt.matvec(torch.tensor(x)), wj.matvec_ref(jnp.asarray(x)), 1e-14, label)


@pytest.mark.parametrize("passes", [3, 1])
def test_bsr_f32_matches_pallas_interpret(hierarchies, passes):
    aj, at, _ = hierarchies["graph"]
    rng = np.random.default_rng(5)
    for label, wj, wt in list(level_ops(aj, at))[:3]:  # the finest A, P, R
        wt32 = copy.deepcopy(wt).float()  # Module.float() casts in place
        wt32.select_passes = passes
        x = rng.normal(size=wt.bc * wt.NC_pad).astype(np.float32)
        y = wt32.matvec_ref(torch.tensor(x))
        assert y.dtype == torch.float32
        y_pl = windowed_bsr_matvec(dataclasses.replace(wj, select_passes=passes),
                                   jnp.asarray(x), interpret=True)
        close(y, y_pl, 1e-6, f"{label} select_passes={passes}")
        if passes == 1:  # the rounding is visible against the exact select
            exact = np.asarray(wj.matvec_ref(jnp.asarray(x.astype(np.float64))))
            rel = np.abs(y.numpy() - exact).max() / np.abs(exact).max()
            assert 1e-8 < rel < 1e-2, (label, rel)


@pytest.mark.parametrize("agg", ["graph", "geometric"])
def test_vcycle_matches_jax(hierarchies, agg):
    aj, at, free = hierarchies[agg]
    rng = np.random.default_rng(2)
    r = rng.normal(size=free.size) * free
    close(at(torch.tensor(r)), aj(jnp.asarray(r)), 1e-12, "node-major apply")
    m_pad = at.NP0 + 256  # a geometry whose padded node count differs
    ri = rng.normal(size=at.vs * m_pad)
    close(at.wrap_internal(m_pad)(torch.tensor(ri)),
          aj.wrap_internal(m_pad)(jnp.asarray(ri)), 1e-12, "internal apply")
    assert at.wrap_internal(m_pad).internal_layout


def test_ell_levels_raise(tets):
    """spmv="ell" builds the ELL hierarchy and is the default; an unknown
    level format raises ValueError."""
    V = tets(4)["torch"][0]
    free = np.ones(V.ndofs, bool)
    for kw in ({"spmv": "ell"}, {}):
        amg = build_amg(V, MU, KAPPA, free, device="cpu", dtype=F64, max_coarse=100, **kw)
        assert isinstance(amg, AmgPreconditioner) and amg.n_levels >= 2
    with pytest.raises(ValueError, match="spmv"):
        build_amg(V, MU, KAPPA, free, device="cpu", dtype=F64, spmv="csr")


@pytest.fixture(scope="module")
def ell_hierarchies(tets):
    pair = tets(6)
    (Vj, bj), (Vt, _) = pair["jax"], pair["torch"]
    free = free_mask(Vj, bj)
    aj = jax_build_amg(Vj, MU, KAPPA, free, nu=3, max_coarse=100)
    at = build_amg(Vt, MU, KAPPA, free, device="cpu", dtype=F64, nu=3, max_coarse=100)
    return aj, at, free


def test_ell_levels_equal_jax(ell_hierarchies):
    aj, at, _ = ell_hierarchies
    assert at.n_levels == aj.n_levels >= 3
    for name in ("A_ell", "P_ell", "R_ell"):
        for lvl, ((vj, cj), (vt, ct)) in enumerate(zip(getattr(aj, name), getattr(at, name))):
            np.testing.assert_array_equal(vt.numpy(), np.asarray(vj), err_msg=f"{name}{lvl}")
            np.testing.assert_array_equal(ct.numpy(), np.asarray(cj), err_msg=f"{name}{lvl}")
    for lvl, dj in enumerate(aj.dinv):
        np.testing.assert_array_equal(getattr(at, f"dinv_{lvl}").numpy(), np.asarray(dj))
    np.testing.assert_array_equal(at.coarse_inv.numpy(), np.asarray(aj.coarse_inv))


def test_ell_vcycle_matches_jax(ell_hierarchies):
    aj, at, free = ell_hierarchies
    r = np.random.default_rng(3).normal(size=free.size) * free
    close(at(torch.tensor(r)), aj(jnp.asarray(r)), 1e-12, "ELL V-cycle")
    z32 = at(torch.tensor(r, dtype=torch.float32))
    assert z32.dtype == torch.float32


def _sim_pair(pair, mat, **kw):
    from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
    from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
    from fenics_constitutive_tpu_torch.models import VonMises3D

    opts = dict(newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-12, preconditioner="amg", **kw)
    (Vj, bj), (Vt, bt) = pair["jax"], pair["torch"]
    sj = JPackedSimulation(JVonMises3D(mat), Vj, bj, 2, **opts)
    st = PackedSimulation(VonMises3D(mat), Vt, bt, 2, device="cpu", dtype=F64, **opts)
    return sj, st


@pytest.mark.parametrize("mesh", ["box", "gather"])
def test_amg_preconditioner_matches_jax(box, tets, mat, mesh):
    """preconditioner="amg" on a 3^3 hex box (the structured engine applies
    the ELL V-cycle grid-major) and on a shuffled 3^3 tet mesh (the gather
    engine, node-major): 3 plastic load steps, converged states equal."""
    pair = box(3, 0.0) if mesh == "box" else tets(3, 0.0)
    sj, st = _sim_pair(pair, mat)
    assert st.engine == ("structured" if mesh == "box" else "gather")
    assert st.preconditioner == "amg" and isinstance(st._mg, AmgPreconditioner)
    for k in (1, 2, 3):
        for sim in (sj, st):
            sim.bcs[1].value = 0.004 * k
            assert sim.solve()[1], (mesh, k)
        close(st.u, sj.u, 1e-7, f"u step {k}")
        close(torch.as_tensor(st.stress), sj.stress, 1e-7, f"stress step {k}")
    assert float(st.histories[0]["alpha"].max()) > 0


@pytest.mark.parametrize("mesh", ["box", "tets", "bar"])
def test_level_formats_agree(box, tets, mesh):
    """The ELL and the windowed levels of one hierarchy (the formats that
    PackedSimulation serves node-major vectors with, off and on the card)
    give the same V-cycle on node-major vectors: within 1e-12 in float64,
    and within 1e-6 in float32 with the windowed format's exact select."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_interval_mesh

    if mesh == "bar":
        V = FunctionSpace(unit_interval_mesh(40), 1, 1)
        free = np.ones(V.ndofs, bool)
        free[[0, V.ndofs - 1]] = False
    else:
        V, bcs = (box(4) if mesh == "box" else tets(5))["torch"]
        free = free_mask(V, bcs)
    opts = dict(nu=3, max_coarse=12, device="cpu")
    r = np.random.default_rng(4).normal(size=V.ndofs) * free
    for dtype, tol in ((F64, 1e-12), (torch.float32, 1e-6)):
        ell = build_amg(V, MU, KAPPA, free, dtype=dtype, spmv="ell", **opts)
        win = build_amg(V, MU, KAPPA, free, dtype=dtype, spmv="windowed", select_passes=3,
                        tile_rows=64, **opts)
        assert ell.n_levels == win.n_levels >= 2
        z = ell(torch.tensor(r, dtype=dtype))
        close(win(torch.tensor(r, dtype=dtype)), z.to(F64), tol, f"{mesh} {dtype}")
