"""The fused V-cycle (ops/cuda_smoother.py::FusedVcycle) and the one-launch CG
operator on non-cubic boxes, against the JAX package (float64, CPU).

On CPU tensors every entry of the fused V-cycle runs its plain twin: the
pre-chain followed by the restriction, the prolongation, mask and add
followed by the post-chain, and the plain recursive V-cycle for the
one-block tail. The CUDA kernels behind them are held to those twins on the
card by chip_smoke.py phase 11. Here:

* the fused V-cycle on an 11 x 10 x 10 hex box (node grids 12 x 11 x 11 ->
  6 x 6 x 6 -> 3 x 3 x 3: non-nested along x at the first transfer and along
  every axis at the second) against JAX ``build_multigrid(fused_smoothing=
  True)`` (Pallas chains in interpret mode), for the direct and the chained
  coarse solve and (nu, nu_coarse) of (3, 2) and (2, 1): rtol 1e-10, the bar
  of the JAX package's fused V-cycle test;
* each twin against the existing chain (``smoother_plain``) composed with
  JAX's convolution transfers: rtol 1e-12 (the sums differ in order only);
* the host-built level data of the kernels: the 27-point stencil of each
  node's pattern of cells equals the 8-cell gather at every node (rtol
  1e-12), and the rule that picks the tail's first level;
* the CG operator's entry point on a 5 x 3 x 4 box against JAX's
  ``matvec_gm`` (rtol 1e-12) and its Pallas kernel in interpret mode (rtol
  1e-9, the tolerance of tests/solver/test_pallas_matvec.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import fenics_constitutive_tpu.ops.pallas_matvec as pm
from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.models import packed_models  # noqa: F401
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu.solver.multigrid import build_multigrid as jax_build_mg
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.ops import IsotropicTangent, cuda_smoother
from fenics_constitutive_tpu_torch.ops.cuda_matvec import build_cuda_matvec
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
from fenics_constitutive_tpu_torch.solver.multigrid import build_multigrid

F64 = torch.float64
CELLS = (11, 10, 10)


def close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def _spaces(cells):
    """The box in both packages with the benchmark's Dirichlet set: x=0 and
    x=1 held in x, y=0 in y, z=0 in z."""

    def on(V, axis, v):
        return V.locate_dofs_geometrical(lambda x: np.isclose(x[:, axis], v), component=axis)

    out = {}
    for key, fem in (("jax", jfem), ("torch", tfem)):
        V = fem.FunctionSpace(fem.unit_cube_mesh(*cells, "hex"), 1, 3)
        bcs = [fem.DirichletBC(on(V, 0, 0.0), 0.0), fem.DirichletBC(on(V, 0, 1.0), 0.004),
               fem.DirichletBC(on(V, 1, 0.0), 0.0), fem.DirichletBC(on(V, 2, 0.0), 0.0)]
        out[key] = (V, bcs)
    return out


@pytest.fixture(scope="module")
def box_11(mat):
    pair = _spaces(CELLS)
    (Vj, bcs_j), (Vt, _) = pair["jax"], pair["torch"]
    gj = jax_build_geometry(Vj, 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(Vt, 2, Constraint.FULL, device="cpu", dtype=F64)
    free = np.ones(Vj.ndofs, bool)
    free[jax_combine(bcs_j)[0]] = False
    r = np.random.default_rng(8).normal(size=Vj.ndofs)
    return gj, gt, free, r


OPTS = {
    "direct_nu32": dict(coarse_direct=True, nu=3, nu_coarse=2),
    "direct_nu21": dict(coarse_direct=True, nu=2, nu_coarse=1),
    "chain_nu32": dict(coarse_direct=False, nu=3, nu_coarse=2),
    "chain_nu21": dict(coarse_direct=False, nu=2, nu_coarse=1),
}


def _port_mg(box_11, mat, **kw):
    _, gt, free, _ = box_11
    return build_multigrid(gt, mat["p_mu"], mat["p_ka"], torch.tensor(free), device="cpu",
                           dtype=F64, fused_smoothing=True, **kw)


@pytest.mark.parametrize("opts", list(OPTS))
def test_fused_vcycle_on_a_non_cubic_box_matches_jax(box_11, mat, opts):
    gj, gt, free, r = box_11
    kw = OPTS[opts]
    mg_t = _port_mg(box_11, mat, **kw)
    mg_j = jax_build_mg(gj, mat["p_mu"], mat["p_ka"], jnp.asarray(free), fused_smoothing=True,
                        **kw)
    assert mg_t.node_grids == mg_j.node_grids == ((12, 11, 11), (6, 6, 6), (3, 3, 3))
    fc = mg_t.fused_cycle
    assert fc is not None and (fc.coarse_inv is not None) == kw["coarse_direct"]
    r_gm = gt.to_grid_major(torch.tensor(r))
    before = cuda_smoother.launches
    z = mg_t(r_gm)
    assert cuda_smoother.launches == before  # CPU tensors: the plain twins
    torch.testing.assert_close(z, fc.plain(r_gm), rtol=0, atol=0)
    close(z.numpy(), mg_j(gj.to_grid_major(jnp.asarray(r))), 1e-10)


@pytest.fixture(scope="module")
def twins(box_11, mat):
    gj, gt, free, r = box_11
    mg_t = _port_mg(box_11, mat, coarse_direct=True, nu=3, nu_coarse=2)
    mg_j = jax_build_mg(gj, mat["p_mu"], mat["p_ka"], jnp.asarray(free), coarse_direct=True,
                        nu=3, nu_coarse=2)
    return mg_t, mg_j, gt.to_grid_major(torch.tensor(r))


@pytest.mark.parametrize("lvl", [0, 1], ids=["x-non-nested", "all-non-nested"])
def test_pre_restrict_twin_is_chain_then_restriction(twins, lvl):
    mg_t, mg_j, r_gm = twins
    fc = mg_t.fused_cycle
    b = r_gm if lvl == 0 else torch.tensor(
        np.random.default_rng(1).normal(size=3 * 6**3))
    x, bc = fc.pre_restrict(lvl, b)  # CPU tensors: the twin
    pre = mg_t.fused[lvl]["pre"]
    x_ref, r_ref = cuda_smoother.smoother_plain(pre.geo, pre.ke, pre.inv_d, pre.mask, None, b,
                                                nu=pre.nu, zero_start=True, emit_residual=True)
    torch.testing.assert_close(x, x_ref, rtol=0, atol=0)
    close(bc.numpy(), mg_j.restrict(jnp.asarray(r_ref.numpy()), lvl), 1e-12)


@pytest.mark.parametrize("lvl", [0, 1], ids=["x-non-nested", "all-non-nested"])
def test_prolong_post_twin_is_correction_then_chain(twins, lvl):
    mg_t, mg_j, _ = twins
    fc = mg_t.fused_cycle
    rng = np.random.default_rng(2 + lvl)
    post = mg_t.fused[lvl]["post"]
    free = (post.inv_d != 0).double()
    n_c = 3 * int(np.prod(mg_t.node_grids[lvl + 1]))
    x = torch.tensor(rng.normal(size=post.inv_d.numel())) * free
    b = torch.tensor(rng.normal(size=post.inv_d.numel()))
    xc = torch.tensor(rng.normal(size=n_c))
    got = fc.prolong_post(lvl, x, b, xc)
    fine = torch.tensor(np.asarray(mg_j.prolong(jnp.asarray(xc.numpy()), lvl)))
    ref = cuda_smoother.smoother_plain(post.geo, post.ke, post.inv_d, post.mask,
                                       x + free * fine, b, nu=post.nu, zero_start=False,
                                       emit_residual=False)
    close(got.numpy(), ref.numpy(), 1e-12)


def test_tail_twin_is_the_plain_vcycle_from_its_level(box_11, twins, mat):
    _, gt, free, _ = box_11
    mg_t, _, r_gm = twins
    fc = mg_t.fused_cycle
    x, bc = fc.pre_restrict_plain(0, r_gm)
    # the tail from level 1 is the unfused V-cycle from level 1
    mg_u = build_multigrid(gt, mat["p_mu"], mat["p_ka"], torch.tensor(free), device="cpu",
                           dtype=F64, coarse_direct=True, nu=3, nu_coarse=2)
    close(fc.tail(bc, 1).numpy(), mg_u.vcycle(1, bc).numpy(), 1e-12)
    torch.testing.assert_close(
        fc.prolong_post_plain(0, x, r_gm, fc.tail(bc, 1)), fc.plain(r_gm), rtol=0, atol=0)


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_pattern_stencils_equal_the_gather(twins, lvl):
    """The kernels' 27-point stencils (one per pattern of valid cells around
    a node, assembled from Ke on the host) apply the same operator as the
    8-cell gather at every node; a box has 27 patterns (or fewer)."""
    mg_t, _, _ = twins
    chain = mg_t.fused_cycle._chain(lvl)
    n0, n1, n2 = chain.grid
    pid = chain.pid.numpy().astype(np.int64).reshape(n0, n1, n2)
    n_pat = chain.st.numel() // cuda_smoother.stencil_values(3)
    assert pid.max() < n_pat <= 27
    x = torch.tensor(np.random.default_rng(5).normal(size=3 * n0 * n1 * n2))
    ref = cuda_smoother._apply_plain(chain.geo, chain.ke, chain.mask, x).reshape(3, n0, n1, n2)
    st = chain.st.numpy().reshape(n_pat, 3, cuda_smoother.stencil_k(3))[:, :, :81]
    st = st.reshape(n_pat, 3, 27, 3)  # [p][k][d][j]
    xp = np.pad(x.numpy().reshape(3, n0, n1, n2), ((0, 0), (1, 1), (1, 1), (1, 1)))
    got = np.zeros((3, n0, n1, n2))
    for d in range(27):
        d0, d1, d2 = d // 9, (d // 3) % 3, d % 3
        nb = xp[:, d0 : d0 + n0, d1 : d1 + n1, d2 : d2 + n2]  # [k, ...]
        got += np.einsum("kj...,k...->j...", np.moveaxis(st[pid][..., d, :], (3, 4), (0, 1)), nb)
    close(got, ref.numpy(), 1e-12)


def test_kernel_refuses_a_cell_mask_other_than_0_and_1(twins):
    """The pattern stencils assume a validity mask; another mask keeps the
    plain chain on the CPU and is refused before any launch."""
    mg_t, _, r_gm = twins
    pre = mg_t.fused[0]["pre"]
    mask = pre.mask.clone()
    mask[0] = 0.5
    chain = cuda_smoother.build_fused_smoother(pre.geo, pre.ke.numpy(), pre.inv_d, mask,
                                               nu=2, zero_start=True, emit_residual=False)
    assert chain.st is None and chain.pid is None
    torch.testing.assert_close(chain(r_gm), chain.plain(r_gm), rtol=0, atol=0)
    with pytest.raises(ValueError, match="0 and 1"):
        chain._kernel(None, r_gm)


GRIDS_50 = ((51,) * 3, (26,) * 3, (13,) * 3, (7,) * 3, (4,) * 3)
PATTERNS_50 = (27,) * 5  # corners, edges, faces and the interior on every level


def test_a_box_level_has_27_patterns(twins):
    mg_t, _, _ = twins
    assert mg_t.fused_cycle.patterns() == [27, 27, 27]


@pytest.mark.parametrize(("itemsize", "smem", "first"), [
    # float32 at 227 KB: 13^3, 7^3, 4^3 take 91.5 KB of vectors and 79.7 KB of stencils
    (4, 232_448, 2),
    (8, 232_448, 3),  # float64: 183.1 + 159.5 KB at level 2 do not fit; 7^3 and 4^3 do
    (4, 150_000, 3),  # a smaller block: the tail starts one level lower
    (8, 100_000, 4),
])
def test_tail_start_rule(itemsize, smem, first):
    assert cuda_smoother.tail_start(GRIDS_50, PATTERNS_50, itemsize, smem) == first
    assert cuda_smoother.tail_bytes(GRIDS_50, PATTERNS_50, itemsize, first) <= smem
    assert cuda_smoother.tail_bytes(GRIDS_50, PATTERNS_50, itemsize, first - 1) > smem


def test_tail_start_rule_raises_when_the_coarsest_level_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_smoother.tail_start(GRIDS_50, PATTERNS_50, 8, 1000)


@pytest.fixture(scope="module")
def matvec_box(mat):
    pair = _spaces((5, 3, 4))
    gj = jax_build_geometry(pair["jax"][0], 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(pair["torch"][0], 2, Constraint.FULL, device="cpu",
                                   dtype=F64)
    rng = np.random.default_rng(6)
    u = jnp.asarray(rng.normal(size=gt.ndofs) * 5e-3)
    hist = {"eps_n": jnp.zeros(gj.qp_shape(6)), "alpha": jnp.zeros(gj.qp_shape(1))}
    _, tg_j, _ = JVonMises3D(mat).evaluate_packed(
        0.0, 1.0, gj.strain_gm(gj.to_grid_major(u)), jnp.zeros(gj.qp_shape(6)), hist)
    assert float(jnp.abs(tg_j.gamma).max()) > 0  # plastic somewhere
    tg_t = IsotropicTangent(
        kappa=mat["p_ka"], beta=torch.tensor(np.asarray(tg_j.beta)),
        gamma=torch.tensor(np.asarray(tg_j.gamma)), n=torch.tensor(np.asarray(tg_j.n)),
    )
    v = rng.normal(size=gt.ndofs)
    v_j, v_t = gj.to_grid_major(jnp.asarray(v)), gt.to_grid_major(torch.tensor(v))
    return gj, tg_j, v_j, build_cuda_matvec(gt)(v_t, tg_t)


def test_matvec_entry_point_on_a_non_cubic_box_matches_jax(matvec_box):
    gj, tg_j, v_j, r_port = matvec_box
    assert r_port.shape == (3 * 6 * 4 * 5,)
    close(r_port.numpy(), gj.matvec_gm(v_j, tg_j), 1e-12)


def test_matvec_entry_point_on_a_non_cubic_box_matches_pallas_interpret(matvec_box,
                                                                       monkeypatch):
    gj, tg_j, v_j, r_port = matvec_box
    orig = pl.pallas_call
    monkeypatch.setattr(pm.pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k))
    close(r_port.numpy(), pm.build_pallas_matvec(gj)(v_j, tg_j), 1e-9)
