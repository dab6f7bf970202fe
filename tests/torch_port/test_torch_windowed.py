"""The windowed exchange engine (ops/windowed.py) against the JAX package.

Shuffled Kuhn tet boxes of 4^3-6^3 cells with node tiles of 128, so that the
plans have several blocks and windows; float64 unless a test says otherwise.

* Plans: the RCM permutation, ``loc`` and ``cell_order`` equal the JAX
  package's bit for bit (the same host numpy code on the same mesh).
* Exchange: the plain gather equals JAX's ``gather_ref`` exactly (an indexed
  take); the plain scatter matches ``scatter_ref`` to 1e-14 (sums of at most
  24 rows per node in another order). In float32 the plain versions match
  JAX's Pallas kernels run in interpret mode: the gather bit for bit, the
  scatter to 2e-6 (the JAX package's own bound for that comparison).
* The node-major transpose the scatter kernel reads (``node_ptr`` and
  ``node_rows``) lists every non-pad row exactly once, in ascending order,
  and summing each node's list in that order reproduces the scatter.
* Geometry: strain, residual, matvec and jacobi_diag of WindowedGeometry,
  and the boundary transforms, match JAX's to 1e-12 of each result's
  largest entry (sums in another order; float64), on P1 tets (one gradient
  per cell) and on P2 tets (one per quadrature point, 3^3 cells, q_degree 4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.packed import IsotropicTangent as JTangent
from fenics_constitutive_tpu.ops.pallas_window import windowed_gather, windowed_scatter
from fenics_constitutive_tpu.ops.windowed import build_windowed_exchange as jax_exchange
from fenics_constitutive_tpu.ops.windowed import build_windowed_geometry as jax_geometry
from fenics_constitutive_tpu.ops.windowed import reverse_cuthill_mckee as jax_rcm
from fenics_constitutive_tpu_torch.ops import (
    Constraint,
    IsotropicTangent,
    build_windowed_exchange,
    build_windowed_geometry,
    reverse_cuthill_mckee,
)

F64 = torch.float64
SIZES = (4, 5, 6)


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=what)


def plans(pair):
    (Vj, _), (Vt, _) = pair["jax"], pair["torch"]
    exj = jax_exchange(Vj.mesh.cells, Vj.mesh.num_nodes, tile=128)
    ext = build_windowed_exchange(Vt.mesh.cells, Vt.mesh.num_nodes, device="cpu", tile=128)
    return exj, ext


@pytest.mark.parametrize("n", SIZES)
def test_plan_matches_jax(tets, n):
    pair = tets(n)
    Vt = pair["torch"][0]
    np.testing.assert_array_equal(
        reverse_cuthill_mckee(Vt.mesh.cells, Vt.mesh.num_nodes),
        jax_rcm(pair["jax"][0].mesh.cells, Vt.mesh.num_nodes),
    )
    exj, ext = plans(pair)
    if n >= 5:  # 4^3 has 125 nodes: one tile
        assert ext.B > 1 and ext.P > 1  # several blocks and windows
    for attr in ("T", "W", "P", "B", "C_B", "n", "M", "M_pad", "n_cells", "pad_ratio"):
        assert getattr(ext, attr) == getattr(exj, attr), attr
    np.testing.assert_array_equal(ext.perm, exj.perm)
    np.testing.assert_array_equal(ext.cell_order, exj.cell_order)
    np.testing.assert_array_equal(ext.loc.numpy(), np.asarray(exj.loc))


@pytest.mark.parametrize("n", SIZES)
def test_scatter_transpose_plan(tets, n):
    _, ex = plans(tets(n))
    loc = ex.loc.numpy().reshape(-1)
    ptr, rows = ex.node_ptr.numpy(), ex.node_rows.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(rows) == int((loc >= 0).sum())
    assert sorted(rows.tolist()) == np.flatnonzero(loc >= 0).tolist()
    b, r = rows // ex.Rn, rows % ex.Rn
    node = np.repeat(np.arange(ex.M_pad), np.diff(ptr))
    np.testing.assert_array_equal(b * ex.T + loc[rows], node)  # each row feeds its node
    for m in range(ex.M_pad):  # ascending within each node
        assert np.all(np.diff(rows[ptr[m] : ptr[m + 1]]) > 0)
    # the kernel's fixed-order sum equals the plain scatter
    f = np.random.default_rng(n).normal(size=(ex.B, 3, ex.Rn))
    out = np.zeros((3, ex.M_pad))
    for m in range(ex.M_pad):
        for e in range(ptr[m], ptr[m + 1]):
            out[:, m] += f[b[e], :, r[e]]
    close(ex.scatter_ref(torch.tensor(f)), out, 1e-15, "ordered node sums")


@pytest.mark.parametrize("n", SIZES)
def test_exchange_matches_jax(tets, n):
    exj, ext = plans(tets(n))
    rng = np.random.default_rng(n)
    u2 = rng.normal(size=(3, ext.M_pad))
    g = ext.gather(torch.tensor(u2))
    np.testing.assert_array_equal(g.numpy(), np.asarray(exj.gather_ref(jnp.asarray(u2))))
    f = rng.normal(size=(ext.B, 3, ext.Rn))
    close(ext.scatter(torch.tensor(f)), exj.scatter_ref(jnp.asarray(f)), 1e-14, "scatter")
    # rows <-> cells layout helpers
    x = rng.normal(size=(ext.n, 3, ext.C_pad))
    np.testing.assert_array_equal(
        ext.cells_to_rows(torch.tensor(x)).numpy(), np.asarray(exj.cells_to_rows(jnp.asarray(x)))
    )
    np.testing.assert_array_equal(ext.rows_to_cells(ext.cells_to_rows(torch.tensor(x))).numpy(), x)


def test_exchange_f32_matches_pallas_interpret(tets):
    exj, ext = plans(tets(6))
    rng = np.random.default_rng(4)
    u2 = rng.normal(size=(3, ext.M_pad)).astype(np.float32)
    g_pl = windowed_gather(exj, jnp.asarray(u2), interpret=True)
    np.testing.assert_array_equal(ext.gather_ref(torch.tensor(u2)).numpy(), np.asarray(g_pl))
    f = rng.normal(size=(ext.B, 3, ext.Rn)).astype(np.float32)
    y_pl = windowed_scatter(exj, jnp.asarray(f), interpret=True)  # masks pads itself
    y = ext.scatter_ref(torch.tensor(f))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pl), rtol=2e-6, atol=2e-6)


@pytest.fixture(scope="module")
def geometries(tets):
    from fenics_constitutive_tpu.fem import FunctionSpace as JFunctionSpace
    from fenics_constitutive_tpu_torch.fem import FunctionSpace

    out = {}
    for key, n, degree, q in ((4, 4, 1, 2), (6, 6, 1, 2), ("p2", 3, 2, 4)):
        pair = tets(n)
        Vj = JFunctionSpace(pair["jax"][0].mesh, degree, 3)
        Vt = FunctionSpace(pair["torch"][0].mesh, degree, 3)
        gj = jax_geometry(Vj, q, JConstraint.FULL, tile=128)
        gt = build_windowed_geometry(Vt, q, Constraint.FULL, device="cpu", dtype=F64, tile=128)
        out[key] = (gj, gt, pair)
    return out


def tangents(N, seed):
    rng = np.random.default_rng(seed)
    beta = 1.0 + rng.random(N)
    gamma = -rng.random(N)
    n = rng.normal(size=(6, N))
    return (
        JTangent(kappa=3.0, beta=jnp.asarray(beta), gamma=jnp.asarray(gamma), n=jnp.asarray(n)),
        IsotropicTangent(kappa=3.0, beta=torch.tensor(beta), gamma=torch.tensor(gamma),
                         n=torch.tensor(n)),
    )


@pytest.mark.parametrize("n", [4, 6, "p2"])
def test_geometry_layout_matches_jax(geometries, n):
    gj, gt, pair = geometries[n]
    assert (gt.N, gt.ndofs_int, gt.n_qp, gt.M) == (gj.N, gj.ndofs_int, gj.n_qp, gj.M)
    assert gt.compact == (n != "p2") and np.asarray(gj.dN).shape == tuple(gt.dN.shape)
    np.testing.assert_array_equal(gt.dN.numpy(), np.asarray(gj.dN))
    np.testing.assert_array_equal(gt.w.numpy(), np.asarray(gj.w))
    rng = np.random.default_rng(7)
    u = rng.normal(size=gt.ndofs)
    ui = gt.to_internal(torch.tensor(u))
    np.testing.assert_array_equal(ui.numpy(), np.asarray(gj.to_internal(jnp.asarray(u))))
    np.testing.assert_array_equal(gt.from_internal(ui).numpy(), u)
    bc_dofs = np.arange(0, gt.ndofs, 7)
    np.testing.assert_array_equal(gt.bc_internal(torch.tensor(bc_dofs)).numpy(),
                                  np.asarray(gj.bc_internal(jnp.asarray(bc_dofs))))
    np.testing.assert_array_equal(gt.free_internal(torch.tensor(bc_dofs)).numpy(),
                                  np.asarray(gj.free_internal(jnp.asarray(bc_dofs))))
    field = rng.normal(size=(6, gt.N))
    np.testing.assert_array_equal(gt.extract_cells(torch.tensor(field)).numpy(),
                                  np.asarray(gj.extract_cells(jnp.asarray(field))))


@pytest.mark.parametrize("op", ["strain", "residual", "matvec", "jacobi_diag"])
@pytest.mark.parametrize("n", [4, 6, "p2"])
def test_geometry_ops_match_jax(geometries, n, op):
    gj, gt, _ = geometries[n]
    rng = np.random.default_rng(10)
    ui = gt.to_internal(torch.tensor(rng.normal(size=gt.ndofs)))
    tj, tt = tangents(gt.N, 11)
    if op == "strain":
        got, ref = gt.strain(ui), gj.strain(jnp.asarray(ui.numpy()))
    elif op == "residual":
        sig = rng.normal(size=(6, gt.N))
        got, ref = gt.residual(torch.tensor(sig)), gj.residual(jnp.asarray(sig))
    elif op == "matvec":
        got, ref = gt.matvec(ui, tt), gj.matvec(jnp.asarray(ui.numpy()), tj)
    else:
        got, ref = gt.jacobi_diag(tt), gj.jacobi_diag(tj)
    close(got, ref, 1e-12, op)
