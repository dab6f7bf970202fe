"""The rank-local geometries of a sharded problem, in one process (float64,
CPU), and the small signature gaps closed beside them.

* ``slab_geometry``: the slabs of a box (structured, structured-tet with a
  subset view, lattice), each given its cells' part of a field, reproduce
  the whole box's strain on their cells and, summed over the slabs into the
  whole grid-major vector, its residual, operator apply and Jacobi diagonal
  (within 1e-13 of the largest entry);
* ``build_windowed_geometry(node_range=...)``: a plan on a window of the
  whole RCM order gives the residual of the same cells on the whole layout;
* ``IsotropicTangent.full_matrix``, ``insert_cells(dense, dtype)`` on the
  three box geometries and ``build_windowed_exchange(max_pad_ratio=...)``
  against the JAX package's.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu.ops import packed as jpacked
from fenics_constitutive_tpu.ops import structured as jst
from fenics_constitutive_tpu.ops import windowed as jwin
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.ops import mandel
from fenics_constitutive_tpu_torch.ops.packed import IsotropicTangent
from fenics_constitutive_tpu_torch.ops.structured import (
    build_lattice_geometry,
    build_structured_geometry,
    build_structured_tet_geometry,
    restrict_structured_tet_geometry,
    slab_geometry,
)
from fenics_constitutive_tpu_torch.ops.windowed import (
    build_windowed_exchange,
    build_windowed_geometry,
    reverse_cuthill_mckee,
)

F64 = torch.float64
FULL = mandel.Constraint.FULL
JFULL = JConstraint.FULL


def box_geometry(kind):
    if kind == "hex":
        V = tfem.FunctionSpace(tfem.unit_cube_mesh(5, 3, 4, "hex"), 1, 3)
        return build_structured_geometry(V, 2, FULL, device="cpu", dtype=F64)
    if kind == "lattice":
        V = tfem.FunctionSpace(tfem.unit_cube_mesh(3, 2, 2, "hex"), 2, 3)
        return build_lattice_geometry(V, 4, FULL, device="cpu", dtype=F64)
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(4, 3, 3, "tetra"), 1, 3)
    geo = build_structured_tet_geometry(V, 2, FULL, device="cpu", dtype=F64)
    if kind == "tet_view":  # a law on the cells above z = 0.5
        z = V.mesh.cell_midpoints()[:, 2]
        geo = restrict_structured_tet_geometry(geo, np.flatnonzero(z > 0.5))
    return geo


def tangent(geo, rng, n_cells):
    """A plastic IsotropicTangent on the geometry's dense cells."""
    Q = geo.n_qp
    beta = 1.0 + rng.random((1, Q, n_cells))
    nvec = rng.normal(size=(6, Q, n_cells))
    nvec /= np.linalg.norm(nvec, axis=0)
    return beta, 0.5 * beta, nvec


@pytest.mark.parametrize("kind", ["hex", "tet", "tet_view", "lattice"])
def test_slabs_reproduce_the_whole_box(kind):
    geo = box_geometry(kind)
    rng = np.random.default_rng(7)
    C = geo.extract_cells(torch.zeros(1, *geo.qp_shape(1)[1:], dtype=F64)).shape[2]
    sig = torch.as_tensor(rng.normal(size=(6, geo.n_qp, C)))
    beta, gamma, nvec = tangent(geo, rng, C)
    u = torch.as_tensor(rng.normal(size=geo.vs * geo.M))

    def iso(g, pos):
        def field(x):
            return g.insert_cells(torch.as_tensor(x[:, :, pos]))

        return IsotropicTangent(3.0, field(beta)[0], field(gamma)[0], field(nvec))

    all_cells = np.arange(C)
    whole_tg = iso(geo, all_cells)
    ref = {
        "residual": geo.residual_gm(geo.insert_cells(sig)),
        "matvec": geo.matvec_gm(u, whole_tg),
        "diag": geo.jacobi_diag_gm(whole_tg),
    }
    strain = geo.extract_cells(geo.strain_gm(u))
    got = {k: torch.zeros_like(v) for k, v in ref.items()}
    X, seen = geo.grid[0], []
    for x0, x1 in ((0, 1), (1, X - 1), (X - 1, X)):
        slab, lo, pos = slab_geometry(geo, x0, x1)
        seen.append(pos)
        tg = iso(slab, pos)
        cut = u.reshape(geo.vs, geo.M)[:, lo : lo + slab.M].reshape(-1)
        torch.testing.assert_close(slab.extract_cells(slab.strain_gm(cut)), strain[:, :, pos],
                                   rtol=0, atol=1e-13 * float(strain.abs().max()))
        parts = {
            "residual": slab.residual_gm(slab.insert_cells(sig[:, :, pos])),
            "matvec": slab.matvec_gm(cut, tg),
            "diag": slab.jacobi_diag_gm(tg),
        }
        for k, v in parts.items():
            got[k].reshape(geo.vs, geo.M)[:, lo : lo + slab.M] += v.reshape(geo.vs, slab.M)
    assert np.array_equal(np.sort(np.concatenate(seen)), all_cells)  # a partition
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-13 * float(v.abs().max()))


def test_slab_rejects_an_empty_range():
    geo = box_geometry("hex")
    with pytest.raises(ValueError, match="non-empty"):
        slab_geometry(geo, 2, 2)


def test_windowed_plan_on_a_node_range(tets):
    """A plan of half the cells on its window of the whole RCM order gives
    that half's residual on the whole layout, sliced."""
    V = tets(5)["torch"][0]
    perm = reverse_cuthill_mckee(V.cell_dof_nodes, V.n_dof_nodes)
    rcm = perm[V.cell_dof_nodes]
    cells = np.argsort(rcm.min(axis=1), kind="stable")[: V.mesh.num_cells // 2]
    n0, n1 = int(rcm[cells].min()), int(rcm[cells].max()) + 1
    opts = dict(device="cpu", dtype=F64, tile=128, perm=perm)
    whole = build_windowed_geometry(V, 2, FULL, cells, **opts)
    part = build_windowed_geometry(V, 2, FULL, cells, node_range=(n0, n1), **opts)
    assert part.M == n1 - n0 and part.ex.C_pad <= whole.ex.C_pad
    rng = np.random.default_rng(3)
    dense = torch.as_tensor(rng.normal(size=(6, whole.n_qp, len(cells))))
    r_whole = whole.residual(whole.insert_cells(dense)).reshape(3, -1)[:, n0:n1]
    r_part = part.residual(part.insert_cells(dense)).reshape(3, -1)[:, : n1 - n0]
    torch.testing.assert_close(r_part, r_whole, rtol=0, atol=1e-13 * float(r_whole.abs().max()))
    torch.testing.assert_close(part.extract_cells(part.insert_cells(dense)), dense)


def test_full_matrix_matches_jax():
    rng = np.random.default_rng(11)
    N = 17
    beta, gamma = rng.random(N) + 1.0, rng.random(N)
    nvec = rng.normal(size=(6, N))
    got = IsotropicTangent(2.5, torch.as_tensor(beta), torch.as_tensor(gamma),
                           torch.as_tensor(nvec)).full_matrix()
    ref = jpacked.IsotropicTangent(jnp.asarray(2.5), jnp.asarray(beta), jnp.asarray(gamma),
                                   jnp.asarray(nvec)).full_matrix()
    assert got.shape == (6, 6, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-14, atol=1e-14)
    # its action is the factored apply's
    eps = torch.as_tensor(rng.normal(size=(6, N)))
    tg = IsotropicTangent(2.5, torch.as_tensor(beta), torch.as_tensor(gamma),
                          torch.as_tensor(nvec))
    torch.testing.assert_close((got * eps[None]).sum(dim=1), tg.apply(eps))


@pytest.mark.parametrize("kind", ["hex", "tet_view", "lattice"])
def test_insert_cells_dtype_matches_jax(kind):
    geo = box_geometry(kind)
    if kind == "hex":
        jV = jfem.FunctionSpace(jfem.unit_cube_mesh(5, 3, 4, "hex"), 1, 3)
        jgeo = jst.build_structured_geometry(jV, 2, JFULL)
    elif kind == "lattice":
        jV = jfem.FunctionSpace(jfem.unit_cube_mesh(3, 2, 2, "hex"), 2, 3)
        jgeo = jst.build_lattice_geometry(jV, 4, JFULL)
    else:
        jV = jfem.FunctionSpace(jfem.unit_cube_mesh(4, 3, 3, "tetra"), 1, 3)
        z = jV.mesh.cell_midpoints()[:, 2]
        jgeo = jst.restrict_structured_tet_geometry(
            jst.build_structured_tet_geometry(jV, 2, JFULL), np.flatnonzero(z > 0.5))
    C = geo.extract_cells(torch.zeros(1, *geo.qp_shape(1)[1:], dtype=F64)).shape[2]
    dense = np.random.default_rng(5).normal(size=(2, geo.n_qp, C))
    for dtype, jdtype in ((None, None), (torch.float32, jnp.float32)):
        got = geo.insert_cells(torch.as_tensor(dense), dtype=dtype)
        ref = jgeo.insert_cells(jnp.asarray(dense), dtype=jdtype)
        assert got.dtype == (dtype or F64)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ratio", [1.0, 4.0])
def test_max_pad_ratio_matches_jax(tets, ratio):
    """The plan warns above ``max_pad_ratio`` padded slots per cell, as
    JAX's does, and is the same plan either way."""
    V = tets(4)["torch"][0]
    cells = V.mesh.cells[: V.mesh.num_cells // 3]
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        ex = build_windowed_exchange(cells, V.mesh.num_nodes, device="cpu", tile=128,
                                     max_pad_ratio=ratio)
    with warnings.catch_warnings(record=True) as ref:
        warnings.simplefilter("always")
        jex = jwin.build_windowed_exchange(cells, V.mesh.num_nodes, tile=128,
                                           max_pad_ratio=ratio)
    padding = [w for w in got if "padding ratio" in str(w.message)]
    assert len(padding) == len([w for w in ref if "padding ratio" in str(w.message)])
    assert len(padding) == (1 if ex.pad_ratio > ratio else 0)
    np.testing.assert_array_equal(ex.loc.numpy(), np.asarray(jex.loc))
