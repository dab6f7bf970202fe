"""The structured-tet engine (ops/structured.py, StructuredTetGeometry): the
Kuhn classes of a box simplex mesh folded onto the hex corner channels.
The port's mirror of the JAX package's tests/solver/test_structured_tet.py,
float64.

* Tet (3 x 4 x 5, 6 classes) and triangle (3 x 5, 2 classes) ops: strain,
  residual, operator and Jacobi diagonal equal the port's gather engine
  within 1e-13 and the JAX package's structured-tet engine within 1e-12.
* The subset view (restrict_structured_tet_geometry) equals the gather
  engine on the same simplices, with classes mixed within cubes.
* Two laws on a Kuhn box through PackedSimulation (the masked views, picked
  by "auto") equal the gather engine and the JAX package, tets and
  triangles; one law with the V-cycle below the tet fine level matches JAX.
* The hierarchy below a tet fine level: hex synthetic coarse levels; the
  fused V-cycle (K3's plain twins on the CPU) equals the unfused one, and
  the JAX package's fused cycle (Pallas in interpret mode), which accepts a
  tet fine level.
* hot_path_geometry refuses a tet geometry whatever its n_qp, so K1 and K2
  never take one; a box that is not the unit one raises ValueError.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.ops.packed import IsotropicTangent as JIso
from fenics_constitutive_tpu.ops.structured import (
    build_structured_tet_geometry as jax_build_tet,
)
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu.solver.multigrid import build_multigrid as jax_build_multigrid
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.ops import (
    Constraint,
    DenseTangent,
    IsotropicTangent,
    StructuredGeometry,
    StructuredTetGeometry,
    build_packed_geometry,
    build_structured_geometry,
    build_structured_tet_geometry,
    restrict_structured_tet_geometry,
)
from fenics_constitutive_tpu_torch.ops.cuda_matvec import hot_path_geometry
from fenics_constitutive_tpu_torch.solver import PackedSimulation, build_multigrid
from fenics_constitutive_tpu_torch.utils import model_from_jax

F64 = torch.float64
MU, KAPPA = 80769.0, 175000.0
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=what)


def tet_ops(gt, u, sig, tg):
    """strain (dense per simplex), residual, operator and diagonal of the
    structured-tet engine, node-major."""
    u_gm = gt.to_grid_major(u)
    return {
        "strain": gt.extract_cells(gt.strain_gm(u_gm)),
        "residual": gt.to_node_major(gt.residual_gm(gt.insert_cells(sig))),
        "matvec": gt.to_node_major(gt.matvec_gm(u_gm, tg)),
        "jacobi_diag": gt.to_node_major(gt.jacobi_diag_gm(tg)),
    }


def gather_ops(gp, u, sig, tg):
    return {
        "strain": gp.extract_cells(gp.strain(u)),
        "residual": gp.residual(sig.reshape(sig.shape[0], -1)),
        "matvec": gp.matvec(u, tg),
        "jacobi_diag": gp.jacobi_diag(tg),
    }


CASES = {
    "tetra": (lambda f: f.unit_cube_mesh(3, 4, 5, "tetra"), 3, "FULL", 6),
    "triangle": (lambda f: f.unit_square_mesh(3, 5, "triangle"), 2, "PLANE_STRAIN", 2),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_ops_match_gather_engine_and_jax(cell):
    make, vs, cname, K = CASES[cell]
    Vt = tfem.FunctionSpace(make(tfem), 1, vs)
    Vj = jfem.FunctionSpace(make(jfem), 1, vs)
    gt = build_structured_tet_geometry(Vt, 2, Constraint[cname], device="cpu", dtype=F64)
    gp = build_packed_geometry(Vt, 2, Constraint[cname], device="cpu", dtype=F64)
    gj = jax_build_tet(Vj, 2, jm.Constraint[cname], jnp.float64)
    assert isinstance(gt, StructuredTetGeometry) and gt.n_classes == gj.n_classes == K
    assert gt.qp_shape(1) == (1, K * gt.n_qp, gt.M) and gt.n_cells == Vt.mesh.num_cells

    rng = np.random.default_rng(0)
    s, Q, C = gt.sdim, gt.n_qp, gt.n_cells
    u = rng.normal(size=Vt.ndofs)
    sig = rng.normal(size=(s, Q, C))
    beta = rng.uniform(1.0, 2.0, size=(Q, C))
    if s == 6:
        nvec = rng.normal(size=(6, Q, C))
        tg_t = IsotropicTangent(3.0, gt.insert_cells(torch.tensor(beta)[None])[0],
                                gt.insert_cells(torch.tensor(0.7 * beta)[None])[0],
                                gt.insert_cells(torch.tensor(nvec)))
        tg_p = IsotropicTangent(3.0, torch.tensor(beta.reshape(-1)),
                                torch.tensor(0.7 * beta.reshape(-1)),
                                torch.tensor(nvec.reshape(6, -1)))
        tg_j = JIso(jnp.asarray(3.0), gj.insert_cells(jnp.asarray(beta)[None])[0],
                    gj.insert_cells(jnp.asarray(0.7 * beta)[None])[0],
                    gj.insert_cells(jnp.asarray(nvec)))
    else:
        A = rng.normal(size=(s, s, Q, C))
        Cm = np.einsum("stqc,rtqc->srqc", A, A) + 2.0 * np.eye(s)[:, :, None, None]
        tg_t = DenseTangent(gt.insert_cells(torch.tensor(Cm.reshape(s * s, Q, C))).reshape(
            s, s, gt.qp_layout, gt.M))
        tg_p = DenseTangent(torch.tensor(Cm.reshape(s, s, -1)))
        tg_j = None
    got = tet_ops(gt, torch.tensor(u), torch.tensor(sig), tg_t)
    ref = gather_ops(gp, torch.tensor(u), torch.tensor(sig), tg_p)
    for key in got:
        close(got[key], ref[key], 1e-13, f"{cell} {key} vs gather")
    close(got["strain"], gj.extract_cells(gj.strain(jnp.asarray(u))), 1e-12, "strain vs JAX")
    close(got["residual"], gj.residual(gj.insert_cells(jnp.asarray(sig))), 1e-12,
          "residual vs JAX")
    if tg_j is not None:
        close(got["matvec"], gj.matvec(jnp.asarray(u), tg_j), 1e-12, "matvec vs JAX")
        close(got["jacobi_diag"], gj.jacobi_diag(tg_j), 1e-12, "jacobi_diag vs JAX")
        close(gt.grad(torch.tensor(u)), gj.grad(jnp.asarray(u)), 1e-12, "grad vs JAX")


def test_subset_view_matches_gather_engine():
    """A law on an x-half of the tets plus ragged extras, so classes mix
    within cubes: the per-class masked view equals the gather engine on the
    same tets, its dense fields come back in the subset's order."""
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(3, 4, 5, "tetra"), 1, 3)
    rng = np.random.default_rng(7)
    mids = V.mesh.cell_midpoints()
    sub = np.flatnonzero((mids[:, 0] < 0.5) | (rng.random(V.mesh.num_cells) < 0.1))
    full = build_structured_tet_geometry(V, 2, Constraint.FULL, device="cpu", dtype=F64)
    gt = restrict_structured_tet_geometry(full, sub)
    gp = build_packed_geometry(V, 2, Constraint.FULL, sub, device="cpu", dtype=F64)
    assert gt.n_cells == len(sub) and gt.KEPS_c is full.KEPS_c

    u = torch.tensor(rng.normal(size=V.ndofs))
    sig = torch.tensor(rng.normal(size=(6, gt.n_qp, len(sub))))
    # a whole-grid tangent field in the engine layout, and its subset values
    beta = torch.tensor(rng.uniform(1.0, 2.0, size=(gt.qp_layout, gt.M)))
    nvec = torch.tensor(rng.normal(size=(6, gt.qp_layout, gt.M)))
    tg_t = IsotropicTangent(3.0, beta, 0.5 * beta, nvec)
    beta_p = gt.extract_cells(beta[None])[0].reshape(-1)
    tg_p = IsotropicTangent(3.0, beta_p, 0.5 * beta_p, gt.extract_cells(nvec).reshape(6, -1))
    got, ref = tet_ops(gt, u, sig, tg_t), gather_ops(gp, u, sig, tg_p)
    for key in got:
        close(got[key], ref[key], 1e-13, f"subset {key}")
    close(gt.extract_cells(gt.insert_cells(sig)), sig, 0.0, "insert/extract")


def two_law_sims(cell, engine, pkg):
    make, vs, cname, _ = CASES[cell]
    fem = jfem if pkg == "jax" else tfem
    mesh = (fem.unit_cube_mesh(4, 4, 4, "tetra") if cell == "tetra"
            else fem.unit_square_mesh(6, 6, "triangle"))
    V = fem.FunctionSpace(mesh, 1, vs)
    x = mesh.cell_midpoints()[:, 0]
    con = jm.Constraint[cname]
    laws = [(jm.LinearElasticityModel({"E": 2000.0, "nu": 0.3}, con), np.flatnonzero(x < 0.5)),
            (jm.LinearElasticityModel({"E": 900.0, "nu": 0.2}, con), np.flatnonzero(x >= 0.5))]

    def at(axis, v):
        return lambda p: np.isclose(p[:, axis], v)

    bcs = [fem.DirichletBC(V.locate_dofs_geometrical(at(0, 0.0), component=0), 0.0),
           fem.DirichletBC(V.locate_dofs_geometrical(at(0, 1.0), component=0), 0.01),
           fem.DirichletBC(V.locate_dofs_geometrical(at(1, 0.0), component=1), 0.0)]
    if vs == 3:
        bcs.append(fem.DirichletBC(V.locate_dofs_geometrical(at(2, 0.0), component=2), 0.0))
    opts = dict(engine=engine, newton_rtol=1e-12, newton_atol=1e-12, cg_rtol=1e-14)
    if pkg == "jax":
        return JPackedSimulation(laws, V, bcs, 2, **opts)
    laws = [(model_from_jax(m), c) for m, c in laws]
    return PackedSimulation(laws, V, bcs, 2, device="cpu", dtype=F64, **opts)


@pytest.mark.parametrize("cell", sorted(CASES))
def test_two_law_kuhn_box_matches_gather_and_jax(cell):
    sims = {"auto": two_law_sims(cell, "auto", "torch"),
            "gather": two_law_sims(cell, "gather", "torch"),
            "jax": two_law_sims(cell, "auto", "jax")}
    assert sims["auto"].engine == "structured_tet"
    assert all(isinstance(g, StructuredTetGeometry) for g in sims["auto"]._geos)
    assert sims["gather"].engine == "structured_tet"  # box meshes keep their engine
    for sim in sims.values():
        assert sim.solve()[1]
    ref = sims["jax"]
    for key in ("auto", "gather"):
        close(sims[key].u, ref.u, 1e-12, f"{key} u")
        close(torch.as_tensor(sims[key].stress), ref.stress, 1e-10, f"{key} stress")
    assert np.abs(sims["auto"].stress).max() > 1.0


def test_vcycle_simulation_matches_jax():
    """VonMises3D on a 3^3 Kuhn box with the V-cycle below the tet fine
    level: three plastic steps, converged states equal within rtol 1e-7."""
    sims = {}
    for pkg, fem in (("jax", jfem), ("torch", tfem)):
        V = fem.FunctionSpace(fem.unit_cube_mesh(3, 3, 3, "tetra"), 1, 3)

        def at(axis, v):
            return lambda p: np.isclose(p[:, axis], v)

        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(at(0, 0.0), component=0), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(at(0, 1.0), component=0), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(at(1, 0.0), component=1), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(at(2, 0.0), component=2), 0.0)]
        opts = dict(preconditioner="vcycle", newton_rtol=1e-10, newton_atol=1e-10,
                    cg_rtol=1e-12)
        law = jm.VonMises3D(MAT)
        sims[pkg] = (JPackedSimulation(law, V, bcs, 2, **opts) if pkg == "jax" else
                     PackedSimulation(model_from_jax(law), V, bcs, 2, device="cpu",
                                      dtype=F64, **opts))
    st, sj = sims["torch"], sims["jax"]
    assert (st.engine, st.preconditioner) == ("structured_tet", "vcycle")
    for k in (1, 2, 3):
        for sim in (sj, st):
            sim.bcs[1].value = 0.004 * k
            assert sim.solve()[1], k
        close(st.u, sj.u, 1e-7, f"u step {k}")
        close(torch.as_tensor(st.stress), sj.stress, 1e-7, f"stress step {k}")
    assert float(st.histories[0]["alpha"].max()) > 0


@pytest.fixture(scope="module")
def tet_hierarchies():
    """The V-cycle below a 6^3 Kuhn tet fine level, unfused and fused, in
    both packages, with the benchmark's Dirichlet set."""
    out = {}
    for pkg, fem in (("jax", jfem), ("torch", tfem)):
        V = fem.FunctionSpace(fem.unit_cube_mesh(6, 6, 6, "tetra"), 1, 3)

        def at(axis, v):
            return lambda p: np.isclose(p[:, axis], v)

        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(at(0, 0.0), component=0), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(at(0, 1.0), component=0), 0.01),
               fem.DirichletBC(V.locate_dofs_geometrical(at(1, 0.0), component=1), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(at(2, 0.0), component=2), 0.0)]
        free = np.ones(V.ndofs, bool)
        free[(jax_combine if pkg == "jax" else tfem.combine_bcs)(bcs)[0]] = False
        kw = dict(nu=3, nu_coarse=2, coarse_direct=True)
        if pkg == "jax":
            geo = jax_build_tet(V, 2, jm.Constraint.FULL, jnp.float64)
            out[pkg] = (geo, jax_build_multigrid(geo, MU, KAPPA, jnp.asarray(free), **kw),
                        jax_build_multigrid(geo, MU, KAPPA, jnp.asarray(free),
                                            fused_smoothing=True, **kw))
        else:
            geo = build_structured_tet_geometry(V, 2, Constraint.FULL, device="cpu", dtype=F64)
            opts = dict(device="cpu", dtype=F64, **kw)
            out[pkg] = (geo, build_multigrid(geo, MU, KAPPA, torch.as_tensor(free), **opts),
                        build_multigrid(geo, MU, KAPPA, torch.as_tensor(free),
                                        fused_smoothing=True, **opts))
    return out


def test_hierarchy_below_a_tet_fine_level(tet_hierarchies):
    gj, mj, mfj = tet_hierarchies["jax"]
    gt, mt, mft = tet_hierarchies["torch"]
    assert mfj.fused is not None  # the JAX package accepts a tet fine level
    assert mft.fused_cycle is not None and mt.n_levels == len(mj.geos) >= 2
    assert isinstance(mt.geos[0], StructuredTetGeometry)
    assert all(type(g) is StructuredGeometry and g.n_nodes == 8 for g in mt.geos[1:])
    for lvl in range(mt.n_levels):
        close(getattr(mt, f"diag_kappa_{lvl}"), mj.diag_kappa[lvl], 1e-12, f"diag_kappa {lvl}")
        close(getattr(mt, f"diag_beta_{lvl}"), mj.diag_beta[lvl], 1e-12, f"diag_beta {lvl}")
    r = np.random.default_rng(3).normal(size=gt.ndofs)
    r_gm = gt.to_grid_major(torch.tensor(r))
    z = mt(r_gm)
    close(z, mj(gj.to_grid_major(jnp.asarray(r))), 1e-12, "unfused V-cycle vs JAX")
    z_fused = mft(r_gm)
    close(z_fused, z, 1e-12, "fused (K3 twins) vs unfused")
    close(z_fused, mfj(gj.to_grid_major(jnp.asarray(r))), 1e-12, "fused vs JAX fused")


def test_hot_path_geometry_refuses_tets():
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(2, 2, 2, "tetra"), 1, 3)
    hexes = tfem.FunctionSpace(tfem.unit_cube_mesh(2, 2, 2, "hex"), 1, 3)
    assert hot_path_geometry(
        build_structured_geometry(hexes, 2, Constraint.FULL, device="cpu", dtype=F64))
    for q in (1, 2, 3):
        g = build_structured_tet_geometry(V, q, Constraint.FULL, device="cpu", dtype=F64)
        assert not hot_path_geometry(g)
        eight = copy.copy(g)
        eight.n_qp = 8  # the hex rule's point count: still refused
        assert not hot_path_geometry(eight)


def test_non_unit_box_raises():
    mesh = tfem.unit_cube_mesh(2, 2, 2, "tetra")
    shifted = tfem.Mesh(mesh.nodes * 2.0 + 1.0, mesh.cells, "tetra",
                        structured_shape=mesh.structured_shape)
    V = tfem.FunctionSpace(shifted, 1, 3)
    with pytest.raises(ValueError, match="unit-domain"):
        build_structured_tet_geometry(V, 2, Constraint.FULL, device="cpu", dtype=F64)
