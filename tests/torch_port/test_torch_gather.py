"""The gather engine (ops/packed.py, PackedGeometry) against the JAX
package's, float64.

* The assembly plan ``gather_idx`` equals the JAX package's (built there by
  a loop over the dofs, here vectorised), and so do ``dofmap_t`` and the
  uniform-geometry flag.
* strain, residual, matvec and jacobi_diag agree within 1e-12 of each
  field's largest entry on uniform meshes (hexes, an interval, where the
  folded KEPS_c/KDIV_c path runs) and non-uniform ones (shuffled tets,
  triangles, perturbed hexes; P1, and P2 on a small tet mesh), with a
  factored tangent in 3D and a dense one on every mesh.
* A step of two laws on the gather engine (a soft and a plastic region of a
  shuffled tet mesh) and PackedSimulation(engine="gather") converge to the
  JAX package's states within the reference's BVP tolerance (rtol 1e-7).
* An interval bar per UNIAXIAL constraint (LinearElasticityModel
  UNIAXIAL_STRAIN and UNIAXIAL_STRESS, UniaxialStrainFrom3D(VonMises3D))
  runs through PackedSimulation as in JAX.
* Assembly repeats bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu.ops.packed import DenseTangent as JDense
from fenics_constitutive_tpu.ops.packed import IsotropicTangent as JIso
from fenics_constitutive_tpu.ops.packed import build_packed_geometry as jax_build
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.ops import (
    Constraint,
    DenseTangent,
    IsotropicTangent,
    PackedGeometry,
    build_packed_geometry,
)
from fenics_constitutive_tpu_torch.solver import PackedSimulation
from fenics_constitutive_tpu_torch.utils import model_from_jax

F64 = torch.float64
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}
CONVERGED = dict(newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-12)


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max(), err_msg=what)


def shuffled(fem, mesh, seed=0):
    """The mesh with its node numbering shuffled and no structured metadata."""
    pi = np.random.default_rng(seed).permutation(mesh.num_nodes)
    nodes = np.empty_like(mesh.nodes)
    nodes[pi] = mesh.nodes
    return fem.Mesh(nodes, pi[mesh.cells].astype(np.int32), mesh.cell_type)


def perturbed(fem, mesh, seed=1):
    """The mesh with its interior nodes moved by up to a tenth of a cell."""
    x = mesh.nodes.copy()
    inner = np.all((x > 1e-9) & (x < 1 - 1e-9), axis=1)
    h = 1.0 / 3.0
    x[inner] += np.random.default_rng(seed).uniform(-0.1 * h, 0.1 * h, size=x[inner].shape)
    return fem.Mesh(x, mesh.cells, mesh.cell_type)


#: name -> (mesh maker(fem), degree, value size, constraint name, uniform)
MESHES = {
    "hex": (lambda f: f.unit_cube_mesh(3, 2, 2, "hex"), 1, 3, "FULL", True),
    "hex-perturbed": (lambda f: perturbed(f, f.unit_cube_mesh(3, 3, 3, "hex")), 1, 3, "FULL",
                      False),
    "tet": (lambda f: shuffled(f, f.unit_cube_mesh(3, 3, 2, "tetra")), 1, 3, "FULL", False),
    "tet-p2": (lambda f: shuffled(f, f.unit_cube_mesh(2, 2, 2, "tetra")), 2, 3, "FULL", False),
    "triangle": (lambda f: f.unit_square_mesh(4, 3, "triangle"), 1, 2, "PLANE_STRAIN", False),
    "interval": (lambda f: f.unit_interval_mesh(7), 1, 1, "UNIAXIAL_STRAIN", True),
}


@pytest.fixture(scope="module", params=sorted(MESHES))
def geometries(request):
    make, degree, vs, cname, uniform = MESHES[request.param]
    Vj = jfem.FunctionSpace(make(jfem), degree, vs)
    Vt = tfem.FunctionSpace(make(tfem), degree, vs)
    gj = jax_build(Vj, 2, jm.Constraint[cname], None, jnp.float64)
    gt = build_packed_geometry(Vt, 2, Constraint[cname], device="cpu", dtype=F64)
    assert gt.uniform == gj.uniform == uniform
    return request.param, gj, gt


def test_plan_equals_jax(geometries):
    _, gj, gt = geometries
    np.testing.assert_array_equal(gt.gather_idx.numpy(), np.asarray(gj.gather_idx))
    np.testing.assert_array_equal(gt.dofmap_t.numpy(), np.asarray(gj.dofmap_t))
    close(gt.dN, gj.dN, 1e-15, "dN")
    close(gt.w, gj.w, 1e-15, "w")
    assert set(gt.build_seconds) == {"geometry", "gather_idx", "upload"}


def tangents(gj, rng):
    """A dense tangent (every mesh) and a factored one (3D), both packages."""
    s, N = gj.constraint.stress_strain_dim, gj.N
    A = rng.normal(size=(s, s, N))
    C = np.einsum("stn,rtn->srn", A, A) + 3.0 * np.eye(s)[:, :, None]  # SPD per point
    out = [("dense", JDense(jnp.asarray(C)), DenseTangent(torch.tensor(C)))]
    if s == 6:
        beta = rng.uniform(1.0, 2.0, size=N)
        nvec = rng.normal(size=(6, N))
        out.append(("factored",
                    JIso(jnp.asarray(3.0), jnp.asarray(beta), jnp.asarray(0.4 * beta),
                         jnp.asarray(nvec)),
                    IsotropicTangent(3.0, torch.tensor(beta), torch.tensor(0.4 * beta),
                                     torch.tensor(nvec))))
    return out


def test_ops_match_jax(geometries):
    name, gj, gt = geometries
    rng = np.random.default_rng(11)
    u = rng.normal(size=gt.ndofs)
    close(gt.strain(torch.tensor(u)), gj.strain(jnp.asarray(u)), 1e-12, f"{name} strain")
    close(gt.grad(torch.tensor(u)), gj.grad(jnp.asarray(u)), 1e-12, f"{name} grad")
    sig = rng.normal(size=(gt.sdim, gt.N))
    close(gt.residual(torch.tensor(sig)), gj.residual(jnp.asarray(sig)), 1e-12,
          f"{name} residual")
    for kind, tj, tt in tangents(gj, rng):
        close(gt.matvec(torch.tensor(u), tt), gj.matvec(jnp.asarray(u), tj), 1e-12,
              f"{name} {kind} matvec")
        close(gt.jacobi_diag(tt), gj.jacobi_diag(tj), 1e-12, f"{name} {kind} jacobi_diag")


def test_assembly_repeats_bit_for_bit(geometries):
    _, _, gt = geometries
    sig = torch.tensor(np.random.default_rng(2).normal(size=(gt.sdim, gt.N)))
    assert torch.equal(gt.residual(sig), gt.residual(sig.clone()))
    assert gt.extract_cells(sig).shape == (gt.sdim, gt.n_qp, gt.n_cells)


def bench_bcs(fem, V, stretch):
    def close_to(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    return [
        fem.DirichletBC(V.locate_dofs_geometrical(close_to(0, 0.0), component=0), 0.0),
        fem.DirichletBC(V.locate_dofs_geometrical(close_to(0, 1.0), component=0), stretch),
        fem.DirichletBC(V.locate_dofs_geometrical(close_to(1, 0.0), component=1), 0.0),
        fem.DirichletBC(V.locate_dofs_geometrical(close_to(2, 0.0), component=2), 0.0),
    ]


def two_laws(mesh, pkg):
    """A soft elastic region below z = 0.5 and a plastic one above."""
    z = mesh.cell_midpoints()[:, 2]
    soft = jm.LinearElasticityModel({"E": 60000.0, "nu": 0.25}, jm.Constraint.FULL)
    hard = jm.VonMises3D(MAT)
    laws = [(soft, np.flatnonzero(z < 0.5)), (hard, np.flatnonzero(z >= 0.5))]
    if pkg == "torch":
        laws = [(model_from_jax(m), c) for m, c in laws]
    return laws


@pytest.mark.parametrize("n_laws", [1, 2])
def test_gather_simulation_matches_jax(n_laws):
    """PackedSimulation(engine="gather") on a shuffled 3^3 tet mesh, one law
    (VonMises3D) or two, Jacobi CG: three plastic steps, converged states
    equal within rtol 1e-7."""
    sims = {}
    for pkg, fem, Sim, kw in (("jax", jfem, JPackedSimulation, {}),
                              ("torch", tfem, PackedSimulation,
                               {"device": "cpu", "dtype": F64})):
        V = fem.FunctionSpace(shuffled(fem, fem.unit_cube_mesh(3, 3, 3, "tetra")), 1, 3)
        if n_laws == 1:
            laws = jm.VonMises3D(MAT) if pkg == "jax" else model_from_jax(jm.VonMises3D(MAT))
        else:
            laws = two_laws(V.mesh, pkg)
        sims[pkg] = Sim(laws, V, bench_bcs(fem, V, 0.0), 2, engine="gather", **CONVERGED, **kw)
    st, sj = sims["torch"], sims["jax"]
    assert st.engine == "gather" and st.preconditioner is None
    assert all(isinstance(g, PackedGeometry) for g in st._geos)
    for k in (1, 2, 3):
        for sim in (sj, st):
            sim.bcs[1].value = 0.004 * k
            assert sim.solve()[1], k
        close(st.u, sj.u, 1e-7, f"u step {k}")
        close(torch.as_tensor(st.stress), sj.stress, 1e-7, f"stress step {k}")
    assert float(st.histories[-1]["alpha"].max()) > 0


UNIAXIAL = {
    "strain": lambda: jm.LinearElasticityModel({"E": 42000.0, "nu": 0.3},
                                               jm.Constraint.UNIAXIAL_STRAIN),
    "stress": lambda: jm.LinearElasticityModel({"E": 42000.0, "nu": 0.3},
                                               jm.Constraint.UNIAXIAL_STRESS),
    "mises-from-3d": lambda: jm.UniaxialStrainFrom3D(jm.VonMises3D(MAT)),
}


@pytest.mark.parametrize("law", sorted(UNIAXIAL))
def test_interval_bar_matches_jax(law):
    """A bar of 8 intervals, x = 0 fixed and x = 1 pulled, on the gather
    engine: two converged steps, the displacements and stresses of JAX."""
    sims = {}
    for pkg, fem, Sim, kw in (("jax", jfem, JPackedSimulation, {}),
                              ("torch", tfem, PackedSimulation,
                               {"device": "cpu", "dtype": F64})):
        V = fem.FunctionSpace(fem.unit_interval_mesh(8), 1, 1)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 0.0)), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 1.0)), 0.0)]
        model = UNIAXIAL[law]()
        sims[pkg] = Sim(model if pkg == "jax" else model_from_jax(model), V, bcs, 2,
                        **CONVERGED, **kw)
    st, sj = sims["torch"], sims["jax"]
    assert st.engine == "gather"
    for k in (1, 2):
        for sim in (sj, st):
            sim.bcs[1].value = 0.004 * k
            assert sim.solve()[1], k
        close(st.u, sj.u, 1e-7, f"u step {k}")
        close(torch.as_tensor(st.stress), sj.stress, 1e-7, f"stress step {k}")
    assert np.abs(st.stress).max() > 1.0


@pytest.mark.parametrize("constraint", ["FULL", "PLANE_STRAIN", "UNIAXIAL_STRAIN"])
def test_packed_strain_takes_a_constraint(constraint):
    """``packed_strain(grad, constraint)``, JAX's signature: the Mandel
    strain of a random gradient field, and the same from the geometry's
    tensor form of the map."""
    from fenics_constitutive_tpu.models import Constraint as JConstraint
    from fenics_constitutive_tpu.ops.packed import packed_strain as jax_strain
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.ops import mandel
    from fenics_constitutive_tpu_torch.ops.packed import packed_strain

    c, cj = Constraint[constraint], JConstraint[constraint]
    g = {"FULL": 3, "PLANE_STRAIN": 2, "UNIAXIAL_STRAIN": 1}[constraint]
    grad = np.random.default_rng(5).normal(size=(g, g, 40))
    want = np.asarray(jax_strain(jnp.asarray(grad), cj))
    got = packed_strain(torch.tensor(grad), c)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    T = torch.tensor(mandel._mandel_matrix_map(c))
    assert torch.equal(packed_strain(torch.tensor(grad), T), got)
