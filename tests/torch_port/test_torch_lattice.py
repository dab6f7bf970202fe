"""The lattice engine (degree 2 on a box of hexes or quads) against the JAX
package's LatticeGeometry, float64 on the CPU.

On a 3^3 hex box (P2, q_degree 4, FULL) and a 4 x 3 quad box (P2, q_degree
4, PLANE_STRAIN):

* build_lattice_geometry's buffers and metadata equal JAX's (1e-12);
* every op (strain, residual, operator, Jacobi diagonal, gradient; node-
  and grid-major) on the same inputs agrees with JAX's at rtol 1e-12 of the
  largest entry: JAX computes them as convolutions whose kernel reverses the
  spatial axes, the port as strided slices in the element's local node
  order, so a wrong node permutation shows here;
* the same ops agree with the port's own gather engine on the same space;
* the P2 dof lattice is the refined P1 grid node for node.

Also: the structured-hex kernels refuse a lattice geometry, the step and the
simulation refuse matvec_impl/eval_impl="kernel" on it, and a lattice
checkpoint round trip continues bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.packed import IsotropicTangent as JTangent
from fenics_constitutive_tpu.ops.structured import build_lattice_geometry as jax_build_lattice
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.ops import (
    IsotropicTangent,
    LatticeGeometry,
    build_lattice_geometry,
    build_packed_geometry,
)
from fenics_constitutive_tpu_torch.ops.cuda_matvec import hot_path_geometry
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.solver import (
    PackedSimulation,
    build_packed_problem,
    make_packed_step,
)
from fenics_constitutive_tpu_torch.utils import load_checkpoint, save_checkpoint

F64 = torch.float64
RTOL = 1e-12
CASES = {"hex": ((3, 3, 3), "FULL"), "quad": ((4, 3), "PLANE_STRAIN")}


def close(got, ref, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def p2_space(fem, cells):
    if len(cells) == 3:
        return fem.FunctionSpace(fem.unit_cube_mesh(*cells, "hex"), 2, 3)
    return fem.FunctionSpace(fem.unit_square_mesh(*cells, "quad"), 2, 2)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    cells, c = CASES[request.param]
    Vj, Vt = p2_space(jfem, cells), p2_space(tfem, cells)
    gj = jax_build_lattice(Vj, 4, JConstraint[c], jnp.float64)
    gt = build_lattice_geometry(Vt, 4, Constraint[c], device="cpu", dtype=F64)
    rng = np.random.default_rng(0)
    s, Q, C = gt.sdim, gt.n_qp, gt.n_cells
    fields = dict(beta=rng.uniform(1.0, 2.0, (Q, C)), gamma=rng.uniform(0.0, 1.0, (Q, C)),
                  n=rng.normal(size=(s, Q, C)))
    tj = JTangent(kappa=3.0, **{k: jnp.asarray(v) for k, v in fields.items()})
    tt = IsotropicTangent(kappa=3.0, **{k: torch.tensor(v) for k, v in fields.items()})
    return dict(gj=gj, gt=gt, Vt=Vt, tj=tj, tt=tt, u=rng.normal(size=gt.ndofs),
                sig=rng.normal(size=(s, Q, C)))


def test_buffers_and_metadata_match_jax(pair):
    gj, gt = pair["gj"], pair["gt"]
    assert isinstance(gt, LatticeGeometry) and gt.engine == "lattice"
    for name in ("KEPS_c", "KDIV_c", "w"):
        close(getattr(gt, name), getattr(gj, name))
    for name in ("grid", "degree", "lattice", "vs", "ndofs", "n_nodes", "n_qp", "n_cells", "M",
                 "N", "gdim", "sdim"):
        assert getattr(gt, name) == getattr(gj, name), name
    assert gt.qp_shape(6) == gj.qp_shape(6)
    close(np.asarray(gt.dN_host), np.asarray(gj.dN_host))
    for a in range(gt.n_nodes):
        assert gt._local_offset(a) == gj._local_offset(a)
        assert gt._cell_slices(a) == gj._cell_slices(a)


def test_node_major_ops_match_jax(pair):
    gj, gt, tj, tt = pair["gj"], pair["gt"], pair["tj"], pair["tt"]
    u, sig = pair["u"], pair["sig"]
    close(gt.strain(torch.tensor(u)), gj.strain(jnp.asarray(u)))
    close(gt.residual(torch.tensor(sig)), gj.residual(jnp.asarray(sig)))
    close(gt.matvec(torch.tensor(u), tt), gj.matvec(jnp.asarray(u), tj))
    close(gt.jacobi_diag(tt), gj.jacobi_diag(tj))
    close(gt.grad(torch.tensor(u)), gj.grad(jnp.asarray(u)))


def test_grid_major_ops_match_jax(pair):
    gj, gt, tj, tt = pair["gj"], pair["gt"], pair["tj"], pair["tt"]
    u_gm = gt.to_grid_major(torch.tensor(pair["u"]))
    uj_gm = gj.to_grid_major(jnp.asarray(pair["u"]))
    close(u_gm, uj_gm, 0.0)
    close(gt._elem_dofs_cm(u_gm.reshape(gt.vs, gt.M)), gj._elem_dofs_cm(uj_gm.reshape(gj.vs, gj.M)))
    close(gt.strain_gm(u_gm), gj.strain_gm(uj_gm))
    close(gt.residual_gm(torch.tensor(pair["sig"])), gj.residual_gm(jnp.asarray(pair["sig"])))
    close(gt.matvec_gm(u_gm, tt), gj.matvec_gm(uj_gm, tj))
    close(gt.jacobi_diag_gm(tt), gj.jacobi_diag_gm(tj))
    torch.testing.assert_close(gt.to_node_major(u_gm), torch.tensor(pair["u"]), rtol=0, atol=0)
    assert gt.extract_cells(u_gm) is u_gm and gt.insert_cells(u_gm) is u_gm


def test_ops_match_the_gather_engine(pair):
    """The same space on the port's gather engine ([s, N], N = q * C + c)."""
    gt, tt, Vt = pair["gt"], pair["tt"], pair["Vt"]
    gp = build_packed_geometry(Vt, 4, gt.constraint, None, device="cpu", dtype=F64)
    s, Q, C = gt.sdim, gt.n_qp, gt.n_cells
    flat = IsotropicTangent(kappa=tt.kappa, beta=tt.beta.reshape(-1),
                            gamma=tt.gamma.reshape(-1), n=tt.n.reshape(s, -1))
    u, sig = torch.tensor(pair["u"]), torch.tensor(pair["sig"])
    close(gt.strain(u), gp.strain(u).reshape(s, Q, C).numpy())
    close(gt.residual(sig), gp.residual(sig.reshape(s, -1)).numpy())
    close(gt.matvec(u, tt), gp.matvec(u, flat).numpy())
    close(gt.jacobi_diag(tt), gp.jacobi_diag(flat).numpy())


def test_residual_is_deterministic(pair):
    gt, sig = pair["gt"], torch.tensor(pair["sig"])
    torch.testing.assert_close(gt.residual_gm(sig), gt.residual_gm(sig), rtol=0, atol=0)


@pytest.mark.parametrize("cells", [(3, 2, 2), (4, 3)], ids=["hex", "quad"])
def test_p2_dof_lattice_is_the_refined_p1_grid(cells):
    V2 = p2_space(tfem, cells)
    refined = tuple(2 * c for c in cells)
    m1 = (tfem.unit_cube_mesh(*refined, "hex") if len(cells) == 3
          else tfem.unit_square_mesh(*refined, "quad"))
    np.testing.assert_allclose(V2.dof_coords, m1.nodes, rtol=0, atol=1e-14)


def test_structured_kernels_refuse_a_lattice_geometry(pair):
    """hot_path_geometry refuses the lattice engine by type (it has no corner
    offsets to read), so "auto" picks the plain operator."""
    assert not hot_path_geometry(pair["gt"])


def test_kernel_impls_on_a_p2_box_raise(mat):
    V = p2_space(tfem, (2, 2, 2))
    geos, _, _ = build_packed_problem(V, VonMises3D(mat), 4, device="cpu", dtype=F64)
    for kw in (dict(matvec_impl="kernel"), dict(eval_impl="kernel")):
        with pytest.raises(ValueError, match="lattice"):
            make_packed_step(geos, **kw)
    bcs = [tfem.DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 0.0)), 0.0)]
    with pytest.raises(ValueError, match="lattice"):
        PackedSimulation(VonMises3D(mat), V, bcs, 4, matvec_impl="kernel", device="cpu",
                         dtype=F64)
    sim = PackedSimulation(VonMises3D(mat), V, bcs, 4, device="cpu", dtype=F64)
    assert (sim.engine, sim.preconditioner) == ("lattice", None)


def _lattice_sim(mat, V, preconditioner="vcycle"):
    def close_to(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    bcs = [
        tfem.DirichletBC(V.locate_dofs_geometrical(close_to(0, 0.0), component=0), 0.0),
        tfem.DirichletBC(V.locate_dofs_geometrical(close_to(0, 1.0), component=0), 0.0),
        tfem.DirichletBC(V.locate_dofs_geometrical(close_to(1, 0.0), component=1), 0.0),
        tfem.DirichletBC(V.locate_dofs_geometrical(close_to(2, 0.0), component=2), 0.0),
    ]
    sim = PackedSimulation(VonMises3D(mat), V, bcs, 4, preconditioner=preconditioner,
                           device="cpu", dtype=F64, newton_rtol=1e-10, newton_atol=1e-10,
                           cg_rtol=1e-10)
    return sim, bcs


def test_lattice_checkpoint_round_trip(mat, box, tmp_path):
    V = p2_space(tfem, (2, 2, 2))
    sim, bcs = _lattice_sim(mat, V)
    for k in (1, 2):
        bcs[1].value = 0.004 * k
        assert sim.solve()[1]
    path = tmp_path / "p2.npz"
    save_checkpoint(path, sim.state_dict())
    other, bcs2 = _lattice_sim(mat, V)
    other.load_state_dict(load_checkpoint(path))
    assert str(np.asarray(load_checkpoint(path)["engine"])) == "lattice"
    for s, b in ((sim, bcs), (other, bcs2)):
        b[1].value = 0.012
        assert s.solve()[1]
    torch.testing.assert_close(other.state.u, sim.state.u, rtol=0, atol=0)
    torch.testing.assert_close(other.state.stress[0], sim.state.stress[0], rtol=0, atol=0)
    # a structured-engine checkpoint is refused by its engine marker
    V1, bcs1 = box(2)["torch"]
    p1 = PackedSimulation(VonMises3D(mat), V1, bcs1, 2, device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="lattice"):
        p1.load_state_dict(sim.state_dict())
