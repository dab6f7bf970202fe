"""Several laws on an imported mesh, and every FULL law on a box, through the
port's engines and PackedSimulation against the JAX package (float64, CPU).

(a) A shuffled 6^3 Kuhn tet box (1,296 cells, no structured metadata: it
    arrives like an imported mesh) on the windowed engine, split at
    z = 0.5: Drucker-Prager (associated, through the dense-tangent adapter)
    below, SpringMaxwellModel (FULL, factored tangent) above. Both packages
    build identical plans for both laws on one shared RCM order; one step's
    residual, operator apply and Jacobi diagonal, summed over the laws,
    agree within 1e-12 of each field's largest entry (measured <= 8.2e-16).
(b) PackedSimulation with its default windowed AMG over two load steps of
    0.004 k: u within rtol 1e-7 and stress within rtol 1e-6 of JAX's (the
    tolerances of the JAX package's own production-path test,
    tests/solver/test_simulation.py); a checkpoint round trip continues
    bit-equal.
(c) Every FULL law of that JAX test on a 3^3 hex box (structured engine,
    factored and dense tangents, Jacobi CG), its two steps of 0.004 k at
    dt 0.5, against JAX's PackedSimulation to the same tolerances.
(d) Guards: matvec_impl="kernel" with a dense-tangent law raises, and the
    "auto" rule takes the CUDA operator only for a law that declares a
    factored tangent (``factored_tangent``), which its packed tangent bears
    out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu.solver.packed_step import build_packed_problem as jax_problem
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.models.interfaces import flat_history_dim
from fenics_constitutive_tpu_torch.ops import DenseTangent, IsotropicTangent, WindowedGeometry
from fenics_constitutive_tpu_torch.solver import PackedSimulation, build_packed_problem
from fenics_constitutive_tpu_torch.utils import load_checkpoint, model_from_jax, save_checkpoint
from test_torch_models import DP, FULL_LAWS, MAT, SLS

F64 = torch.float64


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=what)


def split_laws(V, pkg):
    """DP on cells with midpoint z < 0.5, SpringMaxwellModel above."""
    z = V.mesh.cell_midpoints()[:, 2]
    lower, upper = np.flatnonzero(z < 0.5), np.flatnonzero(z >= 0.5)
    laws = [(jm.DruckerPrager3D(DP), lower), (jm.SpringMaxwellModel(SLS, jm.Constraint.FULL),
                                              upper)]
    if pkg == "torch":
        laws = [(model_from_jax(m), c) for m, c in laws]
    return laws


@pytest.fixture(scope="module")
def tet_problem(tets):
    pair = tets(6, stretch=0.004)
    (Vj, _), (Vt, _) = pair["jax"], pair["torch"]
    gj, mj, sj = jax_problem(Vj, split_laws(Vj, "jax"), 2, engine="windowed")
    gt, mt, st = build_packed_problem(Vt, split_laws(Vt, "torch"), 2, device="cpu",
                                      dtype=F64, engine="windowed")
    return pair, (gj, mj, sj), (gt, mt, st)


def test_plans_equal_jax(tet_problem):
    _, (gj, _, sj), (gt, _, st) = tet_problem
    assert len(gt) == 2 and all(isinstance(g, WindowedGeometry) for g in gt)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a.ex.perm, b.ex.perm)
        np.testing.assert_array_equal(a.ex.perm, gt[0].ex.perm)  # one shared order
        assert (a.ex.M_pad, a.ex.B, a.ex.C_B, a.N) == (b.ex.M_pad, b.ex.B, b.ex.C_B, b.N)
        np.testing.assert_array_equal(a.ex.cell_order, b.ex.cell_order)
        np.testing.assert_array_equal(a.ex.loc.numpy(), np.asarray(b.ex.loc))
        np.testing.assert_array_equal(a.slot_of_cell.numpy(), np.asarray(b.slot_of_cell))
    assert st.u.shape == sj.u.shape
    for a, b in zip(st.histories, sj.histories):
        assert {k: tuple(v.shape) for k, v in a.items()} == {k: v.shape for k, v in b.items()}


def test_residual_and_operator_match_jax(tet_problem):
    """From the zero state, a stretch of 1% in x with a random ripple (DP
    yields, I1 stays below its cone's tip): the summed residual of both
    laws, the summed operator apply on a random vector with their tangents
    (DP's dense, Maxwell's factored) and the summed Jacobi diagonal."""
    pair, (gj, mj, sj), (gt, mt, st) = tet_problem
    V = pair["torch"][0]
    rng = np.random.default_rng(4)
    u_nodes = rng.normal(size=(V.n_dof_nodes, 3)) * 1e-4
    u_nodes[:, 0] += 0.01 * V.dof_coords[:, 0]
    u = gt[0].to_internal(torch.tensor(u_nodes.reshape(-1))).numpy()
    v = rng.normal(size=gt[0].ndofs_int)
    out = {}
    for key, geos, models, state, arr in (("jax", gj, mj, sj, jnp.asarray),
                                          ("torch", gt, mt, st, torch.tensor)):
        r = mv = diag = 0.0
        tangents = []
        for geo, model, s0, h0 in zip(geos, models, state.stress, state.histories):
            s_new, tg, _ = model.evaluate_packed(0.0, 0.5, geo.strain(arr(u)), s0, h0)
            r = r + geo.residual(s_new)
            mv = mv + geo.matvec(arr(v), tg)
            diag = diag + geo.jacobi_diag(tg)
            tangents.append(tg)
        out[key] = (np.asarray(r), np.asarray(mv), np.asarray(diag), tangents)
    assert isinstance(out["torch"][3][0], DenseTangent)
    assert isinstance(out["torch"][3][1], IsotropicTangent)
    dp_c = out["torch"][3][0].C.numpy()
    assert not np.allclose(dp_c, dp_c[..., :1])  # DP yielded at some points
    for i, what in enumerate(("residual", "operator apply", "jacobi diagonal")):
        close(out["torch"][i], out["jax"][i], 1e-12, what)


@pytest.fixture(scope="module")
def tet_simulations(tets):
    pair = tets(6)
    runs = {}
    for key, make in (("jax", JPackedSimulation),
                      ("torch", lambda *a, **k: PackedSimulation(*a, device="cpu", dtype=F64,
                                                                 **k))):
        V, bcs = pair[key]
        sim = make(split_laws(V, key), V, bcs, 2, del_t=0.5, engine="windowed")
        steps = []
        for k in (1, 2):
            bcs[1].value = 0.004 * k
            steps.append(sim.solve())
        runs[key] = (sim, steps, bcs)
    return runs


def test_simulation_matches_jax(tet_simulations):
    (sj, nj, _), (st, nt, _) = tet_simulations["jax"], tet_simulations["torch"]
    assert (st.engine, st.preconditioner) == ("windowed", "amg")
    assert all(c for _, c in nj + nt)
    assert float(st.histories[0]["alpha"].max()) > 0  # the DP layer yielded
    np.testing.assert_allclose(np.asarray(st.u), np.asarray(sj.u), rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(st.stress, sj.stress, rtol=1e-6, atol=1e-6)
    assert st.stress.shape == (st.space.mesh.num_cells, 4, 6)
    assert st.time == pytest.approx(sj.time) == 1.0


def test_checkpoint_roundtrip_continues_bit_equal(tet_simulations, tmp_path):
    sim, _, bcs = tet_simulations["torch"]
    save_checkpoint(tmp_path / "ck.npz", sim.state_dict())
    sim2 = PackedSimulation(split_laws(sim.space, "torch"), sim.space, bcs, 2, del_t=0.5,
                            engine="windowed", device="cpu", dtype=F64)
    sim2.load_state_dict(load_checkpoint(tmp_path / "ck.npz"))
    bcs[1].value = 0.012
    res = [s.solve() for s in (sim, sim2)]
    assert res[0] == res[1] and res[0][1]
    for a, b in zip((sim.state.u, *sim.state.stress,
                     *[v for h in sim.histories for v in h.values()]),
                    (sim2.state.u, *sim2.state.stress,
                     *[v for h in sim2.histories for v in h.values()])):
        assert torch.equal(a, b)


# -- every FULL law on a box -----------------------------------------------------------


@pytest.mark.parametrize("name", list(FULL_LAWS))
def test_every_full_law_on_a_box_matches_jax(box, name):
    pair = box(3, 0.0)
    out = {}
    for key, make in (("jax", JPackedSimulation),
                      ("torch", lambda *a, **k: PackedSimulation(*a, device="cpu", dtype=F64,
                                                                 **k))):
        V, bcs = pair[key]
        law = FULL_LAWS[name]()
        sim = make(law if key == "jax" else model_from_jax(law), V, bcs, 2, del_t=0.5,
                   newton_rtol=1e-11, newton_atol=1e-10, cg_rtol=1e-12)
        steps = []
        for k in (1, 2):
            bcs[1].value = 0.004 * k
            steps.append(sim.solve())
        out[key] = (steps, np.asarray(sim.u), sim.stress)
    assert all(c for _, c in out["jax"][0] + out["torch"][0])
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(out["torch"][2], out["jax"][2], rtol=1e-6, atol=1e-6)


# -- guards ----------------------------------------------------------------------------


def test_kernel_operator_refuses_a_dense_tangent_law(box):
    V, bcs = box(2)["torch"]
    with pytest.raises(ValueError, match="DruckerPrager3D returns a DenseTangent"):
        PackedSimulation(model_from_jax(jm.DruckerPrager3D(DP)), V, bcs, 2,
                         matvec_impl="kernel", device="cpu", dtype=F64)


def packed_tangent(model, geo):
    """The law's packed tangent on ``geo``'s engine from a zero state at one
    point."""
    s = model.constraint.stress_strain_dim
    shape = (1,) * (len(geo.qp_shape(1)) - 1)

    def zeros(k):
        return torch.zeros((k, *shape), dtype=geo.dtype, device=geo.device)

    hd = model.history_dim
    history = None if hd is None else {k: zeros(flat_history_dim(d)) for k, d in hd.items()}
    return model.evaluate_packed(0.0, 1.0, zeros(s), zeros(s), history)[1]


def test_auto_takes_the_kernel_only_for_a_factored_tangent(box):
    """The rule behind matvec_impl="auto" on the card (on the CPU it always
    resolves to "plain"): the hot laws' FULL twins are factored; DP, a
    non-FULL law and a conversion wrapper return a DenseTangent."""
    V, bcs = box(2)["torch"]
    geos, _, _ = build_packed_problem(V, model_from_jax(jm.VonMises3D(MAT)), 2, device="cpu",
                                      dtype=F64)
    for name, make in FULL_LAWS.items():
        law = model_from_jax(make())
        assert law.factored_tangent == (not name.startswith("dp")), name
        assert isinstance(packed_tangent(law, geos[0]), IsotropicTangent) == law.factored_tangent
    quad = tfem.FunctionSpace(tfem.unit_square_mesh(2, 2, "quad"), 1, 2)
    qgeo = build_packed_problem(quad, model_from_jax(jm.LinearElasticityModel(
        {"E": 1.0, "nu": 0.3}, jm.Constraint.PLANE_STRAIN)), 2, device="cpu", dtype=F64)[0][0]
    for law in (jm.LinearElasticityModel({"E": 1.0, "nu": 0.3}, jm.Constraint.PLANE_STRAIN),
                jm.SpringMaxwellModel(SLS, jm.Constraint.PLANE_STRESS),
                jm.PlaneStrainFrom3D(jm.VonMises3D(MAT))):
        law = model_from_jax(law)
        assert not law.factored_tangent
        assert isinstance(packed_tangent(law, qgeo), DenseTangent)
    sim = PackedSimulation(model_from_jax(jm.DruckerPrager3D(DP)), V, bcs, 2, device="cpu",
                           dtype=F64)
    assert sim.solve()[1]
