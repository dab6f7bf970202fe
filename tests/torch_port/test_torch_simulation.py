"""The box-mesh PackedSimulation of the port against the JAX package's
(float64, CPU): linear elasticity, several laws on one grid, Neumann loads,
adaptive substepping, load schedules, checkpoints and state carried across.

Tolerances: Hooke's law is the same few operations in both packages (1e-12).
Converged steps stop at the Newton tolerance, so states agree to what that
leaves (u atol 1e-9, stress rtol 1e-8, the bars of the JAX package's own
multi-material test). The facet loads are the same host numpy: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.fem.facets import (
    assemble_facet_traction as jax_traction,
)
from fenics_constitutive_tpu.fem.facets import (
    locate_boundary_facets as jax_locate_facets,
)
from fenics_constitutive_tpu.models import Constraint as JConstraint
from fenics_constitutive_tpu.models import LinearElasticityModel as JLinearElasticity
from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.models.interfaces import register_model
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.models import (
    Constraint,
    LinearElasticityModel,
    VonMises3D,
)
from fenics_constitutive_tpu_torch.solver import (
    PackedSimulation,
    build_packed_problem,
    make_packed_step,
)
from fenics_constitutive_tpu_torch.utils import (
    load_checkpoint,
    save_checkpoint,
    state_from_numpy,
)

F64 = torch.float64
SOFT = {"E": 60000.0, "nu": 0.3}
HARD = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 300.0, "p_y00": 800.0, "p_w": 200.0}
TIGHT = dict(newton_rtol=1e-12, newton_atol=1e-10, cg_rtol=1e-13)


def close(got, ref, rtol=0.0, atol=0.0):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol)


def port_sim(*args, **kw):
    return PackedSimulation(*args, device="cpu", dtype=F64, **kw)


def two_laws(V, pkg):
    """test_simulation.py's split: linear elasticity for x < 0.5, von Mises
    (low yield) for x >= 0.5."""
    mid = V.mesh.cell_midpoints()
    left = np.flatnonzero(mid[:, 0] < 0.5).astype(np.int32)
    right = np.flatnonzero(mid[:, 0] >= 0.5).astype(np.int32)
    if pkg == "jax":
        return [(JLinearElasticity(SOFT, JConstraint.FULL), left), (JVonMises3D(HARD), right)]
    return [(LinearElasticityModel(SOFT, Constraint.FULL), left), (VonMises3D(HARD), right)]


# -- linear elasticity -------------------------------------------------------------


@pytest.mark.parametrize("shape", [(6, 7), (6, 8, 9)], ids=["flat", "structured"])
def test_linear_elasticity_packed_matches_jax(shape):
    rng = np.random.default_rng(1)
    eps, sig = rng.normal(size=shape) * 1e-3, rng.normal(size=shape) * 100.0
    s_j, tg_j, h_j = JLinearElasticity({"E": 150000.0, "nu": 0.3}, JConstraint.FULL
                                       ).evaluate_packed(0.0, 1.0, jnp.asarray(eps),
                                                         jnp.asarray(sig), None)
    law = LinearElasticityModel({"E": 150000.0, "nu": 0.3}, Constraint.FULL)
    s_t, tg_t, h_t = law.evaluate_packed(0.0, 1.0, torch.tensor(eps), torch.tensor(sig), None)
    assert h_t is None and h_j is None and law.history_dim is None
    close(s_t, s_j, rtol=1e-12, atol=1e-12 * np.abs(np.asarray(s_j)).max())
    for f in ("kappa", "beta", "gamma", "n"):
        ref = np.broadcast_to(np.asarray(getattr(tg_j, f)), np.shape(getattr(tg_t, f)))
        close(getattr(tg_t, f), ref, rtol=1e-12)


@pytest.mark.parametrize("c", ["UNIAXIAL_STRAIN", "UNIAXIAL_STRESS", "PLANE_STRAIN",
                               "PLANE_STRESS"])
def test_linear_elasticity_other_constraints_not_ported(c):
    """The four other constraints, once refused, now run through the generic
    adapter: a DenseTangent equal to JAX's tangent_matrix at every point,
    and the packed update of JAX's adapter within 1e-12. (The test keeps the
    name it had as a refusal; it checks that the constraints run.)"""
    from fenics_constitutive_tpu_torch.ops import DenseTangent

    s = Constraint[c].stress_strain_dim
    rng = np.random.default_rng(2)
    eps, sig = rng.normal(size=(s, 2, 7)) * 1e-3, rng.normal(size=(s, 2, 7)) * 100.0
    jlaw = JLinearElasticity({"E": 150000.0, "nu": 0.3}, JConstraint[c])
    s_j, tg_j, _ = jlaw.evaluate_packed(0.0, 1.0, jnp.asarray(eps), jnp.asarray(sig), None)
    law = LinearElasticityModel({"E": 150000.0, "nu": 0.3}, Constraint[c])
    s_t, tg_t, h_t = law.evaluate_packed(0.0, 1.0, torch.tensor(eps), torch.tensor(sig), None)
    assert h_t is None and isinstance(tg_t, DenseTangent)
    close(s_t, s_j, rtol=1e-12, atol=1e-12 * np.abs(np.asarray(s_j)).max())
    D = np.asarray(jlaw.tangent_matrix(jnp.float64))
    close(tg_t.C, np.broadcast_to(D[:, :, None, None], (s, s, 2, 7)), rtol=1e-12,
          atol=1e-12 * np.abs(D).max())


# -- several laws ------------------------------------------------------------------


@pytest.fixture(scope="module")
def multimat(box):
    """Two laws on the 4^3 box with the V-cycle, two steps of 0.004 k."""
    pair = box(4, 0.0)
    out = {}
    for key, make in (("jax", JPackedSimulation), ("torch", port_sim)):
        V, bcs = pair[key]
        sim = make(two_laws(V, key), V, bcs, 2, preconditioner="vcycle", **TIGHT)
        steps = []
        for k in (1, 2):
            bcs[1].value = 0.004 * k
            steps.append(sim.solve())
        out[key] = (sim, steps)
    return out


def test_multimaterial_matches_jax(multimat):
    (sj, nj), (st, nt) = multimat["jax"], multimat["torch"]
    assert all(c for _, c in nj + nt)
    assert [n for n, _ in nt] == [n for n, _ in nj]
    assert len(st._geos) == 2 and st.histories[0] is None
    assert float(st.histories[1]["alpha"].max()) > 0  # the Mises half yielded
    close(st.u, sj.u, atol=1e-9)
    close(st.stress, sj.stress, rtol=1e-8, atol=1e-7)
    assert st.time == pytest.approx(sj.time) == 2.0


def test_multimaterial_fused_smoothing_matches_jax(box):
    """The same two laws at 6^3 (a two-level hierarchy) with the K3 chains
    in every smoother: the port's fused V-cycle against JAX's unfused one."""
    pair = box(6, 0.0)
    sims = {}
    for key, make, opts in (("jax", JPackedSimulation, {}),
                            ("torch", port_sim, {"fused_smoothing": True})):
        V, bcs = pair[key]
        sim = make(two_laws(V, key), V, bcs, 2, preconditioner="vcycle", mg_options=opts,
                   **TIGHT)
        bcs[1].value = 0.003
        assert sim.solve()[1]
        sims[key] = sim
    assert sims["torch"]._mg.fused is not None and sims["torch"]._mg.n_levels == 2
    close(sims["torch"].u, sims["jax"].u, atol=1e-9)
    close(sims["torch"].stress, sims["jax"].stress, rtol=1e-8, atol=1e-7)


def test_state_from_numpy_with_a_law_without_history(multimat, box):
    """A two-law JAX state (linear elasticity has no history) carried into
    the port is bit-equal, and one more step from it agrees with JAX's."""
    sj = multimat["jax"][0]
    st_j = sj.state
    st = state_from_numpy(
        np.asarray(st_j.u), [np.asarray(s) for s in st_j.stress],
        [None if h is None else {k: np.asarray(v) for k, v in h.items()}
         for h in st_j.histories],
        np.asarray(st_j.t), device="cpu", dtype=F64,
    )
    assert st.histories[0] is None and set(st.histories[1]) == {"eps_n", "alpha"}
    for a, b in zip((st.u, *st.stress), (st_j.u, *st_j.stress)):
        torch.testing.assert_close(a, torch.tensor(np.asarray(b)), rtol=0, atol=0)
    V, bcs = box(4, 0.012)["torch"]
    geos, models, _ = build_packed_problem(V, two_laws(V, "torch"), 2, device="cpu",
                                           dtype=F64)
    step = make_packed_step(geos, **TIGHT)
    bc_dofs, bc_vals = combine_bcs(bcs)
    out, stats = step(models, st, torch.as_tensor(bc_dofs), torch.tensor(bc_vals),
                      torch.zeros(V.ndofs, dtype=F64), 1.0)
    sj.bcs[1].value = 0.012
    n_j, conv = sj.solve()
    assert conv
    close(out.u, sj.u, atol=1e-9)
    close(out.stress[1], sj.state.stress[1], rtol=1e-8, atol=1e-7)


def test_several_laws_refuse_the_kernels(box):
    V, _ = box(4)["torch"]
    geos, _, _ = build_packed_problem(V, two_laws(V, "torch"), 2, device="cpu", dtype=F64)
    for impl in ("matvec_impl", "eval_impl"):
        with pytest.raises(ValueError, match="one law"):
            make_packed_step(geos, **{impl: "kernel"})


def test_several_laws_on_a_general_mesh_not_ported(tets):
    """Several laws on a general mesh, once refused, now build one windowed
    plan per law on one shared node order: the same perm and M_pad, each
    plan holding its own cells, and a state per law. (The test keeps the
    name it had as a refusal; it checks that several laws build.)"""
    from fenics_constitutive_tpu_torch.ops import WindowedGeometry

    V, _ = tets(4)["torch"]
    laws = two_laws(V, "torch")
    geos, _, state = build_packed_problem(V, laws, 2, device="cpu", dtype=F64,
                                          engine="windowed")
    assert all(isinstance(g, WindowedGeometry) for g in geos)
    assert np.array_equal(geos[0].ex.perm, geos[1].ex.perm)
    assert geos[0].ex.M_pad == geos[1].ex.M_pad and state.u.shape == (geos[0].ndofs_int,)
    assert [g.n_cells for g in geos] == [len(c) for _, c in laws]
    assert [s.shape[1] for s in state.stress] == [g.N for g in geos]


# -- Neumann loads -----------------------------------------------------------------


@pytest.mark.parametrize("cell", ["hex", "tetra", "quad"])
def test_facet_traction_equals_jax(cell):
    from fenics_constitutive_tpu import fem as jfem

    out = {}
    for key, fem, locate, assemble in (("jax", jfem, jax_locate_facets, jax_traction),
                                       ("torch", tfem, tfem.locate_boundary_facets,
                                        tfem.assemble_facet_traction)):
        if cell == "quad":
            V = fem.FunctionSpace(fem.unit_square_mesh(5, 4, "quad"), 2, 2)
            t = np.array([3.0, -1.0])
        else:
            V = fem.FunctionSpace(fem.unit_cube_mesh(3, 4, 2, cell), 1, 3)
            t = np.array([4000.0, 0.0, 25.0])
        facets = locate(V.mesh, lambda x: np.isclose(x[:, 0], 1.0))
        out[key] = (facets, assemble(V, facets, t))
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    assert np.abs(out["torch"][1]).sum() > 0


# -- adaptive substepping ------------------------------------------------------------


def _fragile(pkg, threshold):
    """Linear elasticity whose local update NaN-poisons when a strain
    increment exceeds ``threshold``: a local return map that fails at large
    steps, which substepping exists for (as in the JAX package's tests)."""
    if pkg == "jax":
        @register_model
        class JFragile(JLinearElasticity):
            def evaluate_packed(self, t, del_t, eps, stress, history):
                s, tg, h = super().evaluate_packed(t, del_t, eps, stress, history)
                return jnp.where(jnp.max(jnp.abs(eps)) > threshold, jnp.nan, s), tg, h

        return JFragile({"E": 100000.0, "nu": 0.3}, JConstraint.FULL)

    class Fragile(LinearElasticityModel):
        def evaluate_packed(self, t, del_t, eps, stress, history):
            s, tg, h = super().evaluate_packed(t, del_t, eps, stress, history)
            bad = eps.abs().max() > threshold
            return torch.where(bad, torch.full_like(s, float("nan")), s), tg, h

    return Fragile({"E": 100000.0, "nu": 0.3}, Constraint.FULL)


def _both(box, build):
    """Run ``build(pkg, V, bcs) -> result`` in both packages on the 4^3 box."""
    pair = box(4, 0.0)
    return {key: build(key, *pair[key]) for key in ("jax", "torch")}


def test_substepping_recovers_a_failed_step(box):
    def run(pkg, V, bcs):
        make = JPackedSimulation if pkg == "jax" else port_sim
        sim = make(_fragile(pkg, 0.02), V, bcs, 2, max_subdivisions=4)
        bcs[1].value = 0.05
        niter, conv = sim.solve()
        plain = make(_fragile(pkg, 0.02), V, bcs, 2)
        return niter, conv, np.asarray(sim.u), sim.stress, sim.time, plain.solve()[1]

    out = _both(box, run)
    (nj, cj, uj, sj, tj, pj), (nt, ct, ut, stt, tt, pt) = out["jax"], out["torch"]
    assert cj and ct and not pj and not pt
    assert nt == nj and tt == pytest.approx(tj) == 1.0
    close(ut, uj, atol=1e-9)
    close(stt, sj, rtol=1e-8, atol=1e-7)
    assert stt[..., 0].mean() > 0


def test_substepping_restores_state_on_total_failure(box):
    def run(pkg, V, bcs):
        make = JPackedSimulation if pkg == "jax" else port_sim
        sim = make(_fragile(pkg, 1e-5), V, bcs, 2, max_subdivisions=2)
        bcs[1].value = 0.05
        u0 = np.asarray(sim.state.u).copy()
        niter, conv = sim.solve()
        return niter, conv, np.array_equal(np.asarray(sim.state.u), u0), sim.time

    out = _both(box, run)
    assert out["torch"] == out["jax"]
    assert out["torch"][1:] == (False, True, 0.0)


def test_substepping_ramps_f_ext_from_zero(box):
    """A failing first step under a constructor traction ramps the load from
    the committed (zero) load, as BC values ramp from the committed u."""
    from fenics_constitutive_tpu import fem as jfem

    def run(pkg, V, _bcs):
        fem = jfem if pkg == "jax" else tfem
        make = JPackedSimulation if pkg == "jax" else port_sim
        locate = jax_locate_facets if pkg == "jax" else tfem.locate_boundary_facets
        assemble = jax_traction if pkg == "jax" else tfem.assemble_facet_traction

        def close_to(a, v):
            return lambda x: np.isclose(x[:, a], v)

        sym = [fem.DirichletBC(V.locate_dofs_geometrical(close_to(a, 0.0), component=a), 0.0)
               for a in range(3)]
        f_ext = assemble(V, locate(V.mesh, close_to(0, 1.0)), np.array([4000.0, 0.0, 0.0]))
        sim = make(_fragile(pkg, 0.02), V, sym, 2, f_ext=f_ext, max_subdivisions=4)
        niter, conv = sim.solve()
        plain = make(_fragile(pkg, 0.02), V, sym, 2, f_ext=f_ext)
        return niter, conv, np.asarray(sim.u), sim.stress, plain.solve()[1]

    out = _both(box, run)
    (nj, cj, uj, sj, pj), (nt, ct, ut, stt, pt) = out["jax"], out["torch"]
    assert cj and ct and not pj and not pt and nt == nj
    close(ut, uj, atol=1e-9)
    close(stt, sj, rtol=1e-8, atol=1e-7)
    assert stt[..., 0].mean() > 0


# -- load schedules ------------------------------------------------------------------


@pytest.fixture(scope="module")
def schedules(box, mat):
    """test_simulation.py's ramp 0.004, 0.008, 0.012 on the 4^3 box: the
    port sequentially and as a schedule, JAX as a schedule."""
    pair = box(4, 0.0)
    out = {}
    for key, make, law in (("jax", JPackedSimulation, JVonMises3D),
                           ("torch", port_sim, VonMises3D)):
        V, bcs = pair[key]
        combine = jax_combine if key == "jax" else combine_bcs
        vals = []
        for v in (0.004, 0.008, 0.012):
            bcs[1].value = v
            vals.append(combine(bcs)[1])
        sim = make(law(mat), V, bcs, 2)
        out[key] = (sim, sim.solve_schedule(np.stack(vals)))
        if key == "torch":
            seq = make(law(mat), V, bcs, 2)
            for v in (0.004, 0.008, 0.012):
                bcs[1].value = v
                assert seq.solve()[1]
            out["sequential"] = seq
    return out


def test_schedule_equals_sequential_solves(schedules):
    sim, stats = schedules["torch"]
    seq = schedules["sequential"]
    assert stats["converged"].all() and stats["newton_iters"].shape == (3,)
    torch.testing.assert_close(sim.u, seq.u, rtol=0, atol=0)
    np.testing.assert_array_equal(sim.stress, seq.stress)
    assert sim.time == seq.time == 3.0


def test_schedule_stats_match_jax(schedules):
    (sj, stj), (st, stt) = schedules["jax"], schedules["torch"]
    assert set(stt) == set(stj)
    np.testing.assert_array_equal(stt["converged"], stj["converged"])
    np.testing.assert_array_equal(stt["newton_iters"], stj["newton_iters"])
    close(stt["r0_norm"], stj["r0_norm"], rtol=1e-9)
    # the Jacobi CG's counts after a plastic step follow round-off (37 and 40
    # at the third step): the states agree to what the tolerances leave
    close(st.u, sj.u, rtol=1e-7, atol=1e-7 * np.abs(np.asarray(sj.u)).max())
    assert st.last_stats["newton_iters"] == stt["newton_iters"][-1]


def test_schedule_with_load_scales(box):
    """[K] scales of f_ext and [K, ndofs] load vectors give the sequential
    solves that reassign sim.f_ext."""
    V, _ = box(3)["torch"]

    def sym():
        return [tfem.DirichletBC(V.locate_dofs_geometrical(
            (lambda a: lambda x: np.isclose(x[:, a], 0.0))(a), component=a), 0.0)
            for a in range(3)]

    f = tfem.assemble_facet_traction(
        V, tfem.locate_boundary_facets(V.mesh, lambda x: np.isclose(x[:, 0], 1.0)),
        np.array([500.0, 0.0, 0.0]))
    scales = np.array([0.25, 0.5, 1.0])
    law = LinearElasticityModel({"E": 1000.0, "nu": 0.3}, Constraint.FULL)
    seq = port_sim(law, V, sym(), 2, **TIGHT)
    for s in scales:
        seq.f_ext = s * f
        assert seq.solve()[1]
    vals = np.zeros((3, len(combine_bcs(sym())[0])))
    for form in (scales, scales[:, None] * f[None, :]):
        sim = port_sim(law, V, sym(), 2, f_ext=f, **TIGHT)
        assert sim.solve_schedule(vals, f_ext_scales=form)["converged"].all()
        close(sim.u, seq.u.numpy(), rtol=1e-10, atol=1e-13)
    with pytest.raises(ValueError, match="f_ext_scales"):
        sim.solve_schedule(vals, f_ext_scales=scales[:2])
    assert sim.solve_schedule(np.zeros((0, vals.shape[1])))["r_norm"].shape == (0,)


# -- checkpoints ---------------------------------------------------------------------


def test_checkpoint_roundtrip_is_bit_equal(multimat, tmp_path):
    sim = multimat["torch"][0]
    save_checkpoint(tmp_path / "ck.npz", sim.state_dict())
    V, bcs = sim.space, sim.bcs
    sim2 = port_sim(two_laws(V, "torch"), V, bcs, 2, preconditioner="vcycle", **TIGHT)
    sim2.load_state_dict(load_checkpoint(tmp_path / "ck.npz"))
    assert sim2.histories[0] is None and sim2.time == sim.time
    for a, b in zip((sim2.state.u, *sim2.state.stress, *sim2.histories[1].values()),
                    (sim.state.u, *sim.state.stress, *sim.histories[1].values())):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_checkpoint_written_by_jax_loads(multimat, tmp_path):
    sj, st = multimat["jax"][0], multimat["torch"][0]
    jax_save_checkpoint(tmp_path / "jax.npz", sj.state_dict())
    tree = load_checkpoint(tmp_path / "jax.npz")
    assert "engine" not in tree  # no marker: held to the shapes alone
    V, bcs = st.space, st.bcs
    sim = port_sim(two_laws(V, "torch"), V, bcs, 2, preconditioner="vcycle", **TIGHT)
    sim.load_state_dict(tree)
    torch.testing.assert_close(sim.state.u, torch.tensor(np.asarray(sj.state.u)), rtol=0,
                               atol=0)
    assert sim.histories[0] is None and sim.time == sj.time


def test_checkpoint_mismatch_raises(multimat, tmp_path):
    sim = multimat["torch"][0]
    tree = dict(sim.state_dict())
    other = port_sim(two_laws(sim.space, "torch"), sim.space, sim.bcs, 2)
    with pytest.raises(ValueError, match="windowed engine"):
        other.load_state_dict({**tree, "engine": "windowed"})
    one_law = port_sim(VonMises3D(HARD), sim.space, sim.bcs, 2)
    with pytest.raises(ValueError, match="stress"):
        one_law.load_state_dict(tree)
    save_checkpoint(tmp_path / "ck.npz", {**tree, "engine": None})
    small = tfem.FunctionSpace(tfem.unit_cube_mesh(3, 3, 3, "hex"), 1, 3)
    with pytest.raises(ValueError, match="shape"):
        port_sim(two_laws(small, "torch"), small, [], 2).load_state_dict(
            load_checkpoint(tmp_path / "ck.npz"))


def test_windowed_traction_schedule_matches_jax(tets, mat):
    """The windowed engine takes the node-major f_ext like the structured
    one: a traction schedule on a shuffled tet box, port against JAX."""
    from fenics_constitutive_tpu import fem as jfem

    pair = tets(4)
    out = {}
    for key, fem, make, law, locate, assemble in (
        ("jax", jfem, JPackedSimulation, JVonMises3D, jax_locate_facets, jax_traction),
        ("torch", tfem, port_sim, VonMises3D, tfem.locate_boundary_facets,
         tfem.assemble_facet_traction),
    ):
        V, _ = pair[key]
        sym = [fem.DirichletBC(V.locate_dofs_geometrical(
            (lambda a: lambda x: np.isclose(x[:, a], 0.0))(a), component=a), 0.0)
            for a in range(3)]
        f = assemble(V, locate(V.mesh, lambda x: np.isclose(x[:, 0], 1.0)),
                     np.array([300.0, 0.0, 0.0]))
        combine = jax_combine if key == "jax" else combine_bcs
        sim = make(law(mat), V, sym, 2, engine="windowed", f_ext=f, **TIGHT)
        stats = sim.solve_schedule(np.zeros((2, len(combine(sym)[0]))),
                                   f_ext_scales=np.array([0.5, 1.0]))
        assert np.asarray(stats["converged"]).all()
        out[key] = (np.asarray(stats["newton_iters"]), np.asarray(sim.u))
    assert out["torch"][0].tolist() == out["jax"][0].tolist()
    close(out["torch"][1], out["jax"][1], atol=1e-9)
    assert out["torch"][1].reshape(-1, 3)[:, 0].max() > 0
