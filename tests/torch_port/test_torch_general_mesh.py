"""The general-mesh path as a whole against the JAX package: imported
(shuffled) tet boxes on the windowed engine, float64.

(a) The benchmark protocol's first step from the zero state (one Newton
    iteration, fixed-3 plain CG preconditioned by the windowed AMG V(3,3),
    load scale 0.5): u, stress and r_norm agree to rtol 1e-10 of each
    field's largest entry. The step starts from an unloaded state, so no
    point sits on the yield surface and no round-off decides which points
    yield; three CG iterations amplify sum-order differences only a little.
(b) Converged three-step load paths through make_packed_step, with the AMG
    and with Jacobi: u and stress agree to rtol 1e-7 (both Newton loops stop
    at 1e-8 of the first residual). Newton counts after a plastic step are
    not pinned: a step that starts from a plastic state has its first
    tangent decided by round-off (ROADMAP Queue 3).
(c) PackedSimulation(engine="windowed") with the default AMG agrees with
    the JAX package's as in (b), through its public ``u`` and ``stress``.
(d) A windowed JAX state (internal u, [s, N] fields) carried over by
    utils.convert is bit-equal, and one converged step from it agrees.
(e) Every mesh resolves to the JAX package's engine (gather, structured
    tet, windowed; the lattice engine, not ported, raises), and the
    preconditioners resolve as in JAX, with the ELL AMG on a box.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu.solver.amg import build_amg as jax_build_amg
from fenics_constitutive_tpu.solver.packed_step import build_packed_problem as jax_problem
from fenics_constitutive_tpu.solver.packed_step import make_packed_step as jax_make_step
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.ops import WindowedGeometry
from fenics_constitutive_tpu_torch.solver import (
    AmgPreconditioner,
    PackedSimulation,
    build_amg,
    build_packed_problem,
    make_packed_step,
    resolve_engine,
)
from fenics_constitutive_tpu_torch.utils import state_from_numpy

F64 = torch.float64
BENCH = dict(max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5, cg_maxiter=500,
             cg_fixed_iters=3)
CONVERGED = dict(max_newton=25, newton_rtol=1e-8, newton_atol=1e-8, cg_rtol=1e-8,
                 cg_maxiter=1000)
MU, KAPPA = 80769.0, 175000.0


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=what)


def jax_setup(V, bcs, mat, pc):
    geos, models, state = jax_problem(V, JVonMises3D(mat), 2, engine="windowed")
    free = np.ones(V.ndofs, bool)
    free[jax_combine(bcs)[0]] = False
    pc_call = None
    if pc == "amg":
        amg = jax_build_amg(V, MU, KAPPA, free, spmv="windowed", nu=3,
                            node_perm=geos[0].ex.perm)
        pc_call = amg.wrap_internal(geos[0].ex.M_pad)
        pc_call.internal_layout = True
    return geos, models, state, pc_call


def port_setup(V, bcs, mat, pc):
    geos, models, state = build_packed_problem(V, VonMises3D(mat), 2, device="cpu",
                                               dtype=F64, engine="windowed")
    free = np.ones(V.ndofs, bool)
    free[combine_bcs(bcs)[0]] = False
    pc_call = None
    if pc == "amg":
        amg = build_amg(V, MU, KAPPA, free, device="cpu", dtype=F64, nu=3, spmv="windowed",
                        node_perm=geos[0].ex.perm)
        pc_call = amg.wrap_internal(geos[0].ex.M_pad)
    return geos, models, state, pc_call


def run_both(pair, mat, pc, opts, scales):
    (Vj, bj), (Vt, bt) = pair["jax"], pair["torch"]
    geos, models, state, pcj = jax_setup(Vj, bj, mat, pc)
    step = jax.jit(jax_make_step(geos, preconditioner=pcj, **opts))
    bc_dofs, bc_vals = jax_combine(bj)
    ref, st = [], state
    for k in scales:
        st, stats = step(models, st, jnp.asarray(bc_dofs), jnp.asarray(bc_vals) * k,
                         jnp.zeros(geos[0].ndofs_int), jnp.asarray(1.0))
        ref.append((st, stats))
    geos_t, models_t, state_t, pct = port_setup(Vt, bt, mat, pc)
    step_t = make_packed_step(geos_t, preconditioner=pct, **opts)
    bc_dofs, bc_vals = combine_bcs(bt)
    got, st = [], state_t
    for k in scales:
        st, stats = step_t(models_t, st, torch.as_tensor(bc_dofs), torch.tensor(bc_vals) * k,
                           torch.zeros(geos_t[0].ndofs_int, dtype=F64), 1.0)
        got.append((st, stats))
    return ref, got, geos[0], geos_t[0]


@pytest.mark.parametrize("pc", ["amg", "jacobi"])
def test_first_bench_step_matches_jax(tets, mat, pc):
    ref, got, gj, gt = run_both(tets(5), mat, pc, BENCH, (0.5,))
    (sj, stj), (st, stt) = ref[0], got[0]
    assert int(stt["newton_iters"]) == int(stj["newton_iters"]) == 1
    assert st.u.shape == (gt.ndofs_int,) and st.stress[0].shape == (6, gt.N)
    close(st.u, sj.u, 1e-10, "u (internal)")
    close(st.stress[0], sj.stress[0], 1e-10, "stress")
    close(stt["r_norm"], stj["r_norm"], 1e-10, "r_norm")
    assert float(st.histories[0]["alpha"].max()) == 0.0  # the step ends elastic


@pytest.fixture(scope="module")
def converged_paths(tets, mat):
    return {pc: run_both(tets(5), mat, pc, CONVERGED, (1.0, 2.0, 3.0))
            for pc in ("amg", "jacobi")}


@pytest.mark.parametrize("k", [0, 1, 2], ids=["step1", "step2", "step3"])
@pytest.mark.parametrize("pc", ["amg", "jacobi"])
def test_converged_steps_match_jax(converged_paths, pc, k):
    ref, got, gj, gt = converged_paths[pc]
    (sj, stj), (st, stt) = ref[k], got[k]
    assert float(stt["r_norm"]) <= max(1e-8, 1e-8 * float(stt["r0_norm"]))
    if k == 0:
        assert int(stt["newton_iters"]) == int(stj["newton_iters"])
    close(gt.from_internal(st.u), gj.from_internal(sj.u), 1e-7, "u")
    close(gt.extract_cells(st.stress[0]), gj.extract_cells(sj.stress[0]), 1e-7, "stress")
    close(st.histories[0]["alpha"], sj.histories[0]["alpha"], 1e-7, "alpha")


@pytest.fixture(scope="module")
def simulations(tets, mat):
    pair = tets(5)
    runs = {}
    for key, make in (
        ("jax", lambda V, bcs: JPackedSimulation(JVonMises3D(mat), V, bcs, 2,
                                                 engine="windowed")),
        ("torch", lambda V, bcs: PackedSimulation(VonMises3D(mat), V, bcs, 2,
                                                  engine="windowed", device="cpu",
                                                  dtype=F64)),
    ):
        V, bcs = pair[key]
        sim = make(V, bcs)
        steps = []
        for k in (1, 2, 3):
            bcs[1].value = 0.004 * k
            niter, conv = sim.solve()
            steps.append((niter, conv, np.asarray(sim.u).copy(), np.asarray(sim.stress)))
        runs[key] = (sim, steps, bcs)
    return runs


def test_simulation_resolves_windowed_amg(simulations):
    sim = simulations["torch"][0]
    assert (sim.engine, sim.preconditioner) == ("windowed", "amg")
    assert isinstance(sim._geos[0], WindowedGeometry)


@pytest.mark.parametrize("k", [0, 1, 2], ids=["step1", "step2", "step3"])
def test_simulation_matches_jax(simulations, k):
    nj, cj, uj, sj = simulations["jax"][1][k]
    nt, ct, ut, stt = simulations["torch"][1][k]
    assert ct and cj
    assert abs(nt - nj) <= 1
    close(ut, uj, 1e-7, "u")
    close(stt, sj, 1e-7, "stress")


def test_windowed_state_from_numpy_and_step(simulations, mat):
    sim_j, _, bcs_j = simulations["jax"]
    sim_t, _, bcs_t = simulations["torch"]
    sj = sim_j.state
    assert float(sj.histories[0]["alpha"].max()) > 0.0  # plastic
    st = state_from_numpy(
        np.asarray(sj.u), [np.asarray(s) for s in sj.stress],
        [{k: np.asarray(v) for k, v in h.items()} for h in sj.histories],
        np.asarray(sj.t), device="cpu", dtype=F64,
    )
    geo = sim_t._geos[0]
    assert st.u.shape == (geo.ndofs_int,) and st.stress[0].shape == (6, geo.N)
    torch.testing.assert_close(st.u, torch.tensor(np.asarray(sj.u)), rtol=0, atol=0)
    torch.testing.assert_close(st.stress[0], torch.tensor(np.asarray(sj.stress[0])),
                               rtol=0, atol=0)
    for k, v in sj.histories[0].items():
        torch.testing.assert_close(st.histories[0][k], torch.tensor(np.asarray(v)),
                                   rtol=0, atol=0)

    # one more converged load step from the carried state, in both packages
    step_t = make_packed_step((geo,), preconditioner=sim_t._mg.wrap_internal(geo.ex.M_pad),
                              **CONVERGED)
    bcs_t[1].value = 0.016
    bc_dofs, bc_vals = combine_bcs(bcs_t)
    out_t, stats_t = step_t(sim_t._models, st, torch.as_tensor(bc_dofs), torch.tensor(bc_vals),
                            torch.zeros(geo.ndofs_int, dtype=F64), 1.0)
    sim_j.bcs[1].value = 0.016
    niter, conv = sim_j.solve()
    assert conv
    close(geo.from_internal(out_t.u), sim_j.u, 1e-7, "u")
    close(out_t.stress[0], sim_j.state.stress[0], 1e-7, "stress")


#: the engine names of the JAX package's geometry types
JAX_ENGINES = {"StructuredGeometry": "structured", "StructuredTetGeometry": "structured_tet",
               "WindowedGeometry": "windowed", "PackedGeometry": "gather",
               "LatticeGeometry": "lattice"}


def test_engines_not_ported_raise(tets, mat):
    """No mesh raises for want of an engine any more: a shuffled tet mesh
    under WINDOWED_MIN_CELLS takes the gather engine ("auto" and "gather")
    or the windowed one ("windowed"), a Kuhn box the structured-tet engine
    whatever ``engine`` says, an interval bar the gather engine, as in the
    JAX package; a degree-2 space on a whole hex or quad box takes the
    lattice engine in both packages."""
    from fenics_constitutive_tpu import fem as jfem
    from fenics_constitutive_tpu import models as jm
    from fenics_constitutive_tpu_torch import fem as tfem
    from fenics_constitutive_tpu_torch.utils import model_from_jax

    small = tets(4)  # 384 cells < WINDOWED_MIN_CELLS
    kuhn = {k: f.FunctionSpace(f.unit_cube_mesh(3, 3, 3, "tetra"), 1, 3)
            for k, f in (("jax", jfem), ("torch", tfem))}
    bar = {k: f.FunctionSpace(f.unit_interval_mesh(5), 1, 1)
           for k, f in (("jax", jfem), ("torch", tfem))}
    vm = jm.VonMises3D(mat)
    uni = jm.LinearElasticityModel({"E": 1000.0, "nu": 0.3}, jm.Constraint.UNIAXIAL_STRAIN)
    cases = [
        (small["jax"][0], small["torch"][0], vm, "auto", "gather"),
        (small["jax"][0], small["torch"][0], vm, "gather", "gather"),
        (small["jax"][0], small["torch"][0], vm, "windowed", "windowed"),
        (kuhn["jax"], kuhn["torch"], vm, "auto", "structured_tet"),
        (kuhn["jax"], kuhn["torch"], vm, "windowed", "structured_tet"),
        (kuhn["jax"], kuhn["torch"], vm, "gather", "structured_tet"),
        (bar["jax"], bar["torch"], uni, "auto", "gather"),
    ]
    for Vj, Vt, law, engine, expected in cases:
        gj = jax_problem(Vj, law, 2, engine=engine)[0][0]
        gt = build_packed_problem(Vt, model_from_jax(law), 2, device="cpu", dtype=F64,
                                  engine=engine)[0][0]
        assert JAX_ENGINES[type(gj).__name__] == expected, (engine, expected)
        assert JAX_ENGINES[type(gt).__name__] == expected == resolve_engine(Vt, engine)
    for kind in ("hex", "quad"):
        p2 = {k: f.FunctionSpace(f.unit_cube_mesh(2, 2, 2, kind), 2, 3) if kind == "hex"
              else f.FunctionSpace(f.unit_square_mesh(3, 2, kind), 2, 2)
              for k, f in (("jax", jfem), ("torch", tfem))}
        law = vm if kind == "hex" else jm.PlaneStrainFrom3D(vm)
        for engine in ("auto", "windowed", "gather"):
            gj = jax_problem(p2["jax"], law, 4, engine=engine)[0][0]
            gt = build_packed_problem(p2["torch"], model_from_jax(law), 4, device="cpu",
                                      dtype=F64, engine=engine)[0][0]
            assert JAX_ENGINES[type(gj).__name__] == "lattice" == JAX_ENGINES[type(gt).__name__]
            assert resolve_engine(p2["torch"], engine) == "lattice" == gt.engine
        # a degree-2 law on a cell subset of the box: windowed or gather by cell count
        assert resolve_engine(p2["torch"], "auto", whole_mesh=False) == "gather"
        assert resolve_engine(p2["torch"], "windowed", whole_mesh=False) == "windowed"


def test_preconditioners_not_ported_raise(box, tets, mat):
    """preconditioner="amg" on a box now builds the ELL levels; a geometric
    multigrid on a general mesh, and the structured kernels on the windowed
    engine, still raise ValueError."""
    V, bcs = box(2)["torch"]
    sim = PackedSimulation(VonMises3D(mat), V, bcs, 2, preconditioner="amg", device="cpu",
                           dtype=F64)
    assert (sim.engine, sim.preconditioner) == ("structured", "amg")
    assert isinstance(sim._mg, AmgPreconditioner)
    V, bcs = tets(4)["torch"]
    with pytest.raises(ValueError, match="windowed engine"):
        PackedSimulation(VonMises3D(mat), V, bcs, 2, engine="windowed",
                         preconditioner="vcycle", device="cpu", dtype=F64)
    geos, _, _ = build_packed_problem(V, VonMises3D(mat), 2, device="cpu", dtype=F64,
                                      engine="windowed")
    with pytest.raises(ValueError, match="windowed engine"):
        make_packed_step(geos, eval_impl="kernel")
    with pytest.raises(ValueError, match="gather engine"):
        PackedSimulation(VonMises3D(mat), V, bcs, 2, preconditioner="bpx", device="cpu",
                         dtype=F64)
