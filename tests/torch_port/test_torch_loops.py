"""The loops the device decides (``solver/compiled.py::device_while``, the
counterpart of ``lax.while_loop``) against the JAX package, float64 on the
CPU.

(a) Converged Newton with adaptive CG, the port's step through the
    stand-in's capture and replays (``HostRecorder``, which replays every
    while node from its static buffers and predicate buffer), against JAX's
    jitted ``make_packed_step`` on the same numpy inputs, on the box
    (structured), gather and windowed engines (a 4^3 hex box with the
    V(3,3) multigrid, a shuffled 5^3 tet box with the AMG), over three loads
    past yield: equal Newton
    counts, CG counts within one, u, stress and history within 1e-10 of
    their largest entry.
(b) The Mises local Newton as a while node (SoA and AoS) against JAX's
    ``lax.while_loop``: the plastic multiplier (from the new alpha) within
    1e-12, stress and tangent within 1e-12.
(c) Every law of the library through ``PackedSimulation`` with the
    stand-in standing in for the card's graph: captured, and bit-equal to
    the same solves inside ``disable_capture()``, the Drucker-Prager laws
    (their return map's local Newton a while node) on a box and beside a
    Maxwell solid on the benchmark's two-law tet part; a law that reads
    back (``host_sync``) is refused.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.solver.amg import build_amg as jax_build_amg
from fenics_constitutive_tpu.solver.multigrid import build_multigrid as jax_build_mg
from fenics_constitutive_tpu.solver.packed_step import build_packed_problem as jax_problem
from fenics_constitutive_tpu.solver.packed_step import make_packed_step as jax_make_step
from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
from fenics_constitutive_tpu_torch.ops import mandel
from fenics_constitutive_tpu_torch.solver import (
    PackedSimulation,
    build_amg,
    build_multigrid,
    build_packed_problem,
    compile_step,
    disable_capture,
    make_packed_step,
    simulation,
)
from fenics_constitutive_tpu_torch.solver.compiled import no_host_sync
from test_torch_compiled import HostRecorder, SyncingLaw, mises_inputs, trees_equal

F64 = torch.float64
SCALES = (1.0, 2.0, 3.0)
CONVERGED = dict(max_newton=25, newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-8,
                 cg_maxiter=1000)
SQ23 = math.sqrt(2.0 / 3.0)
MU, KAPPA = 80769.0, 175000.0


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
                               err_msg=what)


def preconditioners(Vj, Vt, bcs_j, geos_j, geos_t, engine):
    """The same preconditioner in both packages: the V(3,3) multigrid on the
    box, the smoothed-aggregation AMG V(3,3) on the tets (ELL levels
    node-major on the gather engine, windowed levels in the internal layout
    on the windowed engine)."""
    free_np = np.ones(Vj.ndofs, bool)
    free_np[jax_combine(bcs_j)[0]] = False
    if engine == "structured":
        mg = dict(nu=3, nu_coarse=2, coarse_direct=True)
        return (jax_build_mg(geos_j[0], MU, KAPPA, jnp.asarray(free_np), **mg),
                build_multigrid(geos_t[0], MU, KAPPA, torch.as_tensor(free_np), device="cpu",
                                dtype=F64, **mg))
    if engine == "gather":
        return (jax_build_amg(Vj, MU, KAPPA, free_np, nu=3),
                build_amg(Vt, MU, KAPPA, free_np, nu=3, device="cpu", dtype=F64))
    aj = jax_build_amg(Vj, MU, KAPPA, free_np, spmv="windowed", nu=3,
                       node_perm=geos_j[0].ex.perm)
    pcj = aj.wrap_internal(geos_j[0].ex.M_pad)
    pcj.internal_layout = True
    at = build_amg(Vt, MU, KAPPA, free_np, device="cpu", dtype=F64, nu=3, spmv="windowed",
                   node_perm=geos_t[0].ex.perm)
    return pcj, at.wrap_internal(geos_t[0].ex.M_pad)


def engine_runs(pair, mat, engine):
    """Three converged steps through JAX's jitted step and through the port's
    step captured and replayed by the stand-in, from the zero state."""
    (Vj, bj), (Vt, bt) = pair["jax"], pair["torch"]
    kw = {} if engine == "structured" else {"engine": engine}
    geos, models, state = jax_problem(Vj, JVonMises3D(mat), 2, **kw)
    geos_t, models_t, state_t = build_packed_problem(Vt, VonMises3D(mat), 2, device="cpu",
                                                     dtype=F64, **kw)
    assert geos_t[0].engine == engine
    pcj, pct = preconditioners(Vj, Vt, bj, geos, geos_t, engine)
    n_f = geos[0].ndofs_int if engine == "windowed" else Vj.ndofs
    step = jax.jit(jax_make_step(geos, preconditioner=pcj, **CONVERGED))
    bc_dofs, bc_vals = jax_combine(bj)
    ref, st = [], state
    for k in SCALES:
        st, stats = step(models, st, jnp.asarray(bc_dofs), jnp.asarray(bc_vals) * k,
                         jnp.zeros(n_f), jnp.asarray(1.0))
        ref.append((st, stats))
    comp = compile_step(make_packed_step(geos_t, preconditioner=pct, **CONVERGED),
                        recorder=HostRecorder)
    bc_dofs, bc_vals = combine_bcs(bt)
    got, st = [], state_t
    for k in SCALES:
        st, stats = comp(models_t, st, torch.as_tensor(bc_dofs), torch.tensor(bc_vals) * k,
                         torch.zeros(n_f, dtype=F64), 1.0)
        got.append((st, stats))
    assert comp.captured and (comp.captures, comp.replays) == (1, len(SCALES) - 1)
    return ref, got


@pytest.fixture(scope="module")
def runs(box, tets, mat):
    return {"structured": engine_runs(box(4), mat, "structured"),
            "gather": engine_runs(tets(5), mat, "gather"),
            "windowed": engine_runs(tets(5), mat, "windowed")}


@pytest.mark.parametrize("k", range(len(SCALES)), ids=[f"step{k + 1}" for k in range(3)])
@pytest.mark.parametrize("engine", ["structured", "gather", "windowed"])
def test_converged_replays_match_jax(runs, engine, k):
    (sj, stj), (st, stt) = runs[engine][0][k], runs[engine][1][k]
    assert int(stt["newton_iters"]) == int(stj["newton_iters"])
    assert abs(int(stt["cg_iters_last"]) - int(stj["cg_iters_last"])) <= 1
    assert float(stt["r_norm"]) <= max(1e-10, 1e-10 * float(stt["r0_norm"]))
    close(stt["r0_norm"], stj["r0_norm"], 1e-10, "r0_norm")
    close(st.u, sj.u, 1e-10, "u")
    close(st.stress[0], sj.stress[0], 1e-10, "stress")
    for name in ("alpha", "eps_n"):
        close(st.histories[0][name], sj.histories[0][name], 1e-10, name)


def test_the_loops_ran_several_trips(runs):
    """The paths exercise the while nodes: several Newton and CG trips, and
    plastic points (the local Newton's loop)."""
    for _, got in runs.values():
        newton = [int(stats["newton_iters"]) for _, stats in got]
        cg = [int(stats["cg_iters_last"]) for _, stats in got]
        assert max(newton) >= 2 and max(cg) > 1
        assert float(got[-1][0].histories[0]["alpha"].max()) > 0.0


@pytest.mark.parametrize("form", ["packed", "aos"])
def test_local_newton_while_node_matches_jax(form):
    """The local Newton's while node (the stand-in's replay) against JAX's
    lax.while_loop on the same inputs: gamma, stress and tangent."""
    eps, stress, hist = mises_inputs(F64)
    law = VonMises3D({"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0,
                      "p_w": 200.0})
    jlaw = JVonMises3D(dict(law.params))
    if form == "packed":
        def run():
            return law.evaluate_packed(0.0, 1.0, eps, stress, hist)

        jout = jlaw.evaluate_packed(0.0, 1.0, jnp.asarray(eps.numpy()),
                                    jnp.asarray(stress.numpy()),
                                    {k: jnp.asarray(v.numpy()) for k, v in hist.items()})
    else:
        grad = mandel.mandel_to_matrix(eps.T, Constraint.FULL)
        aos = {"eps_n": hist["eps_n"].T.contiguous(), "alpha": hist["alpha"].T.contiguous()}

        def run():
            return law.evaluate(0.0, 1.0, grad, stress.T.contiguous(), aos)

        jout = jlaw.evaluate(0.0, 1.0, jnp.asarray(grad.numpy()),
                             jnp.asarray(stress.T.contiguous().numpy()),
                             {k: jnp.asarray(v.numpy()) for k, v in aos.items()})
    rec = HostRecorder("cpu")
    with no_host_sync():
        rec.capture(run)
    rec.replay()
    s_new, tangent, h_new = rec.out
    js, jt, jh = jout
    alpha0 = hist["alpha"].reshape(h_new["alpha"].shape)
    gamma = (h_new["alpha"] - alpha0) / SQ23
    jgamma = (np.asarray(jh["alpha"]) - alpha0.numpy()) / SQ23
    assert float((gamma > 0).double().mean()) > 0.2
    close(gamma, jgamma, 1e-12, "gamma")
    close(s_new, js, 1e-12, "stress")
    if form == "packed":
        for name in ("beta", "gamma", "n"):
            close(getattr(tangent, name), getattr(jt, name), 1e-12, f"tangent {name}")
    else:
        close(tangent, jt, 1e-12, "tangent")


# -- (c) every law through PackedSimulation with the stand-in ------------------------

SLS = {"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3}
DP = {"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15, "b_flow": 0.15}
LAWS = {
    "elastic": lambda: tm.LinearElasticityModel({"E": 42000.0, "nu": 0.3}, Constraint.FULL),
    "mises-exp": lambda: VonMises3D({"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0,
                                     "p_y00": 2500.0, "p_w": 200.0}),
    "mises-lin": lambda: tm.MisesPlasticityLinearHardening3D(
        {"mu": 80769.0, "kappa": 175000.0, "y_0": 1200.0, "h": 5000.0}),
    "kelvin": lambda: tm.SpringKelvinModel(SLS, Constraint.FULL),
    "maxwell": lambda: tm.SpringMaxwellModel(SLS, Constraint.FULL),
    "dp": lambda: tm.DruckerPrager3D(DP),
    "dp-hyp": lambda: tm.DruckerPragerHyperbolic3D({**DP, "d": 0.1}),
}


@pytest.mark.parametrize("law", list(LAWS))
def test_every_law_replays_through_simulation(box, law, monkeypatch):
    real = simulation.compile_step
    monkeypatch.setattr(simulation, "compile_step",
                        lambda step, **kw: real(step, recorder=HostRecorder, **kw))
    V, bcs = box(3)["torch"]
    sims = [PackedSimulation(LAWS[law](), V, bcs, 2, del_t=0.5, device="cpu", dtype=F64)
            for _ in range(2)]
    assert sims[0].captured and sims[0].host_syncs == ()
    for k in (1, 2, 3):
        bcs[1].value = 0.004 * k
        a = sims[0].solve()
        with disable_capture():
            b = sims[1].solve()
        assert a == b and a[1]
        assert {k_: v for k_, v in sims[0].last_stats.items() if k_ != "captured"} == {
            k_: v for k_, v in sims[1].last_stats.items() if k_ != "captured"}
        assert sims[0].last_stats["captured"] is True
    bcs[1].value = 0.004
    assert trees_equal(sims[0].state, sims[1].state)
    assert sims[0]._step.replays == 2


def test_drucker_prager_is_not_captured(box, monkeypatch):
    """A law that declares a ``host_sync`` is not captured; Drucker-Prager,
    whose return map reads nothing back, is."""
    real = simulation.compile_step
    monkeypatch.setattr(simulation, "compile_step",
                        lambda step, **kw: real(step, recorder=HostRecorder, **kw))
    V, bcs = box(3)["torch"]
    sim = PackedSimulation(SyncingLaw(dict(LAWS["mises-exp"]().params)), V, bcs, 2,
                           device="cpu", dtype=F64)
    assert not sim.captured and "SyncingLaw" in sim.host_syncs[0]
    dp = tm.DruckerPrager3D({"mu": 80769.0, "kappa": 175000.0, "a": 0.1, "b": 0.1,
                             "b_flow": 0.1})
    sim = PackedSimulation(dp, V, bcs, 2, device="cpu", dtype=F64)
    assert sim.captured and sim.host_syncs == ()


def test_two_laws_on_the_tet_part_replay_through_simulation(monkeypatch, tmp_path):
    """The benchmark's dp-maxwell-tet35-f64 configuration at 4^3 (the shuffled
    Gmsh tet box on the windowed engine with its AMG; Drucker-Prager below z
    = 0.51, a Maxwell solid above, del_t 0.5) through the stand-in: captured,
    and bit-equal in state and last_stats to the same solves inside
    ``disable_capture()``, over warm-up loads into the plastic range."""
    from benchmark import harness, program
    from benchmark.meshes import mesh_module

    real = simulation.compile_step
    monkeypatch.setattr(simulation, "compile_step",
                        lambda step, **kw: real(step, recorder=HostRecorder, **kw))
    cfg = harness.read_cell("dp-maxwell-tet35-f64.plastic")["config"]
    spec = dict(cfg["mesh"], n=4)
    mod = mesh_module(spec["kind"])
    inputs = mod.inputs(spec)
    laws = harness.law_cells(cfg, inputs)
    mod.prepare(inputs, spec, tmp_path)
    progs = [program.Program(dict(cfg, mesh=spec), mod, inputs, laws, tmp_path, "cpu", F64)
             for _ in range(2)]
    assert progs[0].sim.captured and progs[0].sim.host_syncs == ()
    assert progs[0].sim.engine == "windowed"
    for load in (0.002, 0.004, 0.006, 0.008):
        a = progs[0].solve(load)
        with disable_capture():
            b = progs[1].solve(load)
        assert a == b and a[1]
        assert {k: v for k, v in progs[0].last_stats.items() if k != "captured"} == {
            k: v for k, v in progs[1].last_stats.items() if k != "captured"}
    assert trees_equal(progs[0].state, progs[1].state)
    assert float(progs[0].state.histories[0]["alpha"].max()) > 0  # DP has yielded
    assert progs[0].sim._step.replays == 3
