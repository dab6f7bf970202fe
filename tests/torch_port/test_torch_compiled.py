"""The compiled step (``solver/compiled.py``, the port's counterpart of
``jax.jit``) on the CPU, float64, at small sizes: a 4^3 hex box, a 4^3 Kuhn
box, a shuffled 6^3 tet mesh on the windowed engine with the windowed AMG,
and the gather engine with the AMG on that mesh.

No CUDA graph exists on the CPU: the static-buffer path (copy in, the step
under ``no_host_sync()``, clone out) runs eagerly, and ``HostRecorder``
stands in for the graph where a test needs a replay: it records the same
program of segments and while nodes as the card's recorder, and a replay
reruns the captured call on the same static buffers into the same output
tensors, each ``device_while`` replayed from its static carry and predicate
buffer. Every comparison with the plain step is bit for bit: the two run
the same operations and the same loop trips (counter loops of 0, 1 and 37 trips,
flat and nested; converged Newton with adaptive CG on four engines; the
Mises local Newton). The schedule is held to JAX's ``lax.scan`` with the
tolerances of the existing schedule parity tests (test_torch_simulation.py).
"""

import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.models import Constraint as JConstraint
from fenics_constitutive_tpu.models import SpringKelvinModel as JSpringKelvin
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.models import (
    Constraint,
    DruckerPrager3D,
    SpringKelvinModel,
    VonMises3D,
)
from fenics_constitutive_tpu_torch.solver import (
    PackedSimulation,
    build_amg,
    compile_step,
    disable_capture,
    make_packed_step,
    simulation,
)
from fenics_constitutive_tpu_torch.solver import compiled
from fenics_constitutive_tpu_torch.solver.compiled import (
    GUARDED,
    HostSyncError,
    _map,
    device_while,
    host_reads_allowed,
    no_host_sync,
)
from scripts.torch_bench import amg as amg_bench
from scripts.torch_bench import common, tet, unstructured

F64 = torch.float64
CPU = torch.device("cpu")
LOADS = (0.5, 1.0, 1.5, 2.0)
SLS = {"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3}


class HostRecorder(compiled.GraphRecorder):
    """Stands in for ``CudaGraphRecorder`` on the CPU. Its capture records
    the program as the card's does (segments cut at each loop, the loops'
    static carries and predicate buffers); a replay reruns the captured call
    with every ``device_while`` replayed as a while node replays: the carry
    copied into the recorded static buffers, the recorded predicate buffer
    read before each trip, the recorded body run on the buffers and copied
    back. It writes the same output tensors. ``trips`` holds the trips each
    recorded loop ran in the last replay (summed over its entries)."""

    def capture(self, fn):
        self.fn = fn
        self.out = super().capture(fn)
        return self.out

    def replay(self):
        replayer = _Replayer(self.program)
        prev, compiled._recording = compiled._recording, replayer
        try:
            new = self.fn()
        finally:
            compiled._recording = prev
        self.trips = [replayer.trips.get(id(loop), 0) for loop in self.loops]
        _map(lambda dst, src: dst.copy_(src), self.out, new)


class _Replayer:
    """``device_while`` during a stand-in replay: the i-th loop a program
    reaches is its i-th recorded while node."""

    def __init__(self, program):
        self.cursors = [self.loops(program)]
        self.trips: dict = {}

    @staticmethod
    def loops(program):
        return iter([item[1] for item in program if item[0] == "while"])

    def loop(self, cond, body, carry, reads=None):
        node = next(self.cursors[-1])
        compiled._copy_into(node.static, carry)
        node.pred.copy_(cond(node.static))
        while compiled._BOOL(node.pred):
            self.cursors.append(self.loops(node.body))
            compiled._copy_into(node.static, body(node.static))
            node.pred.copy_(cond(node.static))
            self.trips[id(node)] = self.trips.get(id(node), 0) + 1
            self.cursors.pop()
        return node.static


def raw(step):
    """The make_packed_step step under a compiled one."""
    return step.step if isinstance(step, compiled.CompiledStep) else step


@pytest.fixture(scope="module")
def configs():
    """The four capturable configurations: (make the raw step, models, zero
    state, step arguments)."""
    out = {}
    geos, models, state, mg, args = common.bench_setup(4, F64, CPU, fused=True)
    out["box"] = (lambda: raw(common.bench_step(geos, mg, 9, "plain")), models, state, args)
    b = tet.build(4, CPU, F64)
    out["kuhn"] = (lambda: raw(common.bench_step(b["geos"], b["mg"], 14, "plain")),
                   b["models"], b["state"], b["args"])
    s = unstructured.setup(6, CPU, F64, "amg", 2, 512)
    a = common.step_args(s["bcs"], s["geos"][0].ndofs_int, F64, CPU)
    out["windowed"] = (lambda: raw(unstructured.step_of(s["geos"], s["pc"], 12)), s["models"],
                       s["state"], a)
    V = s["V"]
    g, m, st = amg_bench.gather_problem(V, CPU, F64)
    am = build_amg(V, common.MU, common.KAPPA, common.free_mask(V, s["bcs"]), q_degree=2,
                   spmv="ell", device=CPU, dtype=F64)
    out["gather"] = (lambda: raw(amg_bench.step_of(g, am, 3)), m, st,
                     common.step_args(s["bcs"], V.ndofs, F64, CPU))
    # the same problems at converged Newton and adaptive CG (device loops)
    for name, gs, pc in (("box", geos, mg), ("kuhn", b["geos"], b["mg"]),
                         ("windowed", s["geos"], s["pc"]), ("gather", g, am)):
        def make(gs=gs, pc=pc):
            return make_packed_step(gs, preconditioner=pc, **CONVERGED)

        out[f"{name} converged"] = (make, *out[name][1:])
    assert {k: v[0]().host_syncs for k, v in out.items()} == dict.fromkeys(out, ())
    return out


#: converged Newton and adaptive CG, tight enough for several trips of each
CONVERGED = dict(max_newton=25, newton_rtol=1e-9, newton_atol=1e-12, cg_rtol=1e-8,
                 cg_maxiter=400)


def trees_equal(a, b) -> bool:
    flags = []
    _map(lambda x, y: flags.append(torch.equal(x, y)), a, b)
    return all(flags) and len(flags) > 0


# -- (a) the sync guard --------------------------------------------------------------


@pytest.mark.parametrize("name", GUARDED)
def test_guard_refuses_each_host_read(name):
    x = torch.ones(3)
    with no_host_sync():
        assert not host_reads_allowed()
        with pytest.raises(HostSyncError, match=name.strip("_")):
            getattr(x[0] if name in ("__bool__", "__float__", "__int__", "item") else x, name)()
    assert host_reads_allowed()
    getattr(x[0] if name in ("__bool__", "__float__", "__int__", "item") else x, name)()


@pytest.mark.parametrize("config", ["box", "kuhn", "windowed", "gather"])
def test_capturable_body_reads_nothing_back(configs, config):
    make, models, state, (bc_dofs, bc_vals, f_ext, _) = configs[config]
    step = make()
    bnd = step.prepare(bc_dofs)
    dt = torch.ones((), dtype=F64)
    with no_host_sync():
        st, stats = step.run(models, state, bnd, bc_vals * 2.0, f_ext, dt)
        st, stats = step.run(models, st, bnd, bc_vals * 2.05, f_ext, dt)
    assert torch.isfinite(st.u).all() and float(stats["r_norm"]) < float(stats["r0_norm"])


# -- (b) refusals --------------------------------------------------------------------


class SyncingLaw(VonMises3D):
    """A law that declares a host read, as the native ones do."""

    host_sync = "its update runs on the host"


def test_capture_refuses_what_reads_back(configs):
    """Converged Newton and adaptive CG are device loops now: only a law with
    a ``host_sync`` (and a sharded geometry, below) is refused."""
    assert configs["box"][0]().host_syncs == ()
    g, models, state = common.bench_setup(4, F64, CPU)[:3]
    for opts in (dict(max_newton=2, cg_fixed_iters=9), dict(max_newton=1), {}):
        step = make_packed_step(g, **opts)
        assert step.host_syncs == ()
        assert compile_step(step, capture=True).static
        assert not compile_step(step).captured  # no graph off the card
    step = make_packed_step(g, max_newton=1, cg_fixed_iters=9)
    law = SyncingLaw(dict(models[0].params))
    with pytest.raises(ValueError, match="SyncingLaw"):
        compile_step(step, capture=True, models=(law,))
    comp = compile_step(step, recorder=HostRecorder)
    with pytest.raises(ValueError, match="SyncingLaw"):
        comp((law,), state, *common.step_args(common.box(4)[1], g[0].ndofs, F64, CPU))
    # Drucker-Prager's return map reads nothing back: its step is captured
    dp = DruckerPrager3D({"mu": 1.0, "kappa": 1.0, "a": 0.1, "b": 0.1, "b_flow": 0.1})
    comp = compile_step(step, capture=True, models=(dp,))
    assert comp.static and comp.host_syncs == ()
    assert compile_step(step, recorder=HostRecorder, models=(dp,)).captured


def test_capture_refuses_a_sharded_geometry(tmp_path):
    import torch.distributed as dist

    from fenics_constitutive_tpu_torch.parallel import make_device_mesh, shard_packed_state

    geos, models, state, _, _ = common.bench_setup(4, F64, CPU)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        sg, _ = shard_packed_state(geos, state, make_device_mesh(1, device="cpu"))
        step = make_packed_step(sg, max_newton=1, cg_fixed_iters=3)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="sharded"):
        compile_step(step, capture=True)


# -- (c) the static-buffer path ------------------------------------------------------


@pytest.mark.parametrize("recorder", [None, HostRecorder], ids=["static", "replayed"])
@pytest.mark.parametrize("config", ["box", "kuhn", "windowed", "gather"])
def test_static_path_is_bit_equal_to_the_plain_step(configs, config, recorder):
    make, models, state, (bc_dofs, bc_vals, f_ext, dt) = configs[config]
    plain = make()
    comp = compile_step(make(), capture=True, recorder=recorder)
    assert comp.captured == (recorder is not None)
    sp = sc = state
    for k in LOADS:
        sp, stp = plain(models, sp, bc_dofs, bc_vals * k, f_ext, dt)
        sc, stc = comp(models, sc, bc_dofs, bc_vals * k, f_ext, dt)
        assert trees_equal(sp, sc) and trees_equal(stp, stc)
    assert comp.captures == (recorder is not None) and comp.replays == (
        len(LOADS) - 1 if recorder else 0)


def test_a_new_dirichlet_set_or_shape_recaptures(configs):
    make, models, state, (bc_dofs, bc_vals, f_ext, dt) = configs["box"]
    comp = compile_step(make(), recorder=HostRecorder)
    plain = make()
    comp(models, state, bc_dofs, bc_vals, f_ext, dt)
    comp(models, state, bc_dofs.copy(), bc_vals * 2, f_ext, dt)  # same dofs: a replay
    assert (comp.captures, comp.replays) == (1, 1)
    # the same dofs as a tensor, and as an int64 array: the same key, a replay
    comp(models, state, torch.as_tensor(bc_dofs), bc_vals * 3, f_ext, dt)
    comp(models, state, np.asarray(bc_dofs, np.int64), bc_vals, f_ext, dt)
    assert (comp.captures, comp.replays) == (1, 3)
    fewer = (bc_dofs[:-3], bc_vals[:-3])
    got, _ = comp(models, state, fewer[0], fewer[1], f_ext, dt)
    want, _ = plain(models, state, fewer[0], fewer[1], f_ext, dt)
    assert comp.captures == 2 and trees_equal(got, want)
    with disable_capture():
        comp(models, state, bc_dofs, bc_vals, f_ext, dt)
    assert (comp.captures, comp.replays) == (2, 3)


# -- (d) the schedule against JAX's lax.scan -------------------------------------------


def captured_sim(monkeypatch):
    """PackedSimulation whose step records with HostRecorder (captured)."""
    real = simulation.compile_step
    monkeypatch.setattr(simulation, "compile_step",
                        lambda step, **kw: real(step, recorder=HostRecorder, **kw))


def test_schedule_matches_jax_scan_with_a_law_that_reads_dt(box, monkeypatch):
    captured_sim(monkeypatch)
    pair = box(4, 0.0)
    dts = np.array([0.5, 1.0, 0.25, 2.0])
    scales = np.array([1.0, 0.5, 1.5, 1.0])
    opts = dict(max_newton=1, cg_fixed_iters=60, newton_rtol=1e-6, newton_atol=1e-10)
    out = {}
    for key, law, make, combine in (
            ("jax", JSpringKelvin(SLS, JConstraint.FULL), JPackedSimulation, jax_combine),
            ("torch", SpringKelvinModel(SLS, Constraint.FULL), PackedSimulation, combine_bcs)):
        V, bcs = pair[key]
        vals = []
        for v in (0.001, 0.002, 0.002, 0.003):
            bcs[1].value = v
            vals.append(combine(bcs)[1])
        f = np.zeros(V.ndofs)
        f[3 * np.arange(V.ndofs // 3)] = 1e-3  # a uniform x load on every node
        kw = dict(device="cpu", dtype=F64) if key == "torch" else {}
        sim = make(law, V, bcs, 2, f_ext=f, **opts, **kw)
        out[key] = (sim, sim.solve_schedule(np.stack(vals), dts=dts, f_ext_scales=scales))
    (sj, stj), (st, stt) = out["jax"], out["torch"]
    assert st.captured and st._step.replays == 3 and st.last_stats["captured"]
    np.testing.assert_array_equal(stt["newton_iters"], stj["newton_iters"])
    np.testing.assert_allclose(stt["r0_norm"], np.asarray(stj["r0_norm"]), rtol=1e-9)
    uj = np.asarray(sj.u)
    np.testing.assert_allclose(st.u.numpy(), uj, rtol=1e-7, atol=1e-7 * np.abs(uj).max())
    np.testing.assert_allclose(st.stress, np.asarray(sj.stress), rtol=1e-8, atol=1e-7)
    assert st.time == pytest.approx(dts.sum())


# -- (e) the Mises local Newton -------------------------------------------------------


def mises_inputs(dtype, n=512, seed=4):
    rng = np.random.default_rng(seed)
    eps = torch.as_tensor(rng.normal(size=(6, n)) * 4e-3, dtype=dtype)
    stress = torch.as_tensor(rng.normal(size=(6, n)) * 300.0, dtype=dtype)
    hist = {"eps_n": torch.zeros((6, n), dtype=dtype),
            "alpha": torch.as_tensor(rng.uniform(0, 2e-3, size=(1, n)), dtype=dtype)}
    return eps, stress, hist


@pytest.mark.parametrize("form", ["packed", "aos"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mises_without_early_exit_is_bit_equal(form, dtype):
    """The Mises local Newton as a while node (the stand-in's capture and
    replays) against the eager loop, bit for bit: the same trips over the
    static buffers."""
    law = VonMises3D(common.MAT)
    eps, stress, hist = mises_inputs(dtype)
    if form == "packed":
        def run():
            return law.evaluate_packed(0.0, 1.0, eps, stress, hist)
    else:
        from fenics_constitutive_tpu_torch.ops import mandel

        grad = mandel.mandel_to_matrix(eps.T, Constraint.FULL)
        aos = {"eps_n": hist["eps_n"].T.contiguous(), "alpha": hist["alpha"].T.contiguous()}

        def run():
            return law.evaluate(0.0, 1.0, grad, stress.T.contiguous(), aos)
    early = run()
    rec = HostRecorder(CPU)
    with no_host_sync():
        rec.capture(run)
    assert len(rec.loops) == 1
    trips = 0
    for _ in range(2):
        rec.replay()
        assert trees_equal(early, rec.out)
        trips += rec.trips[0]
    assert 2 < trips <= 2 * (law.newton_max_iter + 1)
    alpha = early[2]["alpha"]
    assert float((alpha > hist["alpha"].reshape(alpha.shape)).double().mean()) > 0.2


# -- (f) value semantics -------------------------------------------------------------


def test_a_held_state_does_not_change(configs):
    make, models, state, (bc_dofs, bc_vals, f_ext, dt) = configs["windowed"]
    comp = compile_step(make(), recorder=HostRecorder)
    s1, stats1 = comp(models, state, bc_dofs, bc_vals * 2.0, f_ext, dt)
    held, held_stats = s1.clone(), {k: v.clone() for k, v in stats1.items()}
    s2, _ = comp(models, s1, bc_dofs, bc_vals * 2.05, f_ext, dt)
    comp(models, s2, bc_dofs, bc_vals * 2.1, f_ext, dt)
    assert comp.replays == 2
    assert trees_equal(s1, held) and trees_equal(stats1, held_stats)
    assert not torch.equal(s1.u, s2.u)


def test_a_failed_attempt_leaves_the_committed_state(box, mat, monkeypatch):
    captured_sim(monkeypatch)
    V, bcs = box(4, 0.002)["torch"]
    sim = PackedSimulation(VonMises3D(mat), V, bcs, 2, max_newton=1, cg_fixed_iters=20,
                           newton_rtol=0.0, newton_atol=0.0, max_subdivisions=1,
                           device="cpu", dtype=F64)
    assert sim.captured
    before, u_ref = sim.state, sim.state.u.clone()
    # never converged at a zero tolerance: the step, then its first substep
    # retried from the committed state, which both leave as it was
    niter, ok = sim.solve()
    assert not ok and sim.state is before and torch.equal(sim.state.u, u_ref)
    assert (sim._step.captures, sim._step.replays) == (1, 1)
    sim2 = PackedSimulation(VonMises3D(mat), V, bcs, 2, max_newton=1, cg_fixed_iters=20,
                            newton_rtol=0.5, device="cpu", dtype=F64)
    assert sim2.solve()[1]
    held = sim2.u.clone()
    sim2.solve()
    assert torch.equal(sim.u, u_ref) and not torch.equal(sim2.u, held)


def test_simulation_runs_eagerly_off_the_card_and_where_it_reads_back(box, mat):
    """Off the card every PackedSimulation runs eagerly; on it, the defaults
    (converged Newton, adaptive CG) and a Drucker-Prager law are capturable
    (no host sync), and a law with a ``host_sync`` names it."""
    V, bcs = box(3)["torch"]
    fixed = PackedSimulation(VonMises3D(mat), V, bcs, 2, max_newton=1, cg_fixed_iters=5,
                             device="cpu", dtype=F64)
    conv = PackedSimulation(VonMises3D(mat), V, bcs, 2, device="cpu", dtype=F64)
    dp = PackedSimulation(DruckerPrager3D({"mu": 1.0, "kappa": 1.0, "a": 0.1, "b": 0.1,
                                           "b_flow": 0.1}), V, bcs, 2, device="cpu", dtype=F64)
    syncing = PackedSimulation(SyncingLaw(mat), V, bcs, 2, device="cpu", dtype=F64)
    assert not fixed.captured and fixed.host_syncs == ()
    assert not conv.captured and conv.host_syncs == ()
    assert not dp.captured and dp.host_syncs == ()
    assert not syncing.captured and "SyncingLaw" in syncing.host_syncs[0]
    fixed.solve()
    conv.solve()
    assert fixed.last_stats["captured"] is False and conv.last_stats["captured"] is False


# -- (g) launch counters -------------------------------------------------------------


def test_a_launch_on_a_capturing_stream_is_not_counted(monkeypatch):
    """A wrapper called while the current stream captures a CUDA graph
    records a kernel and launches nothing: ``launched`` adds 0 then, 1
    otherwise (a CUDA context is stood in for: no stream captures without
    one)."""
    from fenics_constitutive_tpu_torch.ops import _cuda_build

    assert _cuda_build.launched() == 1
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    assert _cuda_build.launched() == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert _cuda_build.launched() == 0


# -- (h) the loops the device decides (device_while) -------------------------------


@pytest.mark.parametrize("trips", [0, 1, 37])
@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_loop_replays_n_trips(trips, nested):
    """A loop recorded once with its trip count in a tensor replays exactly
    N trips (a nested loop of 3 trips in each), from the static buffers."""
    i64 = torch.int64
    n = torch.zeros((), dtype=i64)

    def body(carry):
        i, acc = carry
        if nested:
            def inner(c):
                return c[0] + 1, c[1] + 1.0

            acc = device_while(lambda c: c[0] < 3, inner, (torch.zeros_like(i), acc),
                               name="inner")[1]
        else:
            acc = acc + 1.0
        return i + 1, acc

    def fn():
        return device_while(lambda c: c[0] < n, body, (torch.zeros((), dtype=i64),
                                                        torch.zeros((), dtype=F64)),
                            name="outer")

    rec = HostRecorder(CPU)
    rec.capture(fn)
    assert len(rec.loops) == (2 if nested else 1)
    for _ in range(2):  # each replay runs its own trips from the static buffers
        n.fill_(trips)
        rec.replay()
        assert (int(rec.out[0]), float(rec.out[1])) == (trips, trips * (3.0 if nested else 1.0))
        assert rec.trips == ([trips, 3 * trips] if nested else [trips])
    n.fill_(trips)
    eager = fn()  # the same loop eagerly
    assert (int(eager[0]), float(eager[1])) == (int(rec.out[0]), float(rec.out[1]))


def test_device_while_refuses_a_changed_carry_and_a_host_read():
    def grow(c):
        return (torch.cat([c[0], c[0]]),)

    with pytest.raises(ValueError, match="structure"):
        HostRecorder(CPU).capture(lambda: device_while(lambda c: c[0].sum() < 8, grow,
                                                       (torch.ones(2),), name="grow"))

    def reads(c):
        float(c[0])
        return (c[0] + 1,)

    with no_host_sync(), pytest.raises(HostSyncError):
        HostRecorder(CPU).capture(lambda: device_while(lambda c: c[0] < 3, reads,
                                                       (torch.zeros(()),), name="reads"))


@pytest.mark.parametrize("config", ["box", "kuhn", "windowed", "gather"])
def test_converged_steps_replay_bit_equal(configs, config):
    """Converged Newton with adaptive CG (and the Mises local Newton) through
    the stand-in's capture and replays, against the plain step: bit-equal
    states and stats over four loads, so the replays take the plain step's
    Newton and CG trips (``newton_iters``, ``cg_iters_last``)."""
    make, models, state, (bc_dofs, bc_vals, f_ext, dt) = configs[f"{config} converged"]
    plain = make()
    comp = compile_step(make(), recorder=HostRecorder)
    sp = sc = state
    newton = []
    for k in LOADS:
        sp, stp = plain(models, sp, bc_dofs, bc_vals * k, f_ext, dt)
        sc, stc = comp(models, sc, bc_dofs, bc_vals * k, f_ext, dt)
        assert trees_equal(sp, sc) and trees_equal(stp, stc)
        newton.append((int(stc["newton_iters"]), int(stc["cg_iters_last"])))
    assert (comp.captures, comp.replays) == (1, len(LOADS) - 1)
    assert max(n for n, _ in newton) >= 2 and max(k for _, k in newton) > 1
    rec = next(iter(comp._entries.values())).recorder
    assert len(rec.loops) >= 4  # Newton, CG in it, the local Newton before and in it
