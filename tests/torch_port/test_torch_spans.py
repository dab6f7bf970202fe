"""The port's profiler scopes (``utils/timers.py``) through
``PackedSimulation.solve()`` on the CPU, float64: a 4^3 hex box with the
V-cycle and a shuffled 4^3 tet mesh, as it arrives from a mesher, on the
windowed engine with its AMG, each pulled past yield.

Under ``torch.profiler`` (CPU activity) a solve opens every scope of its
layers, nested as designed; the ``cg.iter`` and ``law.trip`` scopes count
the CG iterations and local-Newton trips that wrappers of ``cg_solve`` and
of the law's loop count on their own. Without a profiler no scope enters
``record_function``, and the results are bit-equal to a profiled run's; a
capture taken under a profiler (the ``HostRecorder`` stand-in) replays
bit-equal to the eager step.
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fenics_constitutive_tpu_torch.models import VonMises3D, packed_models
from fenics_constitutive_tpu_torch.solver import PackedSimulation, linear
from test_torch_compiled import captured_sim, trees_equal

F64 = torch.float64
#: stretches of the pulled face: elastic, then past yield twice
LOADS = (0.004, 0.008, 0.010)
#: the enclosing program scope each scope may have in one solve() call
PARENTS = {
    "solve": {None},
    "solve.inputs": {"solve"},
    "solve.read_back": {"solve"},
    "newton.iter": {"solve"},
    "newton.assemble": {"solve", "newton.iter"},  # the first evaluation, then each trip's
    "law.eval": {"newton.assemble"},
    "law.trip": {"law.eval"},
    "cg.solve": {"newton.iter"},
    "cg.iter": {"cg.solve"},
    "cg.operator": {"cg.iter"},
    "cg.precond": {"cg.solve", "cg.iter"},  # the first apply, then each iteration's
}
STEP_SCOPES = ("step.key", "step.copy_in", "step.capture", "step.replay", "step.clone_out")


def make_sim(kind, box, tets, mat):
    if kind == "box":
        V, bcs = box(4)["torch"]
        opts = {"preconditioner": "vcycle"}
    else:
        V, bcs = tets(4)["torch"]
        opts = {"engine": "windowed"}  # preconditioner "auto": the windowed AMG
    sim = PackedSimulation(VonMises3D(mat), V, bcs, 2, device="cpu", dtype=F64, **opts)
    return sim, bcs


def run(sim, bcs, profiled: bool):
    """Each load of LOADS through solve(): (per-step results, the program's
    scope events, innermost first order as the profiler lists them)."""
    out = []

    def steps():
        for v in LOADS:
            bcs[1].value = v
            niter, ok = sim.solve()
            out.append((niter, ok, sim.state, dict(sim.last_stats)))

    if not profiled:
        steps()
        return out, []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps()
    names = set(PARENTS) | set(STEP_SCOPES)
    return out, [e for e in prof.events() if e.name in names]


def program_parent(e):
    """The name of the nearest enclosing scope of the program, or None."""
    p = e.cpu_parent
    while p is not None and p.name not in PARENTS and p.name not in STEP_SCOPES:
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.fixture
def counted(monkeypatch):
    """Counts of CG iterations (from cg_solve's returned count) and of
    local-Newton trips (body calls of the law's loop), kept apart from the
    scopes."""
    counts = collections.Counter()
    cg_solve = linear.cg_solve

    def cg(*args, **kwargs):
        x, k = cg_solve(*args, **kwargs)
        counts["cg_solve"] += 1
        counts["cg_iters"] += int(k)
        return x, k

    loop = packed_models.device_while

    def law_loop(cond, body, carry, **kwargs):
        def trip(c):
            counts["trips"] += 1
            return body(c)

        counts["law_loops"] += 1
        return loop(cond, trip, carry, **kwargs)

    monkeypatch.setattr(linear, "cg_solve", cg)
    monkeypatch.setattr(packed_models, "device_while", law_loop)
    return counts


@pytest.mark.parametrize("kind", ["box", "tets"])
def test_a_plastic_solve_opens_every_scope_nested(kind, box, tets, mat, counted):
    sim, bcs = make_sim(kind, box, tets, mat)
    out, events = run(sim, bcs, profiled=True)
    assert all(ok for _, ok, _, _ in out)
    assert not sim.captured  # the CPU runs the step eagerly: no step.* scope
    n = collections.Counter(e.name for e in events)
    assert set(n) == set(PARENTS), n
    for e in events:
        assert program_parent(e) in PARENTS[e.name], (e.name, program_parent(e))
    newton = sum(niter for niter, _, _, _ in out)
    assert n["solve"] == n["solve.inputs"] == n["solve.read_back"] == len(LOADS)
    assert n["newton.iter"] == newton == n["cg.solve"] == counted["cg_solve"]
    assert n["newton.assemble"] == n["law.eval"] == newton + len(LOADS) == counted["law_loops"]
    assert n["cg.iter"] == counted["cg_iters"] == n["cg.operator"] > 0
    assert n["cg.precond"] == n["cg.iter"] + n["cg.solve"]
    assert n["law.trip"] == counted["trips"] > 0  # past yield: the return map iterates


@pytest.mark.parametrize("kind", ["box", "tets"])
def test_without_a_profiler_no_scope_is_entered(kind, box, tets, mat, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        m.setattr(torch.autograd.profiler, "record_function", refuse)
        plain, _ = run(*make_sim(kind, box, tets, mat), profiled=False)
    scoped, events = run(*make_sim(kind, box, tets, mat), profiled=True)
    assert events
    for (n0, ok0, st0, stats0), (n1, ok1, st1, stats1) in zip(plain, scoped, strict=True):
        assert (n0, ok0, stats0) == (n1, ok1, stats1)
        assert trees_equal(st0, st1)


def test_a_capture_under_a_profiler_replays_bit_equal(box, mat, monkeypatch):
    eager, _ = run(*make_sim("box", box, None, mat), profiled=False)
    captured_sim(monkeypatch)
    sim, bcs = make_sim("box", box, None, mat)
    assert sim.captured
    replayed, events = run(sim, bcs, profiled=True)  # captures at the first load
    n = collections.Counter(e.name for e in events)
    assert n["step.capture"] == 1 and n["step.replay"] == len(LOADS) - 1
    assert n["step.key"] == n["step.copy_in"] == n["step.clone_out"] == len(LOADS)
    assert sim._step.captures == 1
    for (n0, _, st0, stats0), (n1, _, st1, stats1) in zip(eager, replayed, strict=True):
        assert n0 == n1 and stats0["r_norm"] == stats1["r_norm"]
        assert trees_equal(st0, st1)
    # the same graph replayed again without a profiler
    sim.state = eager[0][2]
    bcs[1].value = LOADS[1]
    sim.solve()
    assert sim._step.captures == 1 and trees_equal(sim.state, eager[1][2])
