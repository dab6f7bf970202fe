"""``benchmark/spans.py`` on a hand-written chrome trace: each device event
goes to the innermost program scope open at its launch, inclusive and self
times follow the nesting, and idle gaps count where their middle lies
inside ``solve``."""

import json

import pytest

from benchmark import costs, harness, spans


def annotation(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def kernel(name, ts, dur, launched, corr, cat="cuda_runtime"):
    """A kernel event and its launch call at ``launched`` (a ``cuda_runtime``
    event, or a ``cuda_driver`` one as cuBLAS makes)."""
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": launched,
             "dur": 1, "args": {"correlation": corr}}]


@pytest.fixture
def trace(tmp_path):
    """One step of 0-100 us: ``solve`` 2-90 holds a Newton trip 10-70 with
    an assembly (a law evaluation inside) and a CG solve of one iteration
    (operator, preconditioner, a dot); a kernel launched at 95, and a fill
    with no launch call at 97, lie under no scope of the program. The
    operator's GEMM is launched by a ``cuda_driver`` call at 40 and runs at
    56, under the CG iteration's own time."""
    ev = [annotation("w", 0, 100), annotation("solve", 2, 88),
          annotation("newton.iter", 10, 60),
          annotation("newton.assemble", 11, 20), annotation("law.eval", 12, 8),
          annotation("law.trip", 13, 3), annotation("law.trip", 16, 3),
          annotation("cg.solve", 32, 36), annotation("cg.iter", 33, 30),
          annotation("cg.operator", 34, 10), annotation("cg.precond", 45, 10),
          annotation("solve.read_back", 75, 10)]
    ev += kernel("strain", 20, 2, 11.5, 1)       # newton.assemble itself
    ev += kernel("trip_a", 22, 3, 14, 2)         # law.trip
    ev += kernel("trip_b", 25, 3, 17, 3)         # law.trip
    ev += kernel("law_tail", 28, 1, 19.5, 4)     # law.eval itself
    ev += kernel("matvec", 36, 5, 35, 5)         # cg.operator
    ev += kernel("vcycle", 46, 8, 46, 6)         # cg.precond
    ev += kernel("dot", 56, 2, 60, 7)            # cg.iter itself
    ev += kernel("predicate", 64, 1, 64, 8)      # cg.solve itself
    ev += kernel("late", 96, 2, 95, 9)           # under no scope
    ev += kernel("gemm", 56, 2, 40, 10, "cuda_driver")  # cg.operator
    ev.append({"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 97, "dur": 1})
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return costs.Trace(path, "w")


def test_each_event_goes_to_its_innermost_scope(trace):
    sp = spans.Spans(trace)
    owners = {e["name"]: None if i is None else sp.scopes[i]["name"] for e, i in sp.owned}
    assert owners == {"strain": "newton.assemble", "trip_a": "law.trip", "trip_b": "law.trip",
                      "law_tail": "law.eval", "matvec": "cg.operator", "vcycle": "cg.precond",
                      "dot": "cg.iter", "predicate": "cg.solve", "late": None,
                      "gemm": "cg.operator", "Memset": None}
    assert sp.count("law.trip") == 2 and sp.count("cg.iter") == 1 and sp.count("nothing") == 0


def test_inclusive_and_self_times(trace):
    sp = spans.Spans(trace)
    us = pytest.approx
    assert sp.inclusive_s("law.eval") == us(7e-6)
    assert sp.inclusive_s("newton.assemble") == us(9e-6)
    assert sp.self_s("newton.assemble") == us(2e-6)
    assert sp.inclusive_s("cg.operator") == us(7e-6)
    assert sp.inclusive_s("cg.precond") == us(8e-6)
    assert sp.self_s("cg.solve", "cg.iter") == us(3e-6)
    assert sp.inclusive_s("newton.iter") == us(27e-6)
    assert sp.inclusive_s("solve") == us(27e-6)
    assert sp.outside_s() == us(3e-6)
    assert sp.device_s() == us(30e-6)
    assert sp.unlaunched_s == us(1e-6)


def test_idle_gaps_inside_solve(trace):
    # busy [20, 29], [36, 41], [46, 54], [56, 58], [64, 65], [96, 98]: the
    # gaps whose middle lies in solve (2-90) are 0-20, 29-36, 41-46, 54-56,
    # 58-64 and 65-96; 98-100 is not
    sp = spans.Spans(trace)
    assert sp.idle_s("solve") == pytest.approx((20 + 7 + 5 + 2 + 6 + 31) * 1e-6)
    assert sp.idle_s("solve") + 2e-6 == pytest.approx(trace.window_s - trace.busy_s)


def test_readers_on_a_context(trace):
    ctx = {"kernel_trace": trace, "trace": trace, "trace_steps": 1}
    values = {name: harness.reader(name).read(ctx) for name in (
        "cg.iters_per_step", "law.trips_per_eval", "law.ms_per_step",
        "newton.assemble_ms_per_step", "cg.operator_ms_per_step", "cg.precond_ms_per_step",
        "cg.self_ms_per_step", "solve.idle_ms_per_step")}
    assert values == pytest.approx({
        "cg.iters_per_step": 1.0, "law.trips_per_eval": 2.0, "law.ms_per_step": 7e-3,
        "newton.assemble_ms_per_step": 2e-3, "cg.operator_ms_per_step": 7e-3,
        "cg.precond_ms_per_step": 8e-3, "cg.self_ms_per_step": 3e-3,
        "solve.idle_ms_per_step": 71e-3})


def test_a_program_without_scopes_reads_nothing(tmp_path):
    ev = [annotation("w", 0, 100), *kernel("k", 10, 5, 5, 1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = costs.Trace(path, "w")
    ctx = {"kernel_trace": tr, "trace": tr, "trace_steps": 1}
    for name in ("cg.iters_per_step", "law.trips_per_eval", "law.ms_per_step",
                 "newton.assemble_ms_per_step", "cg.operator_ms_per_step",
                 "cg.precond_ms_per_step", "cg.self_ms_per_step", "solve.idle_ms_per_step"):
        assert harness.reader(name).read(ctx) is None
    assert harness.reader("cg.iters_per_step").read({"kernel_trace": None}) is None
