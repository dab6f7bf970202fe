"""The two-law tet deployment ``dp-maxwell-tet35-f64`` and its cell: the
configuration as the contract states it, its two per-layer metrics on a
hand-written trace, and a CPU run at a 4^3 mesh (the kernels' plain
versions) whose answers the reference judges correct and whose float32
control runs every step and is judged not correct."""

import json

import numpy as np
import pytest

from benchmark import costs, harness
from benchmark.meshes import mesh_module
from benchmark.tests.test_bench_spans import annotation, kernel

CELL = "dp-maxwell-tet35-f64.plastic"
SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NEW_METRICS = ("law.return_map_ms_per_step", "cg.dense_operator_ms_per_step")


def test_the_configuration_and_its_cell():
    files = harness.read_cell(CELL)
    cfg, cell = files["config"], files["cell"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("dp-maxwell-tet35-f64",
                                                                "plastic", 1)
    assert cfg["mesh"] == harness.read_cell("mises-tet35-gmsh-f64.plastic")["config"]["mesh"]
    assert [law["name"] for law in cfg["laws"]] == ["DruckerPrager3D", "SpringMaxwellModel"]
    assert cfg["simulation"] == {"engine": "windowed", "del_t": 0.5}
    assert cfg["reduced"] == [] and cfg["dtype"] == "float64" and cfg["q_degree"] == 2
    assert cfg["control"]["dtype"] == "float32"
    # the split at the size the cell runs: DP on the 18 lowest layers of cubes
    inp = mesh_module("kuhn_tet_gmsh").inputs(cfg["mesh"])
    (dp, below), (mx, above) = harness.law_cells(cfg, inp)
    assert (len(below), len(above)) == (132_300, 124_950)
    assert dp["params"]["b"] == dp["params"]["b_flow"] and mx["constraint"] == "FULL"
    # the cell reports the two new metrics and every accepted one that reads it
    names = {m["name"] for m in files["per_layer"]}
    assert set(NEW_METRICS) <= names
    assert {"K5_roofline", "K6_roofline", "law.trips_per_eval", "device.idle_share"} <= names
    assert not names & {"K1_roofline", "K3_roofline"}
    layers = {m["name"]: (m["layer"], m["workloads"]) for m in SPEC["per_layer"]}
    assert layers["law.return_map_ms_per_step"] == ("Constitutive update", [CELL])
    assert layers["cg.dense_operator_ms_per_step"] == ("CG operator", [CELL])


@pytest.fixture
def trace(tmp_path):
    """One step: a law evaluation whose return map runs two trips and a
    tail, then a CG iteration whose operator holds a dense-tangent part
    (two kernels) and a factored law's part (one)."""
    ev = [annotation("w", 0, 100), annotation("solve", 2, 88),
          annotation("newton.assemble", 5, 30), annotation("law.eval", 6, 20),
          annotation("law.return_map", 7, 18), annotation("law.trip", 8, 4),
          annotation("law.trip", 13, 4), annotation("law.eval", 27, 5),
          annotation("cg.solve", 40, 40), annotation("cg.iter", 41, 35),
          annotation("cg.operator", 42, 20), annotation("cg.operator.dense", 43, 10)]
    ev += kernel("jac_a", 20, 3, 9, 1)           # law.trip
    ev += kernel("jac_b", 23, 3, 14, 2)          # law.trip
    ev += kernel("tangent", 26, 2, 20, 3)        # law.return_map itself
    ev += kernel("maxwell", 30, 1, 28, 4)        # the other law.eval
    ev += kernel("strain", 50, 4, 44, 5)         # cg.operator.dense
    ev += kernel("dense_apply", 54, 6, 48, 6)    # cg.operator.dense
    ev += kernel("cell_apply", 60, 2, 55, 7)     # cg.operator itself
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return costs.Trace(path, "w")


def test_new_readers_on_a_context(trace):
    ctx = {"kernel_trace": trace, "trace": trace, "trace_steps": 1}
    values = {name: harness.reader(name).read(ctx) for name in NEW_METRICS + (
        "law.ms_per_step", "cg.operator_ms_per_step", "law.trips_per_eval")}
    assert values == pytest.approx({
        "law.return_map_ms_per_step": 8e-3, "cg.dense_operator_ms_per_step": 10e-3,
        "law.ms_per_step": 9e-3, "cg.operator_ms_per_step": 12e-3, "law.trips_per_eval": 1.0})
    ctx["trace_steps"] = 2
    assert harness.reader(NEW_METRICS[0]).read(ctx) == pytest.approx(4e-3)


def test_new_readers_find_nothing_without_their_scopes(tmp_path):
    """A program without the scopes reads None, and raises nothing."""
    ev = [annotation("w", 0, 100), annotation("law.eval", 1, 20),
          annotation("cg.operator", 30, 20), *kernel("k", 10, 5, 5, 1)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = costs.Trace(path, "w")
    for name in NEW_METRICS:
        assert harness.reader(name).read({"kernel_trace": tr, "trace": tr,
                                          "trace_steps": 1}) is None
        assert harness.reader(name).read({"kernel_trace": None}) is None


@pytest.mark.parametrize("control", [False, True], ids=["program", "control"])
def test_a_cpu_run_of_the_cell(control):
    """At 4^3: the program is correct; the float32 control converges every
    step of its window and is not correct."""
    line = harness.run(CELL, 2**31 + 25, 0.5, False, device="cpu", n=4, min_steps=8,
                       control=control)
    assert line["failed"] == 0 and line["attempted"] >= 8
    assert line["correct"] is (not control), line["compared"]
    assert np.isfinite([c["value"] for c in line["compared"].values()]).all()
