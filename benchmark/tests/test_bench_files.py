"""Every cell's files load, and BENCHMARK.json keeps to its contract's shape."""

import json
import re

import pytest

from benchmark import harness, loads, program
from benchmark.meshes import mesh_module
from benchmark.reference import check

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    files = harness.read_cell(cell)
    cfg = files["config"]
    mod = mesh_module(cfg["mesh"]["kind"])
    inp = mod.inputs(dict(cfg["mesh"], n=2))
    assert inp["cells"].max() < len(inp["nodes"])
    for law in [cfg["law"]] if "law" in cfg else cfg["laws"]:
        assert check.law_module(law["name"]).HISTORY
    if "laws" in cfg:  # the cells rules split the mesh at the size the cell runs
        assert len(harness.law_cells(cfg, mod.inputs(cfg["mesh"]))) == len(cfg["laws"])
    assert cfg["boundary"] in check.BOUNDARIES and cfg["boundary"] in program.BOUNDARIES
    path = loads.load_path(files["mix"], 2**31 + 12345)
    assert len(path["cycle"]) == len(files["mix"]["cycle"])
    for m in files["end_to_end"] + files["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
    assert {m["name"] for m in files["end_to_end"]} >= {"setup_s"}
    assert files["per_layer"]
    assert set(cfg["limits"]) == {"bc_gap", "newton_residual", "state_gap"}


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + CELLS + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and set(c["reduced"]) == set(
            json.loads((harness.ROOT / c["file"]).read_text())["reduced"])


def test_seed_sets_the_loads():
    mix = loads.read_mix("plastic")
    a, b = loads.load_path(mix, 3 * 2**31), loads.load_path(mix, 3 * 2**31)
    c = loads.load_path(mix, 7)
    assert a == b and a["cycle"] != c["cycle"] and a["warm_up"] == c["warm_up"]
    for x, y in zip(a["cycle"], mix["cycle"]):
        assert abs(x / (mix["stretch"] * y) - 1.0) <= mix["jitter"]
