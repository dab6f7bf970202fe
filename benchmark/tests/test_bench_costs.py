"""The frozen roofline arithmetic of ``benchmark/costs.py`` equals
``scripts/torch_bench/roofline.py``'s on a small mesh (the test may import
the script; a run may not), the AMG V-cycle's composition matches the
applies one cycle makes, and the trace reader's union of intervals."""

import json

import pytest
import torch

from benchmark import costs, harness, program
from benchmark.meshes import mesh_module
from scripts.torch_bench import roofline


def build(cell, tmp_path, n=4):
    cfg = harness.read_cell(cell)["config"]
    spec = dict(cfg["mesh"], n=n)
    mod = mesh_module(spec["kind"])
    inp = mod.inputs(spec)
    mod.prepare(inp, spec, tmp_path)
    return program.Program(dict(cfg, mesh=spec), mod, inp, harness.law_cells(cfg, inp), tmp_path,
                           torch.device("cpu"), torch.float64)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_box_costs(tmp_path, itemsize):
    prog = build("mises-hex50-f64.plastic", tmp_path)
    assert costs.k1_cost(prog.geometry, itemsize) == roofline.k1_cost(prog.geometry, itemsize)
    fc = prog.preconditioner.fused_cycle
    for first in range(fc.n_levels):
        assert costs.vcycle_costs(fc, itemsize, first) == roofline.vcycle_costs(
            fc, itemsize, first)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_lattice_vcycle_costs(tmp_path, itemsize):
    """The refined-P1 hierarchy under a degree-2 space (the lattice engine)."""
    prog = build("mises-p2-hex32-f64.plastic", tmp_path)
    assert prog.sim.engine == "lattice"
    fc = prog.preconditioner.fused_cycle
    assert fc._chain(0).geo.M == (2 * 4 + 1) ** 3
    for first in range(fc.n_levels):
        assert costs.vcycle_costs(fc, itemsize, first) == roofline.vcycle_costs(
            fc, itemsize, first)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_tet_costs(tmp_path, itemsize):
    prog = build("mises-tet35-gmsh-f64.plastic", tmp_path, n=6)
    ex = prog.geometry.ex
    assert costs.window_costs(ex, itemsize) == roofline.window_costs(ex, itemsize)
    amg = prog.preconditioner
    ops = [*amg.A_win, *amg.R_win, *amg.P_win]
    assert ops
    for w in ops:
        assert costs.k6_cost(w) == roofline.k6_cost(w)


def test_amg_vcycle_composition(tmp_path, monkeypatch):
    prog = build("mises-tet35-gmsh-f64.plastic", tmp_path, n=6)
    amg = prog.preconditioner
    assert amg.n_levels >= 2
    calls = []
    cls = type(amg.A_win[0])
    matvec = cls.matvec
    monkeypatch.setattr(cls, "matvec", lambda self, x: (calls.append(self), matvec(self, x))[1])
    b = torch.ones(amg.vs * amg.NP0, dtype=torch.float64)
    amg._cycle(0, b)
    launches, nbytes, flops = costs.amg_vcycle_k6(amg)
    assert launches == len(calls)
    assert nbytes == sum(costs.k6_cost(w)[0] for w in calls)
    assert flops == sum(costs.k6_cost(w)[1] for w in calls)


def test_trace_union_and_gaps(tmp_path):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "w", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel",
           "name": "void (anonymous namespace)::matvec_kernel<double>(int)", "ts": 10,
           "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "other", "ts": 20, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 70, "dur": 10},
          {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 40, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 150, "dur": 10}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    tr = costs.Trace(path, "w")
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)  # [10, 40] and [70, 80]
    assert len(tr.kernels(("matvec_kernel",))) == 1
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
