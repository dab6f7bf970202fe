"""Configurations of several laws on cell subsets, run on the CPU at a 4^3
mesh through ``harness.run``, with their cells supplied here (none is in
BENCHMARK.json): each law's cells are picked by midpoint, the program and
the reference get the same ones, the reference follows each law on its own
points with the configuration's time step, and a program that puts a law on
the wrong cells, or skips half of one law's points, is not correct. Also the
rules' refusals, and whole cycles of a slow step."""

import functools
import time

import numpy as np
import pytest

from benchmark import harness, loads, program
from benchmark.meshes import mesh_module
from benchmark.reference import check
from benchmark.tests.test_bench_run import half_left_out

N = 4
SECONDS = 0.5
BASE = "mises-tet35-gmsh-f64.plastic"
TET = harness.read_cell(BASE)
MISES = TET["config"]["law"]
HARD = dict(MISES, params=dict(MISES["params"], p_y0=1800.0))
#: phase 14's viscoelastic layer over a frictional base (chip_smoke.py)
DP = {"name": "DruckerPrager3D",
      "params": {"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15, "b_flow": 0.15}}
MAXWELL = {"name": "SpringMaxwellModel", "constraint": "FULL",
           "params": {"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3}}


def halves(below, above, at=0.51):
    """``below`` on the cells whose midpoint has z < at, ``above`` on the rest."""
    return [dict(below, cells={"axis": 2, "below": at}),
            dict(above, cells={"axis": 2, "at_least": at})]


def config(laws, del_t=0.5):
    cfg = {k: v for k, v in TET["config"].items() if k != "law"}
    return dict(cfg, laws=laws, simulation=dict(cfg["simulation"], del_t=del_t))


def run(monkeypatch, cfg, mix="plastic", seed=2**31 + 21, **kw):
    """One CPU run of ``cfg`` under ``mix``, as the cell ``laws.<mix>``."""
    name = f"laws.{mix}"
    files = dict(TET, cell=dict(TET["cell"], name=name, traffic=mix), config=cfg,
                 mix=loads.read_mix(mix))
    monkeypatch.setattr(harness, "read_cell", lambda workload: files)
    return harness.run(name, seed, SECONDS, False, device="cpu", n=N, min_steps=8, **kw)


def test_law_cells_split_the_mesh_by_midpoint():
    inp = mesh_module("kuhn_tet_gmsh").inputs({"n": N, "shuffle_seed": 0})
    (low, below), (high, above) = harness.law_cells(config(halves(MISES, HARD)), inp)
    assert (low["name"], high["params"]["p_y0"]) == ("VonMises3D", 1800.0)
    z = inp["nodes"][inp["cells"]].mean(axis=1)[:, 2]
    assert (z[below] < 0.51).all() and (z[above] >= 0.51).all()
    assert np.array_equal(np.sort(np.concatenate([below, above])), np.arange(len(z)))
    assert harness.law_cells(TET["config"], inp) == [(MISES, None)]


def test_two_laws_agree_with_the_reference(monkeypatch):
    seen = {}
    init, judge = program.Program.__init__, check.judge

    def keep_program(self, cfg, mesh_module, inputs, laws, *a):
        seen["program"] = laws
        init(self, cfg, mesh_module, inputs, laws, *a)

    def keep_judge(mesh, laws, *a, **kw):
        seen["judge"], seen["dt"] = laws, kw["dt"]
        return judge(mesh, laws, *a, **kw)

    monkeypatch.setattr(program.Program, "__init__", keep_program)
    monkeypatch.setattr(check, "judge", keep_judge)
    line = run(monkeypatch, config(halves(MISES, HARD)))
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 8
    assert seen["program"] is seen["judge"] and seen["dt"] == 0.5


def test_two_laws_control_fails(monkeypatch):
    line = run(monkeypatch, config(halves(MISES, HARD)), control=True)
    assert not line["correct"], line["compared"]


def test_subsets_swapped_in_the_program_are_not_correct(monkeypatch):
    init = program.Program.__init__

    def swapped(self, cfg, mesh_module, inputs, laws, *a):
        (first, cells0), (second, cells1) = laws
        init(self, cfg, mesh_module, inputs, [(first, cells1), (second, cells0)], *a)

    monkeypatch.setattr(program.Program, "__init__", swapped)
    line = run(monkeypatch, config(halves(MISES, HARD)))
    assert not line["correct"], line["compared"]


def test_one_law_skipping_half_its_points_is_not_correct(monkeypatch):
    line = run(monkeypatch, config(halves(MISES, HARD)),
               fault=functools.partial(half_left_out, law=1))
    assert not line["correct"], line["compared"]


def test_the_time_step_reaches_the_reference(monkeypatch):
    """Maxwell's history depends on the time step: judged with another one
    than the program took, the same run is not correct."""
    judge = check.judge
    monkeypatch.setattr(check, "judge", lambda *a, **kw: judge(*a, **dict(kw, dt=1.0)))
    line = run(monkeypatch, config(halves(MISES, MAXWELL)))
    assert not line["correct"], line["compared"]


def test_drucker_prager_below_maxwell_above_agrees_with_the_reference(monkeypatch):
    line = run(monkeypatch, config(halves(DP, MAXWELL)))
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 8


@pytest.mark.parametrize("rule, message", [
    ([{"axis": 2, "below": 0.6}, {"axis": 2, "at_least": 0.4}], "taken by two laws"),
    ([{"axis": 2, "below": 0.4}, {"axis": 2, "at_least": 0.6}], "taken by no law"),
    ([{"axis": 2, "below": 0.375}, {"axis": 2, "at_least": 0.375}], "lies on"),
], ids=["overlap", "left_out", "through_a_midpoint"])
def test_a_rule_that_does_not_split_the_mesh_is_refused(monkeypatch, rule, message):
    laws = [dict(MISES, cells=rule[0]), dict(HARD, cells=rule[1])]
    with pytest.raises(harness.RunError, match=message):
        run(monkeypatch, config(laws))


def test_a_slow_step_still_runs_a_whole_cycle(monkeypatch):
    def slowed(prog):
        solve = prog.solve

        def slow(load):
            time.sleep(0.2)
            return solve(load)

        prog.solve = slow

    line = run(monkeypatch, TET["config"], mix="elastic", fault=slowed)
    assert line["correct"], line["compared"]
    assert line["attempted"] >= 8
