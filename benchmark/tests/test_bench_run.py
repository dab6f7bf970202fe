"""Runs of every cell on the CPU at a 4^3 mesh (the kernels' plain
versions): the reference agrees with the port, the control and every fault
the cells can have come out not correct, and the command's last line has
the contract's keys."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_files import CELLS

N = 4
SECONDS = 0.5
CONFIGS = sorted({c.rsplit(".", 1)[0] + ".plastic" for c in CELLS})


def cpu_run(cell, seed=2**31 + 7, **kw):
    """A run whose window holds a whole cycle of the mix's 8 steps, however
    long a step takes on this host."""
    return harness.run(cell, seed, SECONDS, False, device="cpu", n=N, min_steps=8, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    line = cpu_run(cell)
    assert line["correct"], line["compared"]
    assert line["failed"] == 0 and line["attempted"] >= 8


@pytest.mark.parametrize("cell", CONFIGS)
def test_the_control_fails(cell):
    line = cpu_run(cell, control=True)
    assert not line["correct"], line["compared"]


def unchanged_state(prog):
    """The step returns the state it was given (with its real stats)."""
    step = prog.sim._step

    def stale(models, state, *args):
        return state, step(models, state, *args)[1]

    prog.sim._step = stale


def half_left_out(prog, law=0):
    """Half the points of a law (the first) keep their old stress and
    history: the eval skips them."""
    law = prog.sim._models[law]
    evaluate = law.evaluate_packed

    def half(t, dt, eps, stress, history):
        s, tg, h = evaluate(t, dt, eps, stress, history)
        s = s.clone()
        s[..., ::2] = stress[..., ::2]
        h = {k: v.clone() for k, v in h.items()}
        for k in h:
            h[k][..., ::2] = history[k][..., ::2]
        return s, tg, h

    law.evaluate_packed = half


def stress_altered(prog):
    """One stress component of one point is moved by 1e-6 of the largest."""
    step = prog.sim._step

    def altered(models, state, *args):
        new, stats = step(models, state, *args)
        s = new.stress[0].clone()
        flat = s.reshape(-1)
        flat[7] += 1e-6 * float(s.abs().max())
        return dataclasses.replace(new, stress=(s,)), stats

    prog.sim._step = altered


@pytest.mark.parametrize("cell", CONFIGS)
@pytest.mark.parametrize("fault", [unchanged_state, half_left_out, stress_altered],
                         ids=lambda f: f.__name__)
def test_a_broken_step_is_not_correct(cell, fault):
    line = cpu_run(cell, fault=fault)
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("cell", CONFIGS)
def test_judge_gets_a_dof_map_only_above_degree_1(cell, monkeypatch):
    from benchmark.reference import check

    seen = []
    judge = check.judge
    monkeypatch.setattr(check, "judge", lambda *a, dof_coords, **kw: seen.append(dof_coords)
                        or judge(*a, dof_coords=dof_coords, **kw))
    assert cpu_run(cell)["correct"]
    degree = harness.read_cell(cell)["config"].get("degree", 1)
    if degree == 1:
        assert seen == [None]
    else:
        assert seen[0].shape == ((degree * N + 1) ** 3, 3)


def test_the_last_line():
    cmd = [sys.executable, str(harness.HERE / "run.py"), "--workload", CELLS[0], "--seed",
           str(2**31 + 99), "--seconds", str(SECONDS), "--trace", "0", "--device", "cpu",
           "--cells-per-edge", str(N)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"step_ms", "step_ms_p95", "peak_gib", "setup_s"}
    assert out.stderr.strip().splitlines()[-1].startswith("compared ")


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, str(harness.HERE / "run.py"), "--workload", CELLS[0], "--seed", "1",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=harness.ROOT)
    assert out.returncode != 0 and not out.stdout.strip()
