"""Every cell at its full size on the card: a short run is correct, and its
control (the program in float32) is not. Marked ``card``; on the card run
``python -m pytest benchmark/tests -m card -q`` from the repository root."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.test_bench_files import CELLS

SECONDS = "3"


def card_run(cell, seed, *extra):
    cmd = [sys.executable, str(harness.HERE / "run.py"), "--workload", cell, "--seed", str(seed),
           "--seconds", SECONDS, "--trace", "0", *extra]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_full_size_run_is_correct(card, cell):
    line = card_run(cell, 2**31 + 4242)
    assert line["correct"] and line["failed"] == 0, line["compared"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_full_size_control_is_not_correct(card, cell):
    line = card_run(cell, 2**31 + 4243, "--control")
    assert not line["correct"], line["compared"]
