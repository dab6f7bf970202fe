"""The one load-path generator: it reads a traffic mix's parameters from
``benchmark/traffic/<mix>.json`` and the run's seed.

A mix is closed-loop: each ``solve()`` follows the return of the one before.
Its keys: ``stretch`` (the load unit), ``warm_up`` (loads, in units of the
stretch, that bring the state to the cycle's start during set-up),
``cycle`` (the K loads of one cycle, in units of the stretch) and
``jitter`` (the seed moves each cycle load by up to this share of itself).
The window repeats the cycle, and each cycle starts from the same state, so
every cycle does the same work. The seed never changes the mesh, the law or
the number and order of the loads.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def read_mix(name: str) -> dict:
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of the seed (any whole number) for one use of it."""
    return np.random.default_rng([seed % 2**64, stream])


def load_path(mix: dict, seed: int) -> dict:
    """``warm_up`` and ``cycle`` loads as floats (absolute values)."""
    s = float(mix["stretch"])
    cycle = np.asarray(mix["cycle"], np.float64)
    jitter = 1.0 + float(mix["jitter"]) * rng(seed, 0).uniform(-1.0, 1.0, cycle.size)
    return {"warm_up": [s * float(v) for v in mix["warm_up"]],
            "cycle": [float(v) for v in s * cycle * jitter]}
