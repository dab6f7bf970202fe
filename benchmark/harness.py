"""One run of one cell: set-up, the measured window, the traced stretch
(``--trace 1``), the comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric sits in
files of its own, found by the names in ``BENCHMARK.json``:
``benchmark/configs/<config>.json`` (with its mesh module
``benchmark/meshes/<kind>.py`` and each law's reference
``benchmark/reference/<law>.py``), ``benchmark/traffic/<mix>.json`` and
``benchmark/metrics/<metric>.py``. A configuration's ``degree`` (1 where
it gives none) is its displacement space's. Its ``law`` runs on every cell;
where it gives ``laws`` instead, each runs on the cells its ``cells`` rule
picks (``law_cells``), with a ``constraint`` where the law takes one. Its
``simulation`` options reach ``PackedSimulation`` as they are, and their
``del_t`` (1.0 where they give none) is the reference's time step too.
Nothing here names a cell.

Order of a run: the mesh inputs are made and any mesh file written; the
set-up clock starts; torch and the port are imported, the simulation is
built, the warm-up loads and one whole cycle run (every capture and kernel
build happens here); the window runs cycles of ``solve()`` calls from the
cycle's start state until ``--seconds`` have passed (and, where a caller
asks for them, at least ``min_steps`` steps are done); the memory peak is
read; with ``--trace 1`` one more cycle runs under torch.profiler; the
program is freed and the reference judges the answers of one cycle drawn
from the seed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import loads
from .meshes import mesh_module

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: top-level module names that may not be loaded in a run (whole names)
FORBIDDEN = ("jax", "jaxlib", "flax", "fenics_constitutive_tpu")
TRACE_TRIES = 3
WINDOW_MARK = "benchmark.window"
#: how close a cell's midpoint may lie to a threshold of a law's ``cells`` rule
ON_THRESHOLD = 1e-9


class RunError(Exception):
    """A run that cannot give a result: it exits non-zero and prints none."""


def note(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the cell's files ------------------------------------------------------------------


def read_cell(name: str) -> dict:
    spec_path = ROOT / "BENCHMARK.json"
    if not spec_path.is_file():
        raise RunError(f"no {spec_path.name} beside the benchmark")
    spec = json.loads(spec_path.read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())

    def ours(m):
        return "workloads" not in m or name in m["workloads"]

    return {"cell": cell, "config": cfg, "mix": loads.read_mix(cell["traffic"]),
            "end_to_end": [m for m in spec["end_to_end"] if ours(m)],
            "per_layer": [m for m in spec["per_layer"] if ours(m)]}


def reader(metric: str):
    """The module ``benchmark/metrics/<metric>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def law_cells(cfg: dict, inputs: dict) -> list:
    """[(law, cells)]: the configuration's ``law`` on every cell (cells
    None), or each of its ``laws`` on the mesh cells (ascending int64 ids)
    whose midpoint, the mean of the cell's nodes, has its coordinate
    ``axis`` ``at_least`` and/or ``below`` the rule's thresholds. Raises
    ``RunError`` where a midpoint lies within ON_THRESHOLD of a threshold
    (rounding would decide its side), where two laws take one cell, where
    a cell is taken by no law, and where a law takes no cell."""
    if "law" in cfg:
        return [(cfg["law"], None)]
    mid = inputs["nodes"][inputs["cells"]].mean(axis=1)
    taken = np.zeros(len(mid), np.int64)
    out = []
    for law in cfg["laws"]:
        rule = law["cells"]
        x = mid[:, rule["axis"]]
        picked = np.ones(len(mid), bool)
        bounds = [(k, float(rule[k])) for k in ("at_least", "below") if k in rule]
        if not bounds:
            raise RunError(f"the cells rule of {law['name']} gives neither at_least nor below")
        for key, t in bounds:
            near = np.abs(x - t) <= ON_THRESHOLD
            if near.any():
                raise RunError(f"cell {int(np.argmax(near))}'s midpoint lies on {law['name']}'s "
                               f"threshold {key} {t:g} along axis {rule['axis']}")
            picked &= x >= t if key == "at_least" else x < t
        cells = np.flatnonzero(picked)
        if not len(cells):
            raise RunError(f"the cells rule of {law['name']} picks no cell")
        taken[cells] += 1
        out.append((law, cells))
    if (taken > 1).any():
        raise RunError(f"cell {int(np.argmax(taken > 1))} is taken by two laws")
    if (taken == 0).any():
        raise RunError(f"cell {int(np.argmax(taken == 0))} is taken by no law")
    return out


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- the run ---------------------------------------------------------------------------


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        n: int | None = None, control: bool = False, fault=None, min_steps: int = 0) -> dict:
    """One run; returns the result line. ``n`` (cells per edge) overrides
    the configuration's mesh (the tests); ``control`` runs the program in
    the configuration's ``control`` precision and options instead of its
    own; ``fault(program)`` breaks the program after its set-up (the tests);
    the window ends at the first step past ``seconds`` once ``min_steps``
    steps are done (the tests: whole cycles of slow CPU steps)."""
    files = read_cell(workload)
    cfg, mix = files["config"], files["mix"]
    if control:
        low = cfg["control"]
        cfg = dict(cfg, dtype=low["dtype"], simulation={**cfg["simulation"], **low["simulation"]})
        files = dict(files, config=cfg)
    mesh_spec = dict(cfg["mesh"], **({"n": n} if n else {}))
    mesh_mod = mesh_module(mesh_spec["kind"])
    inputs = mesh_mod.inputs(mesh_spec)
    laws = law_cells(cfg, inputs)
    path = loads.load_path(mix, seed)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_mod.prepare(inputs, mesh_spec, tmp)
        return _run(files, mesh_spec, mesh_mod, inputs, laws, path, seed, seconds, trace, device,
                    cfg["dtype"], fault, min_steps, Path(tmp))


def _run(files, mesh_spec, mesh_mod, inputs, laws, path, seed, seconds, trace, device_name,
         dtype_name, fault, min_steps, tmp: Path) -> dict:
    t_setup = time.perf_counter()
    import torch

    from . import program

    cell, cfg = files["cell"], files["config"]
    device = torch.device(device_name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is false: the benchmark runs on the card")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"the cell needs {cell['chips']} cards, the machine has "
                           f"{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    prog = program.Program(dict(cfg, mesh=mesh_spec), mesh_mod, inputs, laws, tmp, device, dtype)
    if fault is not None:
        fault(prog)
    warm = []
    for load in path["warm_up"]:
        prog.solve(load)
        warm.append((load, prog.state.u))
    start = prog.state
    for load in path["cycle"]:  # every capture and build before the window
        prog.solve(load)
    prog.state = start
    sync()
    setup_s = time.perf_counter() - t_setup

    # -- the window: whole cycles from the start state, closed loop
    records, kept, kept_state = [], [], None
    draw = loads.rng(seed, 1)
    cycles = 0
    t_first = time.perf_counter()
    deadline = t_first + seconds
    done = False
    while not done:
        keep = draw.random() * (cycles + 1) < 1.0  # a uniform draw of one cycle
        if keep:
            kept, kept_state = [], None
        for load in path["cycle"]:
            t0 = time.perf_counter()
            niter, ok = prog.solve(load)
            t1 = time.perf_counter()
            records.append({"s": t1 - t0, "newton": niter, "ok": ok,
                            "cg_last": prog.last_stats["cg_iters_last"]})
            if keep:
                kept.append((load, prog.state.u))
                kept_state = prog.state
            if t1 >= deadline and len(records) >= min_steps:
                done = True
                break
        else:
            prog.state = start
            cycles += 1
    t_last = t1
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    ctx = {"records": records, "window_s": t_last - t_first, "setup_s": setup_s,
           "peak_bytes": peak, "trace": None, "kernel_trace": None, "launches": {},
           "program": prog,
           "itemsize": torch.empty((), dtype=dtype).element_size(), "device": device,
           "note": note}
    metrics_spec = files["per_layer"] if trace else files["end_to_end"]
    readers = {m["name"]: reader(m["name"]) for m in metrics_spec}
    if trace:
        prog.state = start
        _trace(ctx, prog, path["cycle"], readers, tmp, sync)

    metrics = {}
    for m in metrics_spec:
        value = readers[m["name"]].read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": False, "attempted": len(records),
            "failed": sum(not r["ok"] for r in records), "metrics": metrics,
            "device": device_info}
    tr = ctx["trace"]
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": ctx["kernel_trace"].top_device_ops(),
                             "idle_gaps": tr.idle_gaps()}

    # -- the answers of the drawn cycle, then the program is freed
    steps = [(load, prog.public_u(u).cpu()) for load, u in warm + kept]
    last = prog.fields(kept_state)
    dof_coords = prog.dof_coords if cfg.get("degree", 1) > 1 else None
    del prog, start, kept_state, kept, warm, ctx, readers
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    from .reference.check import judge

    numbers = judge(inputs, laws, cfg["boundary"], steps, last, device,
                    dt=cfg["simulation"].get("del_t", 1.0), dof_coords=dof_coords)
    limits = cfg["limits"]
    line["correct"] = all(numbers[k] <= limits[k] for k in limits)
    line["compared"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return line


def _profiled_cycle(prog, start, cycle, tmp: Path, sync, eager: bool):
    """(Trace, the port's launch counters' growth) of one cycle from the
    start state under torch.profiler: replayed, or inside the program's
    ``disable_capture()`` (every step eager, as the replay computes it)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile, record_function

    from . import costs, program

    prog.state = start
    sync()
    before = program.launch_counts()
    with prog.eager() if eager else contextlib.nullcontext():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_MARK):
                for load in cycle:
                    prog.solve(load)
                sync()
    after = program.launch_counts()
    out = tmp / "trace.json"
    prof.export_chrome_trace(str(out))
    tr = costs.Trace(out, WINDOW_MARK)
    out.unlink()
    return tr, {k: after[k] - before[k] for k in after}


def _trace(ctx, prog, cycle, readers, tmp: Path, sync) -> None:
    """Two traced cycles from the start state. The replayed one (what the
    window runs) gives the device's busy time and idle share and the
    top-level copies: CUPTI records no event from inside the graph's while
    nodes, so the kernels there are timed in the second, eager one
    (``disable_capture()``), whose events carry their kernels' names. The
    eager trace is taken again (up to TRACE_TRIES in all) while a kernel
    reader finds fewer or more events of its kernels than the port's
    counters saw launches (CUPTI now and then delivers a short trace).
    Fills ``ctx["trace"]`` (replayed), ``ctx["kernel_trace"]`` (eager),
    ``ctx["launches"]`` (the counters' growth over the eager cycle) and
    ``ctx["trace_steps"]``."""
    start = prog.state
    ctx["trace"], _ = _profiled_cycle(prog, start, cycle, tmp, sync, eager=False)
    ctx["trace_steps"] = len(cycle)
    for attempt in range(TRACE_TRIES):
        time.sleep(0.2 * attempt * attempt)
        tr, launches = _profiled_cycle(prog, start, cycle, tmp, sync, eager=True)
        ctx.update(kernel_trace=tr, launches=launches)
        short = [name for name, mod in readers.items() if hasattr(mod, "KERNELS")
                 and len(tr.kernels(mod.KERNELS)) != launches[mod.COUNTER]]
        if not short:
            return
        note(f"eager trace {attempt + 1}: kernel events and launches differ for {short}; "
             f"{'taking it again' if attempt + 1 < TRACE_TRIES else 'kept as it is'}")

