"""What every bench twin shares: the box bench state, the device and its
precision, the launch counters and the timing protocol (the twin of the JAX
package's ``scripts/bench_common.py``). The twins import the protocol from
here, so that it can drift in one place only.

Self-check (``rerun``, ``verdict``): the last timed window's settled
residual must lie within 1.02x of a deep re-run of the whole run, warm-up
included, at a higher fixed CG count.

Timing protocol (``time_windows``): after the warm-up loads, whole windows
run untimed in the same process until two in a row agree within 10% (a
fresh process pays one-time CUDA set-up in its first steps, and its first
windows run slower); then ``WINDOWS`` windows are timed, each the K-step
schedule at distinct load scales (``scales(j, K)``: ``2.0 + 1e-4 j + 0.05
i``), by CUDA events on the card and by the host clock beside them. A twin
reports the median ms/step, every window and the spread (max - min) /
median; never the minimum. On the CPU (``--device cpu``, for the tests) the
windows are read by the host clock and the line says so (``clock``).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}
MU, KAPPA = MAT["p_mu"], MAT["p_ka"]
#: a timed run's settled Newton residual must lie within this factor of the
#: deep re-run of the same schedule (and the deep run within it of the 2x-deep)
R_NORM_ENVELOPE = 1.02
#: the warm-up load scales of bench.py, driven past yield
WARM_LOADS = (0.5, 1.0, 1.5)
#: timed windows after the untimed ones
WINDOWS = 5
#: untimed windows: until two in a row agree within WARM_AGREE (host clock),
#: at least 2 and at most WARM_MAX (on the H100 a fresh process's first
#: 48-step box window took 1.86x the median of the timed ones after one)
WARM_MAX = 6
WARM_AGREE = 0.10
#: the entries of the fused V-cycle (K3), as the kernels JSON line names them
K3_ENTRIES = {"pre_restrict": "fused_smoother_pre_restrict",
              "tail": "fused_smoother_tail",
              "prolong_post": "fused_smoother_prolong_post"}


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


# -- the device -------------------------------------------------------------------


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where to run: the card (default) or 'cpu', where the kernels' "
                         "plain versions run (the tests)")
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))


def resolve_device(args) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) of the parsed arguments. No fallback: without a card
    the default fails. Precision is explicit: no TF32 anywhere."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false); pass --device cpu to run "
             "on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device, getattr(torch, args.dtype)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them. A
    nvidia-smi that fails is an error."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    if not out:
        fail("nvidia-smi printed nothing")
    return out[0]


def device_name(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def power_limit_w(smi: str) -> float | None:
    """The power limit in W of a nvidia-smi line ("..., 700.00 W"); None
    where the card reports none ("[N/A]")."""
    field = smi.rsplit(",", 1)[-1].strip()
    try:
        return float(field.removesuffix("W").strip())
    except ValueError:
        return None


def device_info(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "power_limit_w": None}
    smi = nvidia_smi()
    return {"name": device_name(device), "power_limit": smi.rsplit(",", 1)[-1].strip(),
            "power_limit_w": power_limit_w(smi)}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_gib(device) -> float | None:
    """The device memory peak since reset_peak, GiB (None off the card)."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def print_line(line: dict) -> None:
    print(json.dumps(line), flush=True)


# -- the kernels' launch counters ---------------------------------------------------


def reset_counts() -> None:
    """Zero the K1-K3 counters (and K3's per entry)."""
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec, cuda_smoother

    cuda_matvec.launches = cuda_eval.launches = cuda_smoother.launches = 0
    cuda_smoother.brick_launches = 0
    for key in cuda_smoother.entry_launches:
        cuda_smoother.entry_launches[key] = 0


def read_counts() -> dict:
    """K1-K3 launches since reset_counts(), and K3's per V-cycle entry."""
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec, cuda_smoother

    return {"K1": cuda_matvec.launches, "K2": cuda_eval.launches, "K3": cuda_smoother.launches,
            **{f"K3_{kind}": cuda_smoother.entry_launches[kind] for kind in K3_ENTRIES}}


def window_counts() -> dict:
    """K4-K7 launches, and K8's (the lattice operator)."""
    from fenics_constitutive_tpu_torch.ops import cuda_lattice, cuda_window

    return {"K4": cuda_window.launches["gather"], "K5": cuda_window.launches["scatter"],
            "K6": cuda_window.launches["bsr_matvec"], "K7": cuda_window.launches["cell_apply"],
            "K8": cuda_lattice.launches["lattice_apply"]}


def reset_all_counts() -> None:
    from fenics_constitutive_tpu_torch.ops import cuda_lattice, cuda_window

    reset_counts()
    for counter in (cuda_window.launches, cuda_lattice.launches):
        for key in counter:
            counter[key] = 0


def launches() -> dict:
    """K1-K8 launches (K3 also per V-cycle entry) since reset_all_counts(),
    by each wrapper's counter: the launches that ran, none of a replay."""
    return {**read_counts(), **window_counts()}


def require_launched(counts: dict, kernels, label: str) -> None:
    """Fail unless each of ``kernels`` launched in the counted run (on the card)."""
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        fail(f"{label}: the counted run never launched {', '.join(missing)} ({counts})")


# -- timing -------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def scales(j: int, K: int, first: int = 0) -> list:
    """Window j's load scales: bench.py's ramp of +0.05 a step past yield from
    2.0 (steps ``first .. first + K - 1``), offset by 1e-4 j, so that every
    window does the same work on distinct inputs."""
    return [2.0 + 1e-4 * j + 0.05 * (i + first) for i in range(K)]


def all_ranks(flag: bool, device) -> bool:
    """``flag`` held on every rank of the process group, where one is
    initialised (a sharded twin: each rank reads its own clock, and ranks
    that run different windows pair their all-reduces wrongly); else
    ``flag``."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return flag
    t = torch.tensor(int(flag), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def time_windows(run, steps: int, device, windows: int = WINDOWS) -> dict:
    """The timing protocol. ``run(j)`` runs window j (``steps`` steps) and
    returns what the caller wants of its last window. Window 0 runs untimed
    until two runs of it in a row agree (``warm_windows`` of them; on every
    rank, when sharded). A replay
    adds no launch count, so after the timed windows window 0 runs once more
    inside ``disable_capture()``, untimed, and ``launches`` holds that eager
    window's launches. Returns ``windows_ms`` and ``host_windows_ms`` (ms a
    step, per window), ``value`` (their median), ``spread`` ((max - min) /
    median), ``host_ms`` (the host clock's median), ``clock``, ``launches``,
    ``warm_windows`` and ``out`` (the last timed window's result)."""
    from fenics_constitutive_tpu_torch.solver import disable_capture

    cuda = torch.device(device).type == "cuda"
    warm = []
    while len(warm) < WARM_MAX:
        h0 = time.perf_counter()
        run(0)
        sync(device)
        warm.append(time.perf_counter() - h0)
        if all_ranks(len(warm) >= 2 and abs(warm[-1] - warm[-2]) <= WARM_AGREE * warm[-2],
                     device):
            break
    ms, host, out = [], [], None
    for j in range(1, windows + 1):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        if cuda:
            e0.record()
        out = run(j)
        if cuda:
            e1.record()
            e1.synchronize()
        host.append((time.perf_counter() - h0) * 1e3 / steps)
        ms.append(e0.elapsed_time(e1) / steps if cuda else host[-1])
    reset_all_counts()
    with disable_capture():
        run(0)
    counts = launches()
    median = statistics.median(ms)
    return {"windows_ms": ms, "host_windows_ms": host, "value": median,
            "spread": (max(ms) - min(ms)) / median if median > 0 else math.nan,
            "host_ms": statistics.median(host), "clock": "cuda events" if cuda else "host",
            "launches": counts, "warm_windows": len(warm), "out": out}


def timing_fields(timing: dict) -> dict:
    """The JSON fields of a time_windows result."""
    return {k: timing[k] for k in ("value", "windows_ms", "spread", "host_ms",
                                   "host_windows_ms", "clock", "launches", "warm_windows")}


def debug_windows(timing: dict) -> None:
    """BENCH_DEBUG: every window on stderr."""
    print(f"windows ms/step: {timing['windows_ms']} (host clock {timing['host_windows_ms']})",
          file=sys.stderr)


# -- meshes and the box bench state -------------------------------------------------


def bench_bcs(V):
    """The bench's Dirichlet set: x=0 fixed in x, x=1 pulled by 0.004 in x,
    y=0 and z=0 fixed in y and z."""
    from fenics_constitutive_tpu_torch.fem import DirichletBC

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    return [
        DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.004),
        DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0),
    ]


def box(n: int, cell_type: str = "hex"):
    """The n^3 unit box (P1, vector) with the bench's BCs: (V, bcs)."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh

    V = FunctionSpace(unit_cube_mesh(n, n, n, cell_type), 1, 3)
    return V, bench_bcs(V)


def imported_mesh(n: int):
    """A Kuhn tet box with its node numbering shuffled (seed 0) and no
    structured metadata: it arrives like an imported mesh."""
    from fenics_constitutive_tpu_torch.fem import Mesh, unit_cube_mesh

    mesh = unit_cube_mesh(n, n, n, "tetra")
    pi = np.random.default_rng(0).permutation(mesh.num_nodes)
    nodes = np.empty_like(mesh.nodes)
    nodes[pi] = mesh.nodes
    return Mesh(nodes, pi[mesh.cells].astype(np.int32), "tetra")


def free_mask(V, bcs) -> np.ndarray:
    from fenics_constitutive_tpu_torch.fem import combine_bcs

    free = np.ones(V.ndofs, bool)
    free[combine_bcs(bcs)[0]] = False
    return free


def step_args(bcs, ndofs: int, dtype, device) -> tuple:
    """(bc_dofs, bc_vals, f_ext, dt) of a step, the dofs on the host as
    ``PackedSimulation`` passes them; ``ndofs``: the length of the step's
    f_ext (the internal layout's on the windowed engine)."""
    from fenics_constitutive_tpu_torch.fem import combine_bcs

    bc_dofs, bc_vals = combine_bcs(bcs)
    return (bc_dofs, torch.as_tensor(bc_vals, dtype=dtype, device=device),
            torch.zeros(ndofs, dtype=dtype, device=device), 1.0)


def bench_setup(n: int, dtype, device, fused: bool = False, nu: int = 3, nu_coarse: int = 2):
    """bench.py's problem: the n^3 hex box (VonMises3D, q 2) and its V(nu, nu)
    multigrid with ``nu_coarse`` sweeps on the coarse levels and a direct
    coarsest solve (with the K3 chains when ``fused``).
    Returns (geos, models, state, mg, args)."""
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_multigrid, build_packed_problem

    V, bcs = box(n)
    geos, models, state = build_packed_problem(V, VonMises3D(MAT), 2, device=device,
                                               dtype=dtype)
    mg = build_multigrid(
        geos[0], MU, KAPPA, torch.as_tensor(free_mask(V, bcs)), device=device, dtype=dtype,
        nu=nu, nu_coarse=nu_coarse, coarse_direct=True, fused_smoothing=fused,
    )
    return geos, models, state, mg, step_args(bcs, V.ndofs, dtype, device)


def bench_step(geos, mg, fixed_iters, impl):
    """bench.py's step: one Newton iteration, fixed-count CG with ``mg``,
    compiled (``solver/compiled.py``: one CUDA graph a step on the card, as
    bench.py's step is one jitted program; eager on the CPU)."""
    return compiled_step(
        geos, max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5,
        cg_maxiter=400, preconditioner=mg, cg_fixed_iters=fixed_iters,
        matvec_impl=impl, eval_impl=impl,
    )


def compiled_step(geos, **options):
    """``make_packed_step(geos, **options)`` through ``compile_step``: captured
    on the card where the step reads nothing back to the host."""
    from fenics_constitutive_tpu_torch.solver import compile_step, make_packed_step

    return compile_step(make_packed_step(geos, **options))


def run_schedule(step, models, state, args, loads):
    """One step per load scale: (state, r_norm of each step)."""
    bc_dofs, bc_vals, f_ext, dt = args
    probes = []
    for sc in loads:
        state, stats = step(models, state, bc_dofs, bc_vals * sc, f_ext, dt)
        probes.append(stats["r_norm"])
    return state, torch.stack(probes)


def warm_up(step, models, state, args, loads=WARM_LOADS):
    """The warm-up loads from ``state``: the state driven past yield."""
    for k in loads:
        state, _ = step(models, state, args[0], args[1] * k, *args[2:])
    return state


def rerun(step, models, state0, args, loads, warm_loads=WARM_LOADS) -> float:
    """The settled r_norm of the whole run with ``step``: the warm-up loads
    from the initial state ``state0``, then ``loads``. The self-check's
    reference re-runs the warm-up too: from the warm state of an
    under-converged count a deep re-run need not settle lower (on the H100,
    fixed-4 settles at 1.66 and fixed-40 from its warm state at 3.99, so
    bench.py's check, which reuses the timed run's warm state, would pass
    it)."""
    warm = warm_up(step, models, state0, args, warm_loads)
    return float(run_schedule(step, models, warm, args, loads)[1][-1])


def bench_schedule(make_step, fixed: int, deep, models, state, args, K: int, device,
                   first: int = 0, warm_loads=WARM_LOADS) -> dict:
    """The protocol every box and mesh bench runs: the warm-up loads with
    ``make_step(fixed)``, ``time_windows`` over K-step windows at
    ``scales(j, K, first)``, and the self-check: ``rerun`` of the whole run
    at each fixed count in ``deep`` (none, the deep one, or the deep and the
    2x-deep one). Returns the timing fields, ``r_norm``, ``r_norm_ref``,
    ``r_norm_ref2``, ``converged``, ``captured`` (the timed step replays a
    CUDA graph), ``probes`` (the last timed window's residual per step),
    ``warmup_s``, ``warm`` (the state after the warm-up) and ``final`` (the
    state after the last timed window)."""
    step = make_step(fixed)
    captured = bool(getattr(step, "captured", False))
    t0 = time.perf_counter()
    warm = warm_up(step, models, state, args, warm_loads)
    sync(device)
    warmup_s = time.perf_counter() - t0
    timing = time_windows(
        lambda j: run_schedule(step, models, warm, args, scales(j, K, first)), K, device)
    final, probes = timing["out"]
    r_norm = float(probes[-1])
    last = scales(WINDOWS, K, first)
    refs = [rerun(make_step(fk), models, state, args, last, warm_loads) for fk in deep]
    r_ref = refs[0] if refs else None
    r_ref2 = refs[1] if len(refs) > 1 else None
    return {**timing_fields(timing), "captured": captured, "r_norm": r_norm, "r_norm_ref": r_ref,
            "r_norm_ref2": r_ref2, "converged": verdict(r_norm, r_ref, r_ref2),
            "probes": probes.tolist(), "warmup_s": warmup_s, "warm": warm, "final": final}


def verdict(r_norm: float, r_ref: float | None, r_ref2: float | None = None) -> bool:
    """The self-check: the settled residual within the envelope of the deep
    re-run, and the deep re-run within it of the 2x-deep one (where made)."""
    if r_ref is None:
        return bool(np.isfinite(r_norm))
    ok = r_norm <= R_NORM_ENVELOPE * r_ref
    if r_ref2 is not None:
        ok = ok and r_ref <= R_NORM_ENVELOPE * r_ref2
    return bool(ok)
