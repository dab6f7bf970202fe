"""The headline benchmark on the PyTorch/CUDA port: the 1M-quadrature-point
von Mises Newton step of ``bench.py``, on the card.

    python bench_torch.py [--sharded N [--real]] [--device cpu] [--dtype float64]

The workload is bench.py's: a 50^3 hex box with 2x2x2 Gauss points
(1,000,000 QPs), VonMises3D with exponential hardening pulled past yield, one
Newton iteration a load step (max_newton=1), CG with a fixed count of 9
iterations preconditioned by the V(3,3) multigrid with 2 sweeps on the coarse
levels and a direct coarsest solve, K = 48 steps a window at the load scales
``2.0 + 1e-4 j + 0.05 i``. On the card it runs the port's fast path: K2 for
the eval and assembly, K1 for the CG operator, and the V-cycle's smoothing
chains as K3 (``BENCH_FUSED=0``: the eager V-cycle, as bench.py runs it).

The step is compiled (``solver/compiled.py``): on the card each step replays
one captured CUDA graph, as bench.py times one jitted program (``captured``
says so); off the card, and when sharded, it runs eagerly.

Timing (``scripts/torch_bench/common.py``): the three warm-up loads and
untimed windows in this process until two agree within 10%, then 5 timed
windows by CUDA events, with the host clock beside them; ``value`` is the
median ms/step.

The bench verifies itself, as bench.py does: the timed window's settled
Newton residual must lie within 1.02x of a deep re-run of the same loads,
the warm-up included, with fixed-40 CG (``BENCH_VERIFY_ITERS``; 0 skips the
check), and off the 50^3 box or when sharded the deep run within 1.02x of a
2x-deeper one. (bench.py re-runs from the timed run's warm state; from the
warm state of fixed-4 CG the deep run settles higher than fixed-4 does on
the H100, so that check would let fixed-4 pass.) A run
that fails prints ``converged: false`` and exits 1: ``BENCH_FIXED_ITERS=4
python bench_torch.py`` must fail.

Environment: BENCH_N (default 50; 24 with ``--sharded`` without ``--real``),
BENCH_NU (3), BENCH_NU_COARSE (2), BENCH_FIXED_ITERS (9), BENCH_STEPS (48; 4
with ``--sharded`` without ``--real``), BENCH_VERIFY_ITERS (40), BENCH_FUSED
(1), BENCH_DEBUG (every window on stderr).

``--sharded N``: the same step on N ``torch.distributed`` ranks, the QP state
split by ``parallel.shard_packed_state`` (slabs of cell layers), every dof
vector whole on every rank. Without ``--real``: N gloo ranks on the CPU (the
numbers are CPU numbers); with ``--real``: one rank per card on NCCL, which
needs N cards. K1 and K2 refuse a sharded geometry, so the ranks run the
plain eval and operator (``launches`` shows it); ``value`` is the slowest
rank's median.

One JSON line: ``metric`` (``mises_1MQP_newton_step_converged``, with
``_sharded{N}`` and ``cpu`` as bench.py names them), ``value`` (ms/step),
``unit``, ``r_norm`` (the settled residual), ``r_norm_ref`` (the deep
re-run's), ``r_norm_ref2`` (the 2x-deep one's, where made), ``converged``,
``windows_ms``, ``host_windows_ms``, ``spread``, ``host_ms``, ``clock``,
``probes`` (the timed window's residual per step), ``n_qp``, ``dtype``,
``fused``, ``captured``, ``launches`` (K1-K6 of one eager window), ``setup_s``,
``warmup_s``, ``peak_gib`` and ``device`` (name and power limit). bench.py's
``vs_baseline`` (80 ms over the v5p-8's chip count) is a TPU number and is
not printed.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from scripts.torch_bench import common  # noqa: E402

METRIC = "mises_1MQP_newton_step_converged"
N_HEADLINE = 50


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="shard the QP state over N torch.distributed ranks")
    ap.add_argument("--real", action="store_true",
                    help="with --sharded: one rank per card on NCCL instead of gloo ranks on "
                         "the CPU")
    common.add_device_args(ap)
    return ap.parse_args(argv)


def config(args) -> dict:
    """The run's settings from the arguments and the environment (plain
    data: the ranks of a sharded run receive it)."""
    cpu_ranks = bool(args.sharded) and not args.real
    env = os.environ.get
    return {
        "n": int(env("BENCH_N", "24" if cpu_ranks else str(N_HEADLINE))),
        "nu": int(env("BENCH_NU", "3")),
        "nu_coarse": int(env("BENCH_NU_COARSE", "2")),
        "fixed": int(env("BENCH_FIXED_ITERS", "9")),
        "steps": int(env("BENCH_STEPS", "4" if cpu_ranks else "48")),
        "verify": int(env("BENCH_VERIFY_ITERS", "40")),
        "fused": env("BENCH_FUSED", "1") != "0",
        "device": "cpu" if cpu_ranks else args.device,
        "dtype": args.dtype,
        "sharded": args.sharded,
    }


def run(cfg: dict, mesh=None) -> dict:
    """Build, warm up, time and verify the bench step (on ``mesh``'s rank
    when sharded). Returns the line's measured fields and, under
    ``objects``, the run's geometries, multigrid, models and step
    arguments, its state after the warm-up loads and after the last timed
    window."""
    from fenics_constitutive_tpu_torch.parallel import shard_packed_state

    device = mesh.device if mesh is not None else torch.device(cfg["device"])
    dtype = getattr(torch, cfg["dtype"])
    n = cfg["n"]
    common.reset_peak(device)
    t0 = time.perf_counter()
    geos, models, state, mg, args = common.bench_setup(
        n, dtype, device, fused=cfg["fused"], nu=cfg["nu"], nu_coarse=cfg["nu_coarse"])
    n_qp = geos[0].N
    if n == N_HEADLINE and n_qp != 1_000_000:
        common.fail(f"the {n}^3 box has {n_qp} quadrature points, expected 1,000,000")
    if mesh is not None:
        geos, state = shard_packed_state(geos, state, mesh)
    common.sync(device)
    setup_s = time.perf_counter() - t0
    # K1 and K2 serve the whole box on the card; a sharded geometry runs plain
    impl = "kernel" if device.type == "cuda" and mesh is None else "plain"
    # off the calibrated headline box, and when sharded, verify the verifier
    deep = [cfg["verify"]] if cfg["verify"] else []
    if deep and (n != N_HEADLINE or mesh is not None):
        deep.append(2 * cfg["verify"])
    out = common.bench_schedule(lambda fk: common.bench_step(geos, mg, fk, impl), cfg["fixed"],
                                deep, models, state, args, cfg["steps"], device)
    out["objects"] = {"geos": geos, "mg": mg, "models": models, "args": args,
                      "warm": out.pop("warm"),
                      "final": out.pop("final")}
    return {**out, "n_qp": n_qp, "setup_s": setup_s, "peak_gib": common.peak_gib(device)}


def rank_run(cfg: dict) -> dict:
    """A rank's part of a sharded run (the rank program of run_ranks)."""
    from fenics_constitutive_tpu_torch.parallel import make_device_mesh

    mesh = make_device_mesh(cfg["sharded"], device=None if cfg["device"] != "cpu" else "cpu")
    out = run(cfg, mesh)
    out.pop("objects")
    return out


def sharded(cfg: dict, real: bool) -> dict:
    """The N ranks' runs, joined: the slowest rank's windows and median."""
    from fenics_constitutive_tpu_torch.parallel import run_ranks

    n_ranks = cfg["sharded"]
    if real and torch.cuda.device_count() < n_ranks:
        common.fail(f"--sharded {n_ranks} --real needs {n_ranks} cards, have "
                    f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        ranks = run_ranks(rank_run, n_ranks, cfg, workdir=Path(tmp), timeout=3000.0,
                          backend="nccl" if real else "gloo")
    slowest = max(ranks, key=lambda r: r["value"])
    out = dict(slowest)
    out["rank_values"] = [r["value"] for r in ranks]
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in slowest["launches"]}
    out["converged"] = all(r["converged"] for r in ranks)
    out["setup_s"] = max(r["setup_s"] for r in ranks)
    peaks = [r["peak_gib"] for r in ranks]
    out["peak_gib"] = None if None in peaks else max(peaks)
    return out


def measure(argv=None, **overrides) -> tuple[dict, dict | None]:
    """(the JSON line, the run's objects: its ``geos``, its multigrid
    ``mg``, its ``models`` and step ``args``, its ``warm`` state and its
    ``final`` state; None when sharded). ``overrides`` replace settings of
    ``config``."""
    args = parse_args(argv)
    cfg = {**config(args), **overrides}
    device, _ = common.resolve_device(argparse.Namespace(device=cfg["device"], dtype=args.dtype))
    if args.sharded:
        out, objects = sharded(cfg, args.real), None
    else:
        out = run(cfg)
        objects = out.pop("objects")
    metric = METRIC
    if args.sharded:
        metric += f"_sharded{args.sharded}" + ("" if args.real else "cpu")
    line = {"metric": metric, "value": out.pop("value"), "unit": "ms",
            "r_norm": out.pop("r_norm"), "r_norm_ref": out.pop("r_norm_ref")}
    r_ref2 = out.pop("r_norm_ref2")
    if r_ref2 is not None:
        line["r_norm_ref2"] = r_ref2
    line["converged"] = out.pop("converged")
    line.update(out)
    line.update(dtype=cfg["dtype"], fused=cfg["fused"], fixed_iters=cfg["fixed"],
                device=common.device_info(device))
    if device.type == "cuda" and not args.sharded:
        kernels = ("K1", "K2", "K3") if cfg["fused"] else ("K1", "K2")
        common.require_launched(line["launches"], kernels, "bench_torch")
    return line, objects


def main(argv=None) -> dict:
    line, _ = measure(argv)
    if os.environ.get("BENCH_DEBUG"):
        common.debug_windows(line)
    common.print_line(line)
    if not line["converged"]:
        print(f"FAIL: settled r_norm {line['r_norm']:.4f} is outside the "
              f"{common.R_NORM_ENVELOPE} envelope of the deep-CG re-run "
              f"{line['r_norm_ref']:.4f} (and of the 2x-deep {line.get('r_norm_ref2')}); the "
              f"fixed-{line['fixed_iters']} CG step is under-converged: raise "
              "BENCH_FIXED_ITERS or fix the regression.", file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
