"""The 1M-QP von Mises Newton step on a tet mesh, on the structured-tet
engine of the PyTorch/CUDA port (the twin of the JAX package's
``scripts/bench_tet.py``).

    python scripts/torch_bench/tet.py [--device cpu] [--dtype float64]

The Kuhn box ``unit_cube_mesh(35, 35, 35, "tetra")`` (257,250 tets, 1,029,000
QPs at q 2), VonMises3D with bench.py's stretch and material, one Newton
iteration a step, fixed-14 CG preconditioned by the V(3,3) multigrid below
the tet fine level (2 coarse sweeps, direct coarsest solve) whose smoothing
chains run as K3 on the card; bench.py's warm-up loads, then the timing
protocol of ``common.py`` over windows of 16 steps. The settled residual must
lie within 1.02x of a fixed-40 re-run of the same loads, the warm-up
included; a run that fails
prints ``converged: false`` and exits 1.

Environment: TET_N (35), TET_FIXED (14), TET_STEPS (16), TET_VERIFY (40).

One JSON line: ``metric`` (``mises_tet_1MQP_newton_step_structured``),
``value`` (median ms/step), ``unit``, ``n_qp``, ``cg_fixed_iters``,
``verify_iters``, ``r_norm``, ``r_norm_ref``, ``converged``, ``probes``, the
timing fields of common.py, ``launches`` (K1-K6; K3 only on this engine),
``setup_s``, ``warmup_s``, ``peak_gib``, ``fused``, ``dtype`` and ``device``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from scripts.torch_bench import common  # noqa: E402

METRIC = "mises_tet_1MQP_newton_step_structured"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_args(ap)
    return ap.parse_args(argv)


def build(n: int, device, dtype, fused: bool = True) -> dict:
    """The Kuhn box on the structured-tet engine, its multigrid and the
    step's arguments, timed (``setup_s``)."""
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import StructuredTetGeometry
    from fenics_constitutive_tpu_torch.solver import build_multigrid, build_packed_problem

    t0 = time.perf_counter()
    V, bcs = common.box(n, "tetra")
    geos, models, state = build_packed_problem(V, VonMises3D(common.MAT), 2, device=device,
                                               dtype=dtype)
    if not isinstance(geos[0], StructuredTetGeometry):
        common.fail(f"the Kuhn box resolved to {type(geos[0]).__name__}, not the "
                    "structured-tet engine")
    mg = build_multigrid(geos[0], common.MU, common.KAPPA,
                         torch.as_tensor(common.free_mask(V, bcs)), device=device,
                         dtype=dtype, nu=3, nu_coarse=2, coarse_direct=True,
                         fused_smoothing=fused)
    args = common.step_args(bcs, V.ndofs, dtype, device)
    common.sync(device)
    return {"V": V, "bcs": bcs, "geos": geos, "models": models, "state": state, "mg": mg,
            "fused": fused, "args": args, "setup_s": time.perf_counter() - t0}


def run(b: dict, device, dtype, fixed: int = 14, K: int = 16, verify: int = 40) -> dict:
    """The protocol on a ``build``: the JSON line, and under ``objects`` the
    state after the warm-up and after the last timed window."""
    geos, mg = b["geos"], b["mg"]
    out = common.bench_schedule(lambda fk: common.bench_step(geos, mg, fk, "plain"), fixed,
                                [verify], b["models"], b["state"], b["args"], K, device)
    objects = {"warm": out.pop("warm"), "final": out.pop("final")}
    line = {"metric": METRIC, "value": out.pop("value"), "unit": "ms",
            "n_qp": int(geos[0].N), "cg_fixed_iters": fixed, "verify_iters": verify, **out,
            "setup_s": b["setup_s"], "peak_gib": common.peak_gib(device), "fused": b["fused"],
            "dtype": str(dtype).removeprefix("torch."), "device": common.device_info(device),
            "objects": objects}
    return line


def main(argv=None) -> dict:
    device, dtype = common.resolve_device(parse_args(argv))
    env = os.environ.get
    common.reset_peak(device)
    b = build(int(env("TET_N", "35")), device, dtype)
    line = run(b, device, dtype, int(env("TET_FIXED", "14")), int(env("TET_STEPS", "16")),
               int(env("TET_VERIFY", "40")))
    line.pop("objects")
    if env("BENCH_DEBUG"):
        common.debug_windows(line)
    common.print_line(line)
    if device.type == "cuda":
        common.require_launched(line["launches"], ("K3",), "tet")
        if line["launches"]["K1"] or line["launches"]["K2"]:
            common.fail(f"tet: K1/K2 launched on a tet geometry ({line['launches']})")
    if not line["converged"]:
        print(f"FAIL: settled r_norm {line['r_norm']:.4f} exceeds {common.R_NORM_ENVELOPE} x "
              f"the fixed-{line['verify_iters']} re-run {line['r_norm_ref']:.4f}",
              file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
