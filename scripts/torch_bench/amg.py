"""The AMG-preconditioned von Mises Newton step on the gather engine of the
PyTorch/CUDA port, against Jacobi (the twin of the JAX package's
``scripts/bench_amg_tpu.py``).

    python scripts/torch_bench/amg.py [--device cpu] [--dtype float64]

The Kuhn box ``unit_cube_mesh(35, 35, 35, "tetra")`` (1,029,000 QPs at q 2)
on the gather engine, built directly (the box would otherwise resolve to the
structured-tet engine, which ``tet.py`` measures), VonMises3D with bench.py's
stretch and material, one Newton iteration a step. Two preconditioners in
turn: the smoothed-aggregation AMG V(2,2) (``build_amg``; on the card its
levels are the windowed ones, node-major, which K6 applies; off the card the
ELL levels) with fixed-45 CG, and Jacobi with fixed-400 CG. Each: bench.py's
warm-up loads, the timing protocol of ``common.py`` over windows of 16 steps,
and a re-run of the same loads (the warm-up included) with twice the
fixed count whose settled
residual the timed one must match within 1.02x. A run in which either fails
prints ``converged: false`` and exits 1.

Environment: AMG_N (35), AMG_FIXED (45), AMG_STEPS (16), JAC_FIXED (400).

One JSON line: ``metric`` (``mises_tet_1MQP_newton_step_amg``), ``value``
(the AMG step's median ms/step), ``unit``, ``n``, ``ndofs``, ``n_qp``,
``hierarchy_build_s`` (the AMG's host build), ``converged`` (both), and per
preconditioner (``amg_*``, ``jacobi_*``): ``ms_per_step``, ``windows_ms``,
``spread``, ``host_ms``, ``cg_iters``, ``r_norm``, ``r_norm_ref``,
``converged``, ``probes`` and ``launches`` (K1-K6); then ``setup_s``, ``peak_gib``,
``clock``, ``dtype`` and ``device``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from scripts.torch_bench import common  # noqa: E402

METRIC = "mises_tet_1MQP_newton_step_amg"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    common.add_device_args(ap)
    return ap.parse_args(argv)


def gather_problem(V, device, dtype):
    """One VonMises3D law on every cell of V on the gather engine, and its
    zero state."""
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import build_packed_geometry
    from fenics_constitutive_tpu_torch.solver import PackedState

    law = VonMises3D(common.MAT)
    geo = build_packed_geometry(V, 2, law.constraint, np.arange(V.mesh.num_cells), device=device,
                                dtype=dtype)

    def zeros(k):
        return torch.zeros(geo.qp_shape(k), dtype=dtype, device=device)

    state = PackedState(u=torch.zeros(V.ndofs, dtype=dtype, device=device),
                        stress=(zeros(law.constraint.stress_strain_dim),),
                        histories=({k: zeros(d) for k, d in law.history_dim.items()},),
                        t=torch.zeros((), dtype=dtype, device=device))
    return (geo,), (law,), state


def step_of(geos, pc, fixed: int):
    """One Newton iteration, fixed-count PCG, compiled (a CUDA graph on the card)."""
    return common.compiled_step(geos, max_newton=1, newton_rtol=0.0, newton_atol=0.0,
                                cg_rtol=1e-5, cg_maxiter=1000, preconditioner=pc,
                                cg_fixed_iters=fixed)


def measure(argv=None) -> tuple[dict, dict]:
    """(the JSON line, the run's objects: the AMG preconditioner it ran and,
    per preconditioner, the state after the last timed window)."""
    from fenics_constitutive_tpu_torch.solver import build_amg

    device, dtype = common.resolve_device(parse_args(argv))
    env = os.environ.get
    n = int(env("AMG_N", "35"))
    K = int(env("AMG_STEPS", "16"))

    common.reset_peak(device)
    t0 = time.perf_counter()
    V, bcs = common.box(n, "tetra")
    geos, models, state = gather_problem(V, device, dtype)
    t1 = time.perf_counter()
    # the windowed levels on the card (K6, node-major, exact select as
    # PackedSimulation takes them there), the ELL levels off it
    spmv = "windowed" if device.type == "cuda" else "ell"
    amg = build_amg(V, common.MU, common.KAPPA, common.free_mask(V, bcs), q_degree=2, spmv=spmv,
                    device=device, dtype=dtype,
                    **({"select_passes": 3} if spmv == "windowed" else {}))
    common.sync(device)
    build_s = time.perf_counter() - t1
    setup_s = time.perf_counter() - t0
    args = common.step_args(bcs, V.ndofs, dtype, device)

    line = {"metric": METRIC, "value": None, "unit": "ms", "n": n, "ndofs": V.ndofs,
            "n_qp": int(geos[0].N), "hierarchy_build_s": build_s, "amg_levels": amg.n_levels,
            "converged": None}
    final = {}
    for name, pc, fixed in (("amg", amg, int(env("AMG_FIXED", "45"))),
                            ("jacobi", None, int(env("JAC_FIXED", "400")))):
        out = common.bench_schedule(lambda fk, pc=pc: step_of(geos, pc, fk), fixed, [2 * fixed],
                                    models, state, args, K, device)
        final[name] = out["final"]
        line.update({f"{name}_ms_per_step": out["value"],
                     f"{name}_windows_ms": out["windows_ms"],
                     f"{name}_spread": out["spread"], f"{name}_host_ms": out["host_ms"],
                     f"{name}_cg_iters": fixed, f"{name}_r_norm": out["r_norm"],
                     f"{name}_r_norm_ref": out["r_norm_ref"],
                     f"{name}_converged": out["converged"],
                     f"{name}_captured": out["captured"],
                     f"{name}_probes": out["probes"],
                     f"{name}_launches": out["launches"],
                     f"{name}_warm_windows": out["warm_windows"]})
        if env("BENCH_DEBUG"):
            print(f"[{name}]", file=sys.stderr)
            common.debug_windows(out)
    line.update(value=line["amg_ms_per_step"],
                converged=line["amg_converged"] and line["jacobi_converged"],
                captured=line["amg_captured"] and line["jacobi_captured"],
                setup_s=setup_s, peak_gib=common.peak_gib(device), clock=out["clock"],
                dtype=str(dtype).removeprefix("torch."), device=common.device_info(device))
    return line, {"amg": amg, "final": final}


def main(argv=None) -> dict:
    line, _ = measure(argv)
    common.print_line(line)
    if line["device"]["name"] != "cpu":
        common.require_launched(line["amg_launches"], ("K6",), "amg")
    if not line["converged"]:
        print(f"FAIL: settled r_norm outside {common.R_NORM_ENVELOPE} x the 2x-deep re-run: "
              f"amg {line['amg_r_norm']:.4f} vs {line['amg_r_norm_ref']:.4f}, jacobi "
              f"{line['jacobi_r_norm']:.4f} vs {line['jacobi_r_norm_ref']:.4f}", file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
