"""The P2 (27-node hex) von Mises Newton step on the lattice engine of the
PyTorch/CUDA port (the twin of the JAX package's ``scripts/bench_p2.py``).

    python scripts/torch_bench/p2.py [n] [q] [--device cpu] [--dtype float64]

The n^3 hex box (default 32) with a degree-2 vector space at q_degree q
(default 4: 884,736 QPs, 823,875 dofs) on the lattice engine, VonMises3D
with bench.py's material, the x = 1 face pulled by 0.004. One Newton
iteration from the zero state, CG to rtol 1e-5 (at most 250 iterations)
preconditioned by the V-cycle on the refined P1 grid that shares the P2 dof
lattice (65^3 nodes; build_multigrid's defaults) whose smoothing chains run
as K3 on the card. The CG is adaptive, as in the JAX script: on the card
the step replays from one CUDA graph, its CG loop a graph while node that
the device ends (``solver/compiled.py``).

Timing: the protocol of ``common.py`` with one step a window, each from the
zero state at the load 0.004 (1 + 1e-4 j): untimed first steps until two
agree, then the 5 timed steps of the JAX script. The JAX script prints no
JSON line (and sets every Dirichlet value to the load, a rigid
translation); the twin pulls the
x = 1 face alone, as ``chip_smoke.py`` phase 19 does, and checks itself: the
last timed step's residual within 1.02x of the same step in float64. A run
that fails prints ``converged: false`` and exits 1.

One JSON line: ``metric`` (``mises_p2_newton_step_converged``), ``value``
(median ms/step), ``unit``, ``n_qp``, ``ndofs``, ``q_degree``, ``cg``
(adaptive), ``cg_iters`` and ``r_rel`` (r/r0) per timed step, ``r_norm``,
``r_norm_ref`` (float64), ``converged``, the timing fields of common.py,
``launches`` (K1-K6; K3 only on this engine), ``setup_s``, ``peak_gib``,
``dtype`` and ``device``.
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

METRIC = "mises_p2_newton_step_converged"
CG = {"cg_rtol": 1e-5, "cg_maxiter": 250}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=32, help="cells per edge of the box")
    ap.add_argument("q", nargs="?", type=int, default=4, help="quadrature degree")
    common.add_device_args(ap)
    return ap.parse_args(argv)


def p2_problem(V, bcs, q: int, device, dtype) -> dict:
    """The twin's step (one Newton iteration, adaptive CG, the refined-P1
    V-cycle with its K3 chains; compiled, so replayed from one CUDA graph on
    the card, its CG a graph while node), its models, the zero state, the
    step's arguments and the lattice geometry."""
    from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
    from fenics_constitutive_tpu_torch.ops import LatticeGeometry
    from fenics_constitutive_tpu_torch.solver import build_packed_problem
    from fenics_constitutive_tpu_torch.solver.multigrid import build_multigrid, refined_p1_geometry

    geos, models, state0 = build_packed_problem(V, VonMises3D(common.MAT), q, device=device,
                                                dtype=dtype)
    if not isinstance(geos[0], LatticeGeometry):
        common.fail(f"the P2 box resolved to {type(geos[0]).__name__}, not the lattice engine")
    geo1, _ = refined_p1_geometry(V, Constraint.FULL, device=device, dtype=dtype)
    mg = build_multigrid(geo1, common.MU, common.KAPPA, torch.as_tensor(common.free_mask(V, bcs)),
                         device=device, dtype=dtype, fused_smoothing=True)
    step = common.compiled_step(geos, newton_rtol=0.0, newton_atol=0.0, max_newton=1,
                                preconditioner=mg, **CG)
    return {"step": step, "models": models, "state": state0, "geo": geos[0],
            "args": common.step_args(bcs, V.ndofs, dtype, device)}


def p2_step(V, bcs, q: int, device, dtype):
    """(geometry, run(j) -> stats): one Newton iteration of ``p2_problem``
    from the zero state at the load 0.004 (1 + 1e-4 j)."""
    p = p2_problem(V, bcs, q, device, dtype)
    step, models, state0 = p["step"], p["models"], p["state"]
    bc_dofs, bc_vals, f_ext, dt = p["args"]

    def run(j):
        return step(models, state0, bc_dofs, bc_vals * (1 + 1e-4 * j), f_ext, dt)[1]

    run.captured = step.captured

    return p["geo"], run


def measure(argv=None) -> dict:
    """The JSON line of a run."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh

    args_ns = parse_args(argv)
    device, dtype = common.resolve_device(args_ns)
    n, q = args_ns.n, args_ns.q

    common.reset_peak(device)
    t0 = time.perf_counter()
    V = FunctionSpace(unit_cube_mesh(n, n, n, "hex"), 2, 3)
    bcs = common.bench_bcs(V)
    geo, run = p2_step(V, bcs, q, device, dtype)
    common.sync(device)
    setup_s = time.perf_counter() - t0
    by_window = {}

    def window(j):
        by_window[j] = run(j)
        return by_window[j]

    timing = common.time_windows(window, 1, device)
    rows = [by_window[j] for j in range(1, common.WINDOWS + 1)]  # the timed steps
    r_norm = float(rows[-1]["r_norm"])
    _, run64 = p2_step(V, bcs, q, device, torch.float64)
    r_ref = float(run64(common.WINDOWS)["r_norm"])
    ratio = r_norm / r_ref
    line = {"metric": METRIC, "value": timing["value"], "unit": "ms", "n_qp": int(geo.N),
            "ndofs": V.ndofs, "q_degree": q,
            "cg": "adaptive: rtol 1e-5, at most 250 iterations",
            "captured": run.captured,
            "cg_iters": [int(s["cg_iters_last"]) for s in rows],
            "r_rel": [float(s["r_norm"]) / max(float(s["r0_norm"]), 1e-300) for s in rows],
            "r_norm": r_norm, "r_norm_ref": r_ref,
            "converged": bool(max(ratio, 1 / ratio) <= common.R_NORM_ENVELOPE),
            **common.timing_fields(timing), "setup_s": setup_s,
            "peak_gib": common.peak_gib(device), "dtype": str(dtype).removeprefix("torch."),
            "device": common.device_info(device)}
    return line


def main(argv=None) -> dict:
    line = measure(argv)
    if os.environ.get("BENCH_DEBUG"):
        common.debug_windows(line)
    common.print_line(line)
    if line["device"]["name"] != "cpu":
        common.require_launched(line["launches"], ("K3",), "p2")
        if line["launches"]["K1"] or line["launches"]["K2"]:
            common.fail(f"p2: K1/K2 launched on the lattice engine ({line['launches']})")
    if not line["converged"]:
        print(f"FAIL: settled r_norm {line['r_norm']:.5g} is not within "
              f"{common.R_NORM_ENVELOPE}x of the float64 step's {line['r_norm_ref']:.5g}",
              file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
