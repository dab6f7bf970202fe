"""The von Mises Newton step on an imported (general unstructured) tet mesh:
the windowed engine with the windowed AMG on the PyTorch/CUDA port (the twin
of the ``MODE=bench`` protocol of the JAX package's
``scripts/bench_unstructured.py``).

    python scripts/torch_bench/unstructured.py [n] [--device cpu] [--dtype float64]

The mesh is the n^3 Kuhn tet box (default n = 35: 257,250 tets, 1,083,392
padded QPs) with its node numbering shuffled, written with ``write_gmsh``
and read back with ``read_gmsh``, so it arrives like an external mesh: no
structured metadata, no banded numbering. VonMises3D with bench.py's stretch
and material on the windowed engine, one Newton iteration a step, fixed-count
PCG with the windowed AMG V(nu, nu) (K6 on every level; ``PC=jacobi``:
Jacobi), K4 and K5 inside every strain and residual. bench_unstructured's
warm-up loads 0.5-2.0, then the timing protocol of ``common.py`` over windows
of 10 steps at ``2.0 + 1e-4 j + 0.05 (i + 1)``. The settled residual must lie
within 1.02x of a re-run of the same loads (the warm-up included)
with 3x the fixed count, and
that within 1.02x of one with 6x; a run that fails prints ``converged:
false`` and exits 1. The twin writes no file in the repository (the JAX
script records its line in ``BENCH_UNSTRUCTURED.json``); the Gmsh file lives
in a temporary directory.

Environment: FIXED (12), NU (2), STEPS (10), VERIFY_ITERS (3 x FIXED), PC
(amg | jacobi), TR (the AMG plans' tile rows, 512).

One JSON line: ``metric`` (``mises_1MQP_general_tet_newton_step_converged``),
``value`` (median ms/step), ``unit``, ``n_qp``, ``engine``, ``pc``,
``fixed_iters``, ``verify_iters``, ``r_norm``, ``r_norm_ref``,
``r_norm_ref2``, ``converged``, ``probes``, the timing fields of common.py, ``launches`` (K1-K7), ``setup_s`` (split:
Gmsh write and read, RCM plus plan, geometry, AMG host build, freeze and
upload), ``warmup_s``, ``peak_gib``, ``dtype`` and ``device``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from scripts.torch_bench import common  # noqa: E402

METRIC = "mises_1MQP_general_tet_newton_step_converged"
WARM_LOADS = (0.5, 1.0, 1.5, 2.0)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=35, help="cells per edge of the box")
    common.add_device_args(ap)
    return ap.parse_args(argv)


def setup(n: int, device, dtype, pc_kind: str, nu: int, tile_rows: int) -> dict:
    """The imported mesh through Gmsh, its windowed geometry and AMG, timed."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, read_gmsh, write_gmsh
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_amg, build_packed_problem

    t0 = time.perf_counter()
    written = common.imported_mesh(n)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"tet{n}.msh"
        write_gmsh(path, written)
        mesh = read_gmsh(path)
    io_s = time.perf_counter() - t0
    if not (np.array_equal(mesh.cells, written.cells)
            and np.array_equal(mesh.nodes, written.nodes)):
        common.fail("read_gmsh did not give back the mesh write_gmsh wrote")
    if mesh.structured_shape is not None:
        common.fail("the imported mesh carries structured metadata")
    V = FunctionSpace(mesh, 1, 3)
    bcs = common.bench_bcs(V)
    geos, models, state = build_packed_problem(V, VonMises3D(common.MAT), 2, device=device,
                                               dtype=dtype, engine="windowed")
    geo = geos[0]
    amg, pc, amg_s = None, None, {}
    if pc_kind == "amg":
        amg = build_amg(V, common.MU, common.KAPPA, common.free_mask(V, bcs), q_degree=2, nu=nu,
                        tile_rows=tile_rows, spmv="windowed", node_perm=geo.ex.perm,
                        device=device, dtype=dtype)
        pc, amg_s = amg.wrap_internal(geo.ex.M_pad), amg.build_seconds
    elif pc_kind != "jacobi":
        common.fail(f"PC={pc_kind!r}: choose amg or jacobi")
    common.sync(device)
    bs = geo.build_seconds
    split = {"gmsh_write_read": io_s, "rcm_plan": bs["rcm"] + bs["plan"],
             "geometry": bs["geometry"], "amg_host_build": amg_s.get("hierarchy", 0.0),
             "amg_freeze": amg_s.get("freeze", 0.0), "upload": amg_s.get("upload", 0.0)}
    return {"mesh": mesh, "V": V, "bcs": bcs, "geos": geos, "models": models, "state": state,
            "amg": amg, "pc": pc, "pc_kind": pc_kind, "setup_s": time.perf_counter() - t0,
            "setup_split_s": split}


def step_of(geos, pc, fixed: int):
    """One Newton iteration, fixed-count PCG, compiled (a CUDA graph on the card)."""
    return common.compiled_step(geos, max_newton=1, newton_rtol=0.0, newton_atol=0.0,
                                cg_rtol=1e-5, cg_maxiter=500, preconditioner=pc,
                                cg_fixed_iters=fixed)


def run(s: dict, device, dtype, fixed: int = 12, verify: int = 36, K: int = 10) -> dict:
    """The protocol on a ``setup``: the JSON line, and under ``objects`` the
    state after the warm-up and after the last timed window."""
    geos, pc = s["geos"], s["pc"]
    geo = geos[0]
    args = common.step_args(s["bcs"], geo.ndofs_int, dtype, device)
    out = common.bench_schedule(lambda fk: step_of(geos, pc, fk), fixed, [verify, 2 * verify],
                                s["models"], s["state"], args, K, device, first=1,
                                warm_loads=WARM_LOADS)
    objects = {"warm": out.pop("warm"), "final": out.pop("final")}
    return {"metric": METRIC, "value": out.pop("value"), "unit": "ms", "n_qp": int(geo.N),
            "engine": geo.engine, "pc": s["pc_kind"], "fixed_iters": fixed,
            "verify_iters": verify, **out, "setup_s": s["setup_s"],
            "setup_split_s": s["setup_split_s"], "peak_gib": common.peak_gib(device),
            "dtype": str(dtype).removeprefix("torch."), "device": common.device_info(device),
            "objects": objects}


def main(argv=None) -> dict:
    args_ns = parse_args(argv)
    device, dtype = common.resolve_device(args_ns)
    env = os.environ.get
    fixed = int(env("FIXED", "12"))
    pc_kind = env("PC", "amg")
    common.reset_peak(device)
    s = setup(args_ns.n, device, dtype, pc_kind, int(env("NU", "2")), int(env("TR", "512")))
    line = run(s, device, dtype, fixed, int(env("VERIFY_ITERS", str(3 * fixed))),
               int(env("STEPS", "10")))
    line.pop("objects")
    if env("BENCH_DEBUG"):
        common.debug_windows(line)
    common.print_line(line)
    if device.type == "cuda":
        kernels = ("K4", "K5", "K6") if pc_kind == "amg" else ("K4", "K5")
        common.require_launched(line["launches"], kernels, "unstructured")
    if not line["converged"]:
        verify = line["verify_iters"]
        print(f"FAIL: fixed-{fixed} settled r_norm {line['r_norm']:.4f} vs fixed-{verify} "
              f"{line['r_norm_ref']:.4f} / fixed-{2 * verify} {line['r_norm_ref2']:.4f}",
              file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
