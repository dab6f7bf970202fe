"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line of what it found; any failure raises and
exits non-zero before the last line:

  1. device: the card (nvidia-smi name and power limit), torch and CUDA;
     there is no CPU path.
  2. build: compiles the two kernels of ``fenics_constitutive_tpu_torch/csrc``
     with nvcc (first use) and prints the build seconds and register use.
  3. K1, the fused CG operator, against its plain PyTorch version at the
     benchmark size (50^3 hexes, M = 51^3 flat nodes) with a plastic
     tangent, in float64 and float32, and both times.
  4. K2, the fused VonMises3D eval + assembly, against its plain version at
     50^3 from a plastic pre-state, every output, float64 and float32.
  5. the benchmark workload on the port (1M quadrature points, float32,
     max_newton=1, fixed-9 CG, V(3,3) multigrid with a direct coarse solve,
     both kernels): three warm-up load steps, a timed window of 48 steps,
     and the deep fixed-40 CG re-run of the same schedule whose settled
     residual the timed run must match within 2%. Also a 6^3 run of the same
     step with kernels and with plain operators, which must agree.
  6. the user entry point: PackedSimulation(..., preconditioner="vcycle",
     eval_impl="kernel") in float64 on the 50^3 box takes 3 load steps of
     the stretch 0.0004 k; each must converge. (Steps of 0.004 k, which
     converge on small boxes, do not at 50^3 in either package: the first
     Newton iterate puts the whole stretch into the last cell layer, a
     strain of 0.2, and the JAX package's PackedSimulation stalls there
     exactly as the port does.)

The general-mesh path (imported tets, windowed engine, windowed-BSR AMG) on
a 35^3 Kuhn tet box whose node numbering is shuffled, written with the
port's write_gmsh and read back with read_gmsh (257,250 tets, 1,083,392
padded quadrature points):

  7. K4 (windowed gather) and K5 (windowed scatter) against their plain
     versions on that mesh's exchange plan (T = 1024, K = 3), float64 and
     float32: K4 bit-equal, K5 within a normwise tolerance and bit-equal
     across two launches; both times.
  8. K6 (windowed BSR SpMV) against its plain version on every A, P and R
     level of the mesh's AMG hierarchy: float32 with select_passes 1 and 3,
     and float64; per-level errors and times.
  9. the general-tet bench (the JAX package's scripts/bench_unstructured.py
     protocol): float32, max_newton=1, fixed-3 plain PCG with the windowed
     AMG V(3,3); warm-up load scales 0.5-2.0, 10 timed steps at
     2.0 + 0.05 (i+1), and the fixed-9 and fixed-18 re-runs of the same
     schedule, which the settled residual must match within 2% each. First a
     5^3 float64 reference: converged Newton steps on the card (kernels) and
     on the CPU (plain versions) must agree.
 10. the user entry point on the imported mesh: PackedSimulation with
     default options must pick the windowed engine and AMG and converge 3
     load steps of the stretch 0.0004 k in float32. (Steps of 0.004 k, which
     converge up to 24^3, diverge from 30^3 on in both packages, for the
     reason phase 6 gives: the JAX package on the CPU at 30^3 ends its first
     step at r_norm 79289 after 25 Newton iterations, the port at 76181.)

Then one JSON line of per-kernel results and, last, the device JSON line.
"""

from __future__ import annotations

import copy
import json
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}
MU, KAPPA = MAT["p_mu"], MAT["p_ka"]
N_BENCH = 50
R_NORM_ENVELOPE = 1.02

# tolerances, normwise: max|kernel - plain| <= tol * max|plain| per output.
# float64: both sides differ only by summation order and FMA contraction,
# a few ulps of the largest term. float32: the same, at float32 precision,
# where the 48- and 24-term contractions and the residual's cancellation
# between corners cost a few hundred ulps of max|plain|.
TOL_F64 = 1e-10
TOL_F32_K1 = 1e-5
# K2 adds the local Newton, which stops at a relative step of 8 eps: two
# roundings of the same iteration can stop one iterate apart, and the
# tangent's gamma = 4 mu^2 (gamma_p/|s_tr| - 1/(-dF)) cancels by up to
# |s_tr|/yield. Measured at 50^3: float64 <= 3.6e-15, float32 <= 1.9e-6.
TOL_F64_K2 = 1e-9
TOL_F32_K2 = 1e-4
# K5 sums each node's rows in the plan's order, the plain version in another
# (atomics on the card): a node sums at most ~24 rows, so the difference is a
# few ulps of the largest partial sum.
TOL_K5 = {torch.float64: 1e-13, torch.float32: 1e-6}
# K6 sums k slots of br x bc products per row (R_0: 101 x 3) with FMA in
# another order than the plain version; both round x to bf16 alike when
# select_passes = 1, so the tolerance is that of the float sum either way.
TOL_K6 = {torch.float64: 1e-12, torch.float32: 1e-5}

CARD = "cuda"  # the device of the general-mesh phases
N_TET = 35  # the general-tet bench mesh: 35^3 boxes of 6 Kuhn tets
N_QP_TET = 1_083_392  # its padded quadrature points (T = 1024 plan)
TET_FIXED, TET_VERIFY = 3, (9, 18)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def normwise(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max|b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-300)


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


def box(n: int):
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh

    V = FunctionSpace(unit_cube_mesh(n, n, n, "hex"), 1, 3)
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


# -- phases ----------------------------------------------------------------------


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"phase 1 device: {name} sm_{cap[0]}{cap[1]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build() -> None:
    from fenics_constitutive_tpu_torch.ops import _cuda_build

    libs = ("matvec", "eval", "window")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(_cuda_build.load_library, lib) for lib in libs]:
            fut.result()
    for lib in libs:
        info = _cuda_build.build_log[lib]
        usage = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
        print(f"phase 2 build: {lib}.cu in {info['seconds']:.2f} s; " + " | ".join(usage))


def plastic_tangent(geo, law, rng, amp):
    """Tangent of one plastic evaluation from the zero state (plain path)."""
    V_ndofs = geo.ndofs
    u = torch.as_tensor(rng.normal(size=V_ndofs) * amp, dtype=geo.dtype, device=geo.device)
    eps = geo.strain_gm(u)
    zeros = torch.zeros(geo.qp_shape(6), dtype=geo.dtype, device=geo.device)
    hist = {"eps_n": zeros.clone(), "alpha": torch.zeros(geo.qp_shape(1), dtype=geo.dtype, device=geo.device)}
    return law.evaluate_packed(0.0, 1.0, eps, zeros, hist)


def phase_k1(results: dict) -> None:
    from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_matvec
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry

    V, _ = box(N_BENCH)
    law = VonMises3D(MAT)
    line = []
    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32_K1)):
        geo = build_structured_geometry(V, 2, Constraint.FULL, device="cuda", dtype=dtype)
        rng = np.random.default_rng(0)
        # nodal amplitude 7.2e-4 on h = 1/50: strains of a few percent, past yield
        _, tg, _ = plastic_tangent(geo, law, rng, 7.2e-4)
        if float(tg.gamma.abs().max()) <= 0:
            fail("K1 test tangent is not plastic")
        v = torch.as_tensor(rng.normal(size=V.ndofs), dtype=dtype, device="cuda")
        mv = cuda_matvec.build_cuda_matvec(geo)
        r_k = mv(v, tg)
        torch.cuda.synchronize()
        r_p = cuda_matvec.matvec_plain(geo, v, tg)
        if not torch.isfinite(r_k).all():
            fail("K1 returned non-finite values")
        err, rel = normwise(r_k, r_p)
        line.append(f"{str(dtype)[6:]} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g})")
        if rel > tol:
            fail(f"K1 {dtype} disagrees with the plain version: rel {rel:.3e} > {tol:g}")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: mv(v, tg))
            plain_ms = cuda_ms(lambda: cuda_matvec.matvec_plain(geo, v, tg))
            results["K1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
            line.append(f"f32 {ms:.4f} ms/apply vs plain {plain_ms:.4f} ms")
    print("phase 3 K1 vs plain at 50^3: " + "; ".join(line))


def phase_k2(results: dict) -> None:
    from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_eval
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry

    V, _ = box(N_BENCH)
    law = VonMises3D(MAT)
    for dtype, tol in ((torch.float64, TOL_F64_K2), (torch.float32, TOL_F32_K2)):
        geo = build_structured_geometry(V, 2, Constraint.FULL, device="cuda", dtype=dtype)
        rng = np.random.default_rng(0)
        sig1, _, hist1 = plastic_tangent(geo, law, rng, 7.2e-4)
        if float(hist1["alpha"].max()) <= 0:
            fail("K2 pre-state is not plastic")
        du = torch.as_tensor(rng.normal(size=V.ndofs) * 2.4e-4, dtype=dtype, device="cuda")
        fused = cuda_eval.build_cuda_eval(geo, law)
        out_k = fused(du, sig1, hist1)
        torch.cuda.synchronize()
        out_p = cuda_eval.eval_plain(geo, law, du, sig1, hist1)
        fields = {
            "F": (out_k[0], out_p[0]),
            "stress": (out_k[1], out_p[1]),
            "beta": (out_k[2][0], out_p[2][0]),
            "gamma": (out_k[2][1], out_p[2][1]),
            "n": (out_k[2][2], out_p[2][2]),
            "eps_n": (out_k[3]["eps_n"], out_p[3]["eps_n"]),
            "alpha": (out_k[3]["alpha"], out_p[3]["alpha"]),
        }
        parts, worst = [], 0.0
        for name, (a, b) in fields.items():
            if a.shape != b.shape or not torch.isfinite(a).all():
                fail(f"K2 {name}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
            err, rel = normwise(a, b)
            worst = max(worst, rel)
            parts.append(f"{name} {rel:.2e}")
        plastic = float((out_p[3]["alpha"] > hist1["alpha"]).double().mean())
        print(f"phase 4 K2 vs plain at 50^3 {str(dtype)[6:]} (plastic share {plastic:.3f}), "
              f"rel err per field: " + ", ".join(parts) + f" (tol {tol:g})")
        if worst > tol:
            fail(f"K2 {dtype} disagrees with the plain version: rel {worst:.3e} > {tol:g}")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: fused(du, sig1, hist1))
            plain_ms = cuda_ms(lambda: cuda_eval.eval_plain(geo, law, du, sig1, hist1))
            err_f, _ = normwise(out_k[0], out_p[0])
            results["K2"] = {"max_abs_err": err_f, "ms": ms, "plain_ms": plain_ms}
            print(f"phase 4 K2 f32 time: {ms:.4f} ms/call vs plain {plain_ms:.4f} ms")


def bench_setup(n: int, dtype, device):
    from fenics_constitutive_tpu_torch.fem import combine_bcs
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_multigrid, build_packed_problem

    V, bcs = box(n)
    law = VonMises3D(MAT)
    geos, models, state = build_packed_problem(V, law, 2, device=device, dtype=dtype)
    bc_dofs, bc_vals = combine_bcs(bcs)
    free0 = torch.ones(V.ndofs, dtype=torch.bool)
    free0[torch.as_tensor(bc_dofs, dtype=torch.int64)] = False
    mg = build_multigrid(
        geos[0], MU, KAPPA, free0, device=device, dtype=dtype,
        nu=3, nu_coarse=2, coarse_direct=True,
    )
    args = (
        torch.as_tensor(bc_dofs, dtype=torch.int64, device=device),
        torch.as_tensor(bc_vals, dtype=dtype, device=device),
        torch.zeros(V.ndofs, dtype=dtype, device=device),
        1.0,
    )
    return geos, models, state, mg, args


def bench_step(geos, mg, fixed_iters, impl):
    from fenics_constitutive_tpu_torch.solver import make_packed_step

    return make_packed_step(
        geos, max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5,
        cg_maxiter=400, preconditioner=mg, cg_fixed_iters=fixed_iters,
        matvec_impl=impl, eval_impl=impl,
    )


def run_schedule(step, models, state, args, scales):
    bc_dofs, bc_vals, f_ext, dt = args
    probes = []
    for sc in scales:
        state, stats = step(models, state, bc_dofs, bc_vals * sc, f_ext, dt)
        probes.append(stats["r_norm"])
    return state, torch.stack(probes)


def phase_bench(results: dict) -> dict:
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec
    from fenics_constitutive_tpu_torch.solver import make_packed_step

    # small reference: the same load path with kernels and with plain
    # operators, Newton converged. (The benchmark's single Newton iteration
    # is no reference here: at its first evaluation every point that yielded
    # in the previous step sits on the yield surface, so which of them count
    # as plastic, and hence the one tangent the step solves with, is decided
    # by round-off; the converged state does not depend on the tangent.)
    geos, models, state, mg, args = bench_setup(6, torch.float64, "cuda")
    outs = {}
    for impl in ("kernel", "plain"):
        step = make_packed_step(
            geos, max_newton=8, newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-10,
            cg_maxiter=300, preconditioner=mg, matvec_impl=impl, eval_impl=impl,
        )
        st = state
        for k in (0.5, 1.0, 1.5, 2.0):
            st, stats = step(models, st, args[0], args[1] * k, *args[2:])
        outs[impl] = st
    u_rel = normwise(outs["kernel"].u, outs["plain"].u)[1]
    s_rel = normwise(outs["kernel"].stress[0], outs["plain"].stress[0])[1]
    print(f"phase 5 small reference 6^3 f64, converged Newton, kernels vs plain after "
          f"4 load steps: u rel {u_rel:.2e}, stress rel {s_rel:.2e} (tol 1e-7)")
    if max(u_rel, s_rel) > 1e-7:
        fail("the kernel step disagrees with the plain step at 6^3")

    t0 = time.perf_counter()
    geos, models, state, mg, args = bench_setup(N_BENCH, torch.float32, "cuda")
    if geos[0].N != 1_000_000:
        fail(f"bench box has {geos[0].N} quadrature points, expected 1,000,000")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    step = bench_step(geos, mg, 9, "kernel")
    st = state
    for k in (0.5, 1.0, 1.5):  # warm-up, driven past yield
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    torch.cuda.synchronize()

    K, j = 48, 1
    scales = [2.0 + 1e-4 * j + 0.05 * i for i in range(K)]
    cuda_matvec.launches = 0
    cuda_eval.launches = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    out_state, probes = run_schedule(step, models, st.clone(), args, scales)
    ev1.record()
    ev1.synchronize()
    host_s = time.perf_counter() - h0
    counts = {"K1": cuda_matvec.launches, "K2": cuda_eval.launches}
    ms_step = ev0.elapsed_time(ev1) / K
    if not (torch.isfinite(probes).all() and torch.isfinite(out_state.u).all()):
        fail("bench run produced non-finite values")
    if out_state.stress[0].shape != (6, 8, 51**3):
        fail(f"bench stress has shape {tuple(out_state.stress[0].shape)}")
    r_settled = float(probes[-1])

    r = torch.as_tensor(np.random.default_rng(2).normal(size=geos[0].ndofs),
                        dtype=torch.float32, device="cuda")
    vcycle_ms = cuda_ms(lambda: mg(r), iters=10)
    elastic_ms = cuda_ms(lambda: geos[0].elastic_matvec_gm(r, KAPPA, 2 * MU))

    step_ref = bench_step(geos, mg, 40, "kernel")
    _, probes_ref = run_schedule(step_ref, models, st.clone(), args, scales)
    r_ref = float(probes_ref[-1])
    ok = r_settled <= R_NORM_ENVELOPE * r_ref
    print(f"phase 5 bench 50^3 f32 (1,000,000 QPs): {ms_step:.3f} ms/step over {K} steps "
          f"(CUDA events; host clock {host_s / K * 1e3:.3f} ms/step; setup {setup_s:.1f} s), "
          f"r_norm {r_settled:.4f} vs deep fixed-40 {r_ref:.4f} (envelope {R_NORM_ENVELOPE}), "
          f"launches K1 {counts['K1']} K2 {counts['K2']}; V-cycle {vcycle_ms:.3f} ms, "
          f"fine elastic apply {elastic_ms:.4f} ms; "
          f"K1 {results['K1']['ms']:.4f} ms vs plain {results['K1']['plain_ms']:.4f} ms, "
          f"K2 {results['K2']['ms']:.4f} ms vs plain {results['K2']['plain_ms']:.4f} ms")
    if not ok:
        fail(f"settled r_norm {r_settled:.4f} exceeds {R_NORM_ENVELOPE} x deep-CG {r_ref:.4f}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"the bench run never launched {name}")
    return counts


def phase_simulation() -> None:
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V, bcs = box(N_BENCH)
    sim = PackedSimulation(
        VonMises3D(MAT), V, bcs, 2, preconditioner="vcycle", eval_impl="kernel",
        dtype=torch.float64, device="cuda",
    )
    k1, k2 = cuda_matvec.launches, cuda_eval.launches
    report = []
    for k in (1, 2, 3):
        bcs[1].value = 0.0004 * k
        t0 = time.perf_counter()
        niter, converged = sim.solve()
        torch.cuda.synchronize()
        report.append(f"step {k}: newton {niter}, converged {converged}, "
                      f"r {sim.last_stats['r_norm']:.3e}, {time.perf_counter() - t0:.2f} s")
        if not converged:
            fail(f"PackedSimulation step {k} did not converge: {sim.last_stats}")
    stress = sim.stress
    if stress.shape != (N_BENCH**3, 8, 6) or not np.isfinite(stress).all():
        fail(f"PackedSimulation stress has shape {stress.shape} or non-finite values")
    d1, d2 = cuda_matvec.launches - k1, cuda_eval.launches - k2
    print("phase 6 PackedSimulation 50^3 f64 vcycle: " + "; ".join(report)
          + f"; kernel launches K1 +{d1} K2 +{d2}")
    if d1 <= 0 or d2 <= 0:
        fail("PackedSimulation did not launch both kernels")


# -- the general-mesh path ---------------------------------------------------------


def tet_setup(workdir: Path) -> dict:
    """The imported 35^3 tet mesh through write_gmsh/read_gmsh, its windowed
    geometry (float32, on the card) and its AMG hierarchy (V(3,3)), timed."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, read_gmsh, write_gmsh
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_amg, build_packed_problem

    t0 = time.perf_counter()
    written = imported_mesh(N_TET)
    path = workdir / "tet35.msh"
    write_gmsh(path, written)
    mesh = read_gmsh(path)
    io_s = time.perf_counter() - t0
    if not (np.array_equal(mesh.cells, written.cells) and np.array_equal(mesh.nodes, written.nodes)):
        fail("read_gmsh did not give back the mesh write_gmsh wrote")
    if mesh.structured_shape is not None:
        fail("the imported mesh carries structured metadata")
    V = FunctionSpace(mesh, 1, 3)
    bcs = bench_bcs(V)
    geos, models, state = build_packed_problem(
        V, VonMises3D(MAT), 2, device=CARD, dtype=torch.float32, engine="windowed"
    )
    geo = geos[0]
    if geo.N != N_QP_TET:
        fail(f"the tet bench has {geo.N} quadrature points, expected {N_QP_TET}")
    amg = build_amg(V, MU, KAPPA, free_mask(V, bcs), q_degree=2, nu=3,
                    node_perm=geo.ex.perm, device=CARD, dtype=torch.float32)
    return {"mesh": mesh, "V": V, "bcs": bcs, "geos": geos, "models": models,
            "state": state, "amg": amg, "io_s": io_s}


def phase_k4_k5(results: dict, tet: dict) -> None:
    from fenics_constitutive_tpu_torch.ops import cuda_window

    ex = tet["geos"][0].ex
    line = [f"plan T={ex.T} B={ex.B} C_B={ex.C_B} P={ex.P} Rn={ex.Rn} M_pad={ex.M_pad}"]
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(7)
        u2 = torch.as_tensor(rng.normal(size=(3, ex.M_pad)), dtype=dtype, device=CARD)
        f = torch.as_tensor(rng.normal(size=(ex.B, 3, ex.Rn)), dtype=dtype, device=CARD)
        g_k = cuda_window.windowed_gather(ex, u2)
        g_p = cuda_window.gather_plain(ex, u2)
        y1 = cuda_window.windowed_scatter(ex, f)
        y2 = cuda_window.windowed_scatter(ex, f)
        y_p = cuda_window.scatter_plain(ex, f)
        torch.cuda.synchronize()
        if not torch.equal(g_k, g_p):
            fail(f"K4 {dtype} is not bit-equal to its plain version")
        if not torch.equal(y1, y2):
            fail(f"K5 {dtype} differs between two launches")
        if not torch.isfinite(y1).all():
            fail("K5 returned non-finite values")
        err, rel = normwise(y1, y_p)
        tol = TOL_K5[dtype]
        line.append(f"{str(dtype)[6:]}: K4 bit-equal, K5 repeatable, K5 max_abs_err {err:.3e} "
                    f"rel {rel:.3e} (tol {tol:g})")
        if rel > tol:
            fail(f"K5 {dtype} disagrees with the plain version: rel {rel:.3e} > {tol:g}")
        if dtype == torch.float32:
            t = {
                "K4": (cuda_ms(lambda: cuda_window.windowed_gather(ex, u2)),
                       cuda_ms(lambda: cuda_window.gather_plain(ex, u2))),
                "K5": (cuda_ms(lambda: cuda_window.windowed_scatter(ex, f)),
                       cuda_ms(lambda: cuda_window.scatter_plain(ex, f))),
            }
            results["K4"] = {"max_abs_err": 0.0, "ms": t["K4"][0], "plain_ms": t["K4"][1]}
            results["K5"] = {"max_abs_err": err, "ms": t["K5"][0], "plain_ms": t["K5"][1]}
            line.append(f"f32 K4 {t['K4'][0]:.4f} ms vs plain {t['K4'][1]:.4f} ms, "
                        f"K5 {t['K5'][0]:.4f} ms vs plain {t['K5'][1]:.4f} ms")
    print("phase 7 K4/K5 vs plain on the 35^3 tet plan: " + "; ".join(line))


def phase_k6(results: dict, tet: dict) -> None:
    from fenics_constitutive_tpu_torch.ops import cuda_window

    amg = tet["amg"]
    ops = [(f"{name}{lvl}", getattr(amg, name + "_win")[lvl])
           for lvl in range(amg.n_levels - 1) for name in ("A", "P", "R")]
    worst, ms, plain_ms, parts = 0.0, 0.0, 0.0, []
    for label, w32 in ops:
        w64 = copy.deepcopy(w32).double()
        rng = np.random.default_rng(11)
        xh = rng.normal(size=w32.bc * w32.NC_pad)
        errs = []
        for w, dtype, passes in ((w32, torch.float32, 1), (w32, torch.float32, 3),
                                 (w64, torch.float64, 3)):
            x = torch.as_tensor(xh, dtype=dtype, device=CARD)
            saved, w.select_passes = w.select_passes, passes
            try:
                y_k = cuda_window.windowed_bsr_matvec(w, x)
                y_p = cuda_window.bsr_matvec_plain(w, x)
                torch.cuda.synchronize()
                if not torch.isfinite(y_k).all():
                    fail(f"K6 {label} returned non-finite values")
                err, rel = normwise(y_k, y_p)
                if rel > TOL_K6[dtype]:
                    fail(f"K6 {label} {dtype} select_passes={passes}: rel {rel:.3e} > "
                         f"{TOL_K6[dtype]:g}")
                errs.append(rel)
                if dtype == torch.float32 and passes == 1:
                    worst = max(worst, err)
                    k_ms = cuda_ms(lambda w=w, x=x: cuda_window.windowed_bsr_matvec(w, x))
                    p_ms = cuda_ms(lambda w=w, x=x: cuda_window.bsr_matvec_plain(w, x))
                    ms, plain_ms = ms + k_ms, plain_ms + p_ms
            finally:
                w.select_passes = saved
        parts.append(f"{label} ({w32.br}x{w32.bc} k {w32.k} B {w32.B} P {w32.P}) rel "
                     f"{errs[0]:.1e}/{errs[1]:.1e}/{errs[2]:.1e} {k_ms:.4f} ms vs plain {p_ms:.4f}")
    results["K6"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}
    print(f"phase 8 K6 vs plain on {len(ops)} AMG level operators (rel err f32 sel1/f32 sel3/f64; "
          f"tol f32 {TOL_K6[torch.float32]:g}, f64 {TOL_K6[torch.float64]:g}); f32 sel1 times: "
          + "; ".join(parts) + f"; one apply of every operator {ms:.4f} ms vs plain {plain_ms:.4f} ms")


def tet_step(geos, pc, fixed: int | None, **newton):
    from fenics_constitutive_tpu_torch.solver import make_packed_step

    opts = dict(max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5, cg_maxiter=500)
    opts.update(newton)
    return make_packed_step(geos, preconditioner=pc, cg_fixed_iters=fixed, **opts)


def tet_args(geo, bcs, dtype, device):
    from fenics_constitutive_tpu_torch.fem import combine_bcs

    bc_dofs, bc_vals = combine_bcs(bcs)
    return (
        torch.as_tensor(bc_dofs, dtype=torch.int64, device=device),
        torch.as_tensor(bc_vals, dtype=dtype, device=device),
        torch.zeros(geo.ndofs_int, dtype=dtype, device=device),  # internal f_ext
        1.0,
    )


def tet_reference() -> float:
    """5^3 shuffled tets, float64, converged Newton: kernels vs plain."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_amg, build_packed_problem

    V = FunctionSpace(imported_mesh(5), 1, 3)
    bcs = bench_bcs(V)
    outs = {}
    for device in (CARD, "cpu"):
        geos, models, state = build_packed_problem(
            V, VonMises3D(MAT), 2, device=device, dtype=torch.float64, engine="windowed"
        )
        amg = build_amg(V, MU, KAPPA, free_mask(V, bcs), nu=3, node_perm=geos[0].ex.perm,
                        device=device, dtype=torch.float64)
        step = tet_step(geos, amg.wrap_internal(geos[0].ex.M_pad), None, max_newton=8,
                        newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-10, cg_maxiter=300)
        args = tet_args(geos[0], bcs, torch.float64, device)
        st = state
        for k in (0.5, 1.0, 1.5, 2.0):
            st, _ = step(models, st, args[0], args[1] * k, *args[2:])
        outs[device] = st
    u_rel = normwise(outs[CARD].u.cpu(), outs["cpu"].u)[1]
    s_rel = normwise(outs[CARD].stress[0].cpu(), outs["cpu"].stress[0])[1]
    if float(outs["cpu"].histories[0]["alpha"].max()) <= 0:
        fail("the 5^3 tet reference never yields")
    return max(u_rel, s_rel)


def phase_tet_bench(tet: dict) -> dict:
    from fenics_constitutive_tpu_torch.ops import cuda_window

    ref_rel = tet_reference()
    print(f"phase 9 small reference 5^3 tets f64, converged Newton, kernels (card) vs plain "
          f"(CPU) after 4 load steps: max rel {ref_rel:.2e} (tol 1e-7)")
    if ref_rel > 1e-7:
        fail("the kernel tet step disagrees with the plain step at 5^3")

    geos, models, amg = tet["geos"], tet["models"], tet["amg"]
    geo = geos[0]
    pc = amg.wrap_internal(geo.ex.M_pad)
    args = tet_args(geo, tet["bcs"], torch.float32, CARD)
    step = tet_step(geos, pc, TET_FIXED)
    st = tet["state"]
    for k in (0.5, 1.0, 1.5, 2.0):  # warm-up, driven past yield
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    torch.cuda.synchronize()

    K = 10
    scales = [2.0 + 0.05 * (i + 1) for i in range(K)]
    for key in cuda_window.launches:
        cuda_window.launches[key] = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    out_state, probes = run_schedule(step, models, st.clone(), args, scales)
    ev1.record()
    ev1.synchronize()
    host_s = time.perf_counter() - h0
    counts = dict(cuda_window.launches)
    ms_step = ev0.elapsed_time(ev1) / K
    if not (torch.isfinite(probes).all() and torch.isfinite(out_state.u).all()):
        fail("tet bench run produced non-finite values")
    if out_state.stress[0].shape != (6, N_QP_TET):
        fail(f"tet bench stress has shape {tuple(out_state.stress[0].shape)}")
    r_settled = float(probes[-1])

    r = torch.as_tensor(np.random.default_rng(2).normal(size=geo.ndofs_int),
                        dtype=torch.float32, device=CARD)
    vcycle_ms = cuda_ms(lambda: pc(r), iters=10)
    refs = []
    for fk in TET_VERIFY:
        _, pr = run_schedule(tet_step(geos, pc, fk), models, st.clone(), args, scales)
        refs.append(float(pr[-1]))
    ok = r_settled <= R_NORM_ENVELOPE * refs[0] and refs[0] <= R_NORM_ENVELOPE * refs[1]
    bs_g, bs_a = geo.build_seconds, amg.build_seconds
    print(f"phase 9 tet bench 35^3 f32 ({N_QP_TET:,} QPs): {ms_step:.3f} ms/step over {K} steps "
          f"(CUDA events; host clock {host_s / K * 1e3:.3f} ms/step), settled r_norm "
          f"{r_settled:.4f} vs fixed-{TET_VERIFY[0]} {refs[0]:.4f} and fixed-{TET_VERIFY[1]} "
          f"{refs[1]:.4f} (envelope {R_NORM_ENVELOPE} each); setup s: gmsh write+read "
          f"{tet['io_s']:.2f}, RCM {bs_g['rcm']:.2f} + plan {bs_g['plan']:.2f}, geometry "
          f"{bs_g['geometry']:.2f}, AMG host build {bs_a['hierarchy']:.2f} + freeze "
          f"{bs_a['freeze']:.2f}, upload {bs_a['upload']:.2f}; AMG {amg.n_levels} levels; "
          f"launches K4 {counts['gather']} K5 {counts['scatter']} K6 {counts['bsr_matvec']}; "
          f"V-cycle {vcycle_ms:.3f} ms")
    if not ok:
        fail(f"settled r_norm {r_settled:.4f} is outside the {R_NORM_ENVELOPE} envelopes of "
             f"the deep re-runs {refs}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"the tet bench run never launched {name}")
    return counts


def phase_tet_simulation(tet: dict) -> None:
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_window
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V = FunctionSpace(tet["mesh"], 1, 3)
    bcs = bench_bcs(V)
    t0 = time.perf_counter()
    sim = PackedSimulation(
        VonMises3D(MAT), V, bcs, 2, dtype=torch.float32, device=CARD,
        newton_rtol=1e-6, newton_atol=1e-3, cg_rtol=1e-5, cg_maxiter=2000,
    )
    build_s = time.perf_counter() - t0
    if (sim.engine, sim.preconditioner) != ("windowed", "amg"):
        fail(f"PackedSimulation resolved to {sim.engine} + {sim.preconditioner}, "
             "expected windowed + amg")
    before = dict(cuda_window.launches)
    report = []
    for k in (1, 2, 3):
        bcs[1].value = 0.0004 * k
        t0 = time.perf_counter()
        niter, converged = sim.solve()
        torch.cuda.synchronize()
        st = sim.last_stats
        report.append(f"step {k}: newton {niter}, cg_last {int(st['cg_iters_last'])}, "
                      f"converged {converged}, r {st['r_norm']:.3e} (r0 {st['r0_norm']:.3e}), "
                      f"{time.perf_counter() - t0:.2f} s")
        if not converged:
            fail(f"PackedSimulation step {k} on the imported mesh did not converge: {st}")
    stress = sim.stress
    if stress.shape != (tet["mesh"].num_cells, 4, 6) or not np.isfinite(stress).all():
        fail(f"PackedSimulation stress has shape {stress.shape} or non-finite values")
    if sim.u.shape != (V.ndofs,) or not torch.isfinite(sim.u).all():
        fail("PackedSimulation displacement has the wrong shape or non-finite values")
    rise = {k: cuda_window.launches[k] - before[k] for k in before}
    print(f"phase 10 PackedSimulation on the imported 35^3 mesh f32 ({sim.engine} + "
          f"{sim.preconditioner}, build {build_s:.1f} s): " + "; ".join(report)
          + f"; kernel launches K4 +{rise['gather']} K5 +{rise['scatter']} "
          f"K6 +{rise['bsr_matvec']}")
    if min(rise.values()) <= 0:
        fail("PackedSimulation on the imported mesh did not launch K4, K5 and K6")


def timed(label: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"{label} took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> None:
    import fenics_constitutive_tpu_torch  # noqa: F401  (fails outside the repo)

    name, _ = phase_device()
    timed("phase 2", phase_build)
    results: dict = {}
    timed("phase 3", phase_k1, results)
    timed("phase 4", phase_k2, results)
    counts = timed("phase 5", phase_bench, results)
    timed("phase 6", phase_simulation)
    with tempfile.TemporaryDirectory() as tmp:
        tet = timed("tet setup", tet_setup, Path(tmp))
    timed("phase 7", phase_k4_k5, results, tet)
    timed("phase 8", phase_k6, results, tet)
    tet_counts = timed("phase 9", phase_tet_bench, tet)
    timed("phase 10", phase_tet_simulation, tet)
    src = "fenics_constitutive_tpu_torch/csrc/"
    kernels = [
        {"name": "fused_matvec", "route": "cuda", "source": src + "matvec.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_matvec.py:42",
         "launches": counts["K1"], **results["K1"]},
        {"name": "fused_eval", "route": "cuda", "source": src + "eval.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_eval.py:52",
         "launches": counts["K2"], **results["K2"]},
        {"name": "windowed_gather", "route": "cuda", "source": src + "window.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_window.py:89",
         "launches": tet_counts["gather"], **results["K4"]},
        {"name": "windowed_scatter", "route": "cuda", "source": src + "window.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_window.py:153",
         "launches": tet_counts["scatter"], **results["K5"]},
        {"name": "windowed_bsr_matvec", "route": "cuda", "source": src + "window.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_window.py:235",
         "launches": tet_counts["bsr_matvec"], **results["K6"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
