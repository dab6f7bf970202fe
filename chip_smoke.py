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

Then one JSON line of per-kernel results and, last, the device JSON line.
"""

from __future__ import annotations

import json
import subprocess
import time

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


def box(n: int):
    from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace, unit_cube_mesh

    V = FunctionSpace(unit_cube_mesh(n, n, n, "hex"), 1, 3)

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    bcs = [
        DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.004),
        DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0),
    ]
    return V, bcs


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

    for lib in ("matvec", "eval"):
        _cuda_build.load_library(lib)
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


def main() -> None:
    import fenics_constitutive_tpu_torch  # noqa: F401  (fails outside the repo)

    name, _ = phase_device()
    phase_build()
    results: dict = {}
    phase_k1(results)
    phase_k2(results)
    counts = phase_bench(results)
    phase_simulation()
    kernels = [
        {
            "name": "fused_matvec",
            "route": "cuda",
            "source": "fenics_constitutive_tpu_torch/csrc/matvec.cu",
            "replaces": "fenics_constitutive_tpu/ops/pallas_matvec.py:42",
            "launches": counts["K1"],
            **results["K1"],
        },
        {
            "name": "fused_eval",
            "route": "cuda",
            "source": "fenics_constitutive_tpu_torch/csrc/eval.cu",
            "replaces": "fenics_constitutive_tpu/ops/pallas_eval.py:52",
            "launches": counts["K2"],
            **results["K2"],
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
