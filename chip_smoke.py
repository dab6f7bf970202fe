"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line of what it found; any failure raises and
exits non-zero before the last line:

  1. device: the card (nvidia-smi name and power limit), torch and CUDA;
     there is no CPU path.
  2. build: compiles the four sources of ``fenics_constitutive_tpu_torch/csrc``
     (matvec, eval, window, smoother), one nvcc each, started together, and
     prints the build seconds and register use.
  3. K1, the fused CG operator (one launch that writes the node values),
     against its plain PyTorch version at the benchmark size (50^3 hexes,
     M = 51^3 flat nodes) with a plastic tangent, in float64 and float32,
     bit-equal across two launches; its call time, its kernel's time on the
     card (torch.profiler), its device ops per apply (must be 1), and a
     sweep of the node brick one block owns.
  4. K2, the fused VonMises3D eval + assembly (one cooperative launch that
     writes the new state and the residual's node values), against its plain
     version from a plastic pre-state, every output, float64 and float32, at
     50^3, on an 11 x 10 x 10 box and on a 3 x 2 x 400 box (z-lines longer
     than a block's run of nodes), bit-equal across two launches; its call
     time, its kernel's time on the card, its device ops per call (must be
     1), and a replay of one call from a CUDA graph, which must be
     bit-equal.
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
     across two launches; each call's time (CUDA events, back to back), its
     kernel's time on the card (torch.profiler) and the library call's, and
     the host's part of one K4 call beside the indexing call's.
  8. K6 (BSR SpMV on the plan's row layout) against its plain version on
     every A, P and R level of the mesh's AMG hierarchy: float32 with
     select_passes 1 and 3, and float64, two launches bit-equal; per-level
     errors, threads per row, times beside the plain version, a torch CSR
     product and the bound; then the sweep of 1-32 threads per row.
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

The fused multigrid smoothing chains (K3) and the box-mesh entry point
around them:

 11. K3 against its plain twins, float64 and float32, each call bit-equal
     across two launches: every chain of the 50^3 hierarchy (levels 0-3: the
     pre chain, nu sweeps and the residual, and the post chain, nu = 3 on
     level 0 and 2 below; level 4: the coarse chain of 20 sweeps, from a
     hierarchy without the direct coarse solve), one launch each; every entry
     of one fused V-cycle there (pre_restrict and prolong_post on the levels
     above the one-block tail, the tail) with its call time, kernel time on
     the card and bound; the same entries and the whole cycle on an
     11 x 10 x 10 box (non-nested transfers); the device ops of one fused
     V-cycle at 50^3 (torch.profiler; fails above 8); the fused V-cycle
     against the unfused one.
 12. phase 5's workload with fused_smoothing=True: the same warm-up and 48
     steps, the deep fixed-40 re-run with the same preconditioner, ms/step
     beside phase 5's, the V-cycle fused against unfused, K3 launches per
     entry.
 13. PackedSimulation on scripts/ab_multimat.py's two-law 50^3 box (linear
     elasticity below z = 0.5, VonMises3D above; float64, V-cycle with the
     K3 chains): solve_schedule over 3 steps of 0.0004 k, a checkpoint round
     trip into a second simulation (one more step on both, bit-equal), and a
     traction on the x = 1 face with symmetry planes and max_subdivisions=2.

Several laws on the imported mesh, and the whole model library:

 14. PackedSimulation on phase 9's imported 35^3 mesh with two laws, a
     viscoelastic layer over a frictional base: DruckerPrager3D (associated;
     the generic adapter, a dense tangent) on the cells with midpoint
     z < 0.5, SpringMaxwellModel (FULL, factored) above, with default
     options (it must resolve to the windowed engine and AMG), float64,
     del_t 0.5, solve_schedule over 3 steps of the stretch 0.0004 k; every
     step must converge, and K4, K5 and K6 must each launch. First K4 and K5
     on each law's own plan (its cells, B and Rn, the shared M_pad) against
     their plain versions in float64: K4 bit-equal, K5 within its normwise
     tolerance. Prints ms per
     step, Newton iterations, launches per step, the DP return map's trips,
     the device memory peak, and the parts of a step timed apart (each
     law's eval with its local Newton's active points per trip, the
     operator apply, the V-cycle, K4-K6 on the card).
 15. Every FULL law of the JAX package's production-path test on the card
     against the same run on the CPU (plain versions), float64, 2 steps of
     0.004 k: on a 6^3 shuffled tet mesh (windowed engine, AMG) and on a 6^3
     hex box, where the factored laws must launch K1 and Drucker-Prager
     must not; on the tets also phase 14's two laws (Drucker-Prager below
     z = 0.5, SpringMaxwellModel above), whose summed step must agree with
     its CPU run the same way; then DenseTangent.apply/quad_diag and
     jacobi_diag_gm in
     float32 must be bit-equal with TF32 on and off.

Every P1 mesh the JAX package accepts, on its own engine:

 16. the structured-tet engine on scripts/bench_tet.py's workload: a 35^3
     Kuhn tet box (structured_shape set; 1,029,000 QPs), VonMises3D, the
     bench's stretch, float32, max_newton=1, fixed-14 CG with V(3,3)
     multigrid (nu_coarse 2, direct coarsest solve) below the tet fine
     level: fused (K3 on the tet level and the hex levels below) and eager,
     each timed over 16 steps at 2.0 + 1e-4 + 0.05 i after warm-up scales
     0.5/1.0/1.5 and held to a fixed-40 re-run within 1.02x; K3's entries on
     the tet hierarchy against their plain twins; K1 and K2 never launch.
     Then PackedSimulation with two laws on the box (linear elasticity
     below z = 0.5, VonMises3D above), float64, the V-cycle with K3, 3
     converged steps of 0.0004 k.
 17. the gather engine with the AMG on phase 9's mesh: written with
     write_gmsh41_binary and read back (nodes, cells and cell sets equal to
     the ASCII read), PackedSimulation(engine="gather", preconditioner=
     "amg") (1,029,000 QPs unpadded; on the card its AMG levels are the
     windowed ones, which K6 applies), phase 9's protocol (fixed-3 PCG with
     AMG V(3,3), held to fixed-9 and fixed-18), one step run twice bit for
     bit, K6 launches a step, the set-up split (read, gather_idx, AMG host
     build, freeze, upload); the ELL levels of the same hierarchy
     (build_amg(spmv="ell")) beside the windowed ones: one V-cycle each on
     one vector, which must agree, and the same schedule; and the
     displacement and stress through write_vtu/read_vtu, bit-equal.
 18. small meshes on the card against the CPU, float64, 2 steps of 0.004 k
     with equal Newton counts and u and stress within 1e-10: a 6^3
     shuffled tet mesh ("auto" picks the gather engine), a bar of intervals
     with LinearElasticityModel UNIAXIAL_STRAIN and UNIAXIAL_STRESS and
     UniaxialStrainFrom3D(VonMises3D), the 6^3 hex box with the AMG
     (grid-major; K6 on the card, the ELL levels on the CPU), a 6^3 Kuhn
     box with two laws and the K3 V-cycle.

Degree 2, and the 2D boxes (every P2 mesh the JAX package accepts):

 19. the lattice engine on scripts/bench_p2.py's box: unit_cube_mesh(32, 32,
     32, "hex"), P2, q_degree 4 (884,736 QPs, 823,875 dofs), VonMises3D, the
     bench's stretch of 0.004 on x = 1 with the three symmetry planes,
     float32: (a) the lattice strain, residual and operator on a plastic
     tangent held normwise within 1e-5 of the gather engine on the same
     space, the residual bit-equal across two calls, ms per apply of both;
     (b) bench_p2's protocol, one Newton iteration from the zero state with
     CG at rtol 1e-5 (maxiter 250) preconditioned by the V-cycle on the
     refined P1 grid (65^3 nodes), eager (build_multigrid's defaults) and
     through PackedSimulation(preconditioner="vcycle", mg_options=
     {"fused_smoothing": True}) with K3, 5 timed steps at 0.004 (1 + 1e-4
     k): ms/step, CG iterations, r/r0, and the settled r_norm within 1.02x
     of the same step in float64; K3 launches per step (> 0 fused), K1 and
     K2 never; (c) PackedSimulation converges 3 steps of 0.0004 k (float64).
 20. K3 on quad levels: every chain and every fused V-cycle entry of the
     unit_square_mesh(512, 512, "quad") P1 hierarchy (PLANE_STRAIN,
     1,048,576 QPs) and of the 512^2 Kuhn triangle box's hierarchy (quad
     levels below the triangle level) against their plain twins, float64 and
     float32, bit-equal across two launches, the fused V-cycle against the
     eager one, the quad entries' times beside their bound; then
     PackedSimulation on the P2 quad lattice at 256 x 256 (q_degree 4,
     589,824 QPs) with plane-strain linear elasticity and the fused
     refined-P1 V-cycle, float64, 3 converged steps of 0.0004 k.
 21. P2 on an imported mesh: a shuffled 20^3 Kuhn tet box (48,000 tets,
     68,921 dof nodes, 192,000 QPs) through write_gmsh/read_gmsh,
     PackedSimulation with default options (windowed engine, AMG V(3,3)),
     float32; K4 and K5 against their twins on the P2 plan, K6 on every AMG
     operator; phase 9's protocol (fixed-3 PCG held to fixed-9 and fixed-18
     within 1.02x) with ms/step and the set-up split; 2 converged steps.

The reference-parity path (IncrSmallStrainProblem, make_load_step, the AoS
assembly, norms, sensors, checkpoints and the native-model bridge):

 22. (a) phase 9's imported 35^3 mesh (read back through read_gmsh), float64,
     VonMises3D, 2 steps of the stretch 0.0004 k with Newton rtol 1e-10,
     atol 1e-8 and CG rtol 1e-10: IncrSmallStrainProblem on the packed
     engine (it must resolve to the windowed one) and on the AoS engine, both
     preconditioned by ONE AMG hierarchy built with spmv="windowed" and
     passed as a callable, and PackedSimulation with default options. Every
     step converges; u and stress of the three agree within 1e-6 normwise,
     Newton counts within one; the AoS residual is bit-equal across two
     calls (no atomics); K4, K5 and K6 launch on the packed problem's steps
     and K1, K2 and K3 never. Prints ms per step, Newton and CG iterations,
     the AMG host build, the set-up and the device memory peak of each run.
     (b) a 4^3 hex box (structured engine, Jacobi) and a shuffled 6^3 tet
     mesh (gather engine, "amg"), float64, both engines with one law and
     with two laws on cell subsets, and make_load_step: on the card against
     the CPU, equal Newton counts and u and stress within 1e-10; a
     DisplacementSensor, a QPSensor and norm() of the stress likewise; a
     checkpoint round trip into a second problem that continues bit-equal;
     then the native bridge (built with c++/cc): LinearElasticity3D, the
     native linear-hardening Mises law and the C UMAT in a problem on the
     card, each within 1e-10 of the port's own model.

Sharding (parallel/, torch.distributed):

 23. (a) phase 22's packed problem (phase 9's mesh, written with
     write_gmsh41_binary and read by every rank, f64, 2 steps of 0.0004 k,
     Newton and CG rtol 1e-10, the same AMG built by every rank) sharded with
     shard_problem over 2 gloo ranks spawned on the one card, timed after an
     untimed run of its first load in the same rank: Newton and CG
     counts equal to phase 22's, u and stress_0 within 1e-12 of it, the ranks'
     u bit-equal, K4, K5 and K6 launched by every rank, and after the steps
     each rank holds K4 (bit-equal) and K5 (repeatable, within TOL_K5) to
     their plain versions on its own plan, in f64 and f32; per rank ms/step,
     set-up, the memory peaks, its QP state, its all-reduces and the time of
     one all_reduce of the internal vector. The same run in this process on
     a 1-rank group, through the same wrappers (the same checks), after an
     unsharded run (phase 22's AMG for both), splits the 2-rank step's time:
     the wrappers and all-reduces against the second process on the card.
     (b) in the 2 ranks, the reference's MPI test
     problem (4x6x7 tets, AoS engine, 10 steps at Newton rtol 1e-14) within
     1e-14 and the 7^3 hex box with linear hardening (structured slabs)
     within 1e-12 of the card's one-process runs. (c) dryrun_multichip(2,
     device="cuda"), first, while the card's one-process runs of (b) are
     taken. A rank's exception, or a rank that does not end within the
     process group's timeout, fails the phase.

The user layer (the examples on the port, examples/torch/):

 24. (a) the five examples run as a user runs them, `python
     examples/torch/<name>/run_example.py <dir>` on the card, all at once;
     each must exit 0 (through its own checks), and their lines are
     printed. (b) creep_neumann's main() at 50^3 hexes, q 2 (1,000,000
     QPs, 397,953 dofs), f64, PackedSimulation with the V-cycle and its K3
     chains, K1 for the CG operator on the SpringKelvinModel tangent: the
     instant step and the 40 creep steps (5 windows of 8, the first a
     warm-up) must meet the closed form (sigma/E0 within 1e-8, sigma/E0 +
     sigma/E1 within 1e-6); K1 and every K3 entry must launch; then K1 on
     the run's own tangent and the run's whole fused V-cycle against their
     plain versions (f64, bit-equal across two launches). Prints ms/step
     (median, min and max of the timed windows), set-up seconds and the
     device memory peak above what earlier phases hold. (c) mises_c's
     main() at 32^3 hexes (262,144 QPs, f64) for its first 3 load steps:
     per eval the C library's ms (host clock) and the host<->device
     copies' ms (CUDA events around each side), ms per step with its
     Newton and CG iterations.

A kernel's time on the card and a device-op count come from torch.profiler.
CUPTI now and then delivers a short profile on the H100, so such a profile
is taken again, three times in all; after that the time is taken by CUDA
events behind a sleep kernel (gated_ms) and the ops other than the port's
kernels are counted as aten ops (aten_device_ops). A line before the JSON
says how often that happened.

Then one JSON line of per-kernel results (launches on the path's run, for
K3 also on phase 16's tet run, phase 19's fused P2 steps and phase 20's P2
quad steps, for K4-K6 also on phase 14's 3-step run and phase 21's timed
run, for K6 also on phase 17's timed run, for every kernel on phase 22's
packed problem (0 for K1-K3), for K4-K6 per rank on phase 23's sharded
run, for K1 and K3 on phase 24's full-width creep run, times, plain and
library times,
the bound; for K3 also the quad entries' numbers) and, last, the device
JSON line.

    python3 chip_smoke.py --profile

instead profiles 3 steps each of the bench workload with the unfused and
the fused V-cycle, the general-tet bench, phase 16's Kuhn box (fused and
eager) and phase 17's gather engine (torch.profiler: device time per step,
busy share, device ops per step, the costliest kernels), and prints no
JSON.

    python3 chip_smoke.py --profiler-check

instead counts the short profiles torch.profiler delivers for the fused
V-cycle's K3 entries, compares their times by the profiler and by gated_ms,
and counts one V-cycle's device ops both ways, and prints no JSON.

    python3 chip_smoke.py --ab PARENT CHANGE

runs phases 3, 4, 11 and 12, the box profile, and phases 7-9 from two
checkouts of the repository (e.g. `git archive`s of the parent commit and of
the change) in turns, parent, change, change, parent, each in its own
process on the same card, and prints no JSON.
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

N_MULTIMAT = 50  # the two-law box of phase 13
TRACTION = 600.0  # phase 13's x = 1 face load: elastic in both laws

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


# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, and
# operations/s outside the tensor cores per working type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def host_us(fn, iters: int = 500) -> float:
    """Mean host time of fn() in us: what the host spends issuing one call
    (the loop does not wait for the card, whose queue takes the launches)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


def device_events(prof) -> list:
    """The device-side rows of a profile (kernels, copies): the aten rows
    that launched them carry the same device time again."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


#: profiles that torch.profiler delivered empty or short, and the measures
#: that fell back to another clock or count for that reason (printed at the end)
PROFILER_MISSES = {"profiles": 0, "fallbacks": 0}


def profiled(fn, iters: int, complete=bool, tries: int = 3):
    """The device events of a profile of `iters` calls of fn(), or None.

    CUPTI now and then delivers a short profile on the H100 (no device event
    at all, or fewer kernel events than launches; ``--profiler-check``
    counts them), once three empty ones in a row. So a profile for which
    ``complete(events)`` is false is taken again after a pause, `tries`
    times in all."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        time.sleep(0.2 * attempt * attempt)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = device_events(prof)
        if complete(evs):
            return evs
        PROFILER_MISSES["profiles"] += 1
    return None


def gated_ms(fn, iters: int = 20) -> float:
    """Mean device time of fn() in ms by CUDA events, with the launch path
    hidden: a sleep kernel holds the stream while the host queues the events
    and the calls, so the card runs them back to back. (On the H100 it reads
    within 1.5 us per call of the profiler's kernel time.)"""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * host_s + 1e-3)))  # ~2 GHz clock: twice the host time
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, floor_ms: float = 0.0) -> float:
    """Mean device time of fn() in ms: the kernels it ran on the card, by
    torch.profiler (the launch path on the host is not in it). A profile in
    which some kernel's event count is not a multiple of `iters` is short
    (CUPTI dropped events) and is taken again; where three were short, or
    the reading lies below ``floor_ms`` (the call's bound), gated_ms
    measures instead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = profiled(fn, iters, lambda evs: bool(evs) and all(e.count % iters == 0 for e in evs))
    ms = None if evs is None else sum(e.self_device_time_total for e in evs) / 1e3 / iters
    if ms is None or ms < floor_ms:
        PROFILER_MISSES["fallbacks"] += 1
        return gated_ms(fn, iters)
    return ms


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

    libs = ("matvec", "eval", "window", "smoother")
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


#: the node bricks phase 3 sweeps (b0 x b1 x b2, z fastest)
K1_BRICKS = ((8, 8, 13), (4, 8, 13), (4, 4, 13), (4, 4, 17), (4, 8, 17), (8, 4, 17))


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
        r_k, r_k2 = mv(v, tg), mv(v, tg)
        torch.cuda.synchronize()
        r_p = cuda_matvec.matvec_plain(geo, v, tg)
        if not torch.isfinite(r_k).all():
            fail("K1 returned non-finite values")
        if not torch.equal(r_k, r_k2):
            fail(f"K1 {dtype} differs between two launches")
        err, rel = normwise(r_k, r_p)
        line.append(f"{str(dtype)[6:]} max_abs_err {err:.3e} rel {rel:.3e} (tol {tol:g}), "
                    "bit-equal across two launches")
        if rel > tol:
            fail(f"K1 {dtype} disagrees with the plain version: rel {rel:.3e} > {tol:g}")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: mv(v, tg))
            dev = device_ms(lambda: mv(v, tg))
            k1_launches, others, counted = kernel_ops(lambda: mv(v, tg), cuda_matvec,
                                                      ("matvec_kernel",))
            ops = k1_launches + others
            plain_ms = cuda_ms(lambda: cuda_matvec.matvec_plain(geo, v, tg))
            # u -> r: u, beta, gamma [8, M], n [48, M], mask in; r out. Per
            # valid cell the strain and divergence products (2 x 1152
            # multiply-adds) and ~40 operations per Gauss point for the tangent
            M, cells = geo.M, float(geo.mask.sum())
            bound, by = bound_ms(4 * (3 + 8 + 8 + 48 + 1 + 3) * M,
                                 cells * (4 * 1152 + 8 * 40) + 21 * M, dtype)
            results["K1"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by, "library_ms": None,
                             "device_ms": dev, "device_ops": ops}
            line.append(f"f32 {ms:.4f} ms/apply (kernel on the card {dev:.4f}, {ops:g} device "
                        f"ops per apply, other ops by the {counted}) vs plain {plain_ms:.4f} ms "
                        f"(bound {bound:.4f} ms, {by})")
            if ops != 1:
                fail(f"K1 takes {ops:g} device ops per apply, expected 1")
        # the node bricks of one block, each checked: kernel ms on the card
        sweep = {}
        for b in K1_BRICKS:
            mv_b = cuda_matvec.build_cuda_matvec(geo, brick_nodes=b)
            if normwise(mv_b(v, tg), r_p)[1] > tol:
                fail(f"K1 {dtype} with the brick {b} disagrees with the plain version")
            sweep[b] = device_ms(lambda mv_b=mv_b: mv_b(v, tg), iters=10)
        rule = cuda_matvec.brick((geo.grid[0] + 1, geo.grid[1] + 1, geo.grid[2] + 1))
        line.append(f"{str(dtype)[6:]} brick sweep, kernel ms on the card (rule {rule}, best "
                    f"{min(sweep, key=sweep.get)}): "
                    + ", ".join(f"{'x'.join(map(str, b))} {t:.4f}" for b, t in sweep.items()))
    print("phase 3 K1 vs plain at 50^3: " + "; ".join(line))


def k2_case(V, law, dtype, seed: int):
    """A K2 input on V's box: a plastic pre-state (one plain eval from zero)
    and an increment, their nodal amplitudes scaled by the cell size h so
    that the strains are a few percent, past yield (7.2e-4 and 2.4e-4 on
    h = 1/50). Returns (geometry, (du, stress, history))."""
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry

    geo = build_structured_geometry(V, 2, Constraint.FULL, device="cuda", dtype=dtype)
    h = 1.0 / max(geo.grid)
    rng = np.random.default_rng(seed)
    sig1, _, hist1 = plastic_tangent(geo, law, rng, 0.036 * h)
    if float(hist1["alpha"].max()) <= 0:
        fail("K2 pre-state is not plastic")
    du = torch.as_tensor(rng.normal(size=V.ndofs) * 0.012 * h, dtype=dtype, device="cuda")
    return geo, (du, sig1, hist1)


def k2_outputs(out) -> dict:
    """K2's outputs by name."""
    r, stress, (beta, gamma, n), hist = out
    return {"r": r, "stress": stress, "beta": beta, "gamma": gamma, "n": n,
            "eps_n": hist["eps_n"], "alpha": hist["alpha"]}


def check_k2(label: str, fused, args, ref, dtype, tol) -> dict:
    """K2 against the plain outputs ``ref``: every output finite, of the plain
    shape, bit-equal across two launches and within tol normwise. Returns
    {output: (max abs error, rel)}."""
    got, again, want = k2_outputs(fused(*args)), k2_outputs(fused(*args)), k2_outputs(ref)
    torch.cuda.synchronize()
    errs = {}
    for name, b in want.items():
        a = got[name]
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"K2 {label} {dtype} {name}: shape {tuple(a.shape)} vs {tuple(b.shape)} or "
                 "non-finite values")
        if not torch.equal(a, again[name]):
            fail(f"K2 {label} {dtype} {name} differs between two launches")
        errs[name] = normwise(a, b)
        if errs[name][1] > tol:
            fail(f"K2 {label} {dtype} {name} disagrees with the plain version: rel "
                 f"{errs[name][1]:.3e} > {tol:g}")
    return errs


def k2_graph_replay(fused, args) -> str:
    """Capture one K2 call (a cooperative launch) in a CUDA graph and replay
    it: the replay must be bit-equal to a direct launch. A capture or a
    replay that fails fails the phase: a graph of the whole step rests on
    it."""
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fused(*args)  # warm-up on the capture stream, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
            out_g = fused(*args)
        torch.cuda.current_stream().wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as err:
        fail(f"K2 in a CUDA graph: capture or replay failed: {err}")
    again = k2_outputs(fused(*args))
    if not all(torch.equal(a, again[k]) for k, a in k2_outputs(out_g).items()):
        fail("K2 replayed from a CUDA graph differs from a direct launch")
    return "one call captured in a CUDA graph replays bit-equal"


#: K2's small boxes (cells): brick edges in every direction, and z-lines of
#: 401 nodes, longer than the 256-node run a block sums at a time plus one,
#: whose two windows skip the cells between their two planes
K2_BOXES = ((11, 10, 10), (3, 2, 400))


def phase_k2(results: dict) -> None:
    """K2 against its plain version, every output, float64 and float32: on
    the 50^3 box and the K2_BOXES, two launches bit-equal; its call time,
    its kernel's time on the card, its device ops per call (must be 1) and
    a replay of one call captured in a CUDA graph (float32)."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_eval

    V, _ = box(N_BENCH)
    law = VonMises3D(MAT)
    small = {"x".join(map(str, c)): FunctionSpace(unit_cube_mesh(*c, "hex"), 1, 3)
             for c in K2_BOXES}
    for dtype, tol in ((torch.float64, TOL_F64_K2), (torch.float32, TOL_F32_K2)):
        name = str(dtype)[6:]
        geo, args = k2_case(V, law, dtype, 0)
        fused = cuda_eval.build_cuda_eval(geo, law)
        ref = cuda_eval.eval_plain(geo, law, *args)
        errs = check_k2("50^3", fused, args, ref, dtype, tol)
        plastic = float((ref[3]["alpha"] > args[2]["alpha"]).double().mean())
        line = [f"50^3 (plastic share {plastic:.3f}) rel err per output: "
                + ", ".join(f"{k} {rel:.2e}" for k, (_, rel) in errs.items())]
        for seed, (label, V_s) in enumerate(small.items(), start=5):
            geo_s, args_s = k2_case(V_s, law, dtype, seed)
            ref_s = cuda_eval.eval_plain(geo_s, law, *args_s)
            errs_s = check_k2(label, cuda_eval.build_cuda_eval(geo_s, law), args_s, ref_s,
                              dtype, tol)
            line.append(f"{label} (nodes {'x'.join(str(g + 1) for g in geo_s.grid)}) worst rel "
                        f"{max(rel for _, rel in errs_s.values()):.2e}")
        if dtype == torch.float32:
            ms = cuda_ms(lambda: fused(*args))
            dev = device_ms(lambda: fused(*args))
            k2_launches, others, counted = kernel_ops(lambda: fused(*args), cuda_eval,
                                                      ("eval_kernel",))
            ops = k2_launches + others
            plain_ms = cuda_ms(lambda: cuda_eval.eval_plain(geo, law, *args))
            # du 3, stress 48, eps_n 48, alpha 8, mask 1 in; r 3, stress 48,
            # eps_n 48, n 48, alpha 8, beta 8, gamma 8 out: 279 M values.
            # Operations: per valid cell the gradient-structured strain and
            # divergence (2 x 576 multiply-adds) and ~100 per Gauss point for
            # the trial state, not counting the local Newton trips; the node
            # sums (a lower bound)
            M, cells = geo.M, float(geo.mask.sum())
            bound, by = bound_ms(4 * 279 * M, cells * (4 * 576 + 8 * 100) + 21 * M, dtype)
            results["K2"] = {"max_abs_err": errs["r"][0], "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound, "bound_by": by, "library_ms": None,
                             "device_ms": dev, "device_ops": ops}
            line.append(f"f32 {ms:.4f} ms/call (kernel on the card {dev:.4f}, {ops:g} device ops "
                        f"per call, other ops by the {counted}) vs plain {plain_ms:.4f} ms (bound "
                        f"{bound:.4f} ms, {by})")
            if ops != 1:
                fail(f"K2 takes {ops:g} device ops per call, expected 1")
            line.append(k2_graph_replay(fused, args))
        else:
            line.append(f"f64 kernel on the card {device_ms(lambda: fused(*args)):.4f} ms")
        print(f"phase 4 K2 vs plain {name} (tol {tol:g}; every output bit-equal across two "
              f"launches): " + "; ".join(line))


def bench_setup(n: int, dtype, device, fused: bool = False):
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
        nu=3, nu_coarse=2, coarse_direct=True, fused_smoothing=fused,
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
    reset_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    out_state, probes = run_schedule(step, models, st.clone(), args, scales)
    ev1.record()
    ev1.synchronize()
    host_s = time.perf_counter() - h0
    counts = {k: v for k, v in read_counts().items() if not k.startswith("K3")}
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

    box_mg = mg
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
    return {"counts": counts, "ms_step": ms_step, "vcycle_ms": vcycle_ms, "mg": box_mg}


def reset_counts() -> None:
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec, cuda_smoother

    cuda_matvec.launches = cuda_eval.launches = cuda_smoother.launches = 0
    for key in cuda_smoother.entry_launches:
        cuda_smoother.entry_launches[key] = 0


def read_counts() -> dict:
    """K1-K3 launches since reset_counts(), and K3's per V-cycle entry."""
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec, cuda_smoother

    return {"K1": cuda_matvec.launches, "K2": cuda_eval.launches, "K3": cuda_smoother.launches,
            **{f"K3_{kind}": cuda_smoother.entry_launches[kind] for kind in K3_ENTRIES}}


def phase_bench_fused(box_bench: dict) -> dict:
    """Phase 5's workload with the K3 chains on every level of the V-cycle."""
    geos, models, state, mg, args = bench_setup(N_BENCH, torch.float32, "cuda", fused=True)
    step = bench_step(geos, mg, 9, "kernel")
    st = state
    for k in (0.5, 1.0, 1.5):  # warm-up, driven past yield
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    torch.cuda.synchronize()

    K, j = 48, 1
    scales = [2.0 + 1e-4 * j + 0.05 * i for i in range(K)]
    reset_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out_state, probes = run_schedule(step, models, st.clone(), args, scales)
    ev1.record()
    ev1.synchronize()
    counts = read_counts()
    ms_step = ev0.elapsed_time(ev1) / K
    if not (torch.isfinite(probes).all() and torch.isfinite(out_state.u).all()):
        fail("fused bench run produced non-finite values")
    r_settled = float(probes[-1])

    # V-cycle alone, fused and unfused in turns (A B B A)
    mg_plain = box_bench["mg"]
    r = torch.as_tensor(np.random.default_rng(2).normal(size=geos[0].ndofs),
                        dtype=torch.float32, device="cuda")
    t_f1, t_p1 = cuda_ms(lambda: mg(r), iters=10), cuda_ms(lambda: mg_plain(r), iters=10)
    t_p2, t_f2 = cuda_ms(lambda: mg_plain(r), iters=10), cuda_ms(lambda: mg(r), iters=10)
    _, probes_ref = run_schedule(bench_step(geos, mg, 40, "kernel"), models, st.clone(),
                                 args, scales)
    r_ref = float(probes_ref[-1])
    print(f"phase 12 bench 50^3 f32 with the fused V-cycle: {ms_step:.3f} ms/step over {K} "
          f"steps (phase 5, unfused, same call: {box_bench['ms_step']:.3f} ms/step), r_norm "
          f"{r_settled:.4f} vs deep fixed-40 {r_ref:.4f} (envelope {R_NORM_ENVELOPE}); V-cycle "
          f"fused {t_f1:.3f}/{t_f2:.3f} ms vs unfused {t_p1:.3f}/{t_p2:.3f} ms; launches "
          f"K1 {counts['K1']} K2 {counts['K2']} K3 {counts['K3']} ("
          + ", ".join(f"{kind} {counts['K3_' + kind]}" for kind in K3_ENTRIES) + ")")
    if r_settled > R_NORM_ENVELOPE * r_ref:
        fail(f"fused settled r_norm {r_settled:.4f} exceeds {R_NORM_ENVELOPE} x {r_ref:.4f}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"the fused bench run never launched {name}")
    return {"counts": counts, "ms_step": ms_step}


def multimat_sim(V, bcs, **kw):
    """scripts/ab_multimat.py's split of the box: linear elasticity below
    z = 0.5, VonMises3D above; float64, the V-cycle with the K3 chains."""
    from fenics_constitutive_tpu_torch.models import (
        Constraint,
        LinearElasticityModel,
        VonMises3D,
    )
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    mid = V.mesh.cell_midpoints()
    laws = [
        (LinearElasticityModel({"E": 150000.0, "nu": 0.3}, Constraint.FULL),
         np.flatnonzero(mid[:, 2] < 0.5)),
        (VonMises3D(MAT), np.flatnonzero(mid[:, 2] >= 0.5)),
    ]
    return PackedSimulation(laws, V, bcs, 2, preconditioner="vcycle",
                            mg_options={"fused_smoothing": True}, device="cuda",
                            dtype=torch.float64, **kw)


def phase_multimat(workdir: Path) -> dict:
    """The entry point on the two-law box: a schedule, a checkpoint round
    trip, and a Neumann load with substepping."""
    from fenics_constitutive_tpu_torch.fem import (
        DirichletBC,
        assemble_facet_traction,
        combine_bcs,
        locate_boundary_facets,
    )
    from fenics_constitutive_tpu_torch.utils import load_checkpoint, save_checkpoint

    V, bcs = box(N_MULTIMAT)
    t0 = time.perf_counter()
    sim = multimat_sim(V, bcs)
    build_s = time.perf_counter() - t0
    vals = []
    for k in (1, 2, 3):
        bcs[1].value = 0.0004 * k
        vals.append(combine_bcs(bcs)[1])
    reset_counts()
    t0 = time.perf_counter()
    stats = sim.solve_schedule(np.stack(vals))
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    if not stats["converged"].all():
        fail(f"multi-material solve_schedule did not converge: {stats}")
    if sim.histories[0] is not None or float(sim.histories[1]["alpha"].max()) < 0:
        fail("multi-material histories have the wrong structure")

    # checkpoint round trip into a second simulation, then one more step on both
    path = workdir / "multimat.npz"
    save_checkpoint(path, sim.state_dict())
    sim2 = multimat_sim(V, bcs)
    sim2.load_state_dict(load_checkpoint(path))
    bcs[1].value = 0.0016
    res = [s.solve() for s in (sim, sim2)]
    torch.cuda.synchronize()
    if not (res[0][1] and res[1][1]) or res[0][0] != res[1][0]:
        fail(f"the step after the checkpoint round trip: {res}")
    bit_equal = torch.equal(sim.state.u, sim2.state.u) and all(
        torch.equal(a, b) for a, b in zip(sim.state.stress, sim2.state.stress))
    rel = max(normwise(a, b)[1] for a, b in
              zip((sim.state.u, *sim.state.stress), (sim2.state.u, *sim2.state.stress)))
    if rel > 1e-14:
        fail(f"restored simulation differs from the original by {rel:.2e}")
    stress = sim.stress
    if stress.shape != (N_MULTIMAT**3, 8, 6) or not np.isfinite(stress).all():
        fail(f"multi-material stress has shape {stress.shape} or non-finite values")

    # symmetry planes only, a traction on the x = 1 face, substepping allowed
    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    sym = [DirichletBC(V.locate_dofs_geometrical(close(a, 0.0), component=a), 0.0)
           for a in range(3)]
    traction = assemble_facet_traction(V, locate_boundary_facets(V.mesh, close(0, 1.0)),
                                       np.array([TRACTION, 0.0, 0.0]))
    sim3 = multimat_sim(V, sym, f_ext=traction, max_subdivisions=2)
    niter3, conv3 = sim3.solve()
    torch.cuda.synchronize()
    counts = read_counts()
    ux = sim3.u.reshape(-1, 3)[:, 0].cpu().numpy()[np.isclose(V.dof_coords[:, 0], 1.0)]
    print(f"phase 13 PackedSimulation on the two-law {N_MULTIMAT}^3 box f64 (vcycle, fused "
          f"smoothing; build {build_s:.1f} s): solve_schedule 3 steps of 0.0004 k in "
          f"{sched_s:.2f} s, newton {stats['newton_iters'].tolist()}, r "
          + ", ".join(f"{r:.2e}" for r in stats["r_norm"])
          + f"; checkpoint round trip then one step on both: newton {res[0][0]}, "
          f"{'bit-equal' if bit_equal else f'max rel {rel:.2e}'}; traction {TRACTION:g} on "
          f"x = 1 with max_subdivisions=2: newton {niter3}, converged {conv3}, mean u_x "
          f"there {ux.mean():.4e}; launches K1 {counts['K1']} K2 {counts['K2']} K3 "
          f"{counts['K3']}")
    if not conv3 or not ux.mean() > 0:
        fail("the traction step did not converge to a stretched box")
    if counts["K3"] <= 0:
        fail("the multi-material simulation never launched K3")
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
    amg = build_amg(V, MU, KAPPA, free_mask(V, bcs), q_degree=2, nu=3, spmv="windowed",
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
            # the library yardsticks: one indexing of the zero-padded node
            # rows (K4) and one index_add_ (K5), index vectors made beforehand
            gi = ex._global_idx()
            gi_flat = gi.reshape(-1)
            u_ext = torch.cat([u2, u2.new_zeros((3, 1))], dim=1)
            f_rows = f.permute(1, 0, 2).reshape(3, -1).contiguous()
            acc = f.new_zeros((3, ex.M_pad + 1))
            calls = {
                "K4": (lambda: cuda_window.windowed_gather(ex, u2),
                       lambda: cuda_window.gather_plain(ex, u2), lambda: u_ext[:, gi]),
                "K5": (lambda: cuda_window.windowed_scatter(ex, f),
                       lambda: cuda_window.scatter_plain(ex, f),
                       lambda: acc.index_add_(1, gi_flat, f_rows)),
            }
            # bytes only: u2 (or f) and the plan's indices read, the rows written
            rows = ex.B * 3 * ex.Rn * 4
            idx5 = (ex.node_ptr.numel() * ex.node_ptr.element_size()
                    + ex.node_rows.numel() * ex.node_rows.element_size())
            bounds = {
                "K4": bound_ms(u2.numel() * 4 + ex.loc.numel() * ex.loc.element_size() + rows,
                               0.0, dtype),
                "K5": bound_ms(rows + idx5 + 3 * ex.M_pad * 4, 3.0 * ex.node_rows.numel(),
                               dtype),
            }
            errs = {"K4": 0.0, "K5": err}
            for key, (kernel, plain, lib) in calls.items():
                # CUDA events time the calls back to back (host launch path
                # included); the profiler times the kernels alone
                ms, dev = cuda_ms(kernel), device_ms(kernel)
                lib_ms, lib_dev = cuda_ms(lib), device_ms(lib)
                plain_ms = cuda_ms(plain)
                b, by = bounds[key]
                results[key] = {"max_abs_err": errs[key], "ms": ms, "plain_ms": plain_ms,
                                "bound_ms": b, "bound_by": by, "library_ms": lib_ms,
                                "device_ms": dev}
                line.append(f"f32 {key} {ms:.4f} ms/call (kernel on the card {dev:.4f}) vs "
                            f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} (on the card "
                            f"{lib_dev:.4f}), bound {b:.4f} ({by})")
            # the host's part of one K4 call, against the indexing call's
            entry = cuda_window._entry("gather", dtype)
            out = cuda_window.windowed_gather(ex, u2)
            stream = torch._C._cuda_getCurrentRawStream(u2.get_device())
            args = (u2.data_ptr(), ex.loc.data_ptr(), out.data_ptr(), 3, ex.B, ex.Rn, ex.T,
                    ex.M_pad, stream)
            h = {"call": host_us(lambda: cuda_window.windowed_gather(ex, u2)),
                 "alloc": host_us(lambda: u2.new_empty((ex.B, 3, ex.Rn))),
                 "launch": host_us(lambda: entry(*args)),
                 "index": host_us(lambda: u_ext[:, gi])}
            line.append(f"K4 host us per call: {h['call']:.2f} (output allocation "
                        f"{h['alloc']:.2f}, bare ctypes launch {h['launch']:.2f}, checks and "
                        f"the rest {h['call'] - h['alloc'] - h['launch']:.2f}); indexing call "
                        f"{h['index']:.2f}")
    print("phase 7 K4/K5 vs plain on the 35^3 tet plan: " + "; ".join(line))


LANES = (1, 2, 4, 8, 16, 32)


def k6_cost(w) -> tuple[float, float]:
    """(bytes, flops) of one K6 apply: the row layout (row_ptr, col, blk) and
    x read once, y written once; two operations per block entry."""
    size = w.blk.element_size()
    nnzb = w.col.numel()
    nbytes = ((w.NR_pad + 1 + nnzb) * 4
              + (nnzb * w.br * w.bc + w.bc * w.NC_pad + w.br * w.NR_pad) * size)
    return nbytes, 2.0 * nnzb * w.br * w.bc


def phase_k6(results: dict, tet: dict) -> None:
    """K6 against its plain version on every A, P and R operator of the AMG
    hierarchy (f32 with select_passes 1 and 3, f64; two launches bit-equal),
    its time beside the plain version, the CSR product and the bound, and
    the sweep of threads per row."""
    from fenics_constitutive_tpu_torch.ops import cuda_window

    amg = tet["amg"]
    ops = [(f"{name}{lvl}", getattr(amg, name + "_win")[lvl])
           for lvl in range(amg.n_levels - 1) for name in ("A", "P", "R")]
    tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms"), 0.0)
    worst, parts, sweeps = 0.0, [], []
    bnd_bytes = bnd_flops = 0.0
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
                y_k2 = cuda_window.windowed_bsr_matvec(w, x)
                y_p = cuda_window.bsr_matvec_plain(w, x)
                torch.cuda.synchronize()
                if not torch.isfinite(y_k).all():
                    fail(f"K6 {label} returned non-finite values")
                if not torch.equal(y_k, y_k2):
                    fail(f"K6 {label} {dtype} select_passes={passes} differs between two "
                         "launches")
                err, rel = normwise(y_k, y_p)
                if rel > TOL_K6[dtype]:
                    fail(f"K6 {label} {dtype} select_passes={passes}: rel {rel:.3e} > "
                         f"{TOL_K6[dtype]:g}")
                errs.append(rel)
                if dtype == torch.float32 and passes == 1:
                    worst = max(worst, err)
                    t = {
                        "ms": cuda_ms(lambda w=w, x=x: cuda_window.windowed_bsr_matvec(w, x)),
                        "device_ms": device_ms(
                            lambda w=w, x=x: cuda_window.windowed_bsr_matvec(w, x)),
                        "plain_ms": cuda_ms(
                            lambda w=w, x=x: cuda_window.bsr_matvec_plain(w, x)),
                    }
                    A, xr = bsr_as_csr(w), x.to(torch.bfloat16).to(torch.float32)
                    y_l = (A @ xr[:, None]).reshape(-1)
                    if normwise(y_l, y_p)[1] > TOL_K6[dtype]:
                        fail(f"the CSR yardstick of K6 {label} computes another function")
                    t["library_ms"] = cuda_ms(lambda A=A, xr=xr: A @ xr[:, None])
                    for key in tot:
                        tot[key] += t[key]
                    nbytes, flops = k6_cost(w)
                    b_ms, _ = bound_ms(nbytes, flops, dtype)
                    bnd_bytes, bnd_flops = bnd_bytes + nbytes, bnd_flops + flops
                    # threads per row: every power of two, each checked
                    sweep = {}
                    for lanes in LANES:
                        y_s = cuda_window.windowed_bsr_matvec(w, x, lanes=lanes)
                        if normwise(y_s, y_p)[1] > TOL_K6[dtype]:
                            fail(f"K6 {label} with {lanes} lanes disagrees with plain")
                        sweep[lanes] = device_ms(
                            lambda w=w, x=x, n=lanes: cuda_window.windowed_bsr_matvec(
                                w, x, lanes=n), iters=10)
                    sweeps.append((label, w32.lanes, sweep))
            finally:
                w.select_passes = saved
        nnzb = w32.col.numel()
        parts.append(f"{label} ({w32.br}x{w32.bc} rows {w32.n_rnodes} blocks {nnzb} "
                     f"mean {nnzb / w32.n_rnodes:.1f} lanes {w32.lanes}) rel "
                     f"{errs[0]:.1e}/{errs[1]:.1e}/{errs[2]:.1e} {t['ms']:.4f} ms (on the card "
                     f"{t['device_ms']:.4f}) vs plain {t['plain_ms']:.4f}, CSR "
                     f"{t['library_ms']:.4f}, bound {b_ms:.4f}")
    bound, by = bound_ms(bnd_bytes, bnd_flops, torch.float32)
    results["K6"] = {"max_abs_err": worst, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                     "bound_ms": bound, "bound_by": by, "library_ms": tot["library_ms"],
                     "device_ms": tot["device_ms"]}
    print(f"phase 8 K6 vs plain on {len(ops)} AMG level operators (rel err f32 sel1/f32 sel3/f64; "
          f"tol f32 {TOL_K6[torch.float32]:g}, f64 {TOL_K6[torch.float64]:g}; two launches "
          f"bit-equal); f32 sel1 times: " + "; ".join(parts) + f"; one apply of every operator "
          f"{tot['ms']:.4f} ms (on the card {tot['device_ms']:.4f}) vs plain "
          f"{tot['plain_ms']:.4f} ms, CSR library {tot['library_ms']:.4f} ms, bound "
          f"{bound:.4f} ms ({by})")
    print("phase 8 K6 lanes sweep, f32 sel1 kernel ms on the card per apply at lanes " + "/".join(map(str, LANES))
          + ": " + "; ".join(
              f"{label} (rule {rule}, best {min(sw, key=sw.get)}) "
              + "/".join(f"{sw[n]:.4f}" for n in LANES) for label, rule, sw in sweeps))


def bsr_as_csr(w) -> torch.Tensor:
    """The operator of a windowed BSR plan as a torch CSR matrix on the same
    component-major vectors (y[jr * NR_pad + row], x[jc * NC_pad + col]):
    the yardstick of K6, timed beside it and never used by the port."""
    b, a, t = torch.nonzero(w.loc >= 0, as_tuple=True)
    rnode = b * w.T_r + t
    cnode = w.jb.long()[b] * 1024 + w.loc[b, a, t].long()
    v5 = w.vals.reshape(w.B, w.k, w.br, w.bc, w.T_r)
    rows, cols, vals = [], [], []
    for jr in range(w.br):
        for jc in range(w.bc):
            rows.append(jr * w.NR_pad + rnode)
            cols.append(jc * w.NC_pad + cnode)
            vals.append(v5[b, a, jr, jc, t])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (w.br * w.NR_pad, w.bc * w.NC_pad),
                                  check_invariants=True)
    return coo.coalesce().to_sparse_csr()


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
        amg = build_amg(V, MU, KAPPA, free_mask(V, bcs), nu=3, spmv="windowed",
                        node_perm=geos[0].ex.perm, device=device, dtype=torch.float64)
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
    tet["bench_ms_step"] = ms_step  # phase 17 prints it beside the gather engine's
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


# -- several laws on the imported mesh, and the whole model library -----------------

#: the JAX package's Drucker-Prager (associated) and standard-linear-solid
#: parameters (tests/solver/test_simulation.py)
DP_PARAMS = {"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15, "b_flow": 0.15}
SLS_PARAMS = {"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3}
STRETCH_STEP = 0.0004  # phase 14's load step, phase 10's
N_LIBRARY = 6  # phase 15's tet and hex boxes
# phase 15: card (kernels) against CPU (plain versions), converged float64
# steps (Newton to 1e-11 of r0, CG to 1e-12): normwise on u and stress
TOL_LIBRARY = 1e-8


def library_laws() -> dict:
    """The 7 FULL laws of the JAX package's production-path test
    (tests/solver/test_simulation.py), same parameters."""
    from fenics_constitutive_tpu_torch import models as m

    return {
        "elastic": lambda: m.LinearElasticityModel({"E": 42000.0, "nu": 0.3}, m.Constraint.FULL),
        "mises-exp": lambda: m.VonMises3D(MAT),
        "mises-lin": lambda: m.MisesPlasticityLinearHardening3D(
            {"mu": 80769.0, "kappa": 175000.0, "y_0": 1200.0, "h": 5000.0}),
        "kelvin": lambda: m.SpringKelvinModel(SLS_PARAMS, m.Constraint.FULL),
        "maxwell": lambda: m.SpringMaxwellModel(SLS_PARAMS, m.Constraint.FULL),
        "dp": lambda: m.DruckerPrager3D(DP_PARAMS),
        "dp-hyp": lambda: m.DruckerPragerHyperbolic3D({**DP_PARAMS, "d": 0.1}),
    }


def two_layer_laws(V) -> list:
    """A viscoelastic layer over a frictional base: DruckerPrager3D
    (associated) on the cells with midpoint z < 0.5, SpringMaxwellModel (FULL)
    above."""
    from fenics_constitutive_tpu_torch.models import (
        Constraint,
        DruckerPrager3D,
        SpringMaxwellModel,
    )

    z = V.mesh.cell_midpoints()[:, 2]
    return [(DruckerPrager3D(DP_PARAMS), np.flatnonzero(z < 0.5)),
            (SpringMaxwellModel(SLS_PARAMS, Constraint.FULL), np.flatnonzero(z >= 0.5))]


def phase_multilaw(tet: dict) -> dict:
    """PackedSimulation with two laws on the imported 35^3 mesh (default
    options: the windowed engine and AMG), float64. First the one-time
    set-up of the first Drucker-Prager eval and the parts of a step, timed
    apart on the first Newton iterate of step 1; then the 3-step schedule,
    with the launch counts set to 0 just before it; then one more step
    timed alone and one under torch.profiler. Before all that, K4 and K5 on
    each law's own plan against their plain versions."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, combine_bcs
    from fenics_constitutive_tpu_torch.ops import cuda_window
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V = FunctionSpace(tet["mesh"], 1, 3)
    bcs = bench_bcs(V)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim = PackedSimulation(two_layer_laws(V), V, bcs, 2, del_t=0.5, device=CARD,
                           dtype=torch.float64)
    build_s = time.perf_counter() - t0
    if (sim.engine, sim.preconditioner) != ("windowed", "amg"):
        fail(f"two-law PackedSimulation resolved to {sim.engine} + {sim.preconditioner}")
    geos, models, state, g0 = sim._geos, sim._models, sim.state, sim._geos[0]
    if sum(g.n_cells for g in geos) != tet["mesh"].num_cells:
        fail("the two laws do not cover the mesh")

    # K4 and K5 at the shapes this path gives them: each law's own plan (its
    # cells, B and Rn, on the shared M_pad), float64, against the plain
    # versions (K4 bit-equal, K5 normwise)
    rng = np.random.default_rng(14)
    held = []
    for i, g in enumerate(geos):
        ex = g.ex
        u2 = torch.as_tensor(rng.normal(size=(3, ex.M_pad)), dtype=torch.float64, device=CARD)
        f = torch.as_tensor(rng.normal(size=(ex.B, 3, ex.Rn)), dtype=torch.float64, device=CARD)
        if not torch.equal(cuda_window.windowed_gather(ex, u2), cuda_window.gather_plain(ex, u2)):
            fail(f"phase 14 K4 on law {i}'s plan is not bit-equal to its plain version")
        y = cuda_window.windowed_scatter(ex, f)
        err, rel = normwise(y, cuda_window.scatter_plain(ex, f))
        if rel > TOL_K5[torch.float64] or not torch.isfinite(y).all():
            fail(f"phase 14 K5 on law {i}'s plan disagrees with its plain version: rel "
                 f"{rel:.3e} > {TOL_K5[torch.float64]:g}")
        held.append(f"law {i} (B {ex.B}, Rn {ex.Rn}): K4 bit-equal, K5 max_abs_err {err:.3e} "
                    f"rel {rel:.3e}")

    # the parts of a step on the first Newton iterate of step 1 (the first
    # stretch increment on the x = 1 face alone, where DP yields): each law's
    # eval (strain, update, residual), the two-law operator apply with those
    # tangents, one AMG V-cycle, and K4-K6 on the card
    bcs[1].value = STRETCH_STEP
    bc_dofs, bc_vals = combine_bcs(bcs)
    du = torch.zeros_like(state.u)
    du[g0.bc_internal(torch.as_tensor(bc_dofs, device=CARD))] = torch.as_tensor(
        bc_vals, dtype=du.dtype, device=CARD)

    def law_eval(i, d=du):
        s_new, tg, _ = models[i].evaluate_packed(state.t, sim.del_t, geos[i].strain(d),
                                                 state.stress[i], state.histories[i])
        return geos[i].residual(s_new), tg

    # one-time set-up on first use: the batched solver's library, then the
    # rest of the first DP eval (torch.func's first vmap/jacfwd among it)
    t0 = time.perf_counter()
    torch.linalg.solve(torch.eye(8, dtype=torch.float64, device=CARD).expand(4, 8, 8),
                       torch.ones((4, 8), dtype=torch.float64, device=CARD))
    torch.cuda.synchronize()
    solver_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tangents = [law_eval(0)[1]]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    trips = list(models[0].last_active_per_trip)
    tangents.append(law_eval(1)[1])
    eval_ms = [cuda_ms(lambda i=i: law_eval(i), iters=3, warmup=1) for i in range(len(geos))]
    # and on an elastic iterate (no displacement increment), as the later
    # Newton iterates of a converging step are at this load
    zero = torch.zeros_like(du)
    elastic_ms = [cuda_ms(lambda i=i: law_eval(i, zero), iters=3, warmup=1)
                  for i in range(len(geos))]
    v = torch.as_tensor(np.random.default_rng(3).normal(size=g0.ndofs_int),
                        dtype=torch.float64, device=CARD)
    mv_ms = cuda_ms(lambda: sum(g.matvec(v, tg) for g, tg in zip(geos, tangents)), iters=10)
    pc = sim._mg.wrap_internal(g0.ex.M_pad)
    before = cuda_window.launches["bsr_matvec"]
    pc(v)
    k6_cycle = cuda_window.launches["bsr_matvec"] - before
    vc_ms = cuda_ms(lambda: pc(v), iters=10)
    # K4 + K5 on the card for one eval or apply of every law (each gathers
    # and scatters once per law), by torch.profiler (or gated_ms); K6 from a
    # profile of one V-cycle
    win_call = 0.0
    for g in geos:
        ex = g.ex
        u2 = v.reshape(3, ex.M_pad)
        f = torch.zeros((ex.B, 3, ex.Rn), dtype=torch.float64, device=CARD)
        win_call += (device_ms(lambda ex=ex, u2=u2: cuda_window.windowed_gather(ex, u2))
                     + device_ms(lambda ex=ex, f=f: cuda_window.windowed_scatter(ex, f)))
    evs = profiled(lambda: pc(v), 3)
    k6_cycle_ms = None if evs is None else sum(
        e.self_device_time_total for e in evs if "bsr_rows_kernel" in e.key) / 1e3 / 3

    # the schedule: this slice's path, its launches counted from 0
    vals = []
    for k in (1, 2, 3):
        bcs[1].value = STRETCH_STEP * k
        vals.append(combine_bcs(bcs)[1])
    K = len(vals)
    for key in cuda_window.launches:
        cuda_window.launches[key] = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    stats = sim.solve_schedule(np.stack(vals))
    ev1.record()
    ev1.synchronize()
    counts = dict(cuda_window.launches)
    ms_step = ev0.elapsed_time(ev1) / K
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not stats["converged"].all():
        fail(f"the two-law schedule on the imported mesh did not converge: {stats}")
    for name, c in counts.items():
        if c <= 0:
            fail(f"the two-law run never launched {name}")
    stress = sim.stress
    if stress.shape != (tet["mesh"].num_cells, 4, 6) or not np.isfinite(stress).all():
        fail(f"two-law stress has shape {stress.shape} or non-finite values")
    if not torch.isfinite(sim.u).all():
        fail("two-law displacement has non-finite values")
    evals = float(stats["newton_iters"].sum()) + K  # one per Newton iteration, one at start
    per_law = counts["scatter"] / len(geos)  # each eval and each apply scatters once per law
    applies = per_law - evals
    cycles = counts["bsr_matvec"] / k6_cycle
    # a step's first eval as the first iterate's, the later ones as elastic
    parts = {"eval": K * sum(eval_ms) + (evals - K) * sum(elastic_ms),
             "operator": applies * mv_ms, "AMG": cycles * vc_ms}
    rest = K * ms_step - sum(parts.values())

    # one more step alone (host clock), and one under torch.profiler
    def next_step():
        bcs[1].value += STRETCH_STEP
        return sim.solve()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    niter4, conv4 = next_step()
    torch.cuda.synchronize()
    step4_ms = (time.perf_counter() - t0) * 1e3
    evs = profiled(next_step, 1)
    dev = "not measured (three empty profiles)"
    if evs is not None:
        dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:4]
        dev = (f"{dev_ms:.1f} ms on the card in {sum(e.count for e in evs)} device ops (busy "
               f"{dev_ms / step4_ms:.1%} of the step alone); top: " + "; ".join(
                   f"{short_name(e.key)} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
                   for e in top))
    if not conv4:
        fail("the two-law step after the schedule did not converge")
    print(f"phase 14 two laws on the imported {N_TET}^3 mesh f64 (DruckerPrager3D z < 0.5 "
          f"on {geos[0].n_cells} cells, N {geos[0].N}; SpringMaxwellModel above on "
          f"{geos[1].n_cells} cells, N {geos[1].N}; {sim.engine} + {sim.preconditioner}, build "
          f"{build_s:.1f} s; first use: batched solve {solver_s:.2f} s, first DP eval "
          f"{first_s:.2f} s): solve_schedule 3 steps of {STRETCH_STEP} k, {ms_step:.1f} ms/step "
          f"(CUDA events), newton {stats['newton_iters'].tolist()}, cg_last "
          f"{stats['cg_iters_last'].tolist()}, r " + ", ".join(f"{r:.2e}" for r in stats["r_norm"])
          + f"; launches per step K4 {counts['gather'] / K:g} K5 {counts['scatter'] / K:g} K6 "
          f"{counts['bsr_matvec'] / K:g}; device memory peak {peak_gib:.2f} GiB")
    print(f"phase 14 K4/K5 vs plain on each law's plan (f64, tol K5 {TOL_K5[torch.float64]:g}): "
          + "; ".join(held))
    print(f"phase 14 parts on the first iterate of step 1: eval ms DP {eval_ms[0]:.2f} (local "
          f"Newton active per trip {trips}), Maxwell {eval_ms[1]:.2f}; on an elastic iterate DP "
          f"{elastic_ms[0]:.2f}, Maxwell {elastic_ms[1]:.2f}; two-law operator apply "
          f"{mv_ms:.3f} ms; V-cycle {vc_ms:.3f} ms ({k6_cycle} K6); per step {evals / K:g} "
          f"evals, {applies / K:g} applies, {cycles / K:g} V-cycles: eval "
          f"{parts['eval'] / K:.1f} ms, operator {parts['operator'] / K:.1f} ms, AMG "
          f"{parts['AMG'] / K:.1f} ms, the rest (CG vectors, Newton, host) {rest / K:.1f} ms; "
          f"on the card K4+K5 {per_law * win_call / K:.2f} ms/step, K6 "
          + ("not measured" if k6_cycle_ms is None else f"{cycles * k6_cycle_ms / K:.2f} ms/step")
          + f"; step 4 alone newton {niter4}, {step4_ms:.1f} ms (host clock); step 5 profiled: "
          + dev)
    return counts


def phase_library() -> None:
    """Every FULL law on the card against the same run on the CPU: a 6^3
    shuffled tet mesh (windowed engine, AMG) and a 6^3 hex box (K1 for the
    factored laws, the plain operator for DP), float64, 2 steps of 0.004 k,
    and on the tets also phase 14's two laws (DP below z = 0.5, Maxwell
    above); then the dense-tangent and Jacobi-diagonal products with TF32
    on."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.ops import DenseTangent, cuda_matvec, cuda_window
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    tet_mesh = imported_mesh(N_LIBRARY)
    worst, line = 0.0, []
    for kind in ("tet", "box"):
        cases = list(library_laws().items())
        if kind == "tet":
            cases.append(("dp+maxwell", two_layer_laws))
        for name, make in cases:
            runs = {}
            for device in (CARD, "cpu"):
                V = FunctionSpace(tet_mesh, 1, 3) if kind == "tet" else box(N_LIBRARY)[0]
                bcs = bench_bcs(V)
                k1 = cuda_matvec.launches
                win = sum(cuda_window.launches.values())
                laws = make(V) if make is two_layer_laws else make()
                sim = PackedSimulation(laws, V, bcs, 2, del_t=0.5, engine="windowed",
                                       device=device, dtype=torch.float64,
                                       newton_rtol=1e-11, newton_atol=1e-10, cg_rtol=1e-12)
                iters = []
                for k in (1, 2):
                    bcs[1].value = 0.004 * k
                    niter, conv = sim.solve()
                    if not conv:
                        fail(f"phase 15 {kind} {name} on {device}: step {k} did not converge")
                    iters.append(niter)
                runs[device] = (sim.u.cpu(), torch.as_tensor(sim.stress), iters,
                                cuda_matvec.launches - k1,
                                sum(cuda_window.launches.values()) - win)
            (u_c, s_c, it_c, k1_c, win_c), (u_h, s_h, it_h, _, _) = runs[CARD], runs["cpu"]
            rel = max(normwise(u_c, u_h)[1], normwise(s_c, s_h)[1])
            worst = max(worst, rel)
            factored = not name.startswith("dp")
            if rel > TOL_LIBRARY or not (torch.isfinite(u_c).all() and torch.isfinite(s_c).all()):
                fail(f"phase 15 {kind} {name}: card vs CPU rel {rel:.2e} > {TOL_LIBRARY:g}")
            if kind == "box" and (k1_c > 0) != factored:
                fail(f"phase 15 box {name}: {k1_c} K1 launches, expected "
                     + ("some" if factored else "none (a DenseTangent law runs 'plain')"))
            if kind == "tet" and win_c <= 0:
                fail(f"phase 15 tet {name} never launched the window kernels")
            line.append(f"{kind} {name} newton {it_c} (CPU {it_h}) rel {rel:.1e}"
                        + (f" K1 {k1_c}" if kind == "box" else f" K4-K6 {win_c}"))

    # the products that must not run in TF32: float32, TF32 on vs off
    rng = np.random.default_rng(8)
    V, _ = box(N_LIBRARY)
    geo = build_structured_geometry(V, 2, Constraint.FULL, device=CARD, dtype=torch.float32)
    A = torch.as_tensor(rng.normal(size=(6, 6, 8, geo.M)), dtype=torch.float32, device=CARD)
    tg = DenseTangent(A)
    eps = torch.as_tensor(rng.normal(size=(6, 8, geo.M)), dtype=torch.float32, device=CARD)
    B = torch.as_tensor(rng.normal(size=(6, 3, 8, 1)), dtype=torch.float32, device=CARD)
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    outs = []
    try:
        for tf32 in (False, True):
            flags.allow_tf32 = tf32
            outs.append((tg.apply(eps), tg.quad_diag(B), geo.jacobi_diag_gm(tg)))
    finally:
        flags.allow_tf32 = saved
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    print(f"phase 15 every law on the card vs the CPU ({N_LIBRARY}^3 tets windowed + AMG, "
          f"{N_LIBRARY}^3 hex box; f64, 2 steps of 0.004 k; tol {TOL_LIBRARY:g} normwise on u "
          f"and stress): max rel {worst:.2e}; " + "; ".join(line)
          + f"; DenseTangent apply/quad_diag and jacobi_diag_gm in f32 with TF32 on "
          f"{'bit-equal to' if same else 'DIFFER from'} TF32 off")
    if not same:
        fail("a dense-tangent or Jacobi-diagonal product changed under TF32")


# -- K3: the fused multigrid smoothing chains ---------------------------------------


def stencil_flops(geo) -> float:
    """Operations of one stencil apply at a node: 3^d neighbours of vs x vs
    blocks, a multiply and an add each (486 on a hex level, 72 on a quad)."""
    return 2.0 * 3**geo.gdim * geo.vs**2


def chain_cost(chain) -> tuple[float, float]:
    """(bytes, flops) one call of a K3 chain needs: b, the level data (and x)
    read once, x (and r) written once; per operator apply the 3^d-point
    stencil of vs x vs blocks on every node (243 multiply-adds on a hex
    level), per sweep 3 operations per dof."""
    geo = chain.geo
    M, vs, size = geo.M, geo.vs, chain.inv_d.element_size()
    vecs = 1 + (0 if chain.zero_start else 1) + 1 + int(chain.emit_residual)
    nbytes = vecs * vs * M * size + level_bytes(chain)
    sweeps = max(chain.nu - 1, 0) if chain.zero_start else chain.nu
    applies = sweeps + int(chain.emit_residual)
    return nbytes, applies * M * stencil_flops(geo) + sweeps * 3 * M * vs


def level_bytes(chain) -> int:
    """What a K3 kernel reads of a level: inv_d, the pattern ids and stencils."""
    return sum(t.numel() * t.element_size() for t in (chain.inv_d, chain.pid, chain.st))


def k3_chains(mg, mg_coarse):
    """Every chain of one fused V-cycle (levels above the coarsest: pre and
    post) and the coarsest level's chain of a hierarchy without coarse_direct."""
    out = []
    for lvl in range(mg.n_levels - 1):
        out += [(f"L{lvl} pre", mg.fused[lvl]["pre"]), (f"L{lvl} post", mg.fused[lvl]["post"])]
    out.append((f"L{mg.n_levels - 1} coarse", mg_coarse.fused[-1]["coarse"]))
    return out


#: the entries of the fused V-cycle, as the kernels JSON line names them
K3_ENTRIES = {"pre_restrict": "fused_smoother_pre_restrict",
              "tail": "fused_smoother_tail",
              "prolong_post": "fused_smoother_prolong_post"}


def k3_entries(fc, b0: torch.Tensor, first: int | None = None):
    """Every K3 entry one fused V-cycle from b0 runs, in its order, with the
    inputs the cycle gives it (taken from the plain twins): (label, kind,
    kernel call, plain call, (bytes, flops)). ``first``: the tail's first
    level (default: the card's rule)."""
    first = fc.tail_start(b0.device) if first is None else first
    g0 = fc._chain(0).geo
    vs, apply_ops = g0.vs, stencil_flops(g0)
    n_nb, n_corner = 3**g0.gdim, 2**g0.gdim  # restriction and prolongation weights
    vec = b0.element_size() * vs
    out, xs, bs, b = [], [], [], b0
    for lvl in range(first):
        pre, M, Mc = fc.chains[lvl]["pre"], fc._chain(lvl).geo.M, fc._chain(lvl + 1).geo.M
        x, bc = fc.pre_restrict_plain(lvl, b)
        cost = (level_bytes(pre) + vec * (2 * M + Mc),
                pre.nu * M * apply_ops + (pre.nu - 1) * 3 * vs * M + n_nb * 2 * vs * Mc)
        out.append((f"L{lvl} pre_restrict", "pre_restrict",
                    lambda lvl=lvl, b=b: fc.pre_restrict(lvl, b),
                    lambda lvl=lvl, b=b: fc.pre_restrict_plain(lvl, b), cost))
        xs.append(x)
        bs.append(b)
        b = bc
    xc = fc.plain(b, first)
    nbytes = vec * 2 * fc._chain(first).geo.M + sum(
        level_bytes(fc._chain(t)) for t in range(first, fc.n_levels))
    flops = 0.0
    for t in range(first, fc.n_levels - 1):
        c, M = fc._chain(t), fc._chain(t).geo.M
        flops += (2 * c.nu * M * apply_ops + 2 * c.nu * 3 * vs * M
                  + n_nb * 2 * vs * fc._chain(t + 1).geo.M + 2 * n_corner * vs * M)
    Nc = vs * fc._chain(fc.n_levels - 1).geo.M
    if fc.coarse_inv is not None:
        nbytes += fc.coarse_inv.numel() * fc.coarse_inv.element_size()
        flops += 2.0 * Nc * Nc
    else:
        flops += fc.chains[-1]["coarse"].nu * (Nc / vs) * apply_ops
    out.append((f"L{first}-{fc.n_levels - 1} tail", "tail",
                lambda b=b: fc.tail(b, first), lambda b=b: fc.plain(b, first), (nbytes, flops)))
    for lvl in reversed(range(first)):
        post, M = fc.chains[lvl]["post"], fc._chain(lvl).geo.M
        cost = (level_bytes(post) + vec * (3 * M + fc._chain(lvl + 1).geo.M),
                post.nu * M * apply_ops + post.nu * 3 * vs * M + 2 * n_corner * vs * M)
        out.append((f"L{lvl} prolong_post", "prolong_post",
                    lambda lvl=lvl, x=xs[lvl], b=bs[lvl], xc=xc: fc.prolong_post(lvl, x, b, xc),
                    lambda lvl=lvl, x=xs[lvl], b=bs[lvl], xc=xc: fc.prolong_post_plain(
                        lvl, x, b, xc), cost))
        xc = fc.prolong_post_plain(lvl, xs[lvl], bs[lvl], xc)
    return out


def check_k3(label: str, kernel, plain, dtype, tol) -> tuple[float, float]:
    """A K3 call against its plain twin: finite, bit-equal across two
    launches, within tol normwise. Returns (max abs error, worst rel)."""
    out1, out2, ref = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    if isinstance(ref, torch.Tensor):
        out1, out2, ref = (out1,), (out2,), (ref,)
    worst_abs = worst = 0.0
    for got, again, want in zip(out1, out2, ref):
        if got.shape != want.shape or not torch.isfinite(got).all():
            fail(f"K3 {label} {dtype}: shape {tuple(got.shape)} vs {tuple(want.shape)} or "
                 "non-finite values")
        if not torch.equal(got, again):
            fail(f"K3 {label} {dtype} differs between two launches")
        err, rel = normwise(got, want)
        if rel > tol:
            fail(f"K3 {label} {dtype}: rel {rel:.3e} > {tol:g}")
        worst_abs, worst = max(worst_abs, err), max(worst, rel)
    return worst_abs, worst


#: the most device ops one fused V-cycle on the 50^3 hierarchy may take
K3_VCYCLE_OPS = 8


#: aten ops that do no work on the card (allocations, views, aliases)
NO_DEVICE_WORK = ("aten.empty", "aten.new_empty", "aten.detach", "aten.alias",
                  "aten.lift_fresh", "aten._reshape_alias")


def aten_device_ops(fn) -> int:
    """The aten ops one call of fn() dispatches that do work on the card
    (every op but views, allocations and aliases), counted on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or str(func).startswith(NO_DEVICE_WORK)):
                self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def kernel_ops(fn, module, kernels: tuple, iters: int = 10) -> tuple[float, float, str]:
    """(launches, other device ops, how the others were counted) per call of
    fn(): the launches of the kernels named ``kernels`` by
    ``module.launches``, the wrappers' counter, and every other op (kernels,
    copies, fills) by torch.profiler, from a profile that holds an event for
    each of those launches. Where three profiles lack some (see profiled),
    the other ops are the aten ops that do device work (aten_device_ops)."""
    fn()
    before = module.launches
    fn()
    launches = module.launches - before
    torch.cuda.synchronize()

    def ours(evs):
        return sum(e.count for e in evs if short_name(e.key).startswith(kernels))

    evs = profiled(fn, iters, lambda evs: ours(evs) == iters * launches)
    if evs is None:
        PROFILER_MISSES["fallbacks"] += 1
        return launches, aten_device_ops(fn), "aten ops"
    return launches, sum(e.count for e in evs) / iters - launches, "profiler"


def phase_k3(results: dict) -> None:
    """K3 against its plain twins on the 50^3 hierarchy (every chain, and
    every entry of the fused V-cycle) and on an 11 x 10 x 10 box (non-nested
    transfers), float64 and float32; the device ops of one fused V-cycle; the
    fused V-cycle against the unfused one."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.ops import cuda_smoother
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
    from fenics_constitutive_tpu_torch.solver import build_multigrid

    V, bcs = box(N_BENCH)
    free = torch.as_tensor(free_mask(V, bcs))
    V_s = FunctionSpace(unit_cube_mesh(11, 10, 10, "hex"), 1, 3)
    free_s = torch.as_tensor(free_mask(V_s, bench_bcs(V_s)))
    mg_opts = dict(nu=3, nu_coarse=2)
    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32_K1)):
        geo = build_structured_geometry(V, 2, Constraint.FULL, device="cuda", dtype=dtype)

        def mg_of(g=geo, fr=free, **kw):
            return build_multigrid(g, MU, KAPPA, fr, device="cuda", dtype=dtype,
                                   **mg_opts, **kw)

        mg = mg_of(coarse_direct=True, fused_smoothing=True)
        mg_coarse = mg_of(coarse_direct=False, fused_smoothing=True)
        mg_plain = mg_of(coarse_direct=True)
        rng = np.random.default_rng(3)
        parts = []
        for label, chain in k3_chains(mg, mg_coarse):
            n = chain.inv_d.numel()
            fr = (chain.inv_d != 0).to(dtype)
            b = torch.as_tensor(rng.normal(size=n), dtype=dtype, device="cuda") * fr
            x = torch.as_tensor(rng.normal(size=n) * 1e-5, dtype=dtype, device="cuda") * fr
            args = (b,) if chain.zero_start else (x, b)
            _, rel = check_k3(label, lambda: chain(*args), lambda: chain.plain(*args), dtype,
                              tol)
            part = f"{label} (nu {chain.nu}, M {chain.geo.M}) rel {rel:.1e}"
            if dtype == torch.float32:
                ms = cuda_ms(lambda: chain(*args))
                bound, by = bound_ms(*chain_cost(chain), dtype)
                part += f" {ms:.4f} ms (bound {bound:.4f} {by})"
            parts.append(part)
        print(f"phase 11 K3 chains vs plain at {N_BENCH}^3 {str(dtype)[6:]} (tol {tol:g}; one "
              f"launch each, bit-equal across two): " + "; ".join(parts))

        # the fused V-cycle's entries, on the 50^3 hierarchy and the small box
        r = torch.as_tensor(np.random.default_rng(2).normal(size=V.ndofs), dtype=dtype,
                            device="cuda")
        fc = mg.fused_cycle
        parts, agg = [], {}
        for label, kind, kernel, plain, cost in k3_entries(fc, r):
            err, rel = check_k3(label, kernel, plain, dtype, tol)
            part = f"{label} rel {rel:.1e}"
            if dtype == torch.float32:
                bound, by = bound_ms(*cost, dtype)
                t = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel, floor_ms=bound),
                     "plain_ms": cuda_ms(plain)}
                part += (f" {t['ms']:.4f} ms (on the card {t['device_ms']:.4f}) vs plain "
                         f"{t['plain_ms']:.4f} (bound {bound:.4f} {by})")
                a = agg.setdefault(kind, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                          "device_ms": 0.0, "bytes": 0.0, "flops": 0.0})
                a["max_abs_err"] = max(a["max_abs_err"], err)
                for key in ("ms", "plain_ms", "device_ms"):
                    a[key] += t[key]
                a["bytes"] += cost[0]
                a["flops"] += cost[1]
            parts.append(part)
        if dtype == torch.float32:
            # the tail-start rule's choice against one level lower, on the card
            first = fc.tail_start(r.device)
            if first + 1 < fc.n_levels:
                alt = {label: device_ms(kernel) for label, _, kernel, _, _ in
                       k3_entries(fc, r, first=first + 1)[first:first + 3]}
                parts.append(f"tail from level {first} {agg['tail']['device_ms']:.4f} ms on the "
                             f"card vs level {first} as two cooperative launches and the tail "
                             f"from {first + 1}: " + " + ".join(
                                 f"{label} {t:.4f}" for label, t in alt.items())
                             + f" = {sum(alt.values()):.4f} ms")
        geo_s = build_structured_geometry(V_s, 2, Constraint.FULL, device="cuda", dtype=dtype)
        mg_s = mg_of(geo_s, free_s, coarse_direct=True, fused_smoothing=True)
        fc_s = mg_s.fused_cycle
        r_s = torch.as_tensor(np.random.default_rng(4).normal(size=V_s.ndofs), dtype=dtype,
                              device="cuda")
        for label, _, kernel, plain, _ in k3_entries(fc_s, r_s, first=1):
            _, rel = check_k3(f"11x10x10 {label}", kernel, plain, dtype, tol)
            parts.append(f"11x10x10 {label} rel {rel:.1e}")
        _, rel = check_k3("11x10x10 V-cycle", lambda: mg_s(r_s), lambda: fc_s.plain(r_s), dtype,
                          tol)
        _, rel_u = normwise(mg_s(r_s), mg_of(geo_s, free_s, coarse_direct=True)(r_s))
        parts.append(f"11x10x10 V-cycle ({fc_s.node_grids}, tail from level "
                     f"{fc_s.tail_start(r_s.device)}) rel {rel:.1e}, vs unfused {rel_u:.1e}")
        if rel_u > tol:
            fail(f"the fused V-cycle on the 11x10x10 box {dtype} disagrees with the unfused "
                 f"one: {rel_u:.3e}")

        k3_launches, others, counted = kernel_ops(lambda: mg(r), cuda_smoother,
                                                  ("chain_kernel", "tail_kernel"))
        ops = k3_launches + others
        z_f, z_p = mg(r), mg_plain(r)
        _, rel_v = normwise(z_f, z_p)
        vf_ms = cuda_ms(lambda: mg(r), iters=10)
        vp_ms = cuda_ms(lambda: mg_plain(r), iters=10)
        print(f"phase 11 K3 fused V-cycle entries vs plain {str(dtype)[6:]} (tol {tol:g}; "
              f"bit-equal across two launches; tail from level {fc.tail_start(r.device)}): "
              + "; ".join(parts) + f"; V-cycle at {N_BENCH}^3 {ops:g} device ops ({k3_launches:g} "
              f"K3 launches, {others:g} other ops by the {counted}; limit {K3_VCYCLE_OPS}), fused "
              f"vs unfused rel "
              f"{rel_v:.2e}, {vf_ms:.3f} ms vs {vp_ms:.3f} ms")
        if rel_v > tol:
            fail(f"the fused V-cycle {dtype} disagrees with the unfused one: {rel_v:.3e}")
        if ops > K3_VCYCLE_OPS:
            fail(f"one fused V-cycle takes {ops:g} device ops, more than {K3_VCYCLE_OPS}")
        if dtype == torch.float32:
            for kind, a in agg.items():
                bound, by = bound_ms(a.pop("bytes"), a.pop("flops"), dtype)
                results[f"K3_{kind}"] = {**a, "bound_ms": bound, "bound_by": by,
                                         "library_ms": None}
            results["K3_vcycle"] = {"ops": ops, "ms": vf_ms, "unfused_ms": vp_ms}


# -- every P1 mesh: the structured-tet and gather engines, the AMG's two formats -------

N_TET_BOX = 35  # phase 16's Kuhn box: 35^3 cubes of 6 tets
N_QP_TET_BOX = 1_029_000  # 257,250 tets x 4 points, unpadded (phases 16 and 17)
TET_BOX_FIXED, TET_BOX_VERIFY, TET_BOX_STEPS = 14, 40, 16  # scripts/bench_tet.py
# phase 18: card against CPU, converged float64 steps, normwise on u and stress
TOL_SMALL = 1e-10


def kuhn_box_setup(dtype):
    """The 35^3 Kuhn tet box (structured_shape set) with the bench's BCs, on
    the structured-tet engine (VonMises3D), and its V(3,3) hierarchy with
    nu_coarse 2 and a direct coarsest solve, fused (K3) and eager."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import StructuredTetGeometry
    from fenics_constitutive_tpu_torch.solver import build_multigrid, build_packed_problem

    t0 = time.perf_counter()
    V = FunctionSpace(unit_cube_mesh(N_TET_BOX, N_TET_BOX, N_TET_BOX, "tetra"), 1, 3)
    bcs = bench_bcs(V)
    t1 = time.perf_counter()
    geos, models, state = build_packed_problem(V, VonMises3D(MAT), 2, device=CARD, dtype=dtype)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not isinstance(geos[0], StructuredTetGeometry) or geos[0].N != N_QP_TET_BOX:
        fail(f"the Kuhn box resolved to {type(geos[0]).__name__} with {geos[0].N} QPs, "
             f"expected the structured-tet engine with {N_QP_TET_BOX:,}")
    free0 = torch.as_tensor(free_mask(V, bcs))
    mgs, mg_s = {}, {}
    for fused in (True, False):
        t = time.perf_counter()
        mgs[fused] = build_multigrid(geos[0], MU, KAPPA, free0, device=CARD, dtype=dtype, nu=3,
                                     nu_coarse=2, coarse_direct=True, fused_smoothing=fused)
        torch.cuda.synchronize()
        mg_s[fused] = time.perf_counter() - t
    args = tet_box_args(V, bcs, dtype)
    setup = {"mesh": t1 - t0, "geometry": t2 - t1, "multigrid fused": mg_s[True],
             "multigrid eager": mg_s[False]}
    return V, bcs, geos, models, state, mgs, args, setup


def tet_box_args(V, bcs, dtype):
    from fenics_constitutive_tpu_torch.fem import combine_bcs

    bc_dofs, bc_vals = combine_bcs(bcs)
    return (torch.as_tensor(bc_dofs, dtype=torch.int64, device=CARD),
            torch.as_tensor(bc_vals, dtype=dtype, device=CARD),
            torch.zeros(V.ndofs, dtype=dtype, device=CARD), 1.0)


def timed_schedule(step, models, state, args, scales):
    """run_schedule by CUDA events: (state, r_norm probes, ms/step)."""
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out, probes = run_schedule(step, models, state, args, scales)
    ev1.record()
    ev1.synchronize()
    if not (torch.isfinite(probes).all() and torch.isfinite(out.u).all()):
        fail("a timed schedule produced non-finite values")
    return out, probes, ev0.elapsed_time(ev1) / len(scales)


def phase_tet_box(results: dict) -> dict:
    """scripts/bench_tet.py's workload on the structured-tet engine: the 35^3
    Kuhn box, float32, max_newton=1, fixed-14 CG with the V(3,3) multigrid,
    fused (K3 on the tet fine level and the hex levels below) and eager in
    the same call; K3's entries on the tet hierarchy against their plain
    twins; then two laws on the box through PackedSimulation, float64."""
    from fenics_constitutive_tpu_torch.ops import cuda_smoother

    dtype = torch.float32
    V, bcs, geos, models, state, mgs, args, setup = kuhn_box_setup(dtype)
    fc = mgs[True].fused_cycle
    if not cuda_smoother.smoother_geometry_ok(geos[0]):
        fail("K3 refuses the tet fine level, which the JAX package's fused smoothing accepts")

    # K3 at the shapes this path gives it, against the plain twins
    r = torch.as_tensor(np.random.default_rng(16).normal(size=V.ndofs), dtype=dtype, device=CARD)
    r_gm = geos[0].to_grid_major(r)
    held = []
    for label, _, kernel, plain, _ in k3_entries(fc, r_gm):
        _, rel = check_k3(f"tet {label}", kernel, plain, dtype, TOL_F32_K1)
        held.append(f"{label} rel {rel:.1e}")
    _, rel_v = normwise(mgs[True](r_gm), mgs[False](r_gm))
    if rel_v > TOL_F32_K1:
        fail(f"the fused V-cycle on the tet hierarchy disagrees with the eager one: {rel_v:.3e}")
    t_f1, t_e1 = cuda_ms(lambda: mgs[True](r_gm), iters=10), cuda_ms(lambda: mgs[False](r_gm),
                                                                       iters=10)
    t_e2, t_f2 = cuda_ms(lambda: mgs[False](r_gm), iters=10), cuda_ms(lambda: mgs[True](r_gm),
                                                                       iters=10)

    scales = [2.0 + 1e-4 + 0.05 * i for i in range(TET_BOX_STEPS)]
    runs = {}
    for fused in (True, False):
        step = tet_box_step(geos, mgs[fused], TET_BOX_FIXED)
        st = state
        for k in (0.5, 1.0, 1.5):  # warm-up, driven past yield
            st, _ = step(models, st, args[0], args[1] * k, *args[2:])
        torch.cuda.synchronize()
        reset_counts()
        out, probes, ms_step = timed_schedule(step, models, st.clone(), args, scales)
        counts = read_counts()
        _, probes_ref = run_schedule(tet_box_step(geos, mgs[fused], TET_BOX_VERIFY), models,
                                     st.clone(), args, scales)
        runs[fused] = {"ms_step": ms_step, "r": float(probes[-1]),
                       "r_ref": float(probes_ref[-1]), "counts": counts, "state": out}
    for fused, run in runs.items():
        if run["r"] > R_NORM_ENVELOPE * run["r_ref"]:
            fail(f"phase 16 {'fused' if fused else 'eager'}: settled r_norm {run['r']:.4f} "
                 f"exceeds {R_NORM_ENVELOPE} x fixed-{TET_BOX_VERIFY} {run['r_ref']:.4f}")
    counts = runs[True]["counts"]
    if counts["K3"] <= 0 or counts["K1"] or counts["K2"] or runs[False]["counts"]["K3"]:
        fail(f"phase 16 launches: fused {counts}, eager {runs[False]['counts']} (K3 on the "
             "fused run only, K1 and K2 never on a tet geometry)")
    if runs[True]["state"].stress[0].shape != (6, 24, (N_TET_BOX + 1) ** 3):
        fail(f"tet box stress has shape {tuple(runs[True]['state'].stress[0].shape)}")
    results["tet_box"] = {"counts": counts, "ms_step": runs[True]["ms_step"],
                          "eager_ms_step": runs[False]["ms_step"]}
    K = TET_BOX_STEPS
    print(f"phase 16 Kuhn box {N_TET_BOX}^3 f32 ({N_QP_TET_BOX:,} QPs, structured-tet engine, "
          f"{mgs[True].n_levels} levels {fc.node_grids}): fused V-cycle "
          f"{runs[True]['ms_step']:.3f} ms/step, eager {runs[False]['ms_step']:.3f} ms/step "
          f"over {K} steps (CUDA events, same call); settled r_norm fused {runs[True]['r']:.4f} "
          f"vs fixed-{TET_BOX_VERIFY} {runs[True]['r_ref']:.4f}, eager {runs[False]['r']:.4f} vs "
          f"{runs[False]['r_ref']:.4f} (envelope {R_NORM_ENVELOPE}); V-cycle fused "
          f"{t_f1:.3f}/{t_f2:.3f} ms vs eager {t_e1:.3f}/{t_e2:.3f} ms, rel {rel_v:.1e}; "
          f"launches per step K1 {counts['K1']} K2 {counts['K2']} K3 {counts['K3'] / K:g} ("
          + ", ".join(f"{kind} {counts['K3_' + kind] / K:g}" for kind in K3_ENTRIES)
          + "); setup s: " + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
    print(f"phase 16 K3 on the tet hierarchy vs plain f32 (tol {TOL_F32_K1:g}, bit-equal across "
          f"two launches; tail from level {fc.tail_start(r_gm.device)}): " + "; ".join(held))
    phase_tet_box_laws(V)
    return results["tet_box"]


def tet_box_step(geos, mg, fixed: int):
    from fenics_constitutive_tpu_torch.solver import make_packed_step

    return make_packed_step(geos, max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5,
                            cg_maxiter=400, preconditioner=mg, cg_fixed_iters=fixed)


def phase_tet_box_laws(V) -> None:
    """PackedSimulation with two laws on the Kuhn box: linear elasticity
    below z = 0.5, VonMises3D above (masked structured-tet views), float64,
    the V-cycle with the K3 chains on one whole-grid tet hierarchy; 3
    converged steps of 0.0004 k from the elastic start."""
    from fenics_constitutive_tpu_torch.fem import combine_bcs
    from fenics_constitutive_tpu_torch.models import Constraint, LinearElasticityModel, VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    bcs = bench_bcs(V)
    z = V.mesh.cell_midpoints()[:, 2]
    laws = [(LinearElasticityModel({"E": 150000.0, "nu": 0.3}, Constraint.FULL),
             np.flatnonzero(z < 0.5)), (VonMises3D(MAT), np.flatnonzero(z >= 0.5))]
    t0 = time.perf_counter()
    sim = PackedSimulation(laws, V, bcs, 2, preconditioner="vcycle",
                           mg_options={"fused_smoothing": True}, device=CARD,
                           dtype=torch.float64)
    build_s = time.perf_counter() - t0
    if sim.engine != "structured_tet" or sim._mg.fused_cycle is None:
        fail(f"the two-law Kuhn box resolved to {sim.engine}, fused cycle "
             f"{sim._mg.fused_cycle is not None}")
    vals = []
    for k in (1, 2, 3):
        bcs[1].value = STRETCH_STEP * k
        vals.append(combine_bcs(bcs)[1])
    reset_counts()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    stats = sim.solve_schedule(np.stack(vals))
    ev1.record()
    ev1.synchronize()
    counts = read_counts()
    stress = sim.stress
    if not stats["converged"].all():
        fail(f"the two-law Kuhn box schedule did not converge: {stats}")
    if stress.shape != (V.mesh.num_cells, 4, 6) or not np.isfinite(stress).all():
        fail(f"two-law Kuhn box stress has shape {stress.shape} or non-finite values")
    if counts["K3"] <= 0:
        fail("the two-law Kuhn box never launched K3")
    print(f"phase 16 PackedSimulation two laws on the {N_TET_BOX}^3 Kuhn box f64 (elastic "
          f"z < 0.5, VonMises3D above; {sim.engine} + vcycle with K3, build {build_s:.1f} s): "
          f"solve_schedule 3 steps of {STRETCH_STEP} k, {ev0.elapsed_time(ev1) / 3:.1f} ms/step, "
          f"newton {stats['newton_iters'].tolist()}, r "
          + ", ".join(f"{r:.2e}" for r in stats["r_norm"])
          + f"; launches K1 {counts['K1']} K2 {counts['K2']} K3 {counts['K3']}")


def phase_gather(tet: dict, workdir: Path) -> dict:
    """Phase 9's imported mesh written as binary Gmsh v4.1 and read back
    (equal to the ASCII read), then PackedSimulation(engine="gather",
    preconditioner="amg") on it: the gather engine with the AMG at 1,029,000
    QPs, whose levels K6 applies on the card, driven by phase 9's protocol;
    one step run twice (bit for bit); the ELL levels of the same hierarchy
    beside them (V-cycle and step); the displacement and stress through
    write_vtu/read_vtu. Returns the K6 launches of the timed run."""
    from fenics_constitutive_tpu_torch.fem import (
        FunctionSpace,
        read_gmsh,
        read_vtu,
        write_gmsh41_binary,
        write_vtu,
    )
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import PackedGeometry, cuda_window
    from fenics_constitutive_tpu_torch.solver import (
        AmgPreconditioner,
        PackedSimulation,
        WindowedAmgPreconditioner,
        build_amg,
    )

    ascii_mesh = tet["mesh"]
    path = workdir / "tet35.bin.msh"
    t0 = time.perf_counter()
    write_gmsh41_binary(path, ascii_mesh)
    t1 = time.perf_counter()
    mesh = read_gmsh(path)
    write_s, read_s = t1 - t0, time.perf_counter() - t1
    if not (np.array_equal(mesh.nodes, ascii_mesh.nodes)
            and np.array_equal(mesh.cells, ascii_mesh.cells)
            and mesh.cell_sets == ascii_mesh.cell_sets is None):
        fail("the binary read differs from the ASCII read of the same mesh")

    V = FunctionSpace(mesh, 1, 3)
    bcs = bench_bcs(V)
    t0 = time.perf_counter()
    sim = PackedSimulation(VonMises3D(MAT), V, bcs, 2, engine="gather", preconditioner="amg",
                           mg_options={"nu": 3}, device=CARD, dtype=torch.float32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    geos, models, amg, geo = sim._geos, sim._models, sim._mg, sim._geos[0]
    if (sim.engine, sim.preconditioner) != ("gather", "amg") or not isinstance(
            geo, PackedGeometry) or not isinstance(amg, WindowedAmgPreconditioner):
        fail(f"PackedSimulation resolved to {sim.engine} + {sim.preconditioner} with "
             f"{type(amg).__name__}, expected gather + amg with the windowed levels")
    if geo.N != N_QP_TET_BOX:
        fail(f"the gather engine holds {geo.N} QPs, expected {N_QP_TET_BOX:,}")

    # phase 9's protocol on the gather engine's node-major vectors
    args = tet_box_args(V, bcs, torch.float32)
    step = tet_step(geos, amg, TET_FIXED)
    st = sim.state
    for k in (0.5, 1.0, 1.5, 2.0):  # warm-up, driven past yield
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    torch.cuda.synchronize()
    once = [step(models, st, args[0], args[1] * 2.05, *args[2:])[0] for _ in range(2)]
    repeat = torch.equal(once[0].u, once[1].u) and torch.equal(once[0].stress[0],
                                                               once[1].stress[0])
    if not repeat:
        fail("two runs of one gather-engine step differ")
    scales = [2.0 + 0.05 * (i + 1) for i in range(10)]
    for key in cuda_window.launches:
        cuda_window.launches[key] = 0
    out, probes, ms_step = timed_schedule(step, models, st.clone(), args, scales)
    counts = dict(cuda_window.launches)
    if counts["bsr_matvec"] <= 0 or counts["gather"] or counts["scatter"]:
        fail(f"phase 17 launches {counts}: K6 on the AMG levels, never K4 or K5")
    refs = [float(run_schedule(tet_step(geos, amg, fk), models, st.clone(), args, scales)[1][-1])
            for fk in TET_VERIFY]
    r_settled = float(probes[-1])
    if not (r_settled <= R_NORM_ENVELOPE * refs[0] and refs[0] <= R_NORM_ENVELOPE * refs[1]):
        fail(f"gather bench settled r_norm {r_settled:.4f} is outside the {R_NORM_ENVELOPE} "
             f"envelopes of the deep re-runs {refs}")
    r = torch.as_tensor(np.random.default_rng(2).normal(size=V.ndofs), dtype=torch.float32,
                        device=CARD)
    apply_ms = cuda_ms(lambda: geo.residual(geo.strain(r)), iters=10)

    # the ELL levels of the same hierarchy beside the windowed ones, on the
    # same node-major vector and the same schedule from the same state: one
    # V-cycle each on the card alone, and the call and the step each in
    # turns (a, b, b, a) after an untimed run of each schedule
    ell = build_amg(V, MU, KAPPA, free_mask(V, bcs), q_degree=2, nu=3, spmv="ell",
                    device=CARD, dtype=torch.float32)
    if not isinstance(ell, AmgPreconditioner):
        fail(f"build_amg(spmv='ell') gave {type(ell).__name__}")
    _, rel_fmt = normwise(amg(r), ell(r))
    if rel_fmt > TOL_F32_K1:
        fail(f"the windowed and ELL V-cycles of one hierarchy disagree: {rel_fmt:.3e}")
    pcs = {"windowed": amg, "ELL": ell}
    steps = {k: tet_step(geos, pc, TET_FIXED) for k, pc in pcs.items()}
    for k in steps:
        run_schedule(steps[k], models, st.clone(), args, scales)
    vc_dev = {k: device_ms(lambda pc=pc: pc(r), iters=10) for k, pc in pcs.items()}
    vc = {k: [] for k in pcs}
    fmt_ms = {k: [] for k in pcs}
    for k in ("windowed", "ELL", "ELL", "windowed"):
        vc[k].append(cuda_ms(lambda k=k: pcs[k](r), iters=10))
        fmt_ms[k].append(timed_schedule(steps[k], models, st.clone(), args, scales)[2])

    # the displacement and stress through VTU, bit for bit
    u = out.u.reshape(-1, 3).cpu().numpy()
    s_cells = geo.extract_cells(out.stress[0]).mean(dim=1).T.cpu().numpy()  # [C, 6]
    t0 = time.perf_counter()
    vtu = workdir / "gather.vtu"
    write_vtu(vtu, mesh, {"u": u}, {"stress": s_cells})
    _, pdata, cdata = read_vtu(vtu)
    vtu_s = time.perf_counter() - t0
    if not (np.array_equal(pdata["u"], u.astype(np.float64))
            and np.array_equal(cdata["stress"], s_cells.astype(np.float64))):
        fail("the VTU round trip of the displacement and stress is not bit-equal")

    K = len(scales)
    bs_g, bs_a, bs_e = geo.build_seconds, amg.build_seconds, ell.build_seconds
    print(f"phase 17 gather engine + AMG on the imported {N_TET}^3 mesh f32 ({geo.N:,} QPs "
          f"unpadded, gather_idx {tuple(geo.gather_idx.shape)}, AMG {amg.n_levels} windowed "
          f"levels; build {build_s:.1f} s): {ms_step:.3f} ms/step over {K} steps (CUDA "
          f"events; the windowed engine on the same mesh, phase 9: "
          f"{tet.get('bench_ms_step', float('nan')):.3f} ms/step), settled r_norm "
          f"{r_settled:.4f} vs fixed-{TET_VERIFY[0]} {refs[0]:.4f} and fixed-{TET_VERIFY[1]} "
          f"{refs[1]:.4f} (envelope {R_NORM_ENVELOPE} each); one step run twice bit-equal; "
          f"K6 {counts['bsr_matvec'] / K:g} launches a step; strain + residual {apply_ms:.3f} "
          f"ms; setup s: binary write {write_s:.2f}, read {read_s:.2f}, geometry "
          f"{bs_g['geometry']:.2f}, gather_idx {bs_g['gather_idx']:.2f}, geometry upload "
          f"{bs_g['upload']:.2f}, AMG host build {bs_a['hierarchy']:.2f}, windowed freeze "
          f"{bs_a['freeze']:.2f}, upload {bs_a['upload']:.2f}; binary read equal to the ASCII "
          f"read; VTU write + read {vtu_s:.2f} s, bit-equal")
    print("phase 17 level formats of one hierarchy (same call, windowed/ELL/ELL/windowed): "
          "V-cycle on the card " + ", ".join(f"{k} {v:.3f} ms" for k, v in vc_dev.items())
          + "; V-cycle call " + ", ".join(f"{k} {v[0]:.3f}/{v[1]:.3f} ms" for k, v in vc.items())
          + f", rel {rel_fmt:.1e}; step " + ", ".join(
              f"{k} {v[0]:.3f}/{v[1]:.3f}" for k, v in fmt_ms.items())
          + f" ms/step; ELL host build {bs_e['hierarchy']:.2f} s, freeze "
          f"{bs_e['freeze']:.2f} s, upload {bs_e['upload']:.2f} s")
    return counts


def small_cases() -> dict:
    """Phase 18's runs: name -> (space maker, laws maker, simulation
    options, expected engine)."""
    from fenics_constitutive_tpu_torch import models as m
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh, unit_interval_mesh

    def bar():
        return FunctionSpace(unit_interval_mesh(8), 1, 1)

    def kuhn_two_laws(V):
        z = V.mesh.cell_midpoints()[:, 2]
        return [(m.LinearElasticityModel({"E": 150000.0, "nu": 0.3}, m.Constraint.FULL),
                 np.flatnonzero(z < 0.5)), (m.VonMises3D(MAT), np.flatnonzero(z >= 0.5))]

    uni = {"E": 42000.0, "nu": 0.3}
    return {
        "tets-gather": (lambda: FunctionSpace(imported_mesh(N_LIBRARY), 1, 3),
                        lambda V: m.VonMises3D(MAT), {}, "gather"),
        "bar-uniaxial-strain": (bar, lambda V: m.LinearElasticityModel(
            uni, m.Constraint.UNIAXIAL_STRAIN), {}, "gather"),
        "bar-uniaxial-stress": (bar, lambda V: m.LinearElasticityModel(
            uni, m.Constraint.UNIAXIAL_STRESS), {}, "gather"),
        "bar-mises-from-3d": (bar, lambda V: m.UniaxialStrainFrom3D(m.VonMises3D(MAT)), {},
                              "gather"),
        "box-amg": (lambda: box(N_LIBRARY)[0], lambda V: m.VonMises3D(MAT),
                    {"preconditioner": "amg"}, "structured"),
        "kuhn-two-laws": (lambda: FunctionSpace(unit_cube_mesh(N_LIBRARY, N_LIBRARY, N_LIBRARY,
                                                               "tetra"), 1, 3), kuhn_two_laws,
                          {"preconditioner": "vcycle", "mg_options": {"fused_smoothing": True}},
                          "structured_tet"),
    }


def small_bcs(V):
    from fenics_constitutive_tpu_torch.fem import DirichletBC

    if V.value_size == 1:
        return [DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 0.0)), 0.0),
                DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 1.0)), 0.0)]
    return bench_bcs(V)


def phase_small() -> None:
    """The small meshes on the card against the CPU, float64, 2 converged
    steps of 0.004 k: the Newton counts must equal the CPU's and u and the
    stress agree within TOL_SMALL normwise."""
    from fenics_constitutive_tpu_torch.ops import cuda_window
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    line, worst = [], 0.0
    for name, (space, laws, opts, engine) in small_cases().items():
        runs = {}
        for device in (CARD, "cpu"):
            V = space()
            bcs = small_bcs(V)
            reset_counts()
            cuda_window.launches["bsr_matvec"] = 0
            sim = PackedSimulation(laws(V), V, bcs, 2, device=device, dtype=torch.float64,
                                   newton_rtol=1e-11, newton_atol=1e-10, cg_rtol=1e-12, **opts)
            if sim.engine != engine:
                fail(f"phase 18 {name} on {device} resolved to {sim.engine}, expected {engine}")
            iters = []
            for k in (1, 2):
                bcs[1].value = 0.004 * k
                niter, conv = sim.solve()
                if not conv:
                    fail(f"phase 18 {name} on {device}: step {k} did not converge")
                iters.append(niter)
            runs[device] = (sim.u.cpu(), torch.as_tensor(sim.stress), iters,
                            {**read_counts(), "K6": cuda_window.launches["bsr_matvec"]})
        (u_c, s_c, it_c, counts), (u_h, s_h, it_h, _) = runs[CARD], runs["cpu"]
        rel = max(normwise(u_c, u_h)[1], normwise(s_c, s_h)[1])
        worst = max(worst, rel)
        if it_c != it_h:
            fail(f"phase 18 {name}: Newton counts {it_c} on the card, {it_h} on the CPU")
        if rel > TOL_SMALL or not (torch.isfinite(u_c).all() and torch.isfinite(s_c).all()):
            fail(f"phase 18 {name}: card vs CPU rel {rel:.2e} > {TOL_SMALL:g}")
        if name == "kuhn-two-laws" and (counts["K3"] <= 0 or counts["K1"] or counts["K2"]):
            fail(f"phase 18 {name}: launches {counts}, expected K3 and no K1 or K2")
        if name == "box-amg" and counts["K6"] <= 0:
            fail(f"phase 18 {name}: launches {counts}, expected K6 on the AMG levels")
        line.append(f"{name} ({engine}{' + ' + opts['preconditioner'] if opts else ''}) newton "
                    f"{it_c} rel {rel:.1e}")
    print(f"phase 18 small meshes, card vs CPU f64 (2 steps of 0.004 k, Newton counts equal, "
          f"tol {TOL_SMALL:g} normwise on u and stress): max rel {worst:.2e}; " + "; ".join(line))


# -- degree 2 and 2D: the lattice engine, K3 on quad levels, P2 on imported meshes ---

N_P2 = 32  # phase 19: scripts/bench_p2.py's box, P2 at q_degree 4
Q_P2 = 4
N_QP_P2, N_DOF_P2 = 884_736, 823_875
P2_LOAD = 0.004  # the stretch of x = 1
P2_STEPS = 5  # timed steps at P2_LOAD (1 + 1e-4 k), k = 1..5, each from the zero state
P2_CG = dict(cg_rtol=1e-5, cg_maxiter=250)  # bench_p2's CG
# the lattice operator against the gather engine, float32, normwise: both
# sum 27 x 3 element dofs per QP and at most 8 cells per node in another
# order; TF32 (10-bit mantissa) would miss it by about 100x
TOL_P2_OP = 1e-5
N_QUAD = 512  # phase 20's P1 quad and triangle boxes (1,048,576 QPs)
N_QUAD_P2 = 256  # phase 20's P2 quad lattice (q_degree 4: 589,824 QPs)
N_P2_TET = 20  # phase 21's imported P2 tet mesh: 48,000 tets, 68,921 dof nodes
N_QP_P2_TET = 192_000  # its quadrature points, unpadded (4 per tet)


def box_bcs_2d(V):
    """The 2D box's Dirichlet set: x=0 fixed in x, x=1 pulled by 0.004 in x,
    y=0 fixed in y."""
    from fenics_constitutive_tpu_torch.fem import DirichletBC

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    return [
        DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.004),
        DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
    ]


def p2_box(n: int):
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh

    V = FunctionSpace(unit_cube_mesh(n, n, n, "hex"), 2, 3)
    return V, bench_bcs(V)


def p2_step_runs(run, loads) -> dict:
    """Run one step per load from the zero state, each timed by CUDA events on
    its own: the mean ms per step, and per step the CG iterations, r_norm and
    r/r0."""
    rows = []
    for load in loads:
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        stats = run(load)
        ev1.record()
        ev1.synchronize()
        rows.append((ev0.elapsed_time(ev1), int(stats["cg_iters_last"]), float(stats["r_norm"]),
                     float(stats["r_norm"]) / max(float(stats["r0_norm"]), 1e-300)))
    return {"ms": float(np.mean([r[0] for r in rows])), "cg": [r[1] for r in rows],
            "r_norm": [r[2] for r in rows], "rel": [r[3] for r in rows]}


def p2_eager(V, bcs, dtype):
    """bench_p2's step: one Newton iteration from the zero state with CG at
    rtol 1e-5, preconditioned by the eager V-cycle on the refined P1 grid
    (build_multigrid's defaults). Returns (the V-cycle, run(load) -> stats)."""
    from fenics_constitutive_tpu_torch.fem import combine_bcs
    from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_packed_problem, make_packed_step
    from fenics_constitutive_tpu_torch.solver.multigrid import build_multigrid, refined_p1_geometry

    geos, models, state0 = build_packed_problem(V, VonMises3D(MAT), Q_P2, device=CARD,
                                                dtype=dtype)
    geo1, _ = refined_p1_geometry(V, Constraint.FULL, device=CARD, dtype=dtype)
    mg = build_multigrid(geo1, MU, KAPPA, torch.as_tensor(free_mask(V, bcs)), device=CARD,
                         dtype=dtype)
    step = make_packed_step(geos, newton_rtol=0.0, newton_atol=0.0, max_newton=1,
                            preconditioner=mg, **P2_CG)
    bc_dofs, bc_vals = combine_bcs(bcs)
    bc_dofs = torch.as_tensor(bc_dofs, dtype=torch.int64, device=CARD)
    bc_vals = torch.as_tensor(bc_vals, dtype=dtype, device=CARD) / P2_LOAD
    f_ext = torch.zeros(V.ndofs, dtype=dtype, device=CARD)
    return mg, lambda load: step(models, state0, bc_dofs, bc_vals * load, f_ext, 1.0)[1]


def p2_fused(V, bcs, dtype):
    """The same step through PackedSimulation(preconditioner="vcycle",
    mg_options={"fused_smoothing": True}): the refined-P1 V(3,3) with K3 on
    every level. Newton tolerances 0 keep every step uncommitted, so each
    starts from the zero state. Returns (sim, run(load) -> stats)."""
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    sim = PackedSimulation(VonMises3D(MAT), V, bcs, Q_P2, device=CARD, dtype=dtype,
                           preconditioner="vcycle", mg_options={"fused_smoothing": True},
                           max_newton=1, newton_rtol=0.0, newton_atol=0.0, **P2_CG)

    def run(load):
        bcs[1].value = load
        sim.solve()
        return sim.last_stats

    return sim, run


def phase_p2_box(results: dict) -> dict:
    """Phase 19: the P2 lattice box of scripts/bench_p2.py on the card."""
    from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
    from fenics_constitutive_tpu_torch.ops import (
        IsotropicTangent,
        LatticeGeometry,
        build_packed_geometry,
    )
    from fenics_constitutive_tpu_torch.solver import PackedSimulation, build_packed_problem
    from fenics_constitutive_tpu_torch.solver.multigrid import refined_p1_geometry

    V, bcs = p2_box(N_P2)
    law = VonMises3D(MAT)
    f32 = torch.float32
    t0 = time.perf_counter()
    geos, _, _ = build_packed_problem(V, law, Q_P2, device=CARD, dtype=f32)
    geo = geos[0]
    setup_s = time.perf_counter() - t0
    if not isinstance(geo, LatticeGeometry) or geo.engine != "lattice":
        fail(f"the P2 box resolved to {type(geo).__name__}, not the lattice engine")
    if (geo.N, V.ndofs) != (N_QP_P2, N_DOF_P2):
        fail(f"the P2 box has {geo.N} QPs and {V.ndofs} dofs, expected {N_QP_P2} and {N_DOF_P2}")

    # (a) the operator on a plastic tangent against the gather engine
    t0 = time.perf_counter()
    gat = build_packed_geometry(V, Q_P2, Constraint.FULL, None, device=CARD, dtype=f32)
    gather_s = time.perf_counter() - t0
    rng = np.random.default_rng(5)
    u = torch.as_tensor(rng.normal(size=V.ndofs) * 2e-3, dtype=f32, device=CARD)
    v = torch.as_tensor(rng.normal(size=V.ndofs), dtype=f32, device=CARD)
    zeros = torch.zeros(geo.qp_shape(6), dtype=f32, device=CARD)
    hist = {"eps_n": zeros.clone(), "alpha": torch.zeros(geo.qp_shape(1), dtype=f32, device=CARD)}
    sig, tg, _ = law.evaluate_packed(0.0, 1.0, geo.strain(u), zeros, hist)
    if float(tg.gamma.abs().max()) <= 0:
        fail("the P2 operator check's tangent is not plastic anywhere")
    flat = IsotropicTangent(kappa=tg.kappa, beta=tg.beta.reshape(-1),
                            gamma=tg.gamma.reshape(-1), n=tg.n.reshape(6, -1))
    pairs = {"strain": (geo.strain(u), gat.strain(u).reshape(geo.qp_shape(6))),
             "residual": (geo.residual(sig), gat.residual(sig.reshape(6, -1))),
             "matvec": (geo.matvec(v, tg), gat.matvec(v, flat))}
    parts = []
    for name, (lat, ref) in pairs.items():
        rel = normwise(lat, ref)[1]
        parts.append(f"{name} rel {rel:.1e}")
        if not torch.isfinite(lat).all() or rel > TOL_P2_OP:
            fail(f"the lattice {name} disagrees with the gather engine: rel {rel:.3e} > "
                 f"{TOL_P2_OP:g}")
    sig_gm = sig.contiguous()
    if not torch.equal(geo.residual_gm(sig_gm), geo.residual_gm(sig_gm)):
        fail("the lattice residual differs between two calls")
    v_gm = geo.to_grid_major(v)
    t = {"lattice strain": cuda_ms(lambda: geo.strain_gm(v_gm)),
         "lattice residual": cuda_ms(lambda: geo.residual_gm(sig_gm)),
         "lattice matvec": cuda_ms(lambda: geo.matvec_gm(v_gm, tg)),
         "gather matvec": cuda_ms(lambda: gat.matvec(v, flat)),
         "lattice matvec on the card": device_ms(lambda: geo.matvec_gm(v_gm, tg)),
         "gather matvec on the card": device_ms(lambda: gat.matvec(v, flat))}
    del gat, pairs
    print(f"phase 19 P2 box {N_P2}^3 hex q{Q_P2} f32 ({N_QP_P2:,} QPs, {N_DOF_P2:,} dofs; lattice "
          f"set-up {setup_s:.2f} s, gather engine {gather_s:.2f} s): lattice vs gather engine on a "
          f"plastic tangent (tol {TOL_P2_OP:g}): " + ", ".join(parts) + "; residual bit-equal "
          "across two calls; ms per apply: " + ", ".join(f"{k} {ms:.3f}" for k, ms in t.items()))

    # K3 on the refined-P1 hierarchy that preconditions the P2 step, every
    # chain and entry at the shapes the step gives them
    parts = []
    k3_hierarchy_checks(f"refined P1 {2 * N_P2 + 1}^3", lambda dtype: refined_p1_geometry(
        V, Constraint.FULL, device=CARD, dtype=dtype)[0], torch.as_tensor(free_mask(V, bcs)),
        results, parts, key="K3_p2")
    print(f"phase 19 K3 on the refined-P1 hierarchy vs plain (tol f64 {TOL_F64:g}, f32 "
          f"{TOL_F32_K1:g}; bit-equal across two launches): " + "; ".join(parts))

    # (b) bench_p2's protocol: eager V-cycle, then PackedSimulation with K3
    loads = [P2_LOAD] + [P2_LOAD * (1 + 1e-4 * k) for k in range(1, P2_STEPS + 1)]
    line = []
    mg_eager, run = p2_eager(V, bcs, f32)
    run(loads[0])  # the first step: the first use of every op
    reset_counts()
    eager = p2_step_runs(run, loads[1:])
    eager_counts = read_counts()
    ref_eager = p2_step_runs(p2_eager(V, bcs, torch.float64)[1], loads[-1:])
    sim, run = p2_fused(V, bcs, f32)
    run(loads[0])  # the first step: the kernels' first launches
    reset_counts()
    fused = p2_step_runs(run, loads[1:])
    counts = read_counts()
    r = geo.to_grid_major(torch.as_tensor(rng.normal(size=V.ndofs), dtype=f32, device=CARD))
    # the step's own V-cycle against its plain twin
    rel_mg = {"f32": check_k3("P2 step V-cycle", lambda: sim._mg(r),
                              lambda: sim._mg.fused_cycle.plain(r), f32, TOL_F32_K1)[1]}
    vcycle = {"fused": cuda_ms(lambda: sim._mg(r), iters=10),
              "fused on the card": device_ms(lambda: sim._mg(r), iters=10),
              "eager V(2,2)": cuda_ms(lambda: mg_eager(r), iters=5)}
    del sim, mg_eager
    sim64, run64 = p2_fused(V, bcs, torch.float64)
    ref_fused = p2_step_runs(run64, loads[-1:])
    r64 = r.double()
    rel_mg["f64"] = check_k3("P2 step V-cycle", lambda: sim64._mg(r64),
                             lambda: sim64._mg.fused_cycle.plain(r64), torch.float64, TOL_F64)[1]
    del sim64
    for name, res, ref in (("eager", eager, ref_eager), ("fused (K3)", fused, ref_fused)):
        ratio = res["r_norm"][-1] / ref["r_norm"][-1]
        line.append(f"{name} {res['ms']:.3f} ms/step, CG iterations {res['cg']}, r/r0 "
                    + "/".join(f"{x:.1e}" for x in res["rel"]) + f", settled r_norm "
                    f"{res['r_norm'][-1]:.5g} vs f64 {ref['r_norm'][-1]:.5g} (ratio {ratio:.4f}, "
                    f"f64 CG {ref['cg'][-1]})")
        if not (np.isfinite(res["r_norm"]).all() and max(ratio, 1 / ratio) <= R_NORM_ENVELOPE):
            fail(f"phase 19 {name}: settled r_norm {res['r_norm'][-1]:.5g} is not within "
                 f"{R_NORM_ENVELOPE}x of the float64 step's {ref['r_norm'][-1]:.5g}")
    per_step = {k: v / P2_STEPS for k, v in counts.items()}
    print(f"phase 19 bench_p2 protocol (one Newton iteration from the zero state, CG rtol "
          f"{P2_CG['cg_rtol']:g}, maxiter {P2_CG['cg_maxiter']}; {P2_STEPS} timed steps at "
          f"{P2_LOAD} (1 + 1e-4 k)): " + "; ".join(line) + f"; launches per fused step K1 "
          f"{per_step['K1']:g} K2 {per_step['K2']:g} K3 {per_step['K3']:g} ("
          + ", ".join(f"{kind} {per_step['K3_' + kind]:g}" for kind in K3_ENTRIES)
          + f"); eager run K1 {eager_counts['K1']} K2 {eager_counts['K2']} K3 "
          f"{eager_counts['K3']}; the step's fused V-cycle vs its plain twin, bit-equal across "
          f"two launches: f32 rel {rel_mg['f32']:.1e}, f64 {rel_mg['f64']:.1e}; V-cycle ms on "
          f"the {2 * N_P2 + 1}^3 refined grid: "
          + ", ".join(f"{k} {ms:.3f}" for k, ms in vcycle.items()))
    if counts["K3"] <= 0 or counts["K1"] or counts["K2"] or any(eager_counts.values()):
        fail(f"phase 19 launches: fused {counts}, eager {eager_counts}; expected K3 in the "
             "fused run only and never K1 or K2")

    # (c) PackedSimulation converges: 3 load steps of 0.0004 k, float64, fused V-cycle
    sim = PackedSimulation(law, V, bcs, Q_P2, device=CARD, dtype=torch.float64,
                           preconditioner="vcycle", mg_options={"fused_smoothing": True})
    report = []
    for k in (1, 2, 3):
        bcs[1].value = STRETCH_STEP * k
        t0 = time.perf_counter()
        niter, converged = sim.solve()
        torch.cuda.synchronize()
        st = sim.last_stats
        report.append(f"step {k}: newton {niter}, cg_last {int(st['cg_iters_last'])}, r "
                      f"{st['r_norm']:.3e}, {time.perf_counter() - t0:.2f} s")
        if not converged:
            fail(f"phase 19 PackedSimulation step {k} on the P2 box did not converge: {st}")
    stress = sim.stress
    if stress.shape != (N_P2**3, geo.n_qp, 6) or not np.isfinite(stress).all():
        fail(f"phase 19 PackedSimulation stress has shape {stress.shape} or non-finite values")
    print(f"phase 19 PackedSimulation P2 {N_P2}^3 f64 ({sim.engine} + {sim.preconditioner}, "
          "K3 V-cycle on the refined P1 grid): " + "; ".join(report))
    results["p2_box"] = {"eager_ms": eager["ms"], "fused_ms": fused["ms"]}
    return {"counts": counts}


def k3_hierarchy_checks(label: str, geo, free, results: dict | None, parts: list,
                        key: str = "K3_2d"):
    """K3 against its twins on every level of the hierarchy of geo(dtype)
    (every chain; every fused V-cycle entry; the whole cycle, bit-equal
    across two launches) and the fused V-cycle against the eager one, in
    float64 and float32, with the V(3,3), nu_coarse 2 and direct coarsest
    solve of PackedSimulation's "vcycle". Appends to parts; with results,
    keeps the float32 entries' times, errors and bound under
    ``<key>_<kind>``."""
    from fenics_constitutive_tpu_torch.solver import build_multigrid

    for dtype, tol in ((torch.float64, TOL_F64), (torch.float32, TOL_F32_K1)):
        g = geo(dtype)

        def mg_of(**kw):
            return build_multigrid(g, MU, KAPPA, free, device=CARD, dtype=dtype, nu=3,
                                   nu_coarse=2, **kw)

        mg = mg_of(coarse_direct=True, fused_smoothing=True)
        mg_coarse = mg_of(coarse_direct=False, fused_smoothing=True)
        mg_plain = mg_of(coarse_direct=True)
        rng = np.random.default_rng(3)
        worst = 0.0
        for _, chain in k3_chains(mg, mg_coarse):
            n = chain.inv_d.numel()
            fr = (chain.inv_d != 0).to(dtype)
            b = torch.as_tensor(rng.normal(size=n), dtype=dtype, device=CARD) * fr
            x = torch.as_tensor(rng.normal(size=n) * 1e-5, dtype=dtype, device=CARD) * fr
            args = (b,) if chain.zero_start else (x, b)
            worst = max(worst, check_k3(f"{label} chain", lambda: chain(*args),
                                        lambda: chain.plain(*args), dtype, tol)[1])
        r = torch.as_tensor(np.random.default_rng(2).normal(size=g.vs * g.M), dtype=dtype,
                            device=CARD)
        fc = mg.fused_cycle
        agg = {}
        for name, kind, kernel, plain, cost in k3_entries(fc, r):
            err, rel = check_k3(f"{label} {name}", kernel, plain, dtype, tol)
            worst = max(worst, rel)
            if results is not None and dtype == torch.float32:
                a = agg.setdefault(kind, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                                          "device_ms": 0.0, "bytes": 0.0, "flops": 0.0})
                a["max_abs_err"] = max(a["max_abs_err"], err)
                a["ms"] += cuda_ms(kernel)
                a["device_ms"] += device_ms(kernel, floor_ms=bound_ms(*cost, dtype)[0])
                a["plain_ms"] += cuda_ms(plain)
                a["bytes"] += cost[0]
                a["flops"] += cost[1]
        _, rel_c = check_k3(f"{label} V-cycle", lambda: mg(r), lambda: fc.plain(r), dtype, tol)
        z_f, z_p = mg(r), mg_plain(r)
        rel_u = normwise(z_f, z_p)[1]
        part = (f"{label} {str(dtype)[6:]} levels {[ng for ng in fc.node_grids]} tail from "
                f"{fc.tail_start(r.device)}: chains and entries rel <= {worst:.1e}, V-cycle vs "
                f"twin {rel_c:.1e}, vs eager {rel_u:.1e}")
        if rel_u > tol:
            fail(f"the fused V-cycle on {label} {dtype} disagrees with the eager one: "
                 f"{rel_u:.3e}")
        if dtype == torch.float32:
            part += (f", {cuda_ms(lambda: mg(r), iters=10):.3f} ms fused vs "
                     f"{cuda_ms(lambda: mg_plain(r), iters=10):.3f} ms eager")
            for kind, a in agg.items():
                bound, by = bound_ms(a.pop("bytes"), a.pop("flops"), dtype)
                results[f"{key}_{kind}"] = {**a, "bound_ms": bound, "bound_by": by}
                part += (f"; {kind} {a['ms']:.4f} ms (on the card {a['device_ms']:.4f}) vs plain "
                         f"{a['plain_ms']:.4f}, bound {bound:.6f} ({by})")
        parts.append(part)


def phase_2d(results: dict) -> dict:
    """Phase 20: K3 on quad levels, and the 2D boxes through their entry point."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_square_mesh
    from fenics_constitutive_tpu_torch.models import Constraint, LinearElasticityModel
    from fenics_constitutive_tpu_torch.ops.structured import (
        build_structured_geometry,
        build_structured_tet_geometry,
    )
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    parts = []
    for label, cell, build, res in (
        (f"quad {N_QUAD}^2", "quad", build_structured_geometry, results),
        (f"Kuhn triangles {N_QUAD}^2", "triangle", build_structured_tet_geometry, None),
    ):
        V = FunctionSpace(unit_square_mesh(N_QUAD, N_QUAD, cell), 1, 2)
        free = torch.as_tensor(free_mask(V, box_bcs_2d(V)))
        geo = lambda dtype, V=V, build=build: build(  # noqa: E731
            V, 2, Constraint.PLANE_STRAIN, device=CARD, dtype=dtype)
        if cell == "quad" and geo(torch.float32).N != 4 * N_QUAD**2:
            fail("the quad box does not have 4 QPs a cell")
        k3_hierarchy_checks(label, geo, free, res, parts)
    print("phase 20 K3 on 2D levels vs plain (tol f64 "
          f"{TOL_F64:g}, f32 {TOL_F32_K1:g}; bit-equal across two launches): " + "; ".join(parts))

    from fenics_constitutive_tpu_torch.fem import unit_square_mesh as usm

    V = FunctionSpace(usm(N_QUAD_P2, N_QUAD_P2, "quad"), 2, 2)
    bcs = box_bcs_2d(V)
    t0 = time.perf_counter()
    # plane-strain linear elasticity with the bench material's moduli.
    # (PlaneStrainFrom3D(VonMises3D) does not converge a first step of
    # 0.0004 from 64^2 P2 cells on, in either package: the first Newton
    # iterate strains the last cell layer deep into the saturated hardening
    # range, whose plane-strain tangent is SPD but nearly singular, and CG
    # stops at its 1000-iteration cap.)
    E = 9.0 * KAPPA * MU / (3.0 * KAPPA + MU)
    nu = (3.0 * KAPPA - 2.0 * MU) / (2.0 * (3.0 * KAPPA + MU))
    sim = PackedSimulation(LinearElasticityModel({"E": E, "nu": nu}, Constraint.PLANE_STRAIN),
                           V, bcs, Q_P2, device=CARD, dtype=torch.float64,
                           preconditioner="vcycle", mg_options={"fused_smoothing": True})
    build_s = time.perf_counter() - t0
    if sim.engine != "lattice" or sim._geos[0].N != 9 * N_QUAD_P2**2:
        fail(f"the P2 quad box resolved to {sim.engine} with {sim._geos[0].N} QPs")
    reset_counts()
    report = []
    for k in (1, 2, 3):
        bcs[1].value = STRETCH_STEP * k
        t0 = time.perf_counter()
        niter, converged = sim.solve()
        torch.cuda.synchronize()
        st = sim.last_stats
        report.append(f"step {k}: newton {niter}, cg_last {int(st['cg_iters_last'])}, r "
                      f"{st['r_norm']:.3e}, {time.perf_counter() - t0:.2f} s")
        if not converged:
            fail(f"phase 20 PackedSimulation step {k} on the P2 quad box did not converge: {st}")
    counts = read_counts()
    stress = sim.stress
    if stress.shape != (N_QUAD_P2**2, 9, 4) or not np.isfinite(stress).all():
        fail(f"phase 20 PackedSimulation stress has shape {stress.shape} or non-finite values")
    print(f"phase 20 PackedSimulation P2 quad {N_QUAD_P2}^2 q{Q_P2} f64 "
          f"LinearElasticityModel PLANE_STRAIN ({sim.engine} + {sim.preconditioner}, fused "
          f"refined-P1 V-cycle, build {build_s:.1f} s): " + "; ".join(report)
          + f"; launches K1 {counts['K1']} K2 {counts['K2']} K3 {counts['K3']} ("
          + ", ".join(f"{kind} {counts['K3_' + kind]}" for kind in K3_ENTRIES) + ")")
    if counts["K3"] <= 0 or counts["K1"] or counts["K2"]:
        fail(f"phase 20 launches {counts}: expected K3 and never K1 or K2")
    return {"counts": counts}


def phase_p2_imported(results: dict, workdir: Path) -> dict:
    """Phase 21: P2 on an imported tet mesh, the windowed engine with the AMG."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, read_gmsh, write_gmsh
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_window
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    t0 = time.perf_counter()
    written = imported_mesh(N_P2_TET)
    path = workdir / f"tet{N_P2_TET}.msh"
    write_gmsh(path, written)
    mesh = read_gmsh(path)
    io_s = time.perf_counter() - t0
    if not (np.array_equal(mesh.cells, written.cells)
            and np.array_equal(mesh.nodes, written.nodes)):
        fail("read_gmsh did not give back the mesh write_gmsh wrote")
    V = FunctionSpace(mesh, 2, 3)
    bcs = bench_bcs(V)
    t0 = time.perf_counter()
    sim = PackedSimulation(VonMises3D(MAT), V, bcs, 2, device=CARD, dtype=torch.float32,
                           mg_options={"nu": 3}, newton_rtol=1e-6, newton_atol=1e-3,
                           cg_rtol=1e-5, cg_maxiter=2000)
    build_s = time.perf_counter() - t0
    geos, models, amg = sim._geos, sim._models, sim._mg
    geo = geos[0]
    if (sim.engine, sim.preconditioner) != ("windowed", "amg"):
        fail(f"the P2 tet mesh resolved to {sim.engine} + {sim.preconditioner}")
    if geo.n_cells * geo.n_qp != N_QP_P2_TET or geo.n_nodes != 10:
        fail(f"the P2 tet plan has {geo.n_cells * geo.n_qp} QPs and {geo.n_nodes} nodes a cell")
    state0 = sim.state.clone()

    # K4 and K5 on the P2 plan, K6 on every AMG level
    ex = geo.ex
    line = [f"plan T={ex.T} B={ex.B} Rn={ex.Rn} M_pad={ex.M_pad} N={geo.N}"]
    for dtype in (torch.float64, torch.float32):
        rng = np.random.default_rng(7)
        u2 = torch.as_tensor(rng.normal(size=(3, ex.M_pad)), dtype=dtype, device=CARD)
        f = torch.as_tensor(rng.normal(size=(ex.B, 3, ex.Rn)), dtype=dtype, device=CARD)
        g_k = cuda_window.windowed_gather(ex, u2)
        y1, y2 = cuda_window.windowed_scatter(ex, f), cuda_window.windowed_scatter(ex, f)
        if not torch.equal(g_k, cuda_window.gather_plain(ex, u2)):
            fail(f"K4 {dtype} on the P2 plan is not bit-equal to its plain version")
        rel = normwise(y1, cuda_window.scatter_plain(ex, f))[1]
        if not torch.equal(y1, y2) or rel > TOL_K5[dtype]:
            fail(f"K5 {dtype} on the P2 plan: repeatable {torch.equal(y1, y2)}, rel {rel:.3e}")
        line.append(f"{str(dtype)[6:]} K4 bit-equal, K5 rel {rel:.1e}")
    worst = 0.0
    for lvl in range(amg.n_levels - 1):
        for name in ("A", "P", "R"):
            w32 = getattr(amg, name + "_win")[lvl]
            for w, dtype in ((w32, torch.float32), (copy.deepcopy(w32).double(), torch.float64)):
                x = torch.as_tensor(np.random.default_rng(11).normal(size=w.bc * w.NC_pad),
                                    dtype=dtype, device=CARD)
                y_k = cuda_window.windowed_bsr_matvec(w, x)
                y_k2 = cuda_window.windowed_bsr_matvec(w, x)
                rel = normwise(y_k, cuda_window.bsr_matvec_plain(w, x))[1]
                if not torch.equal(y_k, y_k2) or rel > TOL_K6[dtype]:
                    fail(f"K6 {name}{lvl} {dtype} on the P2 AMG: rel {rel:.3e}")
                worst = max(worst, rel)
    line.append(f"K6 on {3 * (amg.n_levels - 1)} operators of {amg.n_levels} levels rel <= "
                f"{worst:.1e} (f32 select_passes {amg.A_win[0].select_passes}, f64)")

    # phase 9's protocol: fixed-F PCG with the AMG V(3,3), held to fixed-3F and 6F
    pc = amg.wrap_internal(ex.M_pad)
    args = tet_args(geo, bcs, torch.float32, CARD)

    step = tet_step(geos, pc, TET_FIXED)
    st = state0
    for k in (0.5, 1.0, 1.5, 2.0):  # warm-up, driven past yield
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    torch.cuda.synchronize()
    K = 10
    scales = [2.0 + 0.05 * (i + 1) for i in range(K)]
    for key in cuda_window.launches:
        cuda_window.launches[key] = 0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out_state, probes = run_schedule(step, models, st.clone(), args, scales)
    ev1.record()
    ev1.synchronize()
    counts = dict(cuda_window.launches)
    ms_step = ev0.elapsed_time(ev1) / K
    if not (torch.isfinite(probes).all() and torch.isfinite(out_state.u).all()):
        fail("the P2 tet run produced non-finite values")
    r_settled = float(probes[-1])
    refs = [float(run_schedule(tet_step(geos, pc, fk), models, st.clone(), args, scales)[1][-1])
            for fk in TET_VERIFY]
    bs_g, bs_a = geo.build_seconds, amg.build_seconds
    print(f"phase 21 P2 on the imported {N_P2_TET}^3 tet mesh ({mesh.num_cells:,} tets, "
          f"{V.n_dof_nodes:,} dof nodes, {N_QP_P2_TET:,} QPs) f32, windowed + AMG V(3,3): "
          + "; ".join(line) + f"; fixed-{TET_FIXED} PCG {ms_step:.3f} ms/step over {K} steps, "
          f"settled r_norm {r_settled:.4f} vs fixed-{TET_VERIFY[0]} {refs[0]:.4f} and "
          f"fixed-{TET_VERIFY[1]} {refs[1]:.4f} (envelope {R_NORM_ENVELOPE} each); launches K4 "
          f"{counts['gather']} K5 {counts['scatter']} K6 {counts['bsr_matvec']}; set-up s: gmsh "
          f"write+read {io_s:.2f}, RCM {bs_g['rcm']:.2f}, plan {bs_g['plan']:.2f}, geometry "
          f"{bs_g['geometry']:.2f}, AMG host build {bs_a['hierarchy']:.2f}, freeze "
          f"{bs_a['freeze']:.2f}, upload {bs_a['upload']:.2f} (PackedSimulation {build_s:.2f}); "
          f"AMG {amg.n_levels} levels")
    if not (r_settled <= R_NORM_ENVELOPE * refs[0] and refs[0] <= R_NORM_ENVELOPE * refs[1]):
        fail(f"phase 21 settled r_norm {r_settled:.4f} is outside the {R_NORM_ENVELOPE} "
             f"envelopes of the deep re-runs {refs}")
    if min(counts.values()) <= 0:
        fail(f"phase 21 launches {counts}: expected K4, K5 and K6")

    report = []
    for k in (1, 2):
        bcs[1].value = STRETCH_STEP * k
        niter, converged = sim.solve()
        report.append(f"step {k}: newton {niter}, r {sim.last_stats['r_norm']:.3e}")
        if not converged:
            fail(f"phase 21 PackedSimulation step {k} did not converge: {sim.last_stats}")
    if sim.stress.shape != (mesh.num_cells, 4, 6) or not np.isfinite(sim.stress).all():
        fail("phase 21 PackedSimulation stress has the wrong shape or non-finite values")
    print("phase 21 PackedSimulation on the P2 tet mesh (windowed + AMG): " + "; ".join(report))
    results["p2_tet"] = {"ms_step": ms_step}
    return counts


# -- phase 22: the reference-parity path -----------------------------------------------

#: phase 22's Newton and CG tolerances, the same for all three full-width runs
PARITY_SOLVE = dict(rtol=1e-10, atol=1e-8, cg_rtol=1e-10)
TOL_PARITY = 1e-6  # the three runs' u and stress, normwise
N_PARITY_BOX, N_PARITY_TETS = 4, 6  # phase 22(b)'s hex box and shuffled tet mesh
NATIVE_MISES = {"mu": MU, "kappa": KAPPA, "y_0": 1200.0, "h": 200.0}


def window_counts() -> dict:
    from fenics_constitutive_tpu_torch.ops import cuda_window

    return {"K4": cuda_window.launches["gather"], "K5": cuda_window.launches["scatter"],
            "K6": cuda_window.launches["bsr_matvec"]}


def reset_all_counts() -> None:
    from fenics_constitutive_tpu_torch.ops import cuda_window

    reset_counts()
    for key in cuda_window.launches:
        cuda_window.launches[key] = 0


def parity_steps(solve, k_max: int = 2) -> tuple[list, float]:
    """Steps of the stretch 0.0004 k through ``solve(k) -> (niter, cg, ok)``;
    (per-step (niter, cg), ms per step)."""
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, k_max + 1):
        niter, cg, ok = solve(k)
        if not ok:
            fail(f"phase 22: step {k} did not converge")
        rows.append((niter, cg))
    torch.cuda.synchronize()
    return rows, (time.perf_counter() - t0) * 1e3 / k_max


def phase_parity_full(tet: dict) -> dict:
    """Phase 22(a): IncrSmallStrainProblem on both engines and PackedSimulation
    on phase 9's imported 35^3 mesh, float64, with one AMG hierarchy."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import (
        IncrSmallStrainProblem,
        PackedSimulation,
        build_amg,
    )

    f64 = torch.float64
    V = FunctionSpace(tet["mesh"], 1, 3)
    t0 = time.perf_counter()
    amg = build_amg(V, MU, KAPPA, free_mask(V, bench_bcs(V)), q_degree=2, spmv="windowed",
                    device=CARD, dtype=f64)
    amg_s = time.perf_counter() - t0
    runs, line = {}, []
    for name in ("packed", "aos", "simulation"):
        bcs = bench_bcs(V)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if name == "simulation":
            sim = PackedSimulation(
                VonMises3D(MAT), V, bcs, 2, device=CARD, dtype=f64,
                newton_rtol=PARITY_SOLVE["rtol"], newton_atol=PARITY_SOLVE["atol"],
                cg_rtol=PARITY_SOLVE["cg_rtol"], cg_maxiter=5000)
            if (sim.engine, sim.preconditioner) != ("windowed", "amg"):
                fail(f"phase 22 PackedSimulation resolved to {sim.engine} + {sim.preconditioner}")
            build_s, pc_s = time.perf_counter() - t0, sim._mg.build_seconds["hierarchy"]

            def solve(k, sim=sim, bcs=bcs):
                bcs[1].value = STRETCH_STEP * k
                niter, ok = sim.solve()
                return niter, int(sim.last_stats["cg_iters_last"]), ok
        else:
            p = IncrSmallStrainProblem(VonMises3D(MAT), V, bcs, 2, device=CARD, dtype=f64,
                                       engine=name, preconditioner=amg)
            if name == "packed" and p._pk_geos[0].engine != "windowed":
                fail(f"phase 22's packed problem resolved to {p._pk_geos[0].engine}")
            build_s, pc_s = time.perf_counter() - t0, amg.build_seconds["hierarchy"]

            def solve(k, p=p, bcs=bcs):
                bcs[1].value = STRETCH_STEP * k
                niter, ok = p.solve(**PARITY_SOLVE)
                p.update()
                return niter, p.last_stats["cg_iters"], ok
        reset_all_counts()
        rows, ms = parity_steps(solve)
        counts = {**read_counts(), **window_counts()}
        mem = torch.cuda.max_memory_allocated() / 2**30
        if name == "simulation":
            u, stress = sim.u, torch.as_tensor(sim.stress, device=CARD)
        else:
            u, stress = p.u, p.stress_0
            if name == "aos":
                # the AoS residual is a gather and a sum in a fixed order: bit-equal
                r1 = p._eval_assemble_aos(p.u, p._time, p.del_t)[0]
                r2 = p._eval_assemble_aos(p.u, p._time, p.del_t)[0]
                if not torch.equal(r1, r2):
                    fail("phase 22: the AoS residual differs between two calls")
        if not (torch.isfinite(u).all() and torch.isfinite(stress).all()):
            fail(f"phase 22 {name}: non-finite state")
        runs[name] = (u, stress, [r[0] for r in rows], counts)
        if name == "packed":  # phase 23 holds its sharded run to this one
            packed_run = {"u": u.cpu(), "stress": stress.cpu(), "rows": [list(r) for r in rows],
                          "ms": ms, "amg": amg}
        line.append(f"{name}: {ms:.1f} ms/step, newton {[r[0] for r in rows]}, cg "
                    f"{[r[1] for r in rows]}{' (last solve)' if name == 'simulation' else ''}, "
                    f"set-up {build_s:.1f} s (AMG host build {pc_s:.1f} s), peak "
                    f"{mem:.2f} GiB, launches K4 {counts['K4']} K5 {counts['K5']} K6 "
                    f"{counts['K6']} K1-K3 {counts['K1'] + counts['K2'] + counts['K3']}")
    u0, s0, it0, _ = runs["packed"]
    worst = 0.0
    for name in ("aos", "simulation"):
        u, s, its, _ = runs[name]
        rel = max(normwise(u, u0)[1], normwise(s, s0)[1])
        worst = max(worst, rel)
        if rel > TOL_PARITY or any(abs(a - b) > 1 for a, b in zip(its, it0)):
            fail(f"phase 22 {name} against the packed problem: rel {rel:.2e}, newton {its} "
                 f"vs {it0}")
    packed_counts = runs["packed"][3]
    print(f"phase 22(a) the reference-parity path on the imported {N_TET}^3 mesh "
          f"({tet['mesh'].num_cells:,} tets, {N_QP_TET:,} padded QPs) f64, 2 steps of "
          f"{STRETCH_STEP} k, Newton rtol {PARITY_SOLVE['rtol']:g} atol {PARITY_SOLVE['atol']:g},"
          f" CG rtol {PARITY_SOLVE['cg_rtol']:g}, one AMG (windowed levels, host build "
          f"{amg_s:.1f} s) for both problems: " + "; ".join(line)
          + f"; u and stress agree within {worst:.2e} (tol {TOL_PARITY:g}); the AoS residual "
          "is bit-equal across two calls")
    for name, (_, _, _, counts) in runs.items():
        if counts["K1"] or counts["K2"] or counts["K3"]:
            fail(f"phase 22 {name} launched K1-K3: {counts}")
    if min(packed_counts["K4"], packed_counts["K5"], packed_counts["K6"]) <= 0:
        fail(f"phase 22's packed problem did not launch K4, K5 and K6: {packed_counts}")
    return {"packed": packed_counts, "steps": 2, **packed_run}


def parity_small_cases() -> dict:
    """Phase 22(b)'s meshes: name -> (space maker, problem options)."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace

    return {
        "box": (lambda: box(N_PARITY_BOX)[0], {}),
        "tets": (lambda: FunctionSpace(imported_mesh(N_PARITY_TETS), 1, 3),
                 {"preconditioner": "amg"}),
    }


def parity_laws(V, kind: str):
    from fenics_constitutive_tpu_torch import models as m

    if kind == "one law":
        return m.VonMises3D(MAT)
    z = V.mesh.cell_midpoints()[:, 2]
    return [(m.LinearElasticityModel({"E": 150000.0, "nu": 0.3}, m.Constraint.FULL),
             np.flatnonzero(z < 0.5)), (m.VonMises3D(MAT), np.flatnonzero(z >= 0.5))]


def parity_small_run(space, opts, engine, kind, device):
    """Two converged steps of 0.004 k; (iterations, u, stress) on the host."""
    from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem

    V = space()
    bcs = bench_bcs(V)
    p = IncrSmallStrainProblem(parity_laws(V, kind), V, bcs, 2, device=device,
                               dtype=torch.float64, engine=engine, **opts)
    its = []
    for k in (1, 2):
        bcs[1].value = 0.004 * k
        niter, ok = p.solve(rtol=1e-11, atol=1e-10, cg_rtol=1e-12)
        if not ok:
            fail(f"phase 22(b) {engine} {kind} on {device}: step {k} did not converge")
        p.update()
        its.append(niter)
    return its, p.u.cpu(), p.stress_0.cpu(), p


def load_step_run(space, device):
    """make_load_step over two steps of 0.004 k from the zero state."""
    from fenics_constitutive_tpu_torch.fem import combine_bcs
    from fenics_constitutive_tpu_torch.solver import (
        IncrSmallStrainProblem,
        StepState,
        make_load_step,
    )

    V = space()
    bcs = bench_bcs(V)
    law = parity_laws(V, "one law")
    p = IncrSmallStrainProblem(law, V, bcs, 2, device=device, dtype=torch.float64, engine="aos")
    step = make_load_step(p, newton_rtol=1e-11)
    st = StepState(u=p.u, stress=p._stress_prev, histories=p._histories,
                   t=torch.zeros((), dtype=torch.float64, device=device))
    its = []
    for k in (1, 2):
        bcs[1].value = 0.004 * k
        dofs, vals = combine_bcs(bcs)
        st, stats = step(p._models, st, dofs, vals, torch.zeros_like(p.u), 1.0)
        its.append(int(stats["newton_iters"]))
    return its, st.u.cpu(), st.stress.cpu()


def phase_parity_small(workdir: Path) -> None:
    """Phase 22(b): small meshes on the card against the CPU, float64."""
    from fenics_constitutive_tpu_torch import models as m
    from fenics_constitutive_tpu_torch import native
    from fenics_constitutive_tpu_torch.postprocessing import DisplacementSensor, QPSensor, norm
    from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem
    from fenics_constitutive_tpu_torch.utils import (
        load_checkpoint,
        load_state_dict,
        save_checkpoint,
        state_dict,
    )

    line, worst = [], 0.0
    for mesh_name, (space, opts) in parity_small_cases().items():
        runs = {}
        for engine in ("packed", "aos"):
            for kind in ("one law", "two laws"):
                out = {d: parity_small_run(space, opts, engine, kind, d) for d in (CARD, "cpu")}
                runs[(engine, kind)] = out
        runs[("load step", "one law")] = {d: load_step_run(space, d) for d in (CARD, "cpu")}
        for (engine, kind), out in runs.items():
            (it_c, u_c, s_c, *_), (it_h, u_h, s_h, *_) = out[CARD], out["cpu"]
            rel = max(normwise(u_c, u_h)[1], normwise(s_c, s_h)[1])
            worst = max(worst, rel)
            if it_c != it_h or rel > TOL_SMALL:
                fail(f"phase 22(b) {mesh_name} {engine} {kind}: newton {it_c} on the card, "
                     f"{it_h} on the CPU, rel {rel:.2e}")
        line.append(f"{mesh_name} newton {runs[('packed', 'one law')][CARD][0]}")

        # observations of the card's packed one-law problem against the CPU's
        p_c, p_h = runs[("packed", "one law")][CARD][3], runs[("packed", "one law")]["cpu"][3]
        V = p_c.space
        pts = [[0.5, 0.25, 0.25], [0.9, 0.6, 0.3]]
        reads = []
        for p in (p_c, p_h):
            reads.append((DisplacementSensor(V, pts)(p.u).cpu(),
                          QPSensor(V, 2, pts)(p.stress_0).cpu(), norm(p.stress_0, p.dxm).cpu()))
        for a, b in zip(*reads):
            rel = normwise(a, b)[1]
            worst = max(worst, rel)
            if rel > TOL_SMALL:
                fail(f"phase 22(b) {mesh_name}: a sensor or norm differs from the CPU by {rel:.2e}")

        # a checkpoint round trip on the card continues bit-equal
        def problem():
            bcs = bench_bcs(V)
            return IncrSmallStrainProblem(parity_laws(V, "one law"), V, bcs, 2, device=CARD,
                                          dtype=torch.float64, **opts), bcs

        (pa, ba), (pb, bb) = problem(), problem()
        ba[1].value = 0.004
        pa.solve()
        pa.update()
        path = workdir / f"parity_{mesh_name}.npz"
        save_checkpoint(path, state_dict(pa))
        load_state_dict(pb, load_checkpoint(path))
        for p, b in ((pa, ba), (pb, bb)):
            b[1].value = 0.008
            p.solve()
            p.update()
        if not (torch.equal(pa.u, pb.u) and torch.equal(pa.stress_0, pb.stress_0)):
            fail(f"phase 22(b) {mesh_name}: the restored problem did not continue bit-equal")

    # the native bridge in a problem on the card, against the port's own models
    E_ = 9.0 * KAPPA * MU / (3.0 * KAPPA + MU)
    NU_ = (3.0 * KAPPA - 2.0 * MU) / (2.0 * (3.0 * KAPPA + MU))
    elastic = lambda: m.LinearElasticityModel({"E": E_, "nu": NU_}, m.Constraint.FULL)  # noqa: E731
    pairs = {
        "LinearElasticity3D": (lambda: native.LinearElasticity3D({"mu": MU, "kappa": KAPPA}),
                               elastic),
        "mises": (lambda: native.NativeModel("mises_linear_hardening3d", NATIVE_MISES),
                  lambda: m.MisesPlasticityLinearHardening3D(NATIVE_MISES)),
        "C UMAT": (lambda: native.UmatModel(native.umat_demo_path(), [E_, NU_], n_statev=1),
                   elastic),
    }
    t0 = time.perf_counter()
    native.ensure_built()
    native_s = time.perf_counter() - t0
    nat = []
    for name, (native_law, port_law) in pairs.items():
        out = []
        for law in (native_law(), port_law()):
            V = box(N_PARITY_BOX)[0]
            bcs = bench_bcs(V)
            p = IncrSmallStrainProblem(law, V, bcs, 2, device=CARD, dtype=torch.float64)
            for k in (1, 2):
                bcs[1].value = 0.004 * k
                if not p.solve(rtol=1e-11, atol=1e-10, cg_rtol=1e-12)[1]:
                    fail(f"phase 22(b) {name}: step {k} did not converge")
                p.update()
            out.append((p.u, p.stress_0))
        rel = max(normwise(out[0][0], out[1][0])[1], normwise(out[0][1], out[1][1])[1])
        if rel > TOL_SMALL:
            fail(f"phase 22(b) native {name} differs from the port's model by {rel:.2e}")
        nat.append(f"{name} rel {rel:.1e}")
    print(f"phase 22(b) small meshes card vs CPU f64 (a {N_PARITY_BOX}^3 hex box on the "
          f"structured engine with Jacobi, a shuffled {N_PARITY_TETS}^3 tet mesh on the gather "
          "engine with the AMG; both engines, one law and two laws, make_load_step; 2 steps of "
          f"0.004 k, Newton counts equal, tol {TOL_SMALL:g}): max rel {worst:.2e}; "
          + "; ".join(line) + "; sensors, norm and a checkpoint round trip (bit-equal) on both; "
          f"native laws in a problem on the card (build {native_s:.1f} s): " + "; ".join(nat))


def phase_parity(tet: dict, workdir: Path) -> dict:
    """Phase 22: the reference-parity path."""
    full = phase_parity_full(tet)
    reset_all_counts()
    phase_parity_small(workdir)
    counts = read_counts()
    if counts["K1"] or counts["K2"] or counts["K3"]:
        fail(f"phase 22(b) launched K1-K3: {counts}")
    return full


# phase 23's small problems: the reference's MPI test problem (the JAX
# package's tests/parallel/test_sharding.py, 10 steps at its tight
# tolerances) on the AoS engine, and the 7^3 hex box with linear hardening on
# the structured engine
SHARD_TIGHT = dict(rtol=1e-14, atol=1e-12, cg_rtol=1e-15)
SHARD_SMALL = {
    "aos": {"mesh": ("box", (4, 6, 7), "tetra"), "law": "mises", "q": 1, "engine": "aos",
            "loads": [0.05 * k / 10 for k in range(1, 11)], "solve": SHARD_TIGHT},
    "hardening": {"mesh": ("box", (7, 7, 7), "hex"), "law": "hardening", "q": 2,
                  "loads": [0.01, 0.02, 0.03],
                  "solve": dict(rtol=1e-14, atol=1e-13, cg_rtol=1e-15)},
}
SHARD_BAR = {"full": 1e-12, "aos": 1e-14, "hardening": 1e-12}
N_RANKS = 2
RANK_DEVICE = None  # each rank computes on cuda:{rank % device_count}: here the one card
SHARD_TIMEOUT = 600.0  # the process group's and the join's, seconds


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def kernel_check_errors(res: dict, label: str) -> str:
    """Fail unless a rank's run held K4 and K5 to their plain versions on
    its windowed plan (``check_window_kernels``); the checks in words."""
    checks = res.get("kernel_checks") or []
    if not checks:
        fail(f"{label}: K4 and K5 were not held to their plain versions on its plan")
    for c in checks:
        tol = TOL_K5[getattr(torch, c["dtype"])]
        if not (c["k4_equal"] and c["k5_repeatable"]) or c["k5_rel"] > tol:
            fail(f"{label} on its plan {c['plan']} {c['dtype']}: K4 bit-equal {c['k4_equal']}, "
                 f"K5 repeatable {c['k5_repeatable']}, K5 rel {c['k5_rel']:.2e} (tol {tol:g})")
    return (f"plan {checks[0]['plan']}: " + ", ".join(
        f"{c['dtype']} K4 bit-equal, K5 rel {c['k5_rel']:.1e}" for c in checks))


def phase_sharded(tet: dict, parity: dict, workdir: Path) -> list:
    """Phase 23: IncrSmallStrainProblem sharded over 2 gloo ranks spawned on
    the one card (parallel/), and over 1 rank through the same wrappers;
    returns each of the 2 ranks' K4-K6 launches in the full-width run."""
    from fenics_constitutive_tpu_torch.fem import write_gmsh41_binary
    import datetime

    import torch.distributed as dist

    from fenics_constitutive_tpu_torch.parallel import dryrun_multichip, make_device_mesh, run_ranks
    from fenics_constitutive_tpu_torch.parallel.runs import (
        allreduce_run,
        cases_rank,
        pair_run,
        problem_run,
    )

    path = workdir / "tet35.msh"
    write_gmsh41_binary(path, tet["mesh"])
    # phase 22's packed problem: its mesh (read back by every rank), its AMG
    # (built by every rank: windowed levels, passed as a node-major callable);
    # timed after an untimed run of the first load in the same process, and
    # after the steps each rank holds K4 and K5 to their plain versions on
    # its own plan
    full = {"mesh": ("gmsh", str(path)), "law": "mises", "q": 2,
            "preconditioner": "amg_windowed", "loads": [STRETCH_STEP * k for k in (1, 2)],
            "solve": PARITY_SOLVE, "check_window_kernels": True}
    # the dry run's ranks (a check, not timed) while this process computes
    # the card's one-process runs of the small problems
    with ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        dry_run = pool.submit(dryrun_multichip, N_RANKS, CARD, SHARD_TIMEOUT)
        refs = {name: problem_run(spec, CARD) for name, spec in SHARD_SMALL.items()}
        dry = dry_run.result()
        refs_s = time.perf_counter() - t0
    print(f"phase 23(c) dryrun_multichip({N_RANKS}, device={CARD!r}): "
          + ", ".join(f"{k} rel {v['rel_u']:.2e} QP share {v['qp_share']:.2f}"
                      for k, v in dry[0].items()))
    refs["full"] = {"u": parity["u"], "stress": parity["stress"], "iters": parity["rows"]}
    n_int = tet["geos"][0].ndofs_int  # the internal vector every CG iteration sums
    reduce_case = ("allreduce", {"numel": n_int, "dtype": "float64", "iters": 50})
    cases = {"full": ("warm", full),
             **{name: ("problem", spec) for name, spec in SHARD_SMALL.items()},
             "allreduce": reduce_case}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(cases_rank, N_RANKS, cases, RANK_DEVICE, workdir=workdir / "ranks",
                      timeout=SHARD_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    # the same full-width run in this process, unsharded and then sharded
    # over a 1-rank group (the wrappers and a 1-rank gloo all-reduce), with
    # phase 22's AMG and no second process on the card
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{workdir / 'store1'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        mesh1 = make_device_mesh(1, device=RANK_DEVICE)
        pair = pair_run(full, mesh1, pc=parity["amg"])
        alone = {"full": pair["sharded"], "allreduce": allreduce_run(reduce_case[1], mesh1)}
    finally:
        dist.destroy_process_group()
    alone_s = time.perf_counter() - t0
    line = []
    for name in ("full", "aos", "hardening"):
        ref = refs[name]
        for rank, res in enumerate([*ranks, alone] if name == "full" else ranks):
            r = res[name]
            who = "the 1-rank run" if rank == N_RANKS else f"rank {rank}"
            ru, rs = rel_l2(r["u"], ref["u"]), rel_l2(r["stress"], ref["stress"])
            newton = [k for k, _ in r["iters"]]
            if max(ru, rs) > SHARD_BAR[name] or newton != [k for k, _ in ref["iters"]]:
                fail(f"phase 23 {name} {who}: rel u {ru:.2e}, stress {rs:.2e} (bar "
                     f"{SHARD_BAR[name]:g}), iterations {r['iters']} vs {ref['iters']}")
            if name == "full" and r["iters"] != ref["iters"]:
                fail(f"phase 23 full {who}: Newton/CG {r['iters']} vs phase 22's "
                     f"{ref['iters']}")
            if not r["u_bitequal"]:
                fail(f"phase 23 {name}: the ranks' u differ")
            if rank == 0:
                line.append(f"{name} rel u {ru:.2e} stress {rs:.2e}")
    per_rank, launches = [], []
    for rank, res in enumerate(ranks):
        r = res["full"]
        k = {"K4": r["launches"]["gather"], "K5": r["launches"]["scatter"],
             "K6": r["launches"]["bsr_matvec"]}
        if min(k.values()) <= 0:
            fail(f"phase 23 rank {rank} did not launch K4, K5 and K6: {k}")
        launches.append(k)
        per_rank.append(
            f"rank {rank}: {r['ms_step']:.1f} ms/step, set-up {r['setup_s']:.1f} s and the AMG "
            f"{r['pc_s']:.1f} s (peak "
            f"{r['setup_mem_peak'] / 2**30:.2f} GiB), steps' peak {r['mem_peak'] / 2**30:.2f} "
            f"GiB, QP state {r['qp_numel']:,} of {r['whole_qp_numel']:,}, launches K4 {k['K4']} "
            f"K5 {k['K5']} K6 {k['K6']}, {r['all_reduces']} all-reduces; "
            + kernel_check_errors(r, f"phase 23 rank {rank}")
            + f"; aos {res['aos']['ms_step']:.1f} ms/step, hardening "
            f"{res['hardening']['ms_step']:.1f} ms/step; all_reduce of {n_int:,} f64 on the "
            f"card {res['allreduce']['ms']:.3f} ms")
    a = alone["full"]
    one = pair["one"]
    ru = rel_l2(one["u"], refs["full"]["u"])
    if one["iters"] != refs["full"]["iters"] or ru > SHARD_BAR["full"]:
        fail(f"phase 23's 1-rank process, unsharded: Newton/CG {one['iters']}, rel u {ru:.2e} "
             "against phase 22")
    one = one["ms_step"]
    ka = {"K4": a["launches"]["gather"], "K5": a["launches"]["scatter"],
          "K6": a["launches"]["bsr_matvec"]}
    if min(ka.values()) <= 0:
        fail(f"phase 23's 1-rank run did not launch K4, K5 and K6: {ka}")
    checks_1 = kernel_check_errors(a, "phase 23's 1-rank run")
    # where the 2-rank step's time goes, from this call's measurements
    steps = len(full["loads"])
    n_red = ranks[0]["full"]["all_reduces"] / steps
    red_1, red_2 = alone["allreduce"]["ms"], max(res["allreduce"]["ms"] for res in ranks)
    ms_2 = max(res["full"]["ms_step"] for res in ranks)
    print(f"phase 23(a, b) {N_RANKS} gloo ranks on the one card: phase 22's packed problem "
          f"({tet['mesh'].num_cells:,} tets, {N_QP_TET:,} padded QPs, f64, {steps} steps) "
          f"sharded, Newton/CG {ranks[0]['full']['iters']} as phase 22's; the AoS problem of "
          f"the reference's MPI test (10 steps) and the 7^3 hardening box against the card's "
          f"one-process runs (with the dry run, {refs_s:.1f} s): " + "; ".join(line)
          + "; ranks bit-equal; " + "; ".join(per_rank)
          + f"; ranks spawned and joined in {ranks_s:.1f} s")
    print(f"phase 23(a) 1 rank in this process through the same wrappers: {a['ms_step']:.1f} "
          f"ms/step, set-up {a['setup_s']:.1f} s (without the AMG), steps' peak {a['mem_peak'] / 2**30:.2f} GiB, Newton/CG "
          f"{a['iters']}, launches K4 {ka['K4']} K5 {ka['K5']} K6 {ka['K6']}, "
          f"{a['all_reduces']} all-reduces, all_reduce of {n_int:,} f64 {red_1:.3f} ms; "
          f"{checks_1}; in the same process unsharded before it {one:.1f} ms/step (phase "
          f"22's counts); both with the warm-up in {alone_s:.1f} s")
    print(f"phase 23 split of the 2-rank step (ms/step): one process {one:.1f} (phase 22 in "
          f"this call {parity['ms']:.1f}); 1 rank {a['ms_step']:.1f} (of which "
          f"its {n_red:.0f} all-reduces a step {n_red * red_1:.1f}); 2 ranks {ms_2:.1f} "
          f"(all-reduces {n_red * red_2:.1f}); the wrappers and the 1-rank all-reduces add "
          f"{a['ms_step'] - one:.1f}, the second rank {ms_2 - a['ms_step']:.1f}, of which the "
          f"2-rank all-reduces' extra {n_red * (red_2 - red_1):.1f} and the rest "
          f"{ms_2 - a['ms_step'] - n_red * (red_2 - red_1):.1f}")
    return launches


#: the examples on the port (examples/torch/<name>/run_example.py)
EXAMPLES = ("creep_neumann", "plasticity_demo", "custom_torch_model", "elasticity_cpp",
            "mises_c")
EXAMPLES_DIR = Path(__file__).resolve().parent / "examples" / "torch"
N_CREEP = 50  # the full-width creep box: 1,000,000 QPs at q 2
N_MISES_C = 32  # the C law's box: 262,144 QPs at q 2
CREEP_WINDOWS = 5  # the 40 creep steps in 5 timed windows, the first a warm-up


def load_example(name: str):
    """An example on the port as a module (its main(), its classes)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES_DIR / name / "run_example.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example_scripts(workdir: Path) -> None:
    """(a) every example as a user runs it, `python examples/torch/<name>/
    run_example.py <dir>` on the card, all five at once; each must exit 0."""
    import sys

    procs = {}
    try:
        for name in EXAMPLES:
            out = workdir / name
            out.mkdir(parents=True)
            procs[name] = subprocess.Popen(
                [sys.executable, str(EXAMPLES_DIR / name / "run_example.py"), str(out)],
                cwd=out, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, proc in procs.items():
            t0 = time.perf_counter()
            stdout, stderr = proc.communicate(timeout=300)
            lines = stdout.strip().splitlines()
            print(f"phase 24 (a) {name}: exit {proc.returncode}, {len(lines)} lines, waited "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            for ln in lines:
                print(f"  {name}: {ln}")
            if proc.returncode != 0:
                fail(f"examples/torch/{name} exited {proc.returncode}:\n{stderr[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def creep_full_width(workdir: Path) -> dict:
    """(b) the creep example at 50^3 through its main(): the V-cycle with the
    K3 chains, K1 for the CG operator, the closed-form bars; then K1 on the
    run's own tangent and K3's whole V-cycle against their plain versions."""
    from fenics_constitutive_tpu_torch.ops import cuda_matvec

    creep = load_example("creep_neumann")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_gib = torch.cuda.memory_allocated() / 2**30  # earlier phases' live tensors
    reset_all_counts()
    r = creep.main(str(workdir / "creep_full_width"), device=CARD, n=N_CREEP,
                   windows=CREEP_WINDOWS, preconditioner="vcycle",
                   mg_options={"fused_smoothing": True})
    torch.cuda.synchronize()
    counts = {**read_counts(), **window_counts()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    eps0, eps_inf = r["instant_strain"], r["creep_strain"]
    err0 = abs(eps0 - creep.SIGMA / creep.E0)
    err_inf = abs(eps_inf - (creep.SIGMA / creep.E0 + creep.SIGMA / creep.E1))
    timed_ms = r["window_ms_per_step"][1:]  # the first window is the warm-up
    sim = r["simulation"]
    geo, law = sim._geos[0], sim._models[0]

    # K1 on the run's own tangent (the law's uniform SLS tangent at the last dt)
    st = sim.state
    _, tg, _ = law.evaluate_packed(sim.time, sim.del_t, geo.strain_gm(st.u), st.stress[0],
                                   st.histories[0])
    v = torch.as_tensor(np.random.default_rng(24).normal(size=geo.ndofs), dtype=geo.dtype,
                        device=CARD)
    mv = cuda_matvec.build_cuda_matvec(geo)
    r_k, r_k2 = mv(v, tg), mv(v, tg)
    r_p = cuda_matvec.matvec_plain(geo, v, tg)
    torch.cuda.synchronize()
    k1_err, k1_rel = normwise(r_k, r_p)
    if not torch.isfinite(r_k).all() or not torch.equal(r_k, r_k2) or k1_rel > TOL_F64:
        fail(f"K1 on the creep tangent: rel {k1_rel:.3e} (tol {TOL_F64:g}), bit-equal "
             f"{torch.equal(r_k, r_k2)}")
    # K3: the run's whole fused V-cycle against its plain twin
    mg = sim._mg
    rv = torch.as_tensor(np.random.default_rng(25).normal(size=geo.ndofs), dtype=geo.dtype,
                         device=CARD)
    k3_err, k3_rel = check_k3("creep V-cycle", lambda: mg(rv), lambda: mg.fused_cycle.plain(rv),
                              torch.float64, TOL_F64)

    print(f"phase 24 (b) creep_neumann at {N_CREEP}^3 ({geo.ndofs:,} dofs, "
          f"{geo.n_qp * N_CREEP**3:,} QPs, f64, V-cycle with K3, K1): instant strain {eps0!r} "
          f"(|err| {err0:.2e}, bar 1e-8), creep limit {eps_inf!r} (|err| {err_inf:.2e}, bar "
          f"1e-6); Newton instant {r['instant_newton']}, creep {sum(r['creep_newton'])} over "
          f"40 steps; ms/step over {len(timed_ms)} windows of {40 // CREEP_WINDOWS} steps after "
          f"a warm-up window ({r['window_ms_per_step'][0]:.1f}): median "
          f"{float(np.median(timed_ms)):.2f}, min {min(timed_ms):.2f}, max {max(timed_ms):.2f}; "
          f"set-up {r['setup_s']:.2f} s; peak {peak_gib - base_gib:.2f} GiB above the "
          f"{base_gib:.2f} GiB allocated before the run; launches "
          + ", ".join(f"{k} {c}" for k, c in counts.items())
          + f"; K1 on the run's tangent vs plain max_abs_err {k1_err:.3e} rel {k1_rel:.3e}, "
          f"K3 V-cycle vs plain max_abs_err {k3_err:.3e} rel {k3_rel:.3e} (tol {TOL_F64:g}), "
          "each bit-equal across two launches", flush=True)
    if err0 >= 1e-8 or err_inf >= 1e-6:
        fail(f"creep at {N_CREEP}^3 misses the closed form: {err0:.3e}, {err_inf:.3e}")
    for name in ("K1", "K3", *(f"K3_{kind}" for kind in K3_ENTRIES)):
        if counts[name] <= 0:
            fail(f"the full-width creep run never launched {name}")
    return {"counts": counts}


def mises_c_on_the_card() -> None:
    """(c) the C law at 32^3 for its first 3 load steps: the C call's ms per
    eval (host clock: it runs on the host), the host<->device copies' ms per
    eval (CUDA events around each side), ms per step."""
    mc = load_example("mises_c")
    parts = {"to_host": [], "call_library": [], "to_device": []}
    originals = {k: getattr(mc.MisesC3D, k) for k in parts}

    def on_events(name):
        def wrapped(self, *args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = originals[name](self, *args)
            e1.record()
            e1.synchronize()
            parts[name].append(e0.elapsed_time(e1))
            return out
        return wrapped

    def on_host(name):
        def wrapped(self, *args):
            t0 = time.perf_counter()
            out = originals[name](self, *args)
            parts[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapped

    mc.MisesC3D.to_host, mc.MisesC3D.to_device = on_events("to_host"), on_events("to_device")
    mc.MisesC3D.call_library = on_host("call_library")
    t0 = time.perf_counter()
    r = mc.main(device=CARD, n=N_MISES_C, n_steps=3)
    total_s = time.perf_counter() - t0
    steps = r["steps"]
    n_eval = len(parts["call_library"])
    q = 8 * N_MISES_C**3
    # per point: grad 9, stress 6, history 7 in; stress 6, tangent 36, history 7 out
    copy_mb = q * (9 + 6 + 7 + 6 + 36 + 7) * 8 / 1e6
    lib, down, up = (float(np.mean(parts[k])) for k in ("call_library", "to_host", "to_device"))
    eval_share = n_eval * (lib + down + up) / 1e3 / sum(s["seconds"] for s in steps)
    print(f"phase 24 (c) mises_c at {N_MISES_C}^3 ({q:,} QPs, f64), 3 steps in {total_s:.1f} s: "
          f"{n_eval} evals; per eval the C library {lib:.1f} ms (host clock), the copies "
          f"{down + up:.1f} ms ({down:.1f} to the host, {up:.1f} back; {copy_mb:.0f} MB, "
          f"{copy_mb / (down + up):.2f} GB/s; CUDA events); per step "
          + ", ".join(f"{s['seconds'] * 1e3:.0f} ms ({s['iters']} Newton, {s['cg_iters']} CG)"
                      for s in steps)
          + f"; the evals' share of the steps {eval_share:.0%}", flush=True)
    if not all(s["converged"] for s in steps) or steps[-1]["alpha_max"] <= 0.0:
        fail(f"mises_c at {N_MISES_C}^3 did not converge past yield: {steps}")


def phase_examples(workdir: Path) -> dict:
    """Phase 24: the user layer (the examples on the port)."""
    run_example_scripts(workdir / "scripts")
    creep = creep_full_width(workdir)
    mises_c_on_the_card()
    return creep


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
    box_bench = timed("phase 5", phase_bench, results)
    timed("phase 6", phase_simulation)
    with tempfile.TemporaryDirectory() as tmp:
        tet = timed("tet setup", tet_setup, Path(tmp))
    timed("phase 7", phase_k4_k5, results, tet)
    timed("phase 8", phase_k6, results, tet)
    tet_counts = timed("phase 9", phase_tet_bench, tet)
    timed("phase 10", phase_tet_simulation, tet)
    timed("phase 11", phase_k3, results)
    fused_bench = timed("phase 12", phase_bench_fused, box_bench)
    with tempfile.TemporaryDirectory() as tmp:
        timed("phase 13", phase_multimat, Path(tmp))
    two_law = timed("phase 14", phase_multilaw, tet)
    timed("phase 15", phase_library)
    tet_box = timed("phase 16", phase_tet_box, results)
    with tempfile.TemporaryDirectory() as tmp:
        gather_counts = timed("phase 17", phase_gather, tet, Path(tmp))
    timed("phase 18", phase_small)
    p2_box_run = timed("phase 19", phase_p2_box, results)
    run_2d = timed("phase 20", phase_2d, results)
    with tempfile.TemporaryDirectory() as tmp:
        p2_tet = timed("phase 21", phase_p2_imported, results, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        parity = timed("phase 22", phase_parity, tet, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        sharded = timed("phase 23", phase_sharded, tet, parity, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        examples = timed("phase 24", phase_examples, Path(tmp))
    print(f"profiler: {PROFILER_MISSES['profiles']} short profiles taken again, "
          f"{PROFILER_MISSES['fallbacks']} measures by the fallback (gated_ms, aten_device_ops)")
    counts = box_bench["counts"]
    src = "fenics_constitutive_tpu_torch/csrc/"
    kernels = [
        {"name": "fused_matvec", "route": "cuda", "source": src + "matvec.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_matvec.py:42",
         "launches": counts["K1"], "launches_parity_run": parity["packed"]["K1"],
         "launches_examples_run": examples["counts"]["K1"], **results["K1"]},
        {"name": "fused_eval", "route": "cuda", "source": src + "eval.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_eval.py:52",
         "launches": counts["K2"], "launches_parity_run": parity["packed"]["K2"],
         **results["K2"]},
        *({"name": name, "route": "cuda", "source": src + "smoother.cu",
           "replaces": "fenics_constitutive_tpu/ops/pallas_smoother.py:38",
           "launches": fused_bench["counts"][f"K3_{kind}"],
           "launches_tet_run": tet_box["counts"][f"K3_{kind}"],
           "launches_p2_run": p2_box_run["counts"][f"K3_{kind}"],
           "launches_2d_run": run_2d["counts"][f"K3_{kind}"],
           "launches_parity_run": parity["packed"][f"K3_{kind}"],
           "launches_examples_run": examples["counts"][f"K3_{kind}"], **results[f"K3_{kind}"],
           "p2_levels": results[f"K3_p2_{kind}"], "quad_levels": results[f"K3_2d_{kind}"]}
          for kind, name in K3_ENTRIES.items()),
        {"name": "windowed_gather", "route": "cuda", "source": src + "window.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_window.py:89",
         "launches": tet_counts["gather"], "launches_two_law_run": two_law["gather"],
         "launches_p2_run": p2_tet["gather"], "launches_parity_run": parity["packed"]["K4"],
         "launches_sharded_run": [r["K4"] for r in sharded],
         **results["K4"]},
        {"name": "windowed_scatter", "route": "cuda", "source": src + "window.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_window.py:153",
         "launches": tet_counts["scatter"], "launches_two_law_run": two_law["scatter"],
         "launches_p2_run": p2_tet["scatter"], "launches_parity_run": parity["packed"]["K5"],
         "launches_sharded_run": [r["K5"] for r in sharded],
         **results["K5"]},
        {"name": "windowed_bsr_matvec", "route": "cuda", "source": src + "window.cu",
         "replaces": "fenics_constitutive_tpu/ops/pallas_window.py:235",
         "launches": tet_counts["bsr_matvec"], "launches_two_law_run": two_law["bsr_matvec"],
         "launches_gather_run": gather_counts["bsr_matvec"],
         "launches_p2_run": p2_tet["bsr_matvec"],
         "launches_parity_run": parity["packed"]["K6"],
         "launches_sharded_run": [r["K6"] for r in sharded], **results["K6"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }))


def short_name(key: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0][:70]


def profile_steps(label: str, run, K: int) -> None:
    """torch.profiler over run(), which takes K load steps: device time per
    step against the same call's CUDA-event ms/step (unprofiled), device ops
    per step and the costliest kernels."""
    run()  # warm
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    run()
    ev1.record()
    ev1.synchronize()
    ms_step = ev0.elapsed_time(ev1) / K
    evs = profiled(run, 1)
    if evs is None:
        fail(f"profile {label}: torch.profiler delivered no device event in three profiles")
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3 / K
    launches = sum(e.count for e in evs) / K
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: {ms_step:.3f} ms/step (CUDA events), device time {dev_ms:.3f} "
          f"ms/step (busy {dev_ms / ms_step:.1%}), {launches:.0f} device ops/step; top: "
          + "; ".join(f"{short_name(e.key)} x{e.count // K} "
                      f"{e.self_device_time_total / 1e3 / K:.3f} ms" for e in top))


def profile_box() -> None:
    """``--profile``: 3 steps of the bench workload with the unfused and the
    fused V-cycle."""
    K = 3
    for fused in (False, True):
        geos, models, state, mg, args = bench_setup(N_BENCH, torch.float32, "cuda",
                                                    fused=fused)
        step = bench_step(geos, mg, 9, "kernel")
        st = state
        for k in (0.5, 1.0, 1.5):
            st, _ = step(models, st, args[0], args[1] * k, *args[2:])
        scales = [2.0 + 0.05 * i for i in range(K)]
        profile_steps(f"box 50^3 f32 {'fused' if fused else 'unfused'} V-cycle",
                      lambda: run_schedule(step, models, st.clone(), args, scales), K)


def profile_tet() -> None:
    """``--profile``: 3 steps of the general-tet bench (phase 9's workload)."""
    with tempfile.TemporaryDirectory() as tmp:
        tet = tet_setup(Path(tmp))
    geos, models, amg = tet["geos"], tet["models"], tet["amg"]
    step = tet_step(geos, amg.wrap_internal(geos[0].ex.M_pad), TET_FIXED)
    args = tet_args(geos[0], tet["bcs"], torch.float32, CARD)
    st = tet["state"]
    for k in (0.5, 1.0, 1.5, 2.0):
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    K = 3
    scales = [2.0 + 0.05 * (i + 1) for i in range(K)]
    profile_steps(f"tet {N_TET}^3 f32 AMG V(3,3), fixed-{TET_FIXED} PCG",
                  lambda: run_schedule(step, models, st.clone(), args, scales), K)


def profile_tet_box() -> None:
    """``--profile``: 3 steps of phase 16's workload (the 35^3 Kuhn box on
    the structured-tet engine, fixed-14 CG), fused and eager V-cycle."""
    _, _, geos, models, state, mgs, args, _ = kuhn_box_setup(torch.float32)
    K = 3
    scales = [2.0 + 0.05 * i for i in range(K)]
    for fused in (True, False):
        step = tet_box_step(geos, mgs[fused], TET_BOX_FIXED)
        st = state
        for k in (0.5, 1.0, 1.5):
            st, _ = step(models, st, args[0], args[1] * k, *args[2:])
        profile_steps(f"Kuhn box {N_TET_BOX}^3 f32 {'fused' if fused else 'eager'} V-cycle, "
                      f"fixed-{TET_BOX_FIXED} CG",
                      lambda st=st, step=step: run_schedule(step, models, st.clone(), args,
                                                            scales), K)


def profile_gather() -> None:
    """``--profile``: 3 steps of phase 17's workload (the gather engine with
    the AMG on the imported 35^3 mesh, fixed-3 PCG)."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V = FunctionSpace(imported_mesh(N_TET), 1, 3)
    bcs = bench_bcs(V)
    sim = PackedSimulation(VonMises3D(MAT), V, bcs, 2, engine="gather", preconditioner="amg",
                           mg_options={"nu": 3}, device=CARD, dtype=torch.float32)
    step = tet_step(sim._geos, sim._mg, TET_FIXED)
    args = tet_box_args(V, bcs, torch.float32)
    st = sim.state
    for k in (0.5, 1.0, 1.5, 2.0):
        st, _ = step(sim._models, st, args[0], args[1] * k, *args[2:])
    K = 3
    scales = [2.0 + 0.05 * (i + 1) for i in range(K)]
    profile_steps(f"gather {N_TET}^3 f32 AMG V(3,3), fixed-{TET_FIXED} PCG",
                  lambda: run_schedule(step, sim._models, st.clone(), args, scales), K)


def profiler_check(reps: int = 25, iters: int = 20) -> None:
    """``--profiler-check``: how often torch.profiler delivers a short
    profile of `iters` calls, for each K3 entry of the fused V-cycle at 50^3
    (float32) and for one torch op, each taken `reps` times, and their
    times by the profiler and by gated_ms; then the device ops of one fused
    V-cycle by the profiler and by the aten count."""
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.ops import cuda_smoother
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
    from fenics_constitutive_tpu_torch.solver import build_multigrid

    V, bcs = box(N_BENCH)
    geo = build_structured_geometry(V, 2, Constraint.FULL, device="cuda", dtype=torch.float32)
    mg = build_multigrid(geo, MU, KAPPA, torch.as_tensor(free_mask(V, bcs)), device="cuda",
                         dtype=torch.float32, nu=3, nu_coarse=2, coarse_direct=True,
                         fused_smoothing=True)
    r = torch.as_tensor(np.random.default_rng(2).normal(size=V.ndofs), dtype=torch.float32,
                        device="cuda")
    big = torch.randn(1 << 22, device="cuda")
    calls = [(label, kernel) for label, _, kernel, _, _ in k3_entries(mg.fused_cycle, r)]
    for label, fn in calls + [("torch mul", lambda: big * 2.0)]:
        fn()
        before = cuda_smoother.launches
        fn()
        want = iters * max(cuda_smoother.launches - before, 1)
        seen, times = {"empty": 0, "short": 0, "full": 0}, []
        for _ in range(reps):
            n = [e.count for e in profiled(fn, iters, complete=lambda evs: True, tries=1)]
            seen["empty" if not n else "short" if sum(n) < want else "full"] += 1
        for _ in range(5):
            evs = profiled(fn, iters) or []
            times += [sum(e.self_device_time_total for e in evs) / 1e3 / iters] if evs else []
        print(f"profiler check {label}: {reps} profiles of {iters} calls {seen}; "
              f"profiler {np.median(times):.4f} ms, gated_ms {gated_ms(fn, iters):.4f} ms")
    kinds = ("chain_kernel", "tail_kernel")
    launches, others, _ = kernel_ops(lambda: mg(r), cuda_smoother, kinds)
    print(f"profiler check V-cycle: {launches:g} K3 launches; other ops: profiler {others:g}, "
          f"aten count {aten_device_ops(lambda: mg(r))}")


#: phases 3, 4, 11 and 12 (the box, with the box profile) and 7-9 (the tets), as
#: both the parent commit's and this script's checkouts have them
AB_PHASES = """
import pathlib, tempfile, torch, chip_smoke as c
c.phase_device()
c.phase_build()
results = {}
c.timed("phase 3", c.phase_k1, results)
c.timed("phase 4", c.phase_k2, results)
c.timed("phase 11", c.phase_k3, results)
box = {"mg": c.bench_setup(c.N_BENCH, torch.float32, "cuda")[3], "ms_step": float("nan")}
c.timed("phase 12", c.phase_bench_fused, box)
c.timed("profile box", c.profile_box)
with tempfile.TemporaryDirectory() as tmp:
    tet = c.timed("tet setup", c.tet_setup, pathlib.Path(tmp))
c.timed("phase 7", c.phase_k4_k5, results, tet)
c.timed("phase 8", c.phase_k6, results, tet)
c.timed("phase 9", c.phase_tet_bench, tet)
"""


def ab(parent: str, change: str) -> None:
    """``--ab PARENT CHANGE``: phases 3, 4, 11, 12, the box profile and phases 7-9
    from two checkouts in turns (parent, change, change, parent), each in its
    own process on the same card."""
    import sys

    for label, where in (("parent", parent), ("change", change), ("change", change),
                         ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", AB_PHASES], cwd=where,
                              capture_output=True, text=True, timeout=1200, check=False)
        for ln in proc.stdout.splitlines():
            print(f"ab {label}: {ln}", flush=True)
        if proc.returncode != 0:
            fail(f"the phases of the {label} ({where}) exited {proc.returncode}:\n"
                 + proc.stderr[-3000:])


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--profile"]:
        phase_device()
        phase_build()
        profile_box()
        profile_tet()
        profile_tet_box()
        profile_gather()
    elif sys.argv[1:] == ["--profiler-check"]:
        phase_device()
        phase_build()
        profiler_check()
    elif sys.argv[1:2] == ["--ab"] and len(sys.argv) == 4:
        phase_device()
        ab(sys.argv[2], sys.argv[3])
    else:
        main()
