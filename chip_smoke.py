"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each printing one line of what it found; any failure raises and
exits non-zero before the last line:

  1. device: the card (nvidia-smi name and power limit), torch and CUDA;
     there is no CPU path.
  2. build: compiles the five sources of ``fenics_constitutive_tpu_torch/csrc``
     (matvec, eval, window, smoother, graph_loop), one nvcc each, started
     together, and prints the build seconds and register use.
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
     both kernels) with bench.py's eager V-cycle: bench_torch.py's run in
     this process (the timing protocol of scripts/torch_bench/common.py:
     three warm-up load steps, untimed windows until two agree, 5 timed
     windows of 48 steps; the deep fixed-40 CG re-run of the whole run,
     whose settled residual the timed run must match within 2%), its JSON
     line printed. Also a 6^3 run of the same step with kernels and with
     plain operators, which must agree.
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
  7b. K7 (the affine tet operator's cell part: gather, strain, factored
     tangent, divergence) then K5 against the plain middle then the plain
     scatter on the same plan, float64 (within 1e-14) and float32 (1e-6),
     normwise, for a plastic, an elastic and a uniform tangent and the
     plastic one in other dtypes and layouts (which K7 converts; the plain
     ops take its entries in the working dtype, as K7 reads them); two
     launches bit-equal, WindowedGeometry.matvec launching K7 once; K7's
     time on the card beside the plain middle's, K5's and its bound, and
     K5's own time right after K7, after the plain middle and after an L2
     flush. Then one converged plastic step of PackedSimulation (f64
     defaults) eager with K7, eager with the plain operator and replayed:
     the replay bit-equal to eager K7 with one K7 launch per operator
     apply, the plain operator taking the same Newton trips and applies
     within one a trip, u and stress within 1e-10 of the K7 step's.
  8. K6 (BSR SpMV on the plan's row layout) against its plain version on
     every A, P and R level of the mesh's AMG hierarchy (the one
     scripts/torch_bench/unstructured.py builds: 512 tile rows): float32 with
     select_passes 1 and 3, and float64, two launches bit-equal; per-level
     errors, threads per row, times beside the plain version, a torch CSR
     product and the bound; each operator also held to plain at 1-32
     threads per row (untimed).
  9. the general-tet bench: scripts/torch_bench/unstructured.py's run (the
     JAX package's scripts/bench_unstructured.py protocol) in this process
     on that mesh: float32, max_newton=1, fixed-12 plain PCG with the
     windowed AMG V(2,2); warm-up load scales 0.5-2.0, windows of 10 steps
     at 2.0 + 0.05 (i+1), and the fixed-36 and fixed-72 re-runs of the whole
     run, which the settled residual must match within 2% each; its JSON
     line printed. First a
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
     against the unfused one. Then the fine levels on bricks (51^3, and the
     65^3 of a 64^3 box, the P2 box's refined-P1 size): the 65^3 V-cycle and
     its entries, and a 51^3 chain with two planes of cells masked out (runs
     of mixed patterns), against their twins, each level's brick launches a V-cycle
     (fails at 0), its level-0 apply one node a thread and on bricks (CUDA
     events) beside the float64 bound, and ptxas's registers and spills of
     both kernels (fails where chain_kernel<f64, 3, run> spills).
 12. bench_torch.py's run as a user runs it by default, in this process:
     phase 5's workload and protocol with fused_smoothing=True, ms/step
     beside phase 5's, the V-cycle fused against unfused, K3 launches per
     entry, its JSON line printed.
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
     law's eval, the operator apply, the V-cycle, K4-K6 on the card). Last,
     the step is captured (captured true, no host sync): three more steps
     of the compiled step, replayed under set_sync_debug_mode("error"), are
     bit-equal in state and stats to the same steps inside
     disable_capture().
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
     each through scripts/torch_bench/tet.py's run in this process (windows
     of 16 steps, held to a fixed-40 re-run within 1.02x; its JSON line
     printed); K3's entries on
     the tet hierarchy against their plain twins; K1 and K2 never launch.
     Then PackedSimulation with two laws on the box (linear elasticity
     below z = 0.5, VonMises3D above), float64, the V-cycle with K3, 3
     converged steps of 0.0004 k.
 17. the gather engine with the AMG on phase 9's mesh: written with
     write_gmsh41_binary and read back (nodes, cells and cell sets equal to
     the ASCII read), PackedSimulation(engine="gather", preconditioner=
     "amg") (1,029,000 QPs unpadded; on the card its AMG levels are the
     windowed ones, which K6 applies), fixed-3 PCG with AMG V(3,3), held to
     fixed-9 and fixed-18 by the twins' protocol, one step run twice bit for
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
     The P2 cells keep the plain operator middle: K7 never launches.

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
     shard_problem over 2 gloo ranks spawned on the one card: Newton and CG
     counts equal to phase 22's, u and stress_0 within 1e-12 of it, the ranks'
     u bit-equal, K4, K5 and K6 launched by every rank, and after the steps
     each rank holds K4 (bit-equal) and K5 (repeatable, within TOL_K5) to
     their plain versions on its own plan, in f64 and f32; per rank ms/step
     (untimed warm-up no longer run: CUDA's lazy set-up included), set-up,
     the memory peaks, its QP state and its all-reduces.
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

The bench layer (bench_torch.py and scripts/torch_bench/); phases 5, 9, 12
and 16 run bench_torch.py, unstructured.py and tet.py, each step replayed
from a captured CUDA graph:

 25. the twins no earlier phase runs, each at its JAX script's default size
     in this process: p2.py, amg.py (with half its windows' steps) with K6
     held against its plain version on every A, P and R operator of the
     AMG it ran (select_passes 3, node-major), roofline.py and roofline.py
     windowed. Each JSON line must say converged and show its path's
     kernels launched in its timed run (K3 in p2.py, K6 in amg.py, K1-K3 and
     K4-K5 in roofline.py). Then `BENCH_FIXED_ITERS=4 python bench_torch.py`
     in its own process, as a user runs it, which must exit 1 with converged
     false (the self-check bites). bench_torch.py --sharded 2 --real runs
     where there are two cards; otherwise a line says it was not run. Every
     twin's line must say captured true (its step replays a CUDA graph;
     p2.py's adaptive CG as a graph while node since PR 16).

The compiled step (solver/compiled.py, the counterpart of jax.jit):

 26. on each path at its twin's full size, from the warm state an earlier
     phase left (phase 12: the hex box with the K3 V-cycle, K1 and K2; phase
     5: with the eager V-cycle; phase 16: the Kuhn box, whose plain Mises
     eval's local Newton is a graph while node; phase 9: the windowed engine
     with the windowed AMG, K4-K6; phase 17: the gather engine with the AMG,
     K6): 8 steps eager (inside disable_capture()) and 8 steps replayed
     from one captured CUDA graph, the replays under
     torch.cuda.set_sync_debug_mode("error"), bit-equal in u, the stresses,
     the histories and the stats, each of the path's kernels launched
     eagerly; ms/step eager,
     replayed and eager again by the twins' protocol (windows of 8 steps);
     the capture's seconds and what the copy into the static buffers and
     the clone of the outputs cost a call. Then PackedSimulation on the
     50^3 box with max_newton=1 and fixed-9 CG: solve_schedule over 3 steps
     and solve() twice through the graph, bit-equal to the same calls
     inside disable_capture(), last_stats captured true; at its Newton and
     CG defaults, captured true; SpringKelvinModel (f64), which reads dt,
     over a schedule of three dts replayed bit-equal to disable_capture()
     (K1 reads the tangent's device coefficients in both), where the same
     schedule with the first dt throughout lies more than 1e-2 away in the
     stress. Last, K1 on a uniform tangent whose coefficients are device
     tensors (an SLS law's) inside no_host_sync(): one launch, held to its
     plain version.

The loops the device decides (solver/compiled.py::device_while, the
counterpart of lax.while_loop; csrc/graph_loop.cu):

 27. first the while node alone: a counter loop captured once
     (CudaGraphRecorder), its trip count a device tensor, replays exactly
     N trips for N = 0, 1 and 37, flat and with a nested loop of 3 trips.
     Then, each
     at full width, converged Newton and adaptive CG replayed from one
     composed graph (segments captured by torch, child-graph and while
     nodes composed by the shim) against disable_capture(), the replays
     under set_sync_debug_mode("error"): 3 steps from the zero state at
     0.0004 k, bit-equal in u, stresses, histories and the stats
     (newton_iters, cg_iters_last, r_norm, r0_norm), each of the path's
     kernels launched eagerly; ms/step both ways (windows of 3 steps), the
     first call's and the composition's seconds. (a) the 50^3 hex box
     through PackedSimulation (VonMises3D, the fused V-cycle K3, K1 by
     matvec_impl="auto", the plain Mises eval whose local Newton nests in
     each Newton trip), float64 at its defaults and float32 at newton_rtol
     1e-6, newton_atol 1e-3; (b) phase 9's imported 35^3 mesh on the
     windowed engine with the AMG (K4-K6), float32 at the same tolerances;
     (c) p2.py's step (the 32^3 P2 lattice box, K3, adaptive CG to 1e-5).
     Last, PackedSimulation.solve() at its defaults (f64, the box) three
     times through the graph, bit-equal to disable_capture() in state and
     last_stats, captured true; DruckerPrager3D alone on the 4^3 box is
     captured too (no host sync): three steps past yield replayed under
     set_sync_debug_mode("error"), bit-equal to disable_capture().

A kernel's time on the card and a device-op count come from torch.profiler.
CUPTI now and then delivers a short profile on the H100, so such a profile
is taken again, three times in all; after that the time is taken by CUDA
events behind a sleep kernel (gated_ms) and the ops other than the port's
kernels are counted as aten ops (aten_device_ops). A line before the JSON
says how often that happened.

Then one JSON line of per-kernel results (launches on the path's run, for
K3 also on phase 16's tet run, phase 19's fused P2 steps and phase 20's P2
quad steps, for K4-K6 also on phase 14's 3-step run and phase 21's run,
for K6 also on phase 17's run, for every kernel on phase 22's packed
problem (0 for K1-K3), for K4-K6 per rank on phase 23's sharded run, for
K1 and K3 on phase 24's full-width creep run, per bench twin on its eager
window, times, plain and library times,
the bound; for K3 also the quad entries' numbers) and, last, the device
JSON line.

    python3 chip_smoke.py --profile

instead profiles 3 steps each of the bench workload with the unfused and
the fused V-cycle, the general-tet bench, phase 16's Kuhn box (fused and
eager), phase 17's gather engine and phase 27's paths (a)-(c), each
replayed from its CUDA graph and eagerly (torch.profiler: device ops per step,
the costliest kernels), and prints no JSON.

    python3 chip_smoke.py --newton-forms

instead times the replayed bench step with its Newton iteration as a
one-trip while node against PR 15's select form, and the composed graph
against torch's own replay of a one-segment program, in turns, and prints
no JSON.

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

import contextlib
import copy
import json
import re
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import bench_torch
from scripts.torch_bench import amg as amg_bench
from scripts.torch_bench import p2 as p2_bench
from scripts.torch_bench import roofline as roofline_bench
from scripts.torch_bench import tet as tet_bench
from scripts.torch_bench import unstructured as unstructured_bench
from scripts.torch_bench.common import (
    K3_ENTRIES,
    KAPPA,
    MAT,
    MU,
    R_NORM_ENVELOPE,
    bench_bcs,
    bench_schedule,
    bench_setup,
    bench_step,
    box,
    compiled_step,
    cuda_ms,
    fail,
    free_mask,
    imported_mesh,
    nvidia_smi,
    read_counts,
    reset_all_counts,
    reset_counts,
    run_schedule,
    step_args,
    window_counts,
)
from scripts.torch_bench.roofline import (
    bound_ms,
    chain_cost,
    k1_cost,
    k2_cost,
    k6_cost,
    vcycle_costs,
    window_costs,
)

N_BENCH = 50

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
# K7 then K5 against the plain operator's middle then the plain scatter: a
# cell's 4 x 3 gradient terms, 6 tangent terms and Q weighted points summed
# in another order (and with FMA), then K5's node sums in the plan's order.
TOL_K7 = {torch.float64: 1e-14, torch.float32: 1e-6}
# One converged f64 plastic step (phase 7b) with K7 against the same step
# with the plain operator: the two operators differ by rounding (TOL_K7) and
# take the same Newton trips and CG counts, so the displacement and stress
# they return differ by rounding carried through CG, far below the step's
# own Newton tolerance (rtol 1e-8).
TOL_K7_STEP = 1e-10
# K6 sums k slots of br x bc products per row (R_0: 101 x 3) with FMA in
# another order than the plain version; both round x to bf16 alike when
# select_passes = 1, so the tolerance is that of the float sum either way.
TOL_K6 = {torch.float64: 1e-12, torch.float32: 1e-5}
# phase 26's dt-reading law, replayed against eager (f64): K1 reads the SLS
# tangent's coefficients from device memory in both, one launch with the
# same rounding, so the replay must be bit-equal (0). (Until the one-launch
# K1, a capture applied them by parts, one launch per coefficient, and the
# H100 measured 6.7e-8 in the stress, held at 1e-6.) A dt frozen at capture
# moved the stress by 9.1e-2; the phase requires it above TOL_SLS_FROZEN.
TOL_SLS_REPLAY = 0.0
TOL_SLS_FROZEN = 1e-2

N_MULTIMAT = 50  # the two-law box of phase 13
TRACTION = 600.0  # phase 13's x = 1 face load: elastic in both laws

CARD = "cuda"  # the device of the general-mesh phases
N_TET = 35  # the general-tet bench mesh: 35^3 boxes of 6 Kuhn tets
N_QP_TET = 1_083_392  # its padded quadrature points (T = 1024 plan)
TET_FIXED, TET_VERIFY = 3, (9, 18)
#: bench_torch.py's settings, as bench.py sets them (whatever the environment)
BOX_BENCH = {"n": N_BENCH, "nu": 3, "nu_coarse": 2, "fixed": 9, "steps": 48, "verify": 40}
#: each bench twin's JSON line of this run by label, as hold_line took it
BENCH_LINES: dict = {}
#: each compiled path's problem as an earlier phase left it (phase 26 reads
#: it): make_step(), models, the warm state and the step's arguments
PATHS: dict = {}


def hold_line(phase: str, label: str, line: dict, kernels=(), key: str = "launches",
              captured: bool = True) -> dict:
    """Print a bench twin's JSON line (without its in-process objects); fail
    unless it says converged, its step was captured in a CUDA graph as
    ``captured`` says, and its eager window launched each of ``kernels``."""
    line = {k: v for k, v in line.items() if k != "objects"}
    print(f"{phase} {label}: {json.dumps(line)}", flush=True)
    if line["converged"] is not True:
        fail(f"{phase} {label}: the twin's self-check failed (converged "
             f"{line['converged']})")
    if line.get("captured") is not captured:
        fail(f"{phase} {label}: the twin's step reports captured {line.get('captured')}, "
             f"expected {captured}")
    missing = [k for k in kernels if line[key][k] <= 0]
    if missing:
        fail(f"{phase} {label}: its eager window never launched {', '.join(missing)} "
             f"({line[key]})")
    BENCH_LINES[label] = line
    return line


def normwise(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max|b|)."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-300)


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
    that launched them carry the same device time again, and so do the
    device rows of the port's profiler scopes (user annotations), which span
    the kernels launched inside them."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


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


def ms_after(prep, fn, iters: int = 20) -> float:
    """Median device time in ms of fn(prep()) alone, right after prep() on
    the card: CUDA events around fn only, every launch queued behind a sleep
    kernel so that the card runs them back to back."""
    fn(prep())
    torch.cuda.synchronize()
    marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    torch.cuda._sleep(int(2e9 * 0.1))  # ~0.1 s at ~2 GHz, longer than the queueing
    for e0, e1 in marks:
        x = prep()
        e0.record()
        fn(x)
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in marks]))


# -- phases ----------------------------------------------------------------------


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA GPU only")
    smi = nvidia_smi()
    print(smi)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"phase 1 device: {name} sm_{cap[0]}{cap[1]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    return name, smi


def phase_build() -> None:
    from fenics_constitutive_tpu_torch.ops import _cuda_build

    libs = ("matvec", "eval", "window", "smoother", "lattice", "return_map", "graph_loop")
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
            bound, by = bound_ms(*k1_cost(geo), dtype)
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
            bound, by = bound_ms(*k2_cost(geo), dtype)
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

    # bench_torch.py's run with bench.py's eager V-cycle, in this process
    line, objs = bench_torch.measure([], **BOX_BENCH, fused=False)
    hold_line("phase 5", "bench_torch eager", line, ("K1", "K2"))
    final, geo, mg = objs["final"], objs["geos"][0], objs["mg"]
    PATHS["box eager V-cycle"] = box_path(objs)
    if not torch.isfinite(final.u).all():
        fail("bench run produced non-finite values")
    if final.stress[0].shape != (6, 8, 51**3):
        fail(f"bench stress has shape {tuple(final.stress[0].shape)}")
    r = torch.as_tensor(np.random.default_rng(2).normal(size=geo.ndofs),
                        dtype=torch.float32, device="cuda")
    vcycle_ms = cuda_ms(lambda: mg(r), iters=10)
    elastic_ms = cuda_ms(lambda: geo.elastic_matvec_gm(r, KAPPA, 2 * MU))
    print(f"phase 5 bench 50^3 f32 (1,000,000 QPs), eager V-cycle: {line['value']:.3f} ms/step, "
          f"the median of {len(line['windows_ms'])} windows of {BOX_BENCH['steps']} steps "
          f"(spread {line['spread']:.1%}; host clock {line['host_ms']:.3f} ms/step; setup "
          f"{line['setup_s']:.1f} s), r_norm {line['r_norm']:.4f} vs deep fixed-"
          f"{BOX_BENCH['verify']} {line['r_norm_ref']:.4f} (envelope {R_NORM_ENVELOPE}); "
          f"V-cycle {vcycle_ms:.3f} ms, fine elastic apply {elastic_ms:.4f} ms; "
          f"K1 {results['K1']['ms']:.4f} ms vs plain {results['K1']['plain_ms']:.4f} ms, "
          f"K2 {results['K2']['ms']:.4f} ms vs plain {results['K2']['plain_ms']:.4f} ms")
    counts = {k: v for k, v in line["launches"].items() if k in ("K1", "K2")}
    return {"counts": counts, "ms_step": line["value"], "vcycle_ms": vcycle_ms, "mg": mg}


def box_path(objs: dict) -> dict:
    """The compiled path of a bench_torch run's objects (phase 26)."""
    geos, mg = objs["geos"], objs["mg"]
    return {"make_step": lambda: bench_step(geos, mg, BOX_BENCH["fixed"], "kernel"),
            "models": objs["models"], "state": objs["warm"], "args": objs["args"],
            "kernels": ("K1", "K2", "K3") if mg.fused_cycle is not None else ("K1", "K2")}


def phase_bench_fused(box_bench: dict) -> dict:
    """bench_torch.py's run (phase 5's workload with the K3 chains on every
    level of the V-cycle), in this process."""
    line, objs = bench_torch.measure([], **BOX_BENCH, fused=True)
    hold_line("phase 12", "bench_torch", line,
              ("K1", "K2", "K3", *(f"K3_{kind}" for kind in K3_ENTRIES)))
    geo, mg = objs["geos"][0], objs["mg"]
    PATHS["box"] = box_path(objs)
    if not torch.isfinite(objs["final"].u).all():
        fail("fused bench run produced non-finite values")
    counts = line["launches"]

    # V-cycle alone, fused and unfused in turns (A B B A)
    mg_plain = box_bench["mg"]
    r = torch.as_tensor(np.random.default_rng(2).normal(size=geo.ndofs),
                        dtype=torch.float32, device="cuda")
    t_f1, t_p1 = cuda_ms(lambda: mg(r), iters=10), cuda_ms(lambda: mg_plain(r), iters=10)
    t_p2, t_f2 = cuda_ms(lambda: mg_plain(r), iters=10), cuda_ms(lambda: mg(r), iters=10)
    print(f"phase 12 bench 50^3 f32 with the fused V-cycle: {line['value']:.3f} ms/step, the "
          f"median of {len(line['windows_ms'])} windows (spread {line['spread']:.1%}; phase 5, "
          f"eager, same call: {box_bench['ms_step']:.3f} ms/step), r_norm "
          f"{line['r_norm']:.4f} vs deep fixed-{BOX_BENCH['verify']} {line['r_norm_ref']:.4f} "
          f"(envelope {R_NORM_ENVELOPE}); V-cycle fused {t_f1:.3f}/{t_f2:.3f} ms vs unfused "
          f"{t_p1:.3f}/{t_p2:.3f} ms; launches K1 {counts['K1']} K2 {counts['K2']} K3 "
          f"{counts['K3']} (" + ", ".join(f"{kind} {counts['K3_' + kind]}"
                                         for kind in K3_ENTRIES) + ")")
    return {"counts": counts, "ms_step": line["value"]}


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


def tet_setup() -> dict:
    """unstructured.py's set-up: the imported 35^3 tet mesh through
    write_gmsh/read_gmsh, its windowed geometry (float32, on the card) and
    its AMG hierarchy (V(2,2), 512 tile rows), timed."""
    tet = unstructured_bench.setup(N_TET, torch.device(CARD), torch.float32, "amg", nu=2,
                                   tile_rows=512)
    if tet["geos"][0].N != N_QP_TET:
        fail(f"the tet bench has {tet['geos'][0].N} quadrature points, expected {N_QP_TET}")
    return tet


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
            bounds = {k: bound_ms(*cost, dtype) for k, cost in window_costs(ex).items()}
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


def k7_cost(geo, itemsize: int, fields: bool = True) -> tuple[float, float]:
    """(bytes, flops) of one K7 call on ``geo``: u [3, M_pad] and the plan's
    loc read once, dN [4, 3, C_pad] and w [N], with a field tangent beta,
    gamma [N] and n [6, N], read once, the rows [B, 3, Rn] written once; per
    slot the gradient and divergence (2 x 36 multiply-adds), the strains and
    T^T (9 operations), ~30 operations a QP for the tangent and weight."""
    ex = geo.ex
    slots, N = ex.C_pad, geo.N
    values = 3 * ex.M_pad + 12 * slots + N + (8 * N if fields else 0) + 12 * slots
    nbytes = values * itemsize + ex.loc.numel() * ex.loc.element_size()
    return nbytes, slots * (144.0 + 9.0 + 30.0 * geo.n_qp)


def k7_tangents(geo, seed: int) -> dict:
    """The tangent forms the tet cells hand K7: a plastic Mises tangent (half
    the points plastic, n a unit deviator there), the elastic one (gamma and
    n zero fields), and a uniform tangent (a host beta, a 0-d device gamma,
    n of 6 values: zero strides); and the plastic one in other layouts, which
    K7 converts (kappa a 0-d device tensor, beta of the other float dtype,
    gamma a 0-d value expanded to [N], n a non-contiguous [6, N])."""
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent

    rng = np.random.default_rng(seed)
    N = geo.N

    def dev(x):
        return torch.as_tensor(x, dtype=geo.dtype, device=geo.device)

    plastic = rng.random(N) < 0.5
    n = rng.normal(size=(6, N))
    n[:3] -= n[:3].mean(axis=0)
    n *= plastic / np.linalg.norm(n, axis=0)
    n_u = rng.normal(size=(6, 1))
    n_u[:3] -= n_u[:3].mean()
    beta = dev(2 * MU * (1 - 0.3 * plastic * rng.random(N)))
    other = torch.float32 if geo.dtype == torch.float64 else torch.float64
    return {
        "plastic": IsotropicTangent(KAPPA, beta, dev(-2 * MU * plastic * rng.random(N)), dev(n)),
        "elastic": IsotropicTangent(KAPPA, dev(np.full(N, 2 * MU)), dev(np.zeros(N)),
                                    dev(np.zeros((6, N)))),
        "uniform": IsotropicTangent(KAPPA, 1.8 * MU, dev(-0.7 * MU),
                                    dev(n_u / np.linalg.norm(n_u))),
        "views": IsotropicTangent(dev(KAPPA), beta.to(other), dev(-0.5 * MU).expand(N),
                                  dev(n.T.copy()).T),
    }


def k7_as_read(tg, dtype):
    """The tangent as K7 reads it: each tensor entry in the working dtype.
    The plain ops on a float32 field beside float64 strains would keep some
    of its terms in float32 (kappa - beta / 3 with a 0-d kappa stays in the
    field's dtype), which K7 does not."""
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent

    return IsotropicTangent(*(x.to(dtype) if isinstance(x, torch.Tensor) else x
                              for x in (tg.kappa, tg.beta, tg.gamma, tg.n)))


def k7_simulation_step(V, bcs) -> str:
    """One converged plastic step of PackedSimulation (f64 at its defaults,
    the windowed engine with its AMG) from the same state three ways: eager
    with K7, eager with the plain operator, and replayed from the CUDA graph
    with K7. The replay equals the eager K7 step bit for bit, with the same
    Newton and CG trips; the plain operator takes the same Newton trips, and
    applies within one per trip of K7's."""
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import cuda_window
    from fenics_constitutive_tpu_torch.solver import PackedSimulation, disable_capture

    sim = PackedSimulation(VonMises3D(MAT), V, bcs, 2, dtype=torch.float64, device=CARD,
                           engine="windowed")
    for k in (1, 2):  # past yield; the first solve captures the step
        bcs[1].value = 0.004 * k
        sim.solve()
    start = sim.state_dict()
    bcs[1].value = 0.012
    geo = sim._geos[0]

    def run(label, eager=True, plain=False):
        sim.load_state_dict(start)
        before = cuda_window.launches["cell_apply"]
        applies = []
        if plain:
            ref = geo.cell_apply_ref
            geo.cell_apply_ref = lambda u2, tg: applies.append(1) or ref(u2, tg)
            pick, cuda_window.cell_apply_form = cuda_window.cell_apply_form, lambda *a: False
        try:
            with disable_capture() if eager else contextlib.nullcontext():
                niter, converged = sim.solve()
        finally:
            if plain:
                del geo.cell_apply_ref
                cuda_window.cell_apply_form = pick
        if not converged:
            fail(f"phase 7b: the {label} step did not converge: {sim.last_stats}")
        return {"niter": niter, "cg_last": int(sim.last_stats["cg_iters_last"]),
                "applies": len(applies) if plain else cuda_window.launches["cell_apply"] - before,
                "u": sim.state.u.clone(), "stress": sim.state.stress[0].clone()}

    eager, plain, replay = run("eager K7"), run("plain", plain=True), run("replayed", eager=False)
    same = torch.equal(replay["u"], eager["u"]) and torch.equal(replay["stress"], eager["stress"])
    if not same or [replay[k] for k in ("niter", "cg_last")] != [
            eager[k] for k in ("niter", "cg_last")]:
        fail(f"phase 7b: the replayed K7 step differs from the eager one: "
             f"{ {k: replay[k] for k in ('niter', 'cg_last')} } against "
             f"{ {k: eager[k] for k in ('niter', 'cg_last')} }")
    if plain["niter"] != eager["niter"] or abs(plain["applies"] - eager["applies"]) > eager["niter"]:
        fail(f"phase 7b: K7 took {eager['niter']} Newton trips and {eager['applies']} applies, "
             f"the plain operator {plain['niter']} and {plain['applies']}")
    u_rel = normwise(eager["u"], plain["u"])[1]
    s_rel = normwise(eager["stress"], plain["stress"])[1]
    if not max(u_rel, s_rel) <= TOL_K7_STEP:
        fail(f"phase 7b: the K7 step left the plain operator's: u rel {u_rel:.3e}, stress rel "
             f"{s_rel:.3e} > {TOL_K7_STEP:g}")
    return (f"one plastic step (f64 defaults): Newton {eager['niter']} / {plain['niter']} "
            f"(K7 / plain), CG last {eager['cg_last']} / {plain['cg_last']}, applies "
            f"{eager['applies']} / {plain['applies']}; the replay bit-equal to eager K7, "
            f"Newton and CG trips equal; u rel {u_rel:.2e}, stress rel {s_rel:.2e} "
            f"(tol {TOL_K7_STEP:g})")


def phase_k7(results: dict, tet: dict) -> None:
    """K7 (the tet operator's cell part) then K5 against the plain middle then
    scatter_plain on the 35^3 plan, f64 and f32, for each tangent form; two
    launches bit-equal; WindowedGeometry.matvec takes K7 once a call; the
    kernel's time beside the plain middle and its bound; then one converged
    simulation step (k7_simulation_step)."""
    from fenics_constitutive_tpu_torch.ops import cuda_window

    geo32 = tet["geos"][0]
    geo64 = copy.deepcopy(geo32).to(torch.float64)
    line = []
    for geo in (geo64, geo32):
        dtype, ex = geo.dtype, geo.ex
        rng = np.random.default_rng(9)
        u2 = torch.as_tensor(rng.normal(size=(3, ex.M_pad)), dtype=dtype, device=CARD)
        errs = []
        for form, tg in k7_tangents(geo, 11).items():
            if not cuda_window.cell_apply_form(geo, tg):
                fail(f"phase 7b: the {form} tangent ({dtype}) does not take K7")
            f1 = cuda_window.windowed_cell_apply(geo, u2, tg)
            f2 = cuda_window.windowed_cell_apply(geo, u2, tg)
            f_p = cuda_window.cell_apply_plain(geo, u2, k7_as_read(tg, dtype))
            y_k = cuda_window.windowed_scatter(ex, f1)
            y_p = cuda_window.scatter_plain(ex, f_p)
            before = cuda_window.launches["cell_apply"]
            y_m = geo.matvec(u2.reshape(-1), tg)
            torch.cuda.synchronize()
            if cuda_window.launches["cell_apply"] - before != 1:
                fail(f"phase 7b: WindowedGeometry.matvec did not launch K7 once ({form})")
            if not torch.equal(f1, f2) or not torch.equal(y_m, y_k.reshape(-1)):
                fail(f"phase 7b: K7 {dtype} {form} differs between two launches or from matvec")
            err, rel = normwise(y_k, y_p)
            errs.append(f"{form} rel {rel:.2e} (rows {normwise(f1, f_p)[1]:.2e})")
            if not np.isfinite(rel) or rel > TOL_K7[dtype]:
                fail(f"phase 7b: K7 {dtype} {form} disagrees with its plain version: rel "
                     f"{rel:.3e} > {TOL_K7[dtype]:g}")
        tg = k7_tangents(geo, 12)["plastic"]
        nbytes, flops = k7_cost(geo, u2.element_size())
        bound, by = bound_ms(nbytes, flops, dtype)
        dev = device_ms(lambda: cuda_window.windowed_cell_apply(geo, u2, tg))
        plain_dev = device_ms(lambda: cuda_window.cell_apply_plain(geo, u2, tg))
        k5 = device_ms(lambda: cuda_window.windowed_scatter(ex, f1))
        # K5 reads the rows just written: by K7 on the operator's path now, by
        # the plain middle's last copy before; both may leave them in L2
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=CARD)
        k5_after = {label: ms_after(prep, lambda f: cuda_window.windowed_scatter(ex, f))
                    for label, prep in (
                        ("K7", lambda: cuda_window.windowed_cell_apply(geo, u2, tg)),
                        ("the plain middle", lambda: cuda_window.cell_apply_plain(geo, u2, tg)),
                        ("an L2 flush", lambda: (flush.zero_(), f1)[1]),
                        ("itself", lambda: f1))}
        del flush
        key = f"K7_{str(dtype)[6:]}"
        results[key] = {"device_ms": dev, "plain_device_ms": plain_dev, "bound_ms": bound,
                        "bound_by": by, "bytes": nbytes, "K5_device_ms": k5,
                        "K5_device_ms_after": k5_after}
        after = ", ".join(f"after {k} {v:.4f}" for k, v in k5_after.items())
        line.append(f"{str(dtype)[6:]}: two launches bit-equal; K7+K5 vs plain " + ", ".join(errs)
                    + f" (tol {TOL_K7[dtype]:g}); K7 on the card {dev:.4f} ms (plain middle "
                    f"{plain_dev:.4f}, K5 {k5:.4f} repeated on its rows; by events {after}), bound "
                    f"{bound:.4f} ({by}, {nbytes / 1e6:.1f} MB): {100 * bound / dev:.1f}%")
    print("phase 7b K7 vs plain on the 35^3 tet plan: " + "; ".join(line), flush=True)
    print("phase 7b " + k7_simulation_step(tet["V"], bench_bcs(tet["V"])), flush=True)


LANES = (1, 2, 4, 8, 16, 32)


def phase_k6(results: dict, tet: dict) -> None:
    """K6 against its plain version on every A, P and R operator of the AMG
    hierarchy (f32 with select_passes 1 and 3, f64; two launches bit-equal),
    its time beside the plain version, the CSR product and the bound, and
    every operator held to plain at each number of threads per row."""
    from fenics_constitutive_tpu_torch.ops import cuda_window

    amg = tet["amg"]
    ops = [(f"{name}{lvl}", getattr(amg, name + "_win")[lvl])
           for lvl in range(amg.n_levels - 1) for name in ("A", "P", "R")]
    tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "library_ms"), 0.0)
    worst, parts = 0.0, []
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
                    # threads per row: every power of two, each held to plain
                    for lanes in LANES:
                        y_s = cuda_window.windowed_bsr_matvec(w, x, lanes=lanes)
                        if normwise(y_s, y_p)[1] > TOL_K6[dtype]:
                            fail(f"K6 {label} with {lanes} lanes disagrees with plain")
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
          f"{bound:.4f} ms ({by}); every operator also within tol at "
          + "/".join(map(str, LANES)) + " threads per row")


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
    """The general-mesh step, compiled: captured on the card unless
    ``newton`` or adaptive CG (``fixed`` None) make it read back."""
    opts = dict(max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5, cg_maxiter=500)
    opts.update(newton)
    return compiled_step(geos, preconditioner=pc, cg_fixed_iters=fixed, **opts)


def tet_args(geo, bcs, dtype, device):
    return step_args(bcs, geo.ndofs_int, dtype, device)  # internal f_ext


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
    ref_rel = tet_reference()
    print(f"phase 9 small reference 5^3 tets f64, converged Newton, kernels (card) vs plain "
          f"(CPU) after 4 load steps: max rel {ref_rel:.2e} (tol 1e-7)")
    if ref_rel > 1e-7:
        fail("the kernel tet step disagrees with the plain step at 5^3")

    # unstructured.py's run at its defaults on the set-up's mesh and AMG
    line = unstructured_bench.run(tet, torch.device(CARD), torch.float32)
    objects = line.pop("objects")
    final = objects["final"]
    hold_line("phase 9", "unstructured", line, ("K4", "K5", "K6"))
    PATHS["windowed"] = {
        "make_step": lambda: unstructured_bench.step_of(tet["geos"], tet["pc"],
                                                        line["fixed_iters"]),
        "models": tet["models"], "state": objects["warm"], "kernels": ("K4", "K5", "K6"),
        "args": tet_args(tet["geos"][0], tet["bcs"], torch.float32, CARD)}
    if not torch.isfinite(final.u).all():
        fail("tet bench run produced non-finite values")
    if final.stress[0].shape != (6, N_QP_TET):
        fail(f"tet bench stress has shape {tuple(final.stress[0].shape)}")
    geo, amg, counts = tet["geos"][0], tet["amg"], line["launches"]
    r = torch.as_tensor(np.random.default_rng(2).normal(size=geo.ndofs_int),
                        dtype=torch.float32, device=CARD)
    vcycle_ms = cuda_ms(lambda: tet["pc"](r), iters=10)
    print(f"phase 9 tet bench 35^3 f32 ({N_QP_TET:,} QPs): {line['value']:.3f} ms/step, the "
          f"median of {len(line['windows_ms'])} windows of 10 steps (spread "
          f"{line['spread']:.1%}; host clock {line['host_ms']:.3f}), settled r_norm "
          f"{line['r_norm']:.4f} vs fixed-{line['verify_iters']} {line['r_norm_ref']:.4f} and "
          f"fixed-{2 * line['verify_iters']} {line['r_norm_ref2']:.4f} (envelope "
          f"{R_NORM_ENVELOPE} each); setup s: " + ", ".join(
              f"{k} {v:.2f}" for k, v in line["setup_split_s"].items())
          + f"; AMG {amg.n_levels} levels; launches K4 {counts['K4']} K5 {counts['K5']} K6 "
          f"{counts['K6']}; V-cycle {vcycle_ms:.3f} ms")
    return {"gather": counts["K4"], "scatter": counts["K5"], "bsr_matvec": counts["K6"]}


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
          f"K6 +{rise['bsr_matvec']} K7 +{rise['cell_apply']}")
    if min(rise.values()) <= 0:
        fail("PackedSimulation on the imported mesh did not launch K4, K5, K6 and K7")


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

    # one-time set-up of the first DP eval (K9's library is built in phase 2)
    t0 = time.perf_counter()
    tangents = [law_eval(0)[1]]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
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
        top = sorted(evs, key=lambda e: -e.self_device_time_total)[:4]
        dev = (f"{sum(e.count for e in evs)} device ops; top: " + "; ".join(
                   f"{short_name(e.key)} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
                   for e in top))
    if not conv4:
        fail("the two-law step after the schedule did not converge")
    print(f"phase 14 two laws on the imported {N_TET}^3 mesh f64 (DruckerPrager3D z < 0.5 "
          f"on {geos[0].n_cells} cells, N {geos[0].N}; SpringMaxwellModel above on "
          f"{geos[1].n_cells} cells, N {geos[1].N}; {sim.engine} + {sim.preconditioner}, build "
          f"{build_s:.1f} s; first DP eval {first_s:.2f} s): solve_schedule 3 steps of {STRETCH_STEP} k, {ms_step:.1f} ms/step "
          f"(CUDA events), newton {stats['newton_iters'].tolist()}, cg_last "
          f"{stats['cg_iters_last'].tolist()}, r " + ", ".join(f"{r:.2e}" for r in stats["r_norm"])
          + f"; launches per step K4 {counts['gather'] / K:g} K5 {counts['scatter'] / K:g} K6 "
          f"{counts['bsr_matvec'] / K:g}; device memory peak {peak_gib:.2f} GiB")
    print(f"phase 14 K4/K5 vs plain on each law's plan (f64, tol K5 {TOL_K5[torch.float64]:g}): "
          + "; ".join(held))
    print(f"phase 14 parts on the first iterate of step 1: eval ms DP {eval_ms[0]:.2f}, "
          f"Maxwell {eval_ms[1]:.2f}; on an elastic iterate DP "
          f"{elastic_ms[0]:.2f}, Maxwell {elastic_ms[1]:.2f}; two-law operator apply "
          f"{mv_ms:.3f} ms; V-cycle {vc_ms:.3f} ms ({k6_cycle} K6); per step {evals / K:g} "
          f"evals, {applies / K:g} applies, {cycles / K:g} V-cycles: eval "
          f"{parts['eval'] / K:.1f} ms, operator {parts['operator'] / K:.1f} ms, AMG "
          f"{parts['AMG'] / K:.1f} ms, the rest (CG vectors, Newton, host) {rest / K:.1f} ms; "
          f"on the card K4+K5 {per_law * win_call / K:.2f} ms/step, K6 "
          + ("not measured" if k6_cycle_ms is None else f"{cycles * k6_cycle_ms / K:.2f} ms/step")
          + f"; step 4 alone newton {niter4}, {step4_ms:.1f} ms (host clock); step 5 profiled: "
          + dev)
    k9 = k9_per_eval(sim, STRETCH_STEP)
    rows = graph_against_eager("phase 14", sim, STRETCH_STEP)
    print(f"phase 14 the two-law step captured (host_syncs {sim.host_syncs}): 3 steps replayed "
          f"under set_sync_debug_mode('error') bit-equal to disable_capture() in state and "
          f"stats (newton {[r['newton_iters'] for r in rows]}, cg_last "
          f"{[r['cg_iters_last'] for r in rows]}); one eager step: {k9}", flush=True)
    return counts


def k9_per_eval(sim, increment: float) -> str:
    """One more step of ``sim`` (its committed state, its moved BC raised by
    ``increment``) inside disable_capture(): K9 launches once for each
    evaluation of its Drucker-Prager law (the ``law.eval`` scopes of that
    law), and the Maxwell law launches none."""
    from fenics_constitutive_tpu_torch.ops import cuda_return_map
    from fenics_constitutive_tpu_torch.solver import disable_capture

    dp = sim._models[0]
    evals = []
    real = dp.evaluate_packed

    def counted(*args):
        evals.append(1)
        return real(*args)

    dp.evaluate_packed = counted
    before = cuda_return_map.launches["dp_return_map"]
    try:
        sim.bcs[1].value += increment
        with disable_capture():
            niter, conv = sim.solve()
    finally:
        del dp.evaluate_packed
    k9 = cuda_return_map.launches["dp_return_map"] - before
    if not conv or k9 != len(evals) or k9 != niter + 1:
        fail(f"phase 14: {k9} K9 launches for {len(evals)} DP evaluations in one eager step "
             f"(newton {niter}, converged {conv})")
    return f"newton {niter}, {len(evals)} DP evaluations, {k9} K9 launches"


def graph_against_eager(phase: str, sim, increment: float, steps: int = 3) -> list:
    """``steps`` load steps of a captured PackedSimulation's compiled step
    from its committed state, the moved BC (``bcs[1]``) raised by
    ``increment`` each: replayed under set_sync_debug_mode("error"), and
    again inside disable_capture(), each side from its own previous state.
    Fails unless the simulation is captured with no host sync and both sides
    agree bit for bit in state and stats at every step, and every step
    converged. The capture must have been taken (one ``solve()`` first).
    Returns the replayed steps' stats."""
    from fenics_constitutive_tpu_torch.fem import combine_bcs
    from fenics_constitutive_tpu_torch.solver import disable_capture

    if not sim.captured or sim.host_syncs:
        fail(f"{phase}: the PackedSimulation is not captured ({sim.host_syncs})")
    st_graph = st_eager = sim.state
    rows = []
    for k in range(steps):
        sim.bcs[1].value += increment
        bc_dofs, bc_vals = combine_bcs(sim.bcs)
        vals, f_ext = sim._inputs(bc_vals, sim._load(sim.f_ext))
        replays = sim._step.replays
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            st_graph, s_graph = sim._step(sim._models, st_graph, bc_dofs, vals, f_ext,
                                          sim.del_t)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        with disable_capture():
            st_eager, s_eager = sim._step(sim._models, st_eager, bc_dofs, vals, f_ext,
                                          sim.del_t)
        s_graph = {key: v.item() for key, v in s_graph.items()}
        s_eager = {key: v.item() for key, v in s_eager.items()}
        if sim._step.replays != replays + 1:
            fail(f"{phase}: step {k + 1} through the compiled step did not replay its graph")
        if s_graph != s_eager:
            fail(f"{phase}: step {k + 1} replayed {s_graph} against eager {s_eager}")
        if not s_graph["r_norm"] <= max(sim._newton_atol, sim._newton_rtol * s_graph["r0_norm"]):
            fail(f"{phase}: step {k + 1} did not converge: {s_graph}")
        rows.append(s_graph)
    if not same_tree(st_graph, st_eager):
        fail(f"{phase}: the replayed state differs from the eager one")
    return rows


#: phase 14b: the dp-maxwell cell's Drucker-Prager points (132,300 tets at q 2)
N_K9 = 529_200
#: K9 against the plain map, normwise ((stress, alpha, plastic strain), tangent);
#: tests/torch_port/test_torch_dp_return_map.py gives the reasons
TOL_K9 = {torch.float64: (1e-12, 1e-10), torch.float32: (1e-5, 2e-4)}


def k9_inputs(dtype, rng):
    """N_K9 points in the unit test's mix (the zero state, elastic, past
    yield, near the apex; DruckerPrager3D's parameters) and the state the
    plain map returns from them, then a second increment (2e-4, deviatoric
    near the apex) that unloads, reloads or flows on: (stress, del_eps,
    alpha) of that step."""
    from fenics_constitutive_tpu_torch.models import DruckerPrager3D

    law = DruckerPrager3D(DP_PARAMS)
    n = N_K9 // 4
    a, b, mu, ka = DP_PARAMS["a"], DP_PARAMS["b"], DP_PARAMS["mu"], DP_PARAMS["kappa"]

    def unit_dev(k):
        m = rng.normal(size=(k, 6))
        m[:, :3] -= m[:, :3].mean(axis=1, keepdims=True)
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    plastic = unit_dev(n) * (rng.uniform(1.2, 4.0, n) * a / (np.sqrt(2.0) * mu))[:, None]
    plastic[:, :3] += rng.uniform(-1e-3, 1e-3, (n, 1)) / 3.0
    delta = rng.uniform(0.01, 0.05, n)
    near = unit_dev(n) * (rng.uniform(1.5, 3.0, n) * delta * a / (np.sqrt(2.0) * mu))[:, None]
    near[:, :3] += ((a / b) * (1.0 - delta) / (9.0 * ka))[:, None]
    first = np.concatenate([np.zeros((n, 6)), rng.normal(size=(n, 6)) * 1e-4, plastic, near])

    def dev(x):
        return torch.as_tensor(x, dtype=dtype, device=CARD)

    second = rng.normal(size=(N_K9, 6)) * 2e-4
    second[3 * n:, :3] -= second[3 * n:, :3].mean(axis=1, keepdims=True)
    zero = torch.zeros((N_K9, 6), dtype=dtype, device=CARD)
    s, _, alpha, _ = law._plain_return_map(zero, dev(first), zero[:, :1])
    return s, dev(second), alpha


def phase_k9(results: dict) -> None:
    """Phase 14b: K9 (Drucker-Prager's return map, ``csrc/return_map.cu``)
    at the dp-maxwell cell's 529,200 points, float64 and float32, from a
    plastic state: against the plain map on the card (max-norm, at the
    points where the plain map has converged: its stress and alpha move by
    less than the tolerance when its trip cap rises from 25 to 50), two
    launches bit-equal, K9's time on the card (torch.profiler, CUDA events)
    beside the plain map's and the byte bound; ptxas's registers and
    spills."""
    from fenics_constitutive_tpu_torch.models import DruckerPrager3D
    from fenics_constitutive_tpu_torch.ops import _cuda_build, cuda_return_map

    law = DruckerPrager3D(DP_PARAMS)
    line = []
    for dtype in (torch.float64, torch.float32):
        s, e, alpha = k9_inputs(dtype, np.random.default_rng(14))
        k9 = cuda_return_map.dp_return_map(law, s, e, alpha)
        again = cuda_return_map.dp_return_map(law, s, e, alpha)
        plain = law._plain_return_map(s, e, alpha)
        law.newton_maxit = 50
        longer = law._plain_return_map(s, e, alpha)
        law.newton_maxit = 25
        if not all(torch.equal(x, y) for x, y in zip(k9, again)):
            fail(f"phase 14b: two K9 launches differ ({dtype})")
        tol, tol_t = TOL_K9[dtype]
        stuck = torch.zeros_like(alpha[:, 0], dtype=torch.bool)
        for i in (0, 2):
            d = (longer[i] - plain[i]).abs().max(dim=1).values
            stuck |= ~(d <= tol * plain[i].abs().max())
        ok = ~stuck
        rels = [normwise(x, y)[1] for x, y in zip(k9, plain)]
        errs = [float((x[ok] - y[ok]).abs().max() / y[ok].abs().max()) for x, y in zip(k9, plain)]
        if not all(np.isfinite(errs)) or max(errs[0], errs[2], errs[3]) > tol or errs[1] > tol_t:
            far = ((k9[0] - plain[0]).abs().max(dim=1).values > tol * plain[0].abs().max())
            kinds = torch.bincount(torch.nonzero(far & ok)[:, 0] // (N_K9 // 4), minlength=4)
            fail(f"phase 14b: K9 {dtype} against the plain map at its {int(ok.sum())} converged "
                 f"points: max-norm errors (stress, tangent, alpha, plastic strain) {errs} > "
                 f"{tol:g}, {tol_t:g}; stress off at {kinds.tolist()} points of each kind")
        plastic = float((plain[2] > alpha).double().mean())
        nbytes = N_K9 * (13 + 49) * s.element_size()
        bound, _ = bound_ms(nbytes, 0.0, dtype)
        dev = device_ms(lambda: cuda_return_map.dp_return_map(law, s, e, alpha), floor_ms=bound)
        events = cuda_ms(lambda: cuda_return_map.dp_return_map(law, s, e, alpha))
        plain_ms = cuda_ms(lambda: law._plain_return_map(s, e, alpha), iters=3, warmup=1)
        key = str(dtype)[6:]
        results[f"K9_{key}"] = {"device_ms": dev, "ms": events, "plain_ms": plain_ms,
                                "bound_ms": bound, "bytes": nbytes, "plastic_share": plastic,
                                "unconverged": int(stuck.sum()), "max_err": errs, "rel": rels}
        line.append(f"{key}: {100 * plastic:.0f}% of the points flow, {int(stuck.sum())} stop "
                    f"unconverged at the trip cap; max-norm errors against "
                    f"the plain map stress {errs[0]:.1e}, tangent {errs[1]:.1e}, alpha "
                    f"{errs[2]:.1e}, plastic strain {errs[3]:.1e} (tol {tol:g}, {tol_t:g}); two "
                    f"launches bit-equal; K9 on the card {dev:.4f} ms (events {events:.4f}), "
                    f"plain map {plain_ms:.2f} ms, bound {bound:.4f} (bytes, "
                    f"{nbytes / 1e6:.1f} MB): {100 * bound / dev:.1f}%")
    usage = [ln.strip() for ln in _cuda_build.build_log["return_map"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 14b K9 at {N_K9} Drucker-Prager points: " + "; ".join(line) + "; ptxas: "
          + " | ".join(usage), flush=True)


def phase_library() -> None:
    """Every FULL law on the card against the same run on the CPU: a 6^3
    shuffled tet mesh (windowed engine, AMG) and a 6^3 hex box (K1 for the
    factored laws, the plain operator for DP), float64, 2 steps of 0.004 k,
    and on the tets also phase 14's two laws (DP below z = 0.5, Maxwell
    above); then the dense-tangent and Jacobi-diagonal products with TF32
    on."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.ops import (
        DenseTangent,
        cuda_matvec,
        cuda_return_map,
        cuda_window,
    )
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
                k9 = cuda_return_map.launches["dp_return_map"]
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
                                sum(cuda_window.launches.values()) - win,
                                cuda_return_map.launches["dp_return_map"] - k9)
            (u_c, s_c, it_c, k1_c, win_c, k9_c), (u_h, s_h, it_h, _, _, k9_h) = (runs[CARD],
                                                                               runs["cpu"])
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
            if (k9_c > 0) != name.startswith("dp") or k9_h:
                fail(f"phase 15 {kind} {name}: {k9_c} K9 launches on the card, {k9_h} on the CPU")
            line.append(f"{kind} {name} newton {it_c} (CPU {it_h}) rel {rel:.1e}"
                        + (f" K1 {k1_c}" if kind == "box" else f" K4-K6 {win_c}")
                        + (f" K9 {k9_c}" if k9_c else ""))

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


def k3_chains(mg, mg_coarse):
    """Every chain of one fused V-cycle (levels above the coarsest: pre and
    post) and the coarsest level's chain of a hierarchy without coarse_direct."""
    out = []
    for lvl in range(mg.n_levels - 1):
        out += [(f"L{lvl} pre", mg.fused[lvl]["pre"]), (f"L{lvl} post", mg.fused[lvl]["post"])]
    out.append((f"L{mg.n_levels - 1} coarse", mg_coarse.fused[-1]["coarse"]))
    return out


def k3_entries(fc, b0: torch.Tensor, first: int | None = None):
    """Every K3 entry one fused V-cycle from b0 runs, in its order, with the
    inputs the cycle gives it (taken from the plain twins): (label, kind,
    kernel call, plain call, (bytes, flops)), the costs by
    roofline.vcycle_costs. ``first``: the tail's first level (default: the
    card's rule)."""
    first = fc.tail_start(b0.device) if first is None else first
    costs = iter(vcycle_costs(fc, b0.element_size(), first))
    out, xs, bs, b = [], [], [], b0
    for lvl in range(first):
        label, kind, cost = next(costs)
        x, bc = fc.pre_restrict_plain(lvl, b)
        out.append((label, kind, lambda lvl=lvl, b=b: fc.pre_restrict(lvl, b),
                    lambda lvl=lvl, b=b: fc.pre_restrict_plain(lvl, b), cost))
        xs.append(x)
        bs.append(b)
        b = bc
    xc = fc.plain(b, first)
    label, kind, cost = next(costs)
    out.append((label, kind, lambda b=b: fc.tail(b, first), lambda b=b: fc.plain(b, first),
                cost))
    for lvl in reversed(range(first)):
        label, kind, cost = next(costs)
        out.append((label, kind,
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
        phase_k3_bricks(dtype, tol, mg, r, results)


#: the P2 box's refined-P1 fine level: 65^3 nodes, a 64^3 box's
N_BRICK_BOX = 64


def chain_kernel_usage() -> dict:
    """ptxas's report of each chain_kernel<T, D, run> of this process's
    smoother build: {(type, D, run): (registers, spill stores, spill loads)}
    (empty where the library came from an earlier build)."""
    from fenics_constitutive_tpu_torch.ops import _cuda_build

    out, key = {}, None
    for line in _cuda_build.build_log.get("smoother", {}).get("log", "").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"chain_kernelI([df])Li(\d)ELi(\d+)E", line)
            key = (("float32", "float64")[m[1] == "d"], int(m[2]), int(m[3])) if m else None
            if key:
                out[key] = [0, 0, 0]
        elif key and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[key][1:] = [int(m[1]), int(m[2])]
        elif key and (m := re.search(r"Used (\d+) registers", line)):
            out[key][0] = int(m[1])
    return {k: tuple(v) for k, v in out.items()}


def k3_apply_us(pre, b, plan) -> float:
    """One stencil phase of a level's chain on the card (a sweep and the
    grid sync before it), in us: the zero-start chain of nu = 2 less the one
    of nu = 1, each timed by CUDA events; ``plan`` () runs it one node a
    thread, None by the card's rule."""
    from fenics_constitutive_tpu_torch.ops import cuda_smoother

    ke = pre.ke.double().cpu().numpy()
    one, two = (cuda_smoother.build_fused_smoother(pre.geo, ke, pre.inv_d, pre.mask, nu=nu,
                                                   zero_start=True, emit_residual=False)
                for nu in (1, 2))
    t = [gated_ms(lambda c=c: c._kernel(None, b, plan=plan), iters=40) for c in (one, two)]
    return (t[1] - t[0]) * 1e3


def phase_k3_bricks(dtype, tol, mg, r, results: dict) -> None:
    """Phase 11 on bricks: the fine levels of the 50^3 hierarchy (51^3 nodes)
    and of a 64^3 box's (65^3, the P2 box's refined-P1 fine level) run their
    stencil phases on bricks: every entry of one V-cycle on the 65^3
    hierarchy against its twin (bit-equal across two launches), the brick
    launches of one V-cycle on both, and a level-0 apply one node a thread
    (before) and on bricks (after), beside its bound and ptxas's registers
    and spills of both kernels."""
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.ops import cuda_smoother
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
    from fenics_constitutive_tpu_torch.solver import build_multigrid

    V, bcs = box(N_BRICK_BOX)
    geo = build_structured_geometry(V, 2, Constraint.FULL, device="cuda", dtype=dtype)
    mg65 = build_multigrid(geo, MU, KAPPA, torch.as_tensor(free_mask(V, bcs)), device="cuda",
                           dtype=dtype, nu=3, nu_coarse=2, coarse_direct=True,
                           fused_smoothing=True)
    r65 = torch.as_tensor(np.random.default_rng(5).normal(size=V.ndofs), dtype=dtype,
                          device="cuda")
    name = str(dtype)[6:]
    usage = chain_kernel_usage()
    parts = []
    for kernel, plain in (((lambda: mg65(r65)), (lambda: mg65.fused_cycle.plain(r65))),
                          *((k, p) for _, _, k, p, _ in k3_entries(mg65.fused_cycle, r65))):
        parts.append(check_k3(f"65^3 bricks {name}", kernel, plain, dtype, tol)[1])
    # a 51^3 level whose cells of two planes are masked out: runs whose nodes
    # differ in pattern, each such node again by its own stencil
    pre = mg.fused[0]["pre"]
    holes = pre.mask.clone().reshape(pre.grid)
    holes[20:22] = 0
    chain = cuda_smoother.build_fused_smoother(pre.geo, pre.ke.double().cpu().numpy(),
                                               pre.inv_d, holes.reshape(-1), nu=3,
                                               zero_start=True, emit_residual=True)
    bh = torch.as_tensor(np.random.default_rng(7).normal(size=pre.inv_d.numel()), dtype=dtype,
                         device="cuda")
    before = cuda_smoother.brick_launches
    parts.append(check_k3(f"51^3 bricks with holes {name}", lambda: chain(bh),
                          lambda: chain.plain(bh), dtype, tol)[1])
    if cuda_smoother.brick_launches - before != 2:
        fail(f"K3 51^3 with holes {name}: {cuda_smoother.brick_launches - before} brick "
             "launches for 2 calls")
    line = [f"65^3 V-cycle and its entries, and a 51^3 chain with two planes of cells masked "
            f"out, vs plain rel <= {max(parts):.1e}"]
    for label, m, rr in (("51^3", mg, r), ("65^3", mg65, r65)):
        pre = m.fused[0]["pre"]
        plan = pre.plan(rr.device)
        before = cuda_smoother.brick_launches
        m(rr)
        per_cycle = cuda_smoother.brick_launches - before
        if plan is None or per_cycle <= 0:
            fail(f"K3 {label} {name}: level 0 took no bricks (plan {plan}, {per_cycle} brick "
                 "launches a V-cycle)")
        n = pre.inv_d.numel()
        b = torch.as_tensor(np.random.default_rng(6).normal(size=n), dtype=dtype,
                            device="cuda") * (pre.inv_d != 0).to(dtype)
        t_node, t_brick = k3_apply_us(pre, b, ()), k3_apply_us(pre, b, None)
        M = pre.geo.M
        bound, by = bound_ms(4 * 3 * M * pre.inv_d.element_size(), 2 * 243 * M, torch.float64)
        line.append(f"{label} (plan {plan}, {per_cycle} of {m.fused_cycle.n_levels} brick "
                    f"launches a V-cycle) level-0 apply {t_node:.2f} us one node a thread, "
                    f"{t_brick:.2f} us on bricks (f64 bound {bound * 1e3:.2f} us, {by})")
        results.setdefault("K3_bricks", {})[f"{label}_{name}"] = {
            "plan": plan, "apply_us_one_node": t_node, "apply_us_bricks": t_brick,
            "bound_us_f64": bound * 1e3}
    for run, what in ((0, "one node a thread"), (cuda_smoother.BRICK_RUN, "bricks")):
        regs = usage.get((name, 3, run))
        line.append(f"chain_kernel<{name}, 3, {run}> ({what}): " + (
            f"{regs[0]} registers, {regs[1]} B spill stores, {regs[2]} B spill loads" if regs
            else "no ptxas report (an earlier build)"))
        if run and regs and dtype == torch.float64 and regs[1] + regs[2] > 0:
            fail(f"chain_kernel<float64, 3, {run}> spills: {regs}")
    print(f"phase 11 K3 on bricks {name} (tol {tol:g}): " + "; ".join(line))


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
    return step_args(bcs, V.ndofs, dtype, CARD)


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

    # tet.py's run on this hierarchy, fused and eager, in this process
    runs = {}
    for fused in (True, False):
        b = {"geos": geos, "models": models, "state": state, "mg": mgs[fused], "fused": fused,
             "args": args, "setup_s": setup["mesh"] + setup["geometry"]
             + setup["multigrid fused" if fused else "multigrid eager"]}
        line = tet_bench.run(b, torch.device(CARD), dtype, TET_BOX_FIXED, TET_BOX_STEPS,
                             TET_BOX_VERIFY)
        objects = line.pop("objects")
        final = objects["final"]
        hold_line("phase 16", "tet" if fused else "tet eager", line, ("K3",) if fused else ())
        if fused:
            mg = mgs[True]
            PATHS["Kuhn box"] = {
                "make_step": lambda: bench_step(geos, mg, TET_BOX_FIXED, "plain"),
                "models": models, "state": objects["warm"], "args": args, "kernels": ("K3",)}
        if not torch.isfinite(final.u).all():
            fail("a tet box run produced non-finite values")
        runs[fused] = {"ms_step": line["value"], "r": line["r_norm"],
                       "r_ref": line["r_norm_ref"], "counts": line["launches"],
                       "state": final, "spread": line["spread"]}
    counts = runs[True]["counts"]
    if counts["K3"] <= 0 or counts["K1"] or counts["K2"] or runs[False]["counts"]["K3"]:
        fail(f"phase 16 launches: fused {counts}, eager {runs[False]['counts']} (K3 on the "
             "fused run only, K1 and K2 never on a tet geometry)")
    if runs[True]["state"].stress[0].shape != (6, 24, (N_TET_BOX + 1) ** 3):
        fail(f"tet box stress has shape {tuple(runs[True]['state'].stress[0].shape)}")
    results["tet_box"] = {"counts": counts, "ms_step": runs[True]["ms_step"],
                          "eager_ms_step": runs[False]["ms_step"]}
    K = TET_BOX_STEPS
    n_steps = K  # the counts are of one eager window (time_windows)
    print(f"phase 16 Kuhn box {N_TET_BOX}^3 f32 ({N_QP_TET_BOX:,} QPs, structured-tet engine, "
          f"{mgs[True].n_levels} levels {fc.node_grids}): fused V-cycle "
          f"{runs[True]['ms_step']:.3f} ms/step, eager {runs[False]['ms_step']:.3f} ms/step, "
          f"medians of windows of {K} steps (spread {runs[True]['spread']:.1%} / "
          f"{runs[False]['spread']:.1%}; CUDA events, same call); settled r_norm fused "
          f"{runs[True]['r']:.4f} "
          f"vs fixed-{TET_BOX_VERIFY} {runs[True]['r_ref']:.4f}, eager {runs[False]['r']:.4f} vs "
          f"{runs[False]['r_ref']:.4f} (envelope {R_NORM_ENVELOPE}); V-cycle fused "
          f"{t_f1:.3f}/{t_f2:.3f} ms vs eager {t_e1:.3f}/{t_e2:.3f} ms, rel {rel_v:.1e}; "
          f"launches per step K1 {counts['K1']} K2 {counts['K2']} K3 "
          f"{counts['K3'] / n_steps:g} ("
          + ", ".join(f"{kind} {counts['K3_' + kind] / n_steps:g}" for kind in K3_ENTRIES)
          + "); setup s: " + ", ".join(f"{k} {v:.2f}" for k, v in setup.items()))
    print(f"phase 16 K3 on the tet hierarchy vs plain f32 (tol {TOL_F32_K1:g}, bit-equal across "
          f"two launches; tail from level {fc.tail_start(r_gm.device)}): " + "; ".join(held))
    phase_tet_box_laws(V)
    return results["tet_box"]


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
    QPs, whose levels K6 applies on the card, fixed-3 PCG held to fixed-9
    and fixed-18 by the bench twins' protocol; one step run twice (bit for bit); the ELL levels of the same hierarchy
    beside them (V-cycle and step); the displacement and stress through
    write_vtu/read_vtu. Returns the K6 launches of one eager window."""
    from fenics_constitutive_tpu_torch.fem import (
        FunctionSpace,
        read_gmsh,
        read_vtu,
        write_gmsh41_binary,
        write_vtu,
    )
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import PackedGeometry
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

    # fixed-3 PCG held to fixed-9 and fixed-18, by the bench twins' protocol,
    # on the gather engine's node-major vectors
    args = tet_box_args(V, bcs, torch.float32)
    K = 10
    run = bench_schedule(lambda fk: tet_step(geos, amg, fk), TET_FIXED, TET_VERIFY, models,
                         sim.state, args, K, CARD, first=1, warm_loads=(0.5, 1.0, 1.5, 2.0))
    st, out, counts = run["warm"], run["final"], run["launches"]
    if run["captured"] is not True:
        fail("phase 17: the gather engine's fixed-count step was not captured in a CUDA graph")
    PATHS["gather"] = {"make_step": lambda: tet_step(geos, amg, TET_FIXED), "models": models,
                       "state": st, "args": args, "kernels": ("K6",)}
    if counts["K6"] <= 0 or counts["K4"] or counts["K5"]:
        fail(f"phase 17 launches {counts}: K6 on the AMG levels, never K4 or K5")
    if not (run["converged"] and torch.isfinite(out.u).all()):
        fail(f"gather bench settled r_norm {run['r_norm']:.4f} is outside the "
             f"{R_NORM_ENVELOPE} envelopes of the deep re-runs {run['r_norm_ref']:.4f}, "
             f"{run['r_norm_ref2']:.4f}")
    step = tet_step(geos, amg, TET_FIXED)
    once = [step(models, st, args[0], args[1] * 2.05, *args[2:])[0] for _ in range(2)]
    if not (torch.equal(once[0].u, once[1].u)
            and torch.equal(once[0].stress[0], once[1].stress[0])):
        fail("two runs of one gather-engine step differ")
    scales = [2.0 + 0.05 * (i + 1) for i in range(K)]
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

    bs_g, bs_a, bs_e = geo.build_seconds, amg.build_seconds, ell.build_seconds
    n_steps = K  # the counts are of one eager window (time_windows)
    print(f"phase 17 gather engine + AMG on the imported {N_TET}^3 mesh f32 ({geo.N:,} QPs "
          f"unpadded, gather_idx {tuple(geo.gather_idx.shape)}, AMG {amg.n_levels} windowed "
          f"levels; build {build_s:.1f} s): {run['value']:.3f} ms/step, the median of "
          f"{len(run['windows_ms'])} windows of {K} steps (spread {run['spread']:.1%}; CUDA "
          f"events), settled r_norm {run['r_norm']:.4f} vs fixed-{TET_VERIFY[0]} "
          f"{run['r_norm_ref']:.4f} and fixed-{TET_VERIFY[1]} {run['r_norm_ref2']:.4f} "
          f"(envelope {R_NORM_ENVELOPE} each); one step run twice bit-equal; "
          f"K6 {counts['K6'] / n_steps:g} launches a step; strain + residual {apply_ms:.3f} "
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
    from fenics_constitutive_tpu_torch.solver import (
        PackedSimulation,
        build_packed_problem,
        disable_capture,
    )
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
    fused = p2_step_runs(run, loads[1:])
    reset_counts()
    with disable_capture():  # a replay adds no count: the same steps eagerly
        p2_step_runs(run, loads[1:])
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


# K8 against the plain lattice operator, normwise (L2): both sum the same
# 27 x 27 products of each cell and at most 8 cells a node, in another order
TOL_K8 = {torch.float64: 1e-13, torch.float32: 1e-5}
#: boxes besides the 32^3 one: ragged bricks, and rows longer than a block's 32 cells
K8_BOXES = ((3, 4, 5), (3, 2, 40))


def k8_cost(geo, itemsize: int, fields: bool = True) -> float:
    """Bytes of one K8 apply, each read or written once: u and r [3, M] and,
    for a field tangent, n, beta and gamma (8 values a Gauss point)."""
    return itemsize * (6 * geo.M + (8 * geo.N if fields else 0))


def k8_tangents(geo, law, seed: int) -> dict:
    """A plastic field tangent (one Mises evaluation past yield from the zero
    state, as phase 19's) and a uniform one whose n is a stride-0 view."""
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=geo.ndofs) * 2e-3 / geo.grid[0] * N_P2, dtype=geo.dtype,
                        device=CARD)
    zeros = torch.zeros(geo.qp_shape(6), dtype=geo.dtype, device=CARD)
    hist = {"eps_n": zeros.clone(),
            "alpha": torch.zeros(geo.qp_shape(1), dtype=geo.dtype, device=CARD)}
    _, plastic, _ = law.evaluate_packed(0.0, 1.0, geo.strain(u), zeros, hist)
    if float(plastic.gamma.abs().max()) <= 0:
        fail("phase 19b: the plastic tangent is not plastic anywhere")
    n = torch.as_tensor(rng.normal(size=6), dtype=geo.dtype, device=CARD)
    n = (n / n.norm()).reshape(6, 1, 1).expand(6, geo.n_qp, geo.n_cells)
    uniform = IsotropicTangent(kappa=KAPPA, beta=2 * MU, gamma=-0.3 * MU, n=n)
    return {"plastic": plastic, "uniform": uniform}


def phase_k8(results: dict) -> None:
    """Phase 19b: K8 (the P2 lattice operator) on the 32^3 box and two small
    ones, float64 and float32, against the plain operator (the body of
    LatticeGeometry.matvec_gm) and its sum-factorised twin; two launches
    bit-equal; matvec_gm takes K8 once a call; a CUDA graph of matvec_gm
    replays bit-equal to the eager call and counts no launch; K8's time on
    the card beside the plain operator's and its byte bound."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.models import Constraint, VonMises3D
    from fenics_constitutive_tpu_torch.ops import _cuda_build, build_lattice_geometry, cuda_lattice

    law = VonMises3D(MAT)
    line = []
    for cells in ((N_P2,) * 3, *K8_BOXES):
        V = FunctionSpace(unit_cube_mesh(*cells, "hex"), 2, 3)
        for dtype in (torch.float64, torch.float32):
            geo = build_lattice_geometry(V, Q_P2, Constraint.FULL, device=CARD, dtype=dtype)
            v = torch.as_tensor(np.random.default_rng(7).normal(size=3 * geo.M), dtype=dtype,
                                device=CARD)
            errs = []
            for form, tg in k8_tangents(geo, law, 8).items():
                if not cuda_lattice.lattice_apply_form(geo, tg):
                    fail(f"phase 19b: the {form} tangent does not take K8")
                r1 = cuda_lattice.lattice_apply(geo, v, tg)
                r2 = cuda_lattice.lattice_apply(geo, v, tg)
                before = cuda_lattice.launches["lattice_apply"]
                r_m = geo.matvec_gm(v, tg)
                torch.cuda.synchronize()
                if cuda_lattice.launches["lattice_apply"] - before != 1:
                    fail(f"phase 19b: matvec_gm did not launch K8 once ({form}, {cells})")
                if not torch.equal(r1, r2) or not torch.equal(r1, r_m):
                    fail(f"phase 19b: K8 {dtype} {form} {cells} differs between two launches "
                         "or from matvec_gm")
                plain = geo.residual_gm(tg.apply(geo.strain_gm(v)))
                twin = cuda_lattice.lattice_apply_plain(geo, v, tg)
                rel = float((r1.double() - plain.double()).norm() / plain.double().norm())
                rel_twin = float((r1.double() - twin.double()).norm() / twin.double().norm())
                errs.append(f"{form} rel {rel:.2e} (twin {rel_twin:.2e})")
                if not np.isfinite(rel) or max(rel, rel_twin) > TOL_K8[dtype]:
                    fail(f"phase 19b: K8 {dtype} {form} on {cells} disagrees with the plain "
                         f"operator: rel {rel:.3e}, twin {rel_twin:.3e} > {TOL_K8[dtype]:g}")
            label = f"{'x'.join(map(str, cells))} {str(dtype)[6:]}"
            if cells != (N_P2,) * 3:
                line.append(f"{label}: " + ", ".join(errs))
                continue
            tg = k8_tangents(geo, law, 9)["plastic"]
            graph_line = k8_graph_replay(geo, v, tg)
            nbytes = k8_cost(geo, v.element_size())
            bound, _ = bound_ms(nbytes, 0.0, dtype)
            dev = device_ms(lambda: geo.matvec_gm(v, tg), floor_ms=bound)
            events = cuda_ms(lambda: geo.matvec_gm(v, tg))
            plain_dev = device_ms(lambda: geo.residual_gm(tg.apply(geo.strain_gm(v))))
            results[f"K8_{str(dtype)[6:]}"] = {"device_ms": dev, "ms": events,
                                               "plain_device_ms": plain_dev, "bound_ms": bound,
                                               "bytes": nbytes}
            line.append(f"{label}: " + ", ".join(errs) + f" (tol {TOL_K8[dtype]:g}); two launches "
                        f"and matvec_gm bit-equal; {graph_line}; K8 on the card {dev:.4f} ms "
                        f"(events {events:.4f}; plain operator {plain_dev:.4f}), bound "
                        f"{bound:.4f} (bytes, {nbytes / 1e6:.1f} MB): {100 * bound / dev:.1f}%")
    usage = [ln.strip() for ln in _cuda_build.build_log["lattice"]["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print("phase 19b K8 vs the plain lattice operator: " + "; ".join(line) + "; ptxas: "
          + " | ".join(usage), flush=True)


def k8_graph_replay(geo, v, tg) -> str:
    """matvec_gm captured in a CUDA graph: the capture and three replays add
    no launch to the counter, and the replays equal the eager call."""
    from fenics_constitutive_tpu_torch.ops import cuda_lattice

    ref = geo.matvec_gm(v, tg)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        geo.matvec_gm(v, tg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = cuda_lattice.launches["lattice_apply"]
    with torch.cuda.graph(graph):
        out = geo.matvec_gm(v, tg)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    added = cuda_lattice.launches["lattice_apply"] - before
    if added or not torch.equal(out, ref):
        fail(f"phase 19b: a graph of matvec_gm counted {added} launches or replays unequal")
    return "a CUDA graph of it replays bit-equal and counts no launch"


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
    from fenics_constitutive_tpu_torch.solver import PackedSimulation, disable_capture

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
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out_state, probes = run_schedule(step, models, st.clone(), args, scales)
    ev1.record()
    ev1.synchronize()
    for key in cuda_window.launches:
        cuda_window.launches[key] = 0
    with disable_capture():  # a replay adds no count: the same steps eagerly
        run_schedule(step, models, st.clone(), args, scales)
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
    if min(counts["gather"], counts["scatter"], counts["bsr_matvec"]) <= 0 or counts["cell_apply"]:
        fail(f"phase 21 launches {counts}: expected K4, K5 and K6, and never K7 on P2 cells")

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
    the one card (parallel/); returns each rank's K4-K6 launches in the
    full-width run."""
    from fenics_constitutive_tpu_torch.fem import write_gmsh41_binary
    from fenics_constitutive_tpu_torch.parallel import dryrun_multichip, run_ranks
    from fenics_constitutive_tpu_torch.parallel.runs import cases_rank, problem_run

    path = workdir / "tet35.msh"
    write_gmsh41_binary(path, tet["mesh"])
    # phase 22's packed problem: its mesh (read back by every rank), its AMG
    # (built by every rank: windowed levels, passed as a node-major callable);
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
    cases = {"full": ("problem", full),
             **{name: ("problem", spec) for name, spec in SHARD_SMALL.items()}}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(cases_rank, N_RANKS, cases, RANK_DEVICE, workdir=workdir / "ranks",
                      timeout=SHARD_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    line = []
    for name in ("full", "aos", "hardening"):
        ref = refs[name]
        for rank, res in enumerate(ranks):
            r = res[name]
            ru, rs = rel_l2(r["u"], ref["u"]), rel_l2(r["stress"], ref["stress"])
            newton = [k for k, _ in r["iters"]]
            if max(ru, rs) > SHARD_BAR[name] or newton != [k for k, _ in ref["iters"]]:
                fail(f"phase 23 {name} rank {rank}: rel u {ru:.2e}, stress {rs:.2e} (bar "
                     f"{SHARD_BAR[name]:g}), iterations {r['iters']} vs {ref['iters']}")
            if name == "full" and r["iters"] != ref["iters"]:
                fail(f"phase 23 full rank {rank}: Newton/CG {r['iters']} vs phase 22's "
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
            f"rank {rank}: {r['ms_step']:.1f} ms/step (first steps of the process: CUDA's "
            f"lazy set-up included), set-up {r['setup_s']:.1f} s (peak "
            f"{r['setup_mem_peak'] / 2**30:.2f} GiB), steps' peak {r['mem_peak'] / 2**30:.2f} "
            f"GiB, QP state {r['qp_numel']:,} of {r['whole_qp_numel']:,}, launches K4 {k['K4']} "
            f"K5 {k['K5']} K6 {k['K6']}, {r['all_reduces']} all-reduces; "
            + kernel_check_errors(r, f"phase 23 rank {rank}"))
    print(f"phase 23(a, b) {N_RANKS} gloo ranks on the one card: phase 22's packed problem "
          f"({tet['mesh'].num_cells:,} tets, {N_QP_TET:,} padded QPs, f64, "
          f"{len(full['loads'])} steps) sharded, Newton/CG {ranks[0]['full']['iters']} as "
          f"phase 22's; the AoS problem of the reference's MPI test (10 steps) and the 7^3 "
          f"hardening box against the card's one-process runs (with the dry run, "
          f"{refs_s:.1f} s): " + "; ".join(line) + "; ranks bit-equal; " + "; ".join(per_rank)
          + f"; ranks spawned and joined in {ranks_s:.1f} s")
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


#: phase 25: amg.py runs half its windows' steps (8): at 16 its fixed-400
#: Jacobi runs took most of the 106 s amg.py took alone (NVIDIA H100 80GB
#: HBM3, 700 W)
AMG_BENCH_STEPS = "8"
TWIN_TIMEOUT = 600  # seconds, a twin run in its own process
#: the kernels line's names -> the twins' launch keys
TWIN_LAUNCH_KEYS = {"fused_matvec": "K1", "fused_eval": "K2",
                    **{name: f"K3_{kind}" for kind, name in K3_ENTRIES.items()},
                    "windowed_gather": "K4", "windowed_scatter": "K5",
                    "windowed_bsr_matvec": "K6"}


def run_twin(argv: list, env: dict, timeout: float = TWIN_TIMEOUT):
    """``python <argv>`` from the repository's root with ``env`` added:
    (exit code, its JSON line or None, its standard error)."""
    import os
    import sys

    proc = subprocess.run([sys.executable, *argv], cwd=Path(__file__).resolve().parent,
                          env={**os.environ, **env}, capture_output=True, text=True,
                          timeout=timeout, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return proc.returncode, json.loads(lines[-1]) if lines else None, proc.stderr


def hold_k6(amg, label: str) -> str:
    """K6 against its plain version on every A, P and R operator of ``amg``,
    at its plans' own type and select_passes, two launches bit-equal."""
    from fenics_constitutive_tpu_torch.ops import cuda_window

    worst, passes = 0.0, set()
    for lvl in range(amg.n_levels - 1):
        for name in ("A", "P", "R"):
            w = getattr(amg, name + "_win")[lvl]
            dtype = w.vals.dtype
            x = torch.as_tensor(np.random.default_rng(11).normal(size=w.bc * w.NC_pad),
                                dtype=dtype, device=CARD)
            y_k = cuda_window.windowed_bsr_matvec(w, x)
            y_k2 = cuda_window.windowed_bsr_matvec(w, x)
            y_p = cuda_window.bsr_matvec_plain(w, x)
            if not (torch.isfinite(y_k).all() and torch.equal(y_k, y_k2)):
                fail(f"K6 {label} {name}{lvl}: non-finite or not bit-equal across two launches")
            rel = normwise(y_k, y_p)[1]
            if rel > TOL_K6[dtype]:
                fail(f"K6 {label} {name}{lvl} disagrees with plain: rel {rel:.3e} > "
                     f"{TOL_K6[dtype]:g}")
            worst = max(worst, rel)
            passes.add(w.select_passes)
    return (f"K6 vs plain on {label}'s {3 * (amg.n_levels - 1)} level operators (select_passes "
            f"{sorted(passes)}, tol {TOL_K6[torch.float32]:g}, two launches bit-equal): worst "
            f"rel {worst:.1e}")


def phase_bench_twins() -> None:
    """Phase 25: the twins no earlier phase runs, in this process (p2.py,
    amg.py with K6 held against its plain version on every operator of the
    AMG it ran, roofline.py in both modes); then bench_torch.py with fixed-4
    CG in its own process as a user runs it, which must exit 1 with
    converged false; then bench_torch.py --sharded 2 --real where there are
    two cards."""
    import os

    hold_line("phase 25", "p2", p2_bench.measure([]), ("K3",))
    saved = os.environ.get("AMG_STEPS")
    os.environ["AMG_STEPS"] = AMG_BENCH_STEPS
    try:
        line, objs = amg_bench.measure([])
    finally:
        if saved is None:
            del os.environ["AMG_STEPS"]
        else:
            os.environ["AMG_STEPS"] = saved
    hold_line("phase 25", "amg", line, ("K6",), key="amg_launches")
    print(f"phase 25 {hold_k6(objs['amg'], 'amg.py')}", flush=True)
    del objs
    for label, argv in (("roofline", []), ("roofline windowed", ["windowed"])):
        line, kernels = roofline_bench.measure(argv)
        hold_line("phase 25", label, line, kernels)

    t0 = time.perf_counter()
    code, line, err = run_twin(["bench_torch.py"], {"BENCH_FIXED_ITERS": "4"})
    print(f"phase 25 bench_torch fixed-4 (BENCH_FIXED_ITERS=4 python bench_torch.py; exit "
          f"{code}, {time.perf_counter() - t0:.1f} s): {json.dumps(line)}", flush=True)
    if code != 1 or line is None or line["converged"] is not False:
        fail(f"phase 25: BENCH_FIXED_ITERS=4 python bench_torch.py exited {code}, expected 1 "
             f"with converged false:\n{err[-3000:]}")

    if torch.cuda.device_count() >= 2:
        code, line, err = run_twin(["bench_torch.py", "--sharded", "2", "--real"], {})
        print(f"phase 25 bench_torch --sharded 2 --real (exit {code}): {json.dumps(line)}")
        if code != 0 or line is None or not line["converged"]:
            fail(f"phase 25 bench_torch.py --sharded 2 --real exited {code}:\n" + err[-3000:])
        BENCH_LINES["bench_torch sharded2"] = line
    else:
        print(f"phase 25 bench_torch.py --sharded 2 --real: not run ("
              f"{torch.cuda.device_count()} card; it needs 2)")


#: phase 26: steps of each path run eagerly and replayed, and steps a timed window
COMPILED_STEPS = 8
#: the order phase 26 takes the paths in, and the phase that leaves each
COMPILED_PATHS = ("box", "box eager V-cycle", "Kuhn box", "windowed", "gather")


def same_tree(a, b) -> bool:
    """Every tensor of two PackedStates (or stats dicts) equal bit for bit."""
    from fenics_constitutive_tpu_torch.solver.compiled import _map

    flags = []
    _map(lambda x, y: flags.append(x.shape == y.shape and torch.equal(x.cpu(), y.cpu())), a, b)
    return all(flags)


def path_on_its_own(label: str) -> dict:
    """A path's problem built here, when phase 26 runs without the phases
    that leave it: the same set-up and warm-up loads."""
    from scripts.torch_bench.common import WARM_LOADS, warm_up

    if label.startswith("box"):
        fused = label == "box"
        geos, models, state, mg, args = bench_setup(N_BENCH, torch.float32, CARD, fused=fused)
        path = box_path({"geos": geos, "mg": mg, "models": models, "args": args,
                         "warm": state})
    elif label == "Kuhn box":
        _, _, geos, models, state, mgs, args, _ = kuhn_box_setup(torch.float32)
        mg = mgs[True]
        path = {"make_step": lambda: bench_step(geos, mg, TET_BOX_FIXED, "plain"),
                "models": models, "state": state, "args": args, "kernels": ("K3",)}
    else:
        tet = tet_setup()
        geos, models = tet["geos"], tet["models"]
        if label == "windowed":
            path = {"make_step": lambda: unstructured_bench.step_of(geos, tet["pc"], 12),
                    "models": models, "state": tet["state"], "kernels": ("K4", "K5", "K6"),
                    "args": tet_args(geos[0], tet["bcs"], torch.float32, CARD)}
        else:
            from fenics_constitutive_tpu_torch.fem import FunctionSpace
            from fenics_constitutive_tpu_torch.solver import PackedSimulation

            V = FunctionSpace(tet["mesh"], 1, 3)
            bcs = bench_bcs(V)
            sim = PackedSimulation(models[0], V, bcs, 2, engine="gather", preconditioner="amg",
                                   mg_options={"nu": 3}, device=CARD, dtype=torch.float32)
            g, amg = sim._geos, sim._mg
            path = {"make_step": lambda: tet_step(g, amg, TET_FIXED), "models": sim._models,
                    "state": sim.state, "args": tet_box_args(V, bcs, torch.float32),
                    "kernels": ("K6",)}
    step = path["make_step"]()
    path["state"] = warm_up(step, path["models"], path["state"], path["args"], WARM_LOADS)
    return path


def compiled_run(label: str, path: dict, phase: str = "phase 26", K: int = COMPILED_STEPS,
                 scales_of=None, eager_again: bool = True) -> dict:
    """One path: K steps eager (inside disable_capture), each of the path's
    kernels launched, and K steps replayed from the same warm state under
    torch.cuda.set_sync_debug_mode("error"), which must agree bit for bit in
    u, the stresses, the histories and the stats; then ms/step both ways by
    the twins' protocol (common.time_windows, windows of K steps at
    ``scales_of(j)``, by default the bench ramp). Also the capture's and the
    composition's seconds."""
    from fenics_constitutive_tpu_torch.solver import disable_capture
    from fenics_constitutive_tpu_torch.solver.compiled import _clone, _map
    from scripts.torch_bench.common import launches, time_windows
    from scripts.torch_bench.common import scales as bench_scales

    def window_scales(j, K):
        return scales_of(j) if scales_of else bench_scales(j, K)

    step, models, state0, args = path["make_step"](), path["models"], path["state"], path["args"]
    if not step.captured:
        fail(f"{phase} {label}: the step was not captured ({step.host_syncs})")
    bc_dofs, bc_vals, f_ext, dt = args
    loads = window_scales(0, K)

    def run(st, loads=loads):
        rows = []
        for sc in loads:
            st, stats = step(models, st, bc_dofs, bc_vals * sc, f_ext, dt)
            rows.append(stats)
        return st, rows

    t0 = time.perf_counter()
    step(models, state0, bc_dofs, bc_vals * loads[0], f_ext, dt)  # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    recorder = next(reversed(step._entries.values())).recorder
    reset_all_counts()
    with disable_capture():
        eager, eager_rows = run(state0)
    torch.cuda.synchronize()
    eager_counts = launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph, graph_rows = run(state0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if not same_tree(eager, graph):
        fail(f"{phase} {label}: {K} replayed steps differ from {K} eager steps")
    if not all(same_tree(a, b) for a, b in zip(eager_rows, graph_rows)):
        fail(f"{phase} {label}: the replayed steps' stats differ from the eager steps'")
    if any(eager_counts[k] <= 0 for k in path["kernels"]):
        fail(f"{phase} {label}: eager launches {eager_counts} (each of {path['kernels']} must "
             "launch)")
    if not torch.isfinite(graph.u).all():
        fail(f"{phase} {label}: non-finite state")

    def window(j):
        return run(state0, window_scales(j, K))[0]

    with disable_capture():
        t_eager = time_windows(window, K, CARD)
    t_graph = time_windows(window, K, CARD)
    t_eager2 = None
    if eager_again:
        with disable_capture():
            t_eager2 = time_windows(window, K, CARD)
    # what value semantics cost a call: the copy into the static buffers and
    # the clone of the outputs, one state each way
    buffers = _clone(state0)
    copy_ms = cuda_ms(lambda: (_map(torch.Tensor.copy_, buffers, state0), _clone(state0)),
                      iters=10)
    return {"eager_ms": t_eager["value"], "graph_ms": t_graph["value"],
            "eager_ms_again": t_eager2["value"] if t_eager2 else None,
            "spread": (t_eager["spread"], t_graph["spread"]),
            "host_ms": (t_eager["host_ms"], t_graph["host_ms"]), "capture_s": capture_s,
            "segment_capture_s": recorder.seconds["capture"],
            "compose_s": recorder.seconds["compose"], "segments": len(recorder.graphs),
            "loops": len(recorder.loops), "copy_ms": copy_ms, "counts": eager_counts,
            "replays": step.replays,
            "stats": {k: graph_rows[-1][k].item() for k in graph_rows[-1]}}


def phase_compiled() -> dict:
    """Phase 26: the compiled step (solver/compiled.py) on the four paths,
    each at its twin's full size: the hex box (K1, K2 and the K3 V-cycle, and
    K1, K2 with the eager V-cycle), the Kuhn box (K3, the plain Mises eval
    whose local Newton is a graph while node), the windowed engine with the
    windowed AMG (K4-K6) and the gather engine with the AMG (K6); then
    PackedSimulation's solve and solve_schedule through the graph, bit-equal
    to the same calls inside disable_capture(), and captured true at its
    Newton and CG defaults."""
    results = {}
    for label in COMPILED_PATHS:
        path = PATHS.get(label) or path_on_its_own(label)
        r = compiled_run(label, path)
        results[label] = r
        c = r["counts"]
        print(f"phase 26 {label}: {COMPILED_STEPS} replayed steps bit-equal to {COMPILED_STEPS} "
              f"eager ones (u, stresses, histories, stats; no host sync in the replays), "
              f"eager launches {', '.join(f'{k} {c[k]}' for k in path['kernels'])}; "
              f"ms/step eager {r['eager_ms']:.3f} / graph {r['graph_ms']:.3f} / eager "
              f"{r['eager_ms_again']:.3f} (medians of windows of {COMPILED_STEPS} steps, "
              f"spread {r['spread'][0]:.1%} / {r['spread'][1]:.1%}; host clock "
              f"{r['host_ms'][0]:.3f} / {r['host_ms'][1]:.3f}); capture {r['capture_s']:.2f} s; "
              f"copy in + clone out {r['copy_ms']:.4f} ms a call", flush=True)
    results["simulation"] = compiled_simulation()
    results["K1 device coefficients"] = k1_device_coefficients()
    return results


def k1_device_coefficients() -> str:
    """K1 on a uniform tangent whose coefficients are 0-d device tensors (an
    SLS law's, which follow dt): one launch that reads them from device
    memory, with no host read (under no_host_sync()); held to the plain
    operator at 50^3, f32."""
    from fenics_constitutive_tpu_torch.models import Constraint
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent, cuda_matvec
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
    from fenics_constitutive_tpu_torch.solver.compiled import no_host_sync

    V, _ = box(N_BENCH)
    geo = build_structured_geometry(V, 2, Constraint.FULL, device=CARD, dtype=torch.float32)
    mv = cuda_matvec.build_cuda_matvec(geo)

    def dev(x):
        return torch.tensor(x, dtype=torch.float32, device=CARD)

    tg = IsotropicTangent(kappa=dev(0.7 * KAPPA), beta=dev(1.4 * MU), gamma=dev(0.0),
                          n=torch.zeros((6, 1, 1), dtype=torch.float32, device=CARD))
    v = torch.as_tensor(np.random.default_rng(26).normal(size=geo.ndofs), dtype=torch.float32,
                        device=CARD)
    before = cuda_matvec.launches
    with no_host_sync():
        y = mv(v, tg)
    torch.cuda.synchronize()
    n = cuda_matvec.launches - before
    _, rel = normwise(y, cuda_matvec.matvec_plain(geo, v, tg))
    if n != 1 or rel > TOL_F32_K1 or not torch.isfinite(y).all():
        fail(f"phase 26: K1 with device coefficients: {n} launches, rel {rel:.3e} (tol "
             f"{TOL_F32_K1:g})")
    line = (f"K1 on a uniform tangent with device coefficients under no_host_sync: {n} "
            f"launch, rel {rel:.1e} against plain (tol {TOL_F32_K1:g})")
    print(f"phase 26 {line}", flush=True)
    return line


def compiled_simulation() -> str:
    """PackedSimulation on the 50^3 box (f32, the K3 V-cycle, K1 and K2,
    max_newton=1, fixed-9 CG): solve() twice and solve_schedule over 3 steps
    replay the graph and agree bit for bit with the same calls inside
    disable_capture(); the same simulation at its Newton and CG defaults
    reports captured true; a law that reads dt (SpringKelvinModel, f64, K1
    on its uniform tangent) replays a schedule of three dts within
    TOL_SLS_REPLAY (bit for bit) of the same schedule inside
    disable_capture(), and the schedule with its first dt throughout lies
    more than TOL_SLS_FROZEN away."""
    from fenics_constitutive_tpu_torch.fem import combine_bcs
    from fenics_constitutive_tpu_torch.models import Constraint, SpringKelvinModel, VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation, disable_capture

    V, bcs = box(N_BENCH)
    opts = dict(preconditioner="vcycle", mg_options={"fused_smoothing": True},
                eval_impl="kernel", max_newton=1, newton_rtol=0.5, newton_atol=0.0,
                cg_fixed_iters=BOX_BENCH["fixed"], device=CARD, dtype=torch.float32)
    sims = [PackedSimulation(VonMises3D(MAT), V, bcs, 2, **opts) for _ in range(2)]
    if not sims[0].captured:
        fail(f"phase 26: PackedSimulation with max_newton=1 and fixed CG is not captured "
             f"({sims[0].host_syncs})")
    bc_vals = combine_bcs(bcs)[1]
    loads = np.stack([bc_vals * k for k in (0.5, 1.0, 1.5)])
    outs = []
    for i, sim in enumerate(sims):
        ctx = disable_capture() if i else contextlib.nullcontext()
        with ctx:
            sched = sim.solve_schedule(loads)
            bcs[1].value = 0.004 * 2.0
            solves = [sim.solve() for _ in range(2)]
        outs.append((sched, solves, sim.state, dict(sim.last_stats)))
        bcs[1].value = 0.004
    (s0, v0, st0, ls0), (s1, v1, st1, _) = outs
    if not (same_tree(st0, st1) and v0 == v1
            and all(np.array_equal(s0[k], s1[k]) for k in s0)):
        fail("phase 26: PackedSimulation through the graph differs from the same calls "
             "inside disable_capture()")
    if ls0["captured"] is not True:
        fail(f"phase 26: PackedSimulation.last_stats says captured {ls0['captured']}")
    conv = PackedSimulation(VonMises3D(MAT), V, bcs, 2, preconditioner="vcycle",
                            device=CARD, dtype=torch.float32)
    if not conv.captured or conv.host_syncs:
        fail(f"phase 26: a converged-Newton PackedSimulation reports captured {conv.captured} "
             f"({conv.host_syncs})")
    # a law that reads dt (SpringKelvinModel), f64: the replayed schedule
    # with its dt in a device buffer, and K1 reading the tangent's device
    # coefficients, against the same schedule inside
    # disable_capture(), and the eager schedule with the first dt throughout
    # (what a dt frozen at capture would give), which must lie far outside
    sls = SpringKelvinModel({"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3},
                            Constraint.FULL)
    dts = np.array([0.5, 1.0, 0.25])
    sls_opts = {**opts, "eval_impl": "plain", "dtype": torch.float64, "cg_fixed_iters": 20}
    sls_sims = [PackedSimulation(sls, V, bcs, 2, **sls_opts) for _ in range(3)]
    k1 = read_counts()["K1"]
    sls_sims[0].solve_schedule(loads, dts=dts)
    k1 = read_counts()["K1"] - k1
    with disable_capture():
        sls_sims[1].solve_schedule(loads, dts=dts)
        sls_sims[2].solve_schedule(loads, dts=np.full(len(dts), dts[0]))
    stresses = [torch.as_tensor(sim.stress) for sim in sls_sims]
    _, rel_sls = normwise(stresses[0], stresses[1])
    _, rel_frozen = normwise(stresses[2], stresses[1])
    same_sls = same_tree(sls_sims[0].state, sls_sims[1].state)
    if (not sls_sims[0].captured or k1 <= 0 or rel_sls > TOL_SLS_REPLAY
            or rel_frozen < TOL_SLS_FROZEN):
        fail(f"phase 26: SpringKelvinModel replayed against eager: captured "
             f"{sls_sims[0].captured}, K1 launches {k1}, rel stress {rel_sls:.3e} (tol "
             f"{TOL_SLS_REPLAY:g}; state bit-equal {same_sls}); with dt frozen "
             f"{rel_frozen:.3e} (must exceed {TOL_SLS_FROZEN:g})")
    line = (f"PackedSimulation (50^3, f32, max_newton=1, fixed-9, K1-K3): solve_schedule over "
            f"3 steps and solve() twice replayed, bit-equal to disable_capture(), last_stats "
            f"captured {ls0['captured']}; at its Newton and CG defaults: captured "
            f"{conv.captured}; SpringKelvinModel (f64, dt 0.5/1/0.25, K1 {k1} launches "
            f"replayed) against disable_capture(): rel stress {rel_sls:.1e} (tol "
            f"{TOL_SLS_REPLAY:g}; state bit-equal {same_sls}; with dt frozen at 0.5 "
            f"{rel_frozen:.1e})")
    print(f"phase 26 {line}", flush=True)
    return line


# -- phase 27: the loops the device decides (CUDA graph while nodes) ----------------

#: phase 27's loads: phase 6's stretch 0.0004 k, k = 1, 2, 3 (window j adds 1e-4 j)
LOOP_STEPS = 3
#: float32 Newton tolerances of phase 27 (a): the eager float32 run converges
#: there in 2-3 iterations at 50^3 (float64 runs at PackedSimulation's defaults)
LOOP_F32 = {"newton_rtol": 1e-6, "newton_atol": 1e-3, "cg_rtol": 1e-5, "cg_maxiter": 2000}
#: the counter loop's trip counts
LOOP_TRIPS = (0, 1, 37)


def loop_scales(j: int) -> list:
    return [(k + 1) * (1 + 1e-4 * j) for k in range(LOOP_STEPS)]


def loop_self_test() -> str:
    """The while node alone: a counter loop captured once by
    CudaGraphRecorder, its trip count a device tensor, replays exactly N
    trips for N = 0, 1 and 37, alone and with a nested loop of 3 trips a
    trip. Also the versions the while node needs."""
    from fenics_constitutive_tpu_torch.solver import graph_loop
    from fenics_constitutive_tpu_torch.solver.compiled import CudaGraphRecorder, device_while

    build, driver = graph_loop.versions()
    if not hasattr(torch.cuda.CUDAGraph, "raw_cuda_graph"):
        fail(f"phase 27: torch {torch.__version__} has no CUDAGraph.raw_cuda_graph")
    i64, f64 = torch.int64, torch.float64
    n = torch.zeros((), dtype=i64, device=CARD)
    report = []
    for nested in (False, True):
        def body(carry, nested=nested):
            i, acc = carry
            if nested:
                acc = device_while(lambda c: c[0] < 3, lambda c: (c[0] + 1, c[1] + 1.0),
                                   (torch.zeros_like(i), acc), name="inner")[1]
            else:
                acc = acc + 1.0
            return i + 1, acc

        def fn(body=body):
            zero = torch.zeros((), dtype=i64, device=CARD)
            return device_while(lambda c: c[0] < n, body,
                                (zero, torch.zeros((), dtype=f64, device=CARD)), name="outer")

        rec = CudaGraphRecorder(CARD)
        out = rec.capture(fn)
        got = []
        for trips in LOOP_TRIPS:
            n.fill_(trips)
            torch.cuda.set_sync_debug_mode("error")
            try:
                rec.replay()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            want = (trips, trips * (3.0 if nested else 1.0))
            have = (int(out[0]), float(out[1]))
            if have != want:
                fail(f"phase 27 counter loop (nested {nested}): {trips} trips gave (trips, sum) "
                     f"{have}, expected {want}")
            got.append(f"{trips}: {have[0]} trips")
        report.append(f"{'nested' if nested else 'flat'} ({len(rec.graphs)} segments, "
                      f"{rec.graph.sets} set nodes) " + ", ".join(got))
    line = (f"while node self-test (CUDA runtime {build}, driver {driver}, torch "
            f"{torch.__version__}): " + "; ".join(report))
    print(f"phase 27 {line}", flush=True)
    return line


def loop_box_path(n: int, dtype) -> dict:
    """(a): PackedSimulation on the n^3 hex box with converged Newton and
    adaptive CG (its defaults; float32 at LOOP_F32), the fused V-cycle (K3),
    K1 by matvec_impl="auto", and the plain Mises eval, whose local Newton
    nests inside each Newton trip."""
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V, bcs = box(n)
    bcs[1].value = 0.0004
    opts = LOOP_F32 if dtype == torch.float32 else {}
    sim = PackedSimulation(VonMises3D(MAT), V, bcs, 2, preconditioner="vcycle",
                           mg_options={"fused_smoothing": True}, matvec_impl="auto",
                           eval_impl="plain", device=CARD, dtype=dtype, **opts)
    if not sim.captured or sim.host_syncs:
        fail(f"phase 27: PackedSimulation at its defaults is not captured ({sim.host_syncs})")
    return {"make_step": lambda: sim._step, "models": sim._models, "state": sim.state,
            "args": step_args(bcs, V.ndofs, dtype, CARD), "kernels": ("K1", "K3"), "sim": sim}


def loop_tet_path(tet: dict) -> dict:
    """(b): phase 9's imported 35^3 mesh (unstructured.setup: windowed engine,
    AMG V(2,2) with K4-K6), float32, converged Newton and adaptive CG at
    phase 10's tolerances."""
    bcs = tet["bcs"]
    value = bcs[1].value
    bcs[1].value = 0.0004
    try:
        args = tet_args(tet["geos"][0], bcs, torch.float32, CARD)
    finally:
        bcs[1].value = value
    geos, pc = tet["geos"], tet["pc"]
    return {"make_step": lambda: compiled_step(geos, preconditioner=pc, **LOOP_F32),
            "models": tet["models"], "state": tet["state"], "args": args,
            "kernels": ("K4", "K5", "K6")}


def loop_p2_path(n: int, q: int) -> dict:
    """(c): p2.py's step on the n^3 P2 lattice box (one Newton iteration,
    adaptive CG to 1e-5 with the refined-P1 V-cycle and its K3 chains)."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh

    V = FunctionSpace(unit_cube_mesh(n, n, n, "hex"), 2, 3)
    p = p2_bench.p2_problem(V, bench_bcs(V), q, CARD, torch.float32)
    return {"make_step": lambda: p["step"], "models": p["models"], "state": p["state"],
            "args": p["args"], "kernels": ("K3", "K8")}


def loop_simulation(path: dict) -> str:
    """PackedSimulation.solve() at its defaults through the graph against the
    same calls inside disable_capture() (a fresh simulation of the same
    options): states and last_stats bit-equal, last_stats["captured"]
    true; PackedSimulation with no option but device and dtype (a 4^3 box)
    captured and converged; a Drucker-Prager law on the 4^3 box captured,
    its replays bit-equal to disable_capture() (``graph_against_eager``)."""
    from fenics_constitutive_tpu_torch.models import DruckerPrager3D, VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation, disable_capture

    sim = path["sim"]
    V, bcs = sim.space, sim.bcs
    twin = PackedSimulation(sim._models[0], V, bcs, 2, preconditioner="vcycle",
                            mg_options={"fused_smoothing": True}, device=CARD,
                            dtype=sim.state.u.dtype)
    rows = []
    for k in range(1, LOOP_STEPS + 1):
        bcs[1].value = 0.0004 * k
        a = sim.solve()
        with disable_capture():
            b = twin.solve()
        rows.append((a, b, dict(sim.last_stats), dict(twin.last_stats)))
    bcs[1].value = 0.0004
    for a, b, sa, sb in rows:
        if a != b or {k: v for k, v in sa.items() if k != "captured"} != {
                k: v for k, v in sb.items() if k != "captured"} or sa["captured"] is not True:
            fail(f"phase 27: PackedSimulation.solve() through the graph {a} {sa} against "
                 f"disable_capture() {b} {sb}")
    if not same_tree(sim.state, twin.state):
        fail("phase 27: PackedSimulation's state through the graph differs from eager")
    V4, bcs4 = box(4)
    plain = PackedSimulation(VonMises3D(MAT), V4, bcs4, 2, device=CARD, dtype=torch.float64)
    ok = plain.solve()[1]
    if not (plain.captured and plain.host_syncs == () and ok
            and plain.last_stats["captured"] is True):
        fail(f"phase 27: PackedSimulation(VonMises3D, V, bcs, 2, device, dtype) at every default "
             f"is not captured ({plain.host_syncs}) or did not converge ({plain.last_stats})")
    V4, bcs4 = box(4)
    dp = PackedSimulation(DruckerPrager3D(DP_PARAMS), V4, bcs4, 2, device=CARD,
                          dtype=torch.float64)
    bcs4[1].value = 0.004
    if not dp.solve()[1]:  # the capture
        fail(f"phase 27: the Drucker-Prager box's first step did not converge ({dp.last_stats})")
    dp_rows = graph_against_eager("phase 27 DruckerPrager3D", dp, 0.004)
    line = (f"PackedSimulation at its defaults: solve() x{LOOP_STEPS} replayed (newton "
            f"{[r[2]['newton_iters'] for r in rows]}, cg_last "
            f"{[r[2]['cg_iters_last'] for r in rows]}), bit-equal to disable_capture() in "
            f"state and last_stats, captured {rows[-1][2]['captured']}; every default (4^3 "
            f"box, f64, preconditioner {plain.preconditioner}): captured {plain.captured}; "
            f"DruckerPrager3D (4^3 box): captured {dp.captured} (host_syncs {dp.host_syncs}), "
            f"3 steps past yield replayed under set_sync_debug_mode('error') bit-equal to "
            f"disable_capture() (newton {[r['newton_iters'] for r in dp_rows]})")
    print(f"phase 27 {line}", flush=True)
    return line


def phase_loops(tet: dict | None = None, n_box: int = N_BENCH, n_p2: int = N_P2,
                q_p2: int = 4) -> dict:
    """Phase 27: the steps whose loops the device decides, each replayed from
    one composed graph (compiled_run: bit-equal to disable_capture() in u,
    stresses, histories and stats, the path's kernels launched eagerly, no
    host read during the replays, ms/step both ways): (a) the box through PackedSimulation in
    float64 and float32, (b) the imported tet mesh on the windowed engine,
    (c) p2.py's step; first the while node's self-test, last
    PackedSimulation.solve() at its defaults."""
    results = {"self-test": loop_self_test()}
    paths = {}
    for dtype in (torch.float64, torch.float32):
        paths[f"(a) box {n_box}^3 {str(dtype)[6:]}"] = lambda dtype=dtype: loop_box_path(
            n_box, dtype)
    if tet is not None:
        paths[f"(b) imported {N_TET}^3 tets f32"] = lambda: loop_tet_path(tet)
    paths[f"(c) p2 {n_p2}^3 q{q_p2} f32"] = lambda: loop_p2_path(n_p2, q_p2)
    for label, make in paths.items():
        path = make()
        r = compiled_run(label, path, phase="phase 27", K=LOOP_STEPS, scales_of=loop_scales,
                         eager_again=False)
        results[label] = r
        c, st = r["counts"], r["stats"]
        print(f"phase 27 {label}: {LOOP_STEPS} replayed steps bit-equal to {LOOP_STEPS} eager "
              f"ones (u, stresses, histories; newton_iters {st['newton_iters']}, cg_iters_last "
              f"{st['cg_iters_last']}, r_norm {st['r_norm']:.4e}, r0_norm {st['r0_norm']:.4e} "
              f"on the last), no host sync in the replays, eager launches "
              f"{', '.join(f'{k} {c[k]}' for k in path['kernels'])}; ms/step eager "
              f"{r['eager_ms']:.3f} / graph {r['graph_ms']:.3f} (spread {r['spread'][0]:.1%} / "
              f"{r['spread'][1]:.1%}; host clock {r['host_ms'][0]:.3f} / {r['host_ms'][1]:.3f}); "
              f"first call {r['capture_s']:.2f} s (segment capture {r['segment_capture_s']:.3f} "
              f"s, composition {r['compose_s']:.3f} s; {r['segments']} segments, {r['loops']} "
              f"loops)", flush=True)
        if label.startswith("(a)") and "float64" in label:
            results["simulation"] = loop_simulation(path)
        del path
    return results


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
    tet = timed("tet setup", tet_setup)
    timed("phase 7", phase_k4_k5, results, tet)
    timed("phase 7b", phase_k7, results, tet)
    timed("phase 8", phase_k6, results, tet)
    tet_counts = timed("phase 9", phase_tet_bench, tet)
    timed("phase 10", phase_tet_simulation, tet)
    timed("phase 11", phase_k3, results)
    fused_bench = timed("phase 12", phase_bench_fused, box_bench)
    with tempfile.TemporaryDirectory() as tmp:
        timed("phase 13", phase_multimat, Path(tmp))
    two_law = timed("phase 14", phase_multilaw, tet)
    timed("phase 14b", phase_k9, results)
    timed("phase 15", phase_library)
    tet_box = timed("phase 16", phase_tet_box, results)
    with tempfile.TemporaryDirectory() as tmp:
        gather_counts = timed("phase 17", phase_gather, tet, Path(tmp))
    timed("phase 18", phase_small)
    p2_box_run = timed("phase 19", phase_p2_box, results)
    timed("phase 19b", phase_k8, results)
    run_2d = timed("phase 20", phase_2d, results)
    with tempfile.TemporaryDirectory() as tmp:
        p2_tet = timed("phase 21", phase_p2_imported, results, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        parity = timed("phase 22", phase_parity, tet, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        sharded = timed("phase 23", phase_sharded, tet, parity, Path(tmp))
    with tempfile.TemporaryDirectory() as tmp:
        examples = timed("phase 24", phase_examples, Path(tmp))
    timed("phase 25", phase_bench_twins)
    timed("phase 26", phase_compiled)
    timed("phase 27", phase_loops, tet)
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
         "launches_gather_run": gather_counts["K6"],
         "launches_p2_run": p2_tet["bsr_matvec"],
         "launches_parity_run": parity["packed"]["K6"],
         "launches_sharded_run": [r["K6"] for r in sharded], **results["K6"]},
    ]
    for k in kernels:  # the bench twins' eager windows (phases 5, 9, 12, 16 and 25)
        key = TWIN_LAUNCH_KEYS[k["name"]]
        runs = {label: line.get("amg_launches", line.get("launches"))[key]
                for label, line in BENCH_LINES.items()}
        k["launches_bench_run"] = {label: n for label, n in runs.items() if n}
    kernels.append({"name": "windowed_cell_apply", "route": "cuda", "source": src + "window.cu",
                    "replaces": "the plain middle of WindowedGeometry.matvec (no TPU kernel)",
                    "f64": results["K7_float64"], "f32": results["K7_float32"]})
    kernels.append({"name": "dp_return_map", "route": "cuda", "source": src + "return_map.cu",
                    "replaces": "the plain implicit_return_map of Drucker-Prager (no TPU kernel)",
                    "f64": results["K9_float64"], "f32": results["K9_float32"]})
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
    """``profile_run`` of run(), which takes K load steps of a compiled step,
    replayed from its CUDA graph and eagerly (inside disable_capture)."""
    from fenics_constitutive_tpu_torch.solver import disable_capture

    profile_run(f"{label}, replayed", run, K)
    with disable_capture():
        profile_run(f"{label}, eager", run, K)


def profile_run(label: str, run, K: int) -> None:
    """torch.profiler over run(), which takes K load steps: the same call's
    CUDA-event ms/step (unprofiled), device ops per step and the costliest
    kernels."""
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
    launches = sum(e.count for e in evs) / K
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: {ms_step:.3f} ms/step (CUDA events), "
          f"{launches:.0f} device ops/step; top: "
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
    tet = tet_setup()
    geos, models = tet["geos"], tet["models"]
    step = unstructured_bench.step_of(geos, tet["pc"], 12)
    args = tet_args(geos[0], tet["bcs"], torch.float32, CARD)
    st = tet["state"]
    for k in (0.5, 1.0, 1.5, 2.0):
        st, _ = step(models, st, args[0], args[1] * k, *args[2:])
    K = 3
    scales = [2.0 + 0.05 * (i + 1) for i in range(K)]
    profile_steps(f"tet {N_TET}^3 f32 AMG V(2,2), fixed-12 PCG",
                  lambda: run_schedule(step, models, st.clone(), args, scales), K)


def profile_tet_box() -> None:
    """``--profile``: 3 steps of phase 16's workload (the 35^3 Kuhn box on
    the structured-tet engine, fixed-14 CG), fused and eager V-cycle."""
    _, _, geos, models, state, mgs, args, _ = kuhn_box_setup(torch.float32)
    K = 3
    scales = [2.0 + 0.05 * i for i in range(K)]
    for fused in (True, False):
        step = bench_step(geos, mgs[fused], TET_BOX_FIXED, "plain")
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


def profile_loops() -> None:
    """``--profile``: phase 27's paths, 3 converged steps each from the zero
    state at 0.0004 k (p2.py's step: at 0.004 (1, 2, 3)), replayed and eager."""
    paths = {f"(a) box {N_BENCH}^3 f64": lambda: loop_box_path(N_BENCH, torch.float64),
             f"(a) box {N_BENCH}^3 f32": lambda: loop_box_path(N_BENCH, torch.float32),
             f"(b) imported {N_TET}^3 tets f32": lambda: loop_tet_path(tet_setup()),
             f"(c) p2 {N_P2}^3 q4 f32": lambda: loop_p2_path(N_P2, 4)}
    for label, make in paths.items():
        path = make()
        step = path["make_step"]()
        scales = loop_scales(0)
        profile_steps(f"{label} converged Newton, adaptive CG",
                      lambda step=step, path=path: run_schedule(
                          step, path["models"], path["state"], path["args"], scales),
                      len(scales))
        del path, step


def newton_forms(K: int = 24) -> None:
    """``--newton-forms``: the replayed bench step (50^3 box, f32, fixed-9
    CG, K1 and K2; the eager and the fused V-cycle) with its one Newton
    iteration as a while node of at most one trip (the step's own form)
    against PR 15's select form (evaluate, then torch.where on the
    predicate), in turns (while, select, select, while); then, in the select
    form, whose program is one segment, the composed graph against torch's
    own replay of that segment. ms/step by common.time_windows (windows of K
    steps) and a profile of 3 steps each."""
    from fenics_constitutive_tpu_torch.solver import packed_step
    from fenics_constitutive_tpu_torch.solver.compiled import _map
    from scripts.torch_bench.common import scales, time_windows, warm_up

    own = packed_step.device_while

    def select_once(cond, body, carry, reads=None):
        active = cond(carry)
        return _map(lambda n, o: torch.where(active, n, o), body(carry), carry)

    def run(label, step, models, state, args):
        st = warm_up(step, models, state, args)
        t = time_windows(lambda j: run_schedule(step, models, st, args, scales(j, K))[0], K,
                         CARD)
        print(f"newton forms {label}: {t['value']:.3f} ms/step (spread {t['spread']:.2%})",
              flush=True)
        profile_run(f"newton forms {label}",
                    lambda: run_schedule(step, models, st, args, scales(0, 3)), 3)

    try:
        for fused in (False, True):
            geos, models, state, mg, args = bench_setup(N_BENCH, torch.float32, CARD,
                                                        fused=fused)
            v = "fused" if fused else "eager"
            for form in ("while", "select", "select", "while"):
                packed_step.device_while = own if form == "while" else select_once
                run(f"{v} V-cycle, {form}", bench_step(geos, mg, 9, "kernel"), models, state,
                    args)
            packed_step.device_while = select_once
            for replay in ("composed", "torch", "torch", "composed"):
                step = bench_step(geos, mg, 9, "kernel")
                step(models, state, args[0], args[1], *args[2:])  # the capture
                rec = next(iter(step._entries.values())).recorder
                if len(rec.graphs) != 1 or rec.loops:
                    fail(f"newton forms: the select form has {len(rec.graphs)} segments")
                if replay == "torch":
                    rec.replay = rec.graphs[0].replay
                run(f"{v} V-cycle, select, {replay} replay", step, models, state, args)
    finally:
        packed_step.device_while = own


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
import inspect, pathlib, tempfile, torch, chip_smoke as c
c.phase_device()
c.phase_build()
results = {}
c.timed("phase 3", c.phase_k1, results)
c.timed("phase 4", c.phase_k2, results)
c.timed("phase 11", c.phase_k3, results)
box = {"mg": c.bench_setup(c.N_BENCH, torch.float32, "cuda")[3], "ms_step": float("nan")}
c.timed("phase 12", c.phase_bench_fused, box)
c.timed("profile box", c.profile_box)
with tempfile.TemporaryDirectory() as tmp:  # older checkouts' tet_setup takes a directory
    where = (pathlib.Path(tmp),) if inspect.signature(c.tet_setup).parameters else ()
    tet = c.timed("tet setup", c.tet_setup, *where)
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
        profile_loops()
    elif sys.argv[1:] == ["--newton-forms"]:
        phase_device()
        phase_build()
        newton_forms()
    elif sys.argv[1:] == ["--profiler-check"]:
        phase_device()
        phase_build()
        profiler_check()
    elif sys.argv[1:2] == ["--ab"] and len(sys.argv) == 4:
        phase_device()
        ab(sys.argv[2], sys.argv[3])
    else:
        main()
