"""Roofline accounting of the bench steps on the PyTorch/CUDA port (the twin
of the JAX package's ``scripts/roofline.py``), and the bound arithmetic that
``chip_smoke.py`` shares.

    python scripts/torch_bench/roofline.py [n] [--device cpu] [--dtype float64]
    python scripts/torch_bench/roofline.py windowed [n]

Box mode (default n = 50): bench.py's step past yield, each phase timed alone
by CUDA events on the card (the mean of many calls) against its bound:

  A eval_assemble  one K2 call: strain, radial return, tangent factors, residual
  B matvec         one K1 call: the fused CG operator
  C V-cycle        one V(3,3) multigrid apply, its chains as K3
  D cg_iteration   one iteration of the fixed-count CG (B + C + dots and axpys)
  E full step      one Newton iteration, end to end (fixed-9 CG)

Windowed mode (default n = 35): the shuffled Kuhn tet box on the windowed
engine: K4 (gather), K5 (scatter), one operator apply, one eval and assembly,
and one step with fixed-40 Jacobi CG (ROOF_FIXED).

A phase's bound is the larger of its bytes (each input read once, each
output written once) over the H100's memory rate, 3.35 TB/s, and its
operations over the card's peak rate outside the tensor cores (67 TFLOP/s in
float32, 34 in float64; NVIDIA's data sheet, SXM, 700 W). One JSON line:
``metric`` (``roofline_box`` or ``roofline_windowed``), ``n_qp``,
``phases`` (per phase ``ms``, ``bytes``, ``flops``, ``bound_ms``,
``bound_by`` and ``x_bound`` = ms / bound), ``converged`` (every phase's
output finite and the step's residual below its start), ``launches``
(K1-K7 over the phases' own kernel calls; the step's replays add none), ``clock``, ``dtype`` and ``device``.
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


def k1_cost(geo, itemsize: int = 4) -> tuple[float, float]:
    """(bytes, flops) of one K1 apply with values of ``itemsize`` bytes:
    u -> r reads u, beta, gamma [8, M], n [48, M] and the mask and writes r;
    per valid cell the strain and divergence products (2 x 1152
    multiply-adds) and ~40 operations per Gauss point for the tangent."""
    M, cells = geo.M, float(geo.mask.sum())
    return itemsize * (3 + 8 + 8 + 48 + 1 + 3) * M, cells * (4 * 1152 + 8 * 40) + 21 * M


def k2_cost(geo, itemsize: int = 4) -> tuple[float, float]:
    """(bytes, flops) of one K2 call with values of ``itemsize`` bytes: du
    3, stress 48, eps_n 48, alpha 8, mask 1 in; r 3, stress 48, eps_n 48, n
    48, alpha 8, beta 8, gamma 8 out: 279 M values. Operations: per valid cell the
    gradient-structured strain and divergence (2 x 576 multiply-adds) and
    ~100 per Gauss point for the trial state, not counting the local Newton
    trips; the node sums (a lower bound)."""
    M, cells = geo.M, float(geo.mask.sum())
    return itemsize * 279 * M, cells * (4 * 576 + 8 * 100) + 21 * M


def window_costs(ex, itemsize: int = 4) -> dict:
    """(bytes, flops) of one K4 and one K5 call on the plan ``ex`` (3
    components): K4 reads u [3, M_pad] and the plan's ``loc`` and writes the
    rows; K5 reads the rows and its node index and writes [3, M_pad], three
    additions per row entry."""
    rows = ex.B * 3 * ex.Rn * itemsize
    idx5 = (ex.node_ptr.numel() * ex.node_ptr.element_size()
            + ex.node_rows.numel() * ex.node_rows.element_size())
    return {"K4": (3 * ex.M_pad * itemsize + ex.loc.numel() * ex.loc.element_size() + rows,
                   0.0),
            "K5": (rows + idx5 + 3 * ex.M_pad * itemsize, 3.0 * ex.node_rows.numel())}


def k6_cost(w) -> tuple[float, float]:
    """(bytes, flops) of one K6 apply: the row layout (row_ptr, col, blk) and
    x read once, y written once; two operations per block entry."""
    size = w.blk.element_size()
    nnzb = w.col.numel()
    nbytes = ((w.NR_pad + 1 + nnzb) * 4
              + (nnzb * w.br * w.bc + w.bc * w.NC_pad + w.br * w.NR_pad) * size)
    return nbytes, 2.0 * nnzb * w.br * w.bc


def stencil_flops(geo) -> float:
    """Operations of one stencil apply at a node: 3^d neighbours of vs x vs
    blocks, a multiply and an add each (486 on a hex level, 72 on a quad)."""
    return 2.0 * 3**geo.gdim * geo.vs**2


def level_bytes(chain) -> int:
    """What a K3 kernel reads of a level: inv_d, the pattern ids and stencils."""
    return sum(t.numel() * t.element_size() for t in (chain.inv_d, chain.pid, chain.st))


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


def vcycle_costs(fc, itemsize: int, first: int) -> list:
    """(label, kind, (bytes, flops)) of every K3 entry of one fused V-cycle
    (``FusedVcycle``) whose one-block tail starts at level ``first``, in the
    cycle's order: pre_restrict down to ``first``, the tail, prolong_post up."""
    g0 = fc._chain(0).geo
    vs, apply_ops = g0.vs, stencil_flops(g0)
    n_nb, n_corner = 3**g0.gdim, 2**g0.gdim  # restriction and prolongation weights
    vec = itemsize * vs
    out = []
    for lvl in range(first):
        pre, M, Mc = fc.chains[lvl]["pre"], fc._chain(lvl).geo.M, fc._chain(lvl + 1).geo.M
        out.append((f"L{lvl} pre_restrict", "pre_restrict",
                    (level_bytes(pre) + vec * (2 * M + Mc),
                     pre.nu * M * apply_ops + (pre.nu - 1) * 3 * vs * M + n_nb * 2 * vs * Mc)))
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
    out.append((f"L{first}-{fc.n_levels - 1} tail", "tail", (nbytes, flops)))
    for lvl in reversed(range(first)):
        post, M = fc.chains[lvl]["post"], fc._chain(lvl).geo.M
        out.append((f"L{lvl} prolong_post", "prolong_post",
                    (level_bytes(post) + vec * (3 * M + fc._chain(lvl + 1).geo.M),
                     post.nu * M * apply_ops + post.nu * 3 * vs * M + 2 * n_corner * vs * M)))
    return out


# -- the measurement ----------------------------------------------------------------


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", nargs="*", help="[n] (box) or windowed [n]")
    common.add_device_args(ap)
    return ap.parse_args(argv)


def phase_ms(fn, device, iters: int = 20) -> float:
    """Mean ms of fn(): CUDA events on the card, the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        return common.cuda_ms(fn, iters=iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def row(name: str, ms: float, cost: tuple, dtype) -> dict:
    bound, by = bound_ms(*cost, dtype)
    return {"phase": name, "ms": ms, "bytes": cost[0], "flops": cost[1], "bound_ms": bound,
            "bound_by": by, "x_bound": ms / bound if bound else None}


def finite(*tensors) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tensors)


def box_phases(n: int, device, dtype) -> dict:
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent, cuda_eval, cuda_matvec
    from fenics_constitutive_tpu_torch.solver import linear

    cuda = device.type == "cuda"
    impl = "kernel" if cuda else "plain"
    geos, models, state, mg, args = common.bench_setup(n, dtype, device, fused=True)
    geo, law = geos[0], models[0]
    step = common.bench_step(geos, mg, 9, impl)
    warm = common.warm_up(step, models, state, args, (*common.WARM_LOADS, 2.0))
    common.sync(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    rng = np.random.default_rng(3)
    v = torch.as_tensor(rng.normal(size=geo.ndofs), dtype=dtype, device=device)
    du = geo.to_grid_major(warm.u) * 0.01
    common.reset_all_counts()

    fused_eval = cuda_eval.build_cuda_eval(geo, law)
    r_a, s_a, (beta, gamma, nf), h_a = fused_eval(du, warm.stress[0], warm.histories[0])
    ms_a = phase_ms(lambda: fused_eval(du, warm.stress[0], warm.histories[0]), device)
    tg = IsotropicTangent(kappa=law.params["p_ka"], beta=beta, gamma=gamma, n=nf)
    mv = cuda_matvec.build_cuda_matvec(geo)
    y_b = mv(v, tg)
    ms_b = phase_ms(lambda: mv(v, tg), device)
    z_c = mg(v)
    ms_c = phase_ms(lambda: mg(v), device, iters=10)
    iters = 9
    x_d, _ = linear.cg_solve(lambda p: mv(p, tg), v, precond=mg, fixed_iters=iters)
    ms_d = phase_ms(lambda: linear.cg_solve(lambda p: mv(p, tg), v, precond=mg,
                                            fixed_iters=iters), device, iters=5) / iters
    loads = iter(range(10**6))
    st_e, stats = step(models, warm, args[0], args[1] * 2.05, *args[2:])
    ms_e = phase_ms(lambda: step(models, warm, args[0], args[1] * (2.05 + 1e-4 * next(loads)),
                                 *args[2:]), device, iters=10)
    counts = common.launches()

    fc = mg.fused_cycle
    first = fc.tail_start(device) if cuda else fc.n_levels - 1
    cost_a, cost_b = k2_cost(geo, itemsize), k1_cost(geo, itemsize)
    cost_c = tuple(sum(c[k] for _, _, c in vcycle_costs(fc, itemsize, first)) for k in (0, 1))
    axpy = itemsize * 3 * geo.M * (2 * 2 + 3 * 3)  # 2 dots, 3 axpys on 3-vectors
    cost_d = (cost_b[0] + cost_c[0] + axpy, cost_b[1] + cost_c[1] + 3 * geo.M * (2 * 2 + 2 * 3))
    cost_e = (2 * cost_a[0] + iters * cost_d[0], 2 * cost_a[1] + iters * cost_d[1])
    phases = [row("A eval_assemble (K2)", ms_a, cost_a, dtype),
              row("B matvec (K1)", ms_b, cost_b, dtype),
              row("C V(3,3) cycle (K3)", ms_c, cost_c, dtype),
              row("D cg_iteration", ms_d, cost_d, dtype),
              row("E full step (1 Newton, fixed-9 CG)", ms_e, cost_e, dtype)]
    ok = finite(r_a, s_a, h_a["alpha"], y_b, z_c, x_d, st_e.u) and float(
        stats["r_norm"]) < float(stats["r0_norm"])
    return {"metric": "roofline_box", "n_qp": int(geo.N), "phases": phases, "converged": ok,
            "captured": step.captured, "launches": counts, "kernels": ("K1", "K2", "K3")}


def windowed_phases(n: int, device, dtype) -> dict:
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent
    from fenics_constitutive_tpu_torch.solver import build_packed_problem

    V = FunctionSpace(common.imported_mesh(n), 1, 3)
    bcs = common.bench_bcs(V)
    geos, models, state = build_packed_problem(V, VonMises3D(common.MAT), 2, device=device,
                                               dtype=dtype, engine="windowed")
    geo, law = geos[0], models[0]
    ex, N = geo.ex, geo.N
    itemsize = torch.empty((), dtype=dtype).element_size()
    fixed = int(os.environ.get("ROOF_FIXED", "40"))
    step = common.compiled_step(geos, max_newton=1, newton_rtol=0.0, newton_atol=0.0,
                                cg_rtol=1e-5, cg_maxiter=400, cg_fixed_iters=fixed)
    args = common.step_args(bcs, geo.ndofs_int, dtype, device)
    warm = common.warm_up(step, models, state, args, (*common.WARM_LOADS, 2.0))
    common.sync(device)
    rng = np.random.default_rng(1)
    u2 = torch.as_tensor(rng.normal(size=(geo.vs, ex.M_pad)), dtype=dtype, device=device)
    rows = torch.as_tensor(rng.normal(size=(ex.B, geo.vs, ex.Rn)), dtype=dtype, device=device)
    ui = torch.as_tensor(rng.normal(size=geo.ndofs_int), dtype=dtype, device=device)
    tg = IsotropicTangent(kappa=common.KAPPA,
                          beta=torch.full((N,), 2 * common.MU, dtype=dtype, device=device),
                          gamma=torch.zeros(N, dtype=dtype, device=device),
                          n=torch.zeros((6, N), dtype=dtype, device=device))
    sig0, h0 = warm.stress[0], warm.histories[0]

    def eval_assemble():
        s2, tg2, h2 = law.evaluate_packed(0.0, 1.0, geo.strain(ui * 1e-3), sig0, h0)
        return geo.residual(s2), s2, h2["alpha"]

    common.reset_all_counts()
    outs = [ex.gather(u2), ex.scatter(rows), geo.matvec(ui, tg), *eval_assemble()]
    ms = {"gather": phase_ms(lambda: ex.gather(u2), device),
          "scatter": phase_ms(lambda: ex.scatter(rows), device),
          "matvec": phase_ms(lambda: geo.matvec(ui, tg), device),
          "eval": phase_ms(eval_assemble, device, iters=10)}
    loads = iter(range(10**6))
    st_e, stats = step(models, warm, args[0], args[1] * 2.05, *args[2:])
    ms["step"] = phase_ms(lambda: step(models, warm, args[0],
                                       args[1] * (2.05 + 1e-4 * next(loads)), *args[2:]),
                          device, iters=3)
    counts = common.launches()
    costs = window_costs(ex, itemsize)
    ex_bytes = costs["K4"][0] + costs["K5"][0]
    # dN [4, 3, N] read twice (strain and residual), the tangent factors and
    # weights, plus a gather and a scatter
    cost_mv = (itemsize * (2 * 12 * N + 8 * N + 2 * N) + ex_bytes, costs["K5"][1])
    # stress and history in and out, factors, strain, dN twice, the exchanges
    cost_ev = (itemsize * N * (6 * 4 + 7 * 2 + 8 + 2 * 12 + 2) + ex_bytes, costs["K5"][1])
    cost_step = (2 * cost_ev[0] + fixed * cost_mv[0], 2 * cost_ev[1] + fixed * cost_mv[1])
    phases = [row("gather (K4)", ms["gather"], costs["K4"], dtype),
              row("scatter (K5)", ms["scatter"], costs["K5"], dtype),
              row("matvec", ms["matvec"], cost_mv, dtype),
              row("eval_assemble", ms["eval"], cost_ev, dtype),
              row(f"full step (fixed-{fixed} Jacobi CG)", ms["step"], cost_step, dtype)]
    ok = finite(*outs, st_e.u) and float(stats["r_norm"]) < float(stats["r0_norm"])
    return {"metric": "roofline_windowed", "n_qp": int(N), "phases": phases, "converged": ok,
            "captured": step.captured, "launches": counts, "kernels": ("K4", "K5")}


def measure(argv=None) -> tuple[dict, tuple]:
    """(the JSON line, the kernels its phases must launch on the card)."""
    args = parse_args(argv)
    device, dtype = common.resolve_device(args)
    target = list(args.target)
    windowed = bool(target) and target[0] == "windowed"
    if windowed:
        target = target[1:]
    n = int(target[0]) if target else (35 if windowed else 50)
    out = (windowed_phases if windowed else box_phases)(n, device, dtype)
    kernels = out.pop("kernels")
    return {**out, "clock": "cuda events" if device.type == "cuda" else "host",
            "dtype": str(dtype).removeprefix("torch."),
            "device": common.device_info(device)}, kernels


def main(argv=None) -> dict:
    line, kernels = measure(argv)
    for p in line["phases"]:
        print(f"{p['phase']:38s} {p['ms']:9.4f} ms  bound {p['bound_ms']:.4f} ms "
              f"({p['bound_by']}), x{p['x_bound']:.1f}", file=sys.stderr)
    common.print_line(line)
    if line["device"]["name"] != "cpu":
        common.require_launched(line["launches"], kernels, line["metric"])
    if not line["converged"]:
        print("FAIL: a phase produced non-finite values or the step did not lower the "
              "residual", file=sys.stderr)
        sys.exit(1)
    return line


if __name__ == "__main__":
    main()
