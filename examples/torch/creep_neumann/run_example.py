"""Stress-controlled creep: a constant traction on a viscoelastic bar.

The PyTorch port's twin of ``examples/creep_neumann/run_example.py``: the
same mesh, law, load and checks, on the card in float64. Demonstrates:

  * Neumann loads on PackedSimulation (``f_ext=`` built with
    ``assemble_facet_traction``),
  * a whole creep history through one ``solve_schedule`` call, which reads
    nothing back until its last step,
  * checking the elastic instant response and the analytic creep limit
    of the standard linear solid (Kelvin branch):
      eps(0+) = sigma / E0,   eps(inf) = sigma / E0 + sigma / E1.

On the card one law with a factored tangent on a box of hexes runs its CG
operator through the fused CUDA kernel (``matvec_impl="auto"``). The creep
problem is homogeneous, so the two closed-form strains hold at any mesh
size: ``main(n=50, preconditioner="vcycle", mg_options={"fused_smoothing":
True})`` runs it at 1M quadrature points with the multigrid V-cycle and
its fused smoothing kernels.

Run:  python examples/torch/creep_neumann/run_example.py [out_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

# allow running from a plain checkout
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

import numpy as np
import torch

E0, E1, TAU, NU, SIGMA = 42.0, 10.0, 1.0, 0.2, 0.1
K = 40  # creep steps of dt = tau / 2


def main(out_dir: str = ".", *, device="cuda", n: int = 4, windows: int = 1,
         **options) -> dict:
    """Run the example on an n^3 box of hexes; return what it prints.

    ``options`` go to ``PackedSimulation`` (e.g. ``preconditioner``,
    ``mg_options``). ``windows`` splits the 40 creep steps into that many
    ``solve_schedule`` calls, each timed on its own (the physics is the
    same: every step starts from the one before).

    Returns the instant and creep-limit strains, the Newton iterations of the
    instant step and of every creep step, the set-up seconds, the ms per
    step of each window, and the simulation.
    """
    from fenics_constitutive_tpu_torch.fem import (
        DirichletBC,
        FunctionSpace,
        assemble_facet_traction,
        combine_bcs,
        locate_boundary_facets,
        unit_cube_mesh,
    )
    from fenics_constitutive_tpu_torch.models import Constraint, SpringKelvinModel
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    if K % windows:
        msg = f"windows={windows} does not divide the {K} creep steps"
        raise ValueError(msg)
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    mesh = unit_cube_mesh(n, n, n, "hex")
    V = FunctionSpace(mesh, 1, 3)

    def plane(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    # symmetry planes; the x=1 face carries the traction (no Dirichlet there)
    bcs = [
        DirichletBC(V.locate_dofs_geometrical(plane(0, 0.0), component=0), 0.0),
        DirichletBC(V.locate_dofs_geometrical(plane(1, 0.0), component=1), 0.0),
        DirichletBC(V.locate_dofs_geometrical(plane(2, 0.0), component=2), 0.0),
    ]
    facets = locate_boundary_facets(mesh, plane(0, 1.0))
    f_ext = assemble_facet_traction(V, facets, np.array([SIGMA, 0.0, 0.0]))

    law = SpringKelvinModel({"E0": E0, "E1": E1, "tau": TAU, "nu": NU}, Constraint.FULL)
    # q_degree=2: 1-point quadrature on hexes has hourglass (zero-energy)
    # modes, a singular tangent that a tightly converged CG resolves into.
    # The moduli of a multilevel preconditioner are the instant (E0) ones.
    moduli = (E0 / (2 * (1 + NU)), E0 / (3 * (1 - 2 * NU)))
    sim = PackedSimulation(
        law, V, bcs, 2, del_t=1e-8, f_ext=f_ext, device=device, dtype=torch.float64,
        elastic_moduli=moduli, newton_rtol=1e-12, newton_atol=1e-10, cg_rtol=1e-12,
        **options,
    )
    sync()
    setup_s = time.perf_counter() - t0

    # elastic instant response (dt -> 0: the dashpot is rigid)
    niter, converged = sim.solve()
    assert converged
    eps0 = float(sim.histories[0]["strain"].max())
    print(f"instant strain {eps0:.6f}  (analytic {SIGMA / E0:.6f})")
    assert abs(eps0 - SIGMA / E0) < 1e-8

    # the whole creep history: 40 steps of dt = tau/2
    sim.del_t = TAU / 2
    n_bc = len(combine_bcs(bcs)[0])
    k = K // windows
    iters, window_ms = [], []
    for _ in range(windows):
        sync()
        t1 = time.perf_counter()
        stats = sim.solve_schedule(np.zeros((k, n_bc)), f_ext_scales=np.ones(k))
        sync()
        window_ms.append((time.perf_counter() - t1) / k * 1e3)
        assert bool(stats["converged"].all())
        iters.extend(int(i) for i in stats["newton_iters"])
    eps_inf = float(sim.histories[0]["strain"].max())
    analytic = SIGMA / E0 + SIGMA / E1
    print(f"creep limit strain {eps_inf:.6f}  (analytic {analytic:.6f})")
    assert abs(eps_inf - analytic) < 1e-6

    outdir = pathlib.Path(out_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    out = outdir / "creep_history.csv"
    t_end = K * TAU / 2
    out.write_text(f"t,max_strain\n0.0,{eps0:.9f}\n{t_end},{eps_inf:.9f}\n")
    print(f"creep_neumann example OK (history -> {out})")
    return {
        "instant_strain": eps0, "creep_strain": eps_inf, "instant_newton": niter,
        "creep_newton": iters, "setup_s": setup_s, "window_ms_per_step": window_ms,
        "simulation": sim,
    }


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default=".")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
