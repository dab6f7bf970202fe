"""Plug a standalone, history-bearing C material into the solver.

The PyTorch port's twin of ``examples/mises_c/run_example.py``: a material
written completely outside the framework (plain C99,
``examples/mises_c/mises.c``, read where it is), compiled with gcc and
wrapped into the ``IncrSmallStrainModel`` protocol with ctypes, including
the history contract (plastic strain + alpha, ``{"history": 7}`` per
point). The solver runs on the card in float64; the C function runs on the
host, so every evaluation copies its operands there (new float64 arrays:
the C side writes through its pointers) and its results back.

Run:  python examples/torch/mises_c/run_example.py [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys
import time

# allow running from a plain checkout
REPO = pathlib.Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

import numpy as np
import torch

from fenics_constitutive_tpu_torch.models import Constraint, IncrSmallStrainModel
from fenics_constitutive_tpu_torch.native import build_shared_library, device_copy, host_copy

SOURCE = REPO / "examples" / "mises_c" / "mises.c"


def load() -> ctypes.CDLL:
    """Build the model's library (once) and declare its entry point."""
    so = build_shared_library([SOURCE], "libmises_c.so", compiler="gcc",
                              flags=("-std=c99", "-O2", "-lm"))
    lib = ctypes.CDLL(str(so))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.mises_c_evaluate.argtypes = [
        ctypes.c_double, ctypes.c_double, dp, dp, dp, dp, ctypes.c_long, dp,
    ]
    lib.mises_c_evaluate.restype = None
    return lib


class MisesC3D(IncrSmallStrainModel):
    """Wrapper: the C entry point -> model protocol (with history).

    ``evaluate`` runs in three steps, each a method: ``to_host`` (the
    operands as new host arrays), ``call_library`` (the C function, which
    writes stress, tangent and history in place) and ``to_device`` (the
    results as tensors of the caller's dtype and device)."""

    def __init__(self, parameters: dict[str, float]):
        self.params = {k: float(parameters[k]) for k in ("mu", "kappa", "y_0", "h")}
        self._lib = load()

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self):
        # the flat layout of the reference's Rust models
        # (bindings/src/lib.rs:130-136: {"history": 7})
        return {"history": 7}

    def to_host(self, grad_del_u, stress, history):
        q = grad_del_u.shape[0]
        return (host_copy(grad_del_u), host_copy(stress), host_copy(history),
                np.zeros(q * 36))

    def call_library(self, t, del_t, grad, sig, hist, tangent) -> None:
        dp = ctypes.POINTER(ctypes.c_double)
        params = np.array(list(self.params.values()))
        self._lib.mises_c_evaluate(
            float(t), float(del_t), grad.ctypes.data_as(dp), sig.ctypes.data_as(dp),
            tangent.ctypes.data_as(dp), hist.ctypes.data_as(dp), len(grad) // 9,
            params.ctypes.data_as(dp),
        )

    def to_device(self, sig, tangent, hist, like):
        q = len(sig) // 6
        return (device_copy(sig.reshape(q, 6), like),
                device_copy(tangent.reshape(q, 6, 6), like),
                device_copy(hist.reshape(q, 7), like))

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        grad, sig, hist, tangent = self.to_host(grad_del_u, stress, history["history"])
        self.call_library(t, del_t, grad, sig, hist, tangent)
        s_new, tangent_new, h_new = self.to_device(sig, tangent, hist, stress)
        return s_new, tangent_new, {"history": h_new}


def main(*, device="cuda", n: int = 2, n_steps: int = 10) -> dict:
    """Run the first ``n_steps`` of the 10 load steps on an n^3 box of hexes
    (the example: n = 2, all 10); return per step the displacement, the
    Newton iterations, whether it converged, the mean sigma_xx, the largest
    alpha and the step's seconds (solve and update; the solve reads its
    residual norms back, so the device has finished)."""
    from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem

    mesh = unit_cube_mesh(n, n, n, "hex")
    V = FunctionSpace(mesh, 1, 3)
    law = MisesC3D({"mu": 80769.0, "kappa": 175000.0, "y_0": 250.0, "h": 1000.0})

    def plane(axis, v, component):
        dofs = V.locate_dofs_geometrical(lambda x: np.isclose(x[:, axis], v),
                                         component=component)
        return DirichletBC(dofs, 0.0)

    move = plane(0, 1.0, 0)
    bcs = [plane(0, 0.0, 0), plane(1, 0.0, 1), plane(2, 0.0, 2), move]
    problem = IncrSmallStrainProblem(law, V, bcs, q_degree=2, device=device,
                                     dtype=torch.float64)
    rows = []
    for disp in np.linspace(0.001, 0.02, 10)[:n_steps]:
        move.value = float(disp)
        t0 = time.perf_counter()
        n_it, converged = problem.solve()
        problem.update()
        seconds = time.perf_counter() - t0
        alpha = float(problem._history_0[0]["history"][:, 6].max())
        sigma_xx = float(problem.stress_0[..., 0].mean())
        print(
            f"disp={disp:.4f} iters={n_it} converged={converged} "
            f"sigma_xx={sigma_xx:9.2f} alpha_max={alpha:.5f}"
        )
        rows.append({"disp": float(disp), "iters": n_it, "converged": converged,
                     "sigma_xx": sigma_xx, "alpha_max": alpha, "seconds": seconds,
                     "cg_iters": problem.last_stats["cg_iters"]})
    return {"steps": rows}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default=".", help="unused (nothing is written)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(device=parse_args().device)
