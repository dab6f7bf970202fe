"""Plug a hand-written C++ material into the solver.

The PyTorch port's twin of ``examples/elasticity_cpp/run_example.py``:
compile the standalone model (``examples/elasticity_cpp/elasticity.cpp``,
read where it is) with g++, wrap its flat-array entry point into the
``IncrSmallStrainModel`` protocol with ctypes, and solve a BVP with it on
the card in float64. The C++ function runs on the host: ``evaluate`` copies
its operands to new float64 host arrays (the C side writes through its
pointers), calls it, and returns tensors on the caller's device.

Run:  python examples/torch/elasticity_cpp/run_example.py [--device cpu]
"""

from __future__ import annotations

import argparse
import ctypes
import pathlib
import sys

# allow running from a plain checkout
REPO = pathlib.Path(__file__).resolve().parents[3]
sys.path.insert(0, str(REPO))

import numpy as np
import torch

from fenics_constitutive_tpu_torch.models import Constraint, IncrSmallStrainModel
from fenics_constitutive_tpu_torch.native import build_shared_library, device_copy, host_copy

SOURCE = REPO / "examples" / "elasticity_cpp" / "elasticity.cpp"


def load() -> ctypes.CDLL:
    """Build the model's library (once) and declare its entry point."""
    so = build_shared_library([SOURCE], "libelasticity_example.so", compiler="g++")
    lib = ctypes.CDLL(str(so))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.example_evaluate.argtypes = [
        ctypes.c_double, ctypes.c_double, dp, dp, dp, dp, ctypes.c_long, dp,
    ]
    lib.example_evaluate.restype = None
    return lib


class CppElasticity3D(IncrSmallStrainModel):
    """Wrapper: flat-array C++ entry point -> model protocol."""

    def __init__(self, parameters: dict[str, float]):
        self.params = {"E": float(parameters["E"]), "nu": float(parameters["nu"])}
        self._lib = load()

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self):
        return None

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        q = grad_del_u.shape[0]
        grad = host_copy(grad_del_u)
        sig = host_copy(stress)
        tangent = np.zeros(q * 36)
        params = np.array([self.params["E"], self.params["nu"]])
        dp = ctypes.POINTER(ctypes.c_double)
        self._lib.example_evaluate(
            float(t), float(del_t), grad.ctypes.data_as(dp), sig.ctypes.data_as(dp),
            tangent.ctypes.data_as(dp), None, q, params.ctypes.data_as(dp),
        )
        return (device_copy(sig.reshape(q, 6), stress),
                device_copy(tangent.reshape(q, 6, 6), stress), history)


def main(*, device="cuda") -> dict:
    """Run the example; return the Newton iterations, whether it converged,
    max |u| and the mean sigma_xx."""
    from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem

    mesh = unit_cube_mesh(2, 2, 2, "tetra")
    V = FunctionSpace(mesh, 1, 3)
    law = CppElasticity3D({"E": 42.0, "nu": 0.3})
    bcs = [
        DirichletBC(
            V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 0.0)),
            np.zeros(3),
        ),
        DirichletBC(
            V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 1.0)),
            np.array([0.01, 0.0, 0.0]),
        ),
    ]
    problem = IncrSmallStrainProblem(law, V, bcs, 1, device=device, dtype=torch.float64)
    n, converged = problem.solve()
    problem.update()
    u_max = float(problem.u.abs().max())
    sigma_xx = float(problem.stress_0[..., 0].mean())
    print(f"converged={converged} in {n} iterations")
    print("max |u| =", u_max)
    print("mean sigma_xx =", sigma_xx)
    return {"iters": n, "converged": converged, "max_u": u_max, "mean_sigma_xx": sigma_xx}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default=".", help="unused (nothing is written)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(device=parse_args().device)
