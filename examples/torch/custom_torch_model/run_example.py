"""Write a custom constitutive model in plain PyTorch.

The PyTorch port's twin of ``examples/custom_jax_model/run_example.py``.
Where the reference's custom-model story is Rust/C++/Fortran behind a numpy
ABI (docs/custom_models/*), a model here can be a plain subclass of
``IncrSmallStrainModel`` whose ``evaluate`` maps (t, dt, grad_del_u, stress,
history) to (stress, tangent, history) with torch ops. This example
implements a Ramberg-Osgood-flavored nonlinear elastic model not present in
the library and uses it end-to-end, on the card in float64. Its consistent
tangent is ``torch.func.vmap(torch.func.jacfwd(...))`` of the stress
function, and the solver's engines reach it through the generic
``evaluate_packed`` adapter.

Run:  python examples/torch/custom_torch_model/run_example.py [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

# allow running from a plain checkout
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

import numpy as np
import torch
from torch.func import jacfwd, vmap

from fenics_constitutive_tpu_torch.models import Constraint, IncrSmallStrainModel
from fenics_constitutive_tpu_torch.ops import mandel


class NonlinearElastic3D(IncrSmallStrainModel):
    """Deviatorically-stiffening elasticity: mu_eff = mu (1 + c ||e'||).

    The tangent comes from torch.func.jacfwd of the stress function: no hand
    derivation, and it is exactly consistent by construction. The stress
    function must stay functional under torch.func (no in-place ops, no
    ``.item()``).
    """

    def __init__(self, parameters: dict[str, float]):
        self.params = {k: float(v) for k, v in parameters.items()}  # mu, kappa, c

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self):
        return {"strain": 6}  # total strain (path-independent model)

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        del t, del_t, stress
        mu, kappa, c = self.params["mu"], self.params["kappa"], self.params["c"]
        i2 = torch.as_tensor(mandel.sym_identity(6), dtype=grad_del_u.dtype,
                             device=grad_del_u.device)

        def sigma_fn(eps_total):  # one point: [6] -> [6]
            tr = eps_total[:3].sum()
            dev = eps_total - tr / 3.0 * i2
            # smooth norm: a plain vector norm has a NaN derivative at 0,
            # which would poison the jacfwd tangent on the first iteration
            dev_norm = torch.sqrt(torch.sum(dev * dev) + 1e-30)
            mu_eff = mu * (1.0 + c * dev_norm)
            return kappa * tr * i2 + 2.0 * mu_eff * dev

        deps = mandel.strain_from_grad_u(grad_del_u, Constraint.FULL)
        eps_total = history["strain"] + deps
        stress_new = vmap(sigma_fn)(eps_total)
        tangent = vmap(jacfwd(sigma_fn))(eps_total)
        return stress_new, tangent, {"strain": eps_total}


def main(*, device="cuda") -> dict:
    """Run the example; return the Newton iterations, whether it converged
    and the mean sigma_xx."""
    from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem

    mesh = unit_cube_mesh(2, 2, 2, "hex")
    V = FunctionSpace(mesh, 1, 3)
    law = NonlinearElastic3D({"mu": 80.0, "kappa": 170.0, "c": 50.0})
    bcs = [
        DirichletBC(
            V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 0.0)),
            np.zeros(3),
        ),
        DirichletBC(
            V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 1.0)),
            np.array([0.05, 0.0, 0.0]),
        ),
    ]
    problem = IncrSmallStrainProblem(law, V, bcs, 2, device=device, dtype=torch.float64)
    n, converged = problem.solve()
    problem.update()
    sigma_xx = float(problem.stress_0[..., 0].mean())
    print(f"converged={converged} in {n} Newton iterations (nonlinear model)")
    print("mean sigma_xx =", sigma_xx)
    return {"iters": n, "converged": converged, "mean_sigma_xx": sigma_xx}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default=".", help="unused (nothing is written)")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(device=parse_args().device)
