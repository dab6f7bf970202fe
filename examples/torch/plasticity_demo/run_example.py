"""End-to-end demo: multi-material elastoplastic cube, ParaView output.

The PyTorch port's twin of ``examples/plasticity_demo/run_example.py``: a
stiff von Mises matrix with a soft elastic inclusion, stretched in 12 load
steps on the card in float64; writes a .pvd time series (displacement +
per-cell von Mises stress) you can open directly in ParaView. Demonstrates:

  * multi-material laws on cell subsets (reference _lawonsubmesh machinery),
  * the interactive solve/update loop of ``IncrSmallStrainProblem``,
  * VTU/PVD field output (``fem.io``), fed host numpy arrays.

Run:  python examples/torch/plasticity_demo/run_example.py [out_dir] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

# allow running from a plain checkout
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[3]))

import numpy as np
import torch


def main(out_dir: str = ".", *, device="cuda") -> dict:
    """Run the demo; return per step the displacement, the Newton
    iterations, whether it converged and the largest cell-mean Mises stress."""
    from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.fem.io import PVDWriter
    from fenics_constitutive_tpu_torch.models import (
        Constraint,
        LinearElasticityModel,
        VonMises3D,
    )
    from fenics_constitutive_tpu_torch.ops import mandel
    from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem

    mesh = unit_cube_mesh(6, 6, 6, "hex")
    V = FunctionSpace(mesh, 1, 3)

    # soft elastic sphere in a hardening von Mises matrix
    mid = mesh.cell_midpoints()
    inside = np.linalg.norm(mid - 0.5, axis=1) < 0.25
    cells_incl = np.flatnonzero(inside)
    cells_matrix = np.flatnonzero(~inside)
    matrix = VonMises3D(
        {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0,
         "p_y00": 2500.0, "p_w": 200.0}
    )
    inclusion = LinearElasticityModel({"E": 20000.0, "nu": 0.3}, Constraint.FULL)
    laws = [(matrix, cells_matrix), (inclusion, cells_incl)]

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    bc_move = DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.0)
    bcs = [
        DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
        bc_move,
        DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0),
    ]
    problem = IncrSmallStrainProblem(laws, V, bcs, q_degree=2, device=device,
                                     dtype=torch.float64)

    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pvd = PVDWriter(out / "plasticity_demo.pvd")
    material_id = inside.astype(float)

    rows = []
    for step, disp in enumerate(np.linspace(0.002, 0.024, 12), start=1):
        bc_move.value = float(disp)
        niter, converged = problem.solve(rtol=1e-10, atol=1e-8, cg_rtol=1e-10)
        problem.update()
        sig = problem.stress_0  # [C, Q, 6] Mandel, on the problem's device
        mises = mandel.mises_norm(sig.reshape(-1, 6)).reshape(sig.shape[0], -1).mean(dim=1)
        mises = mises.cpu().numpy()
        pvd.write(
            mesh,
            time=problem._time,
            point_data={"u": problem.u.cpu().numpy().reshape(-1, 3)},
            cell_data={
                "mises": mises,
                "sigma_xx": sig[..., 0].mean(dim=1).cpu().numpy(),
                "material": material_id,
            },
        )
        print(
            f"step {step:2d} disp={disp:.4f} iters={niter} "
            f"converged={converged} max_mises={mises.max():8.1f}"
        )
        rows.append({"disp": float(disp), "iters": niter, "converged": converged,
                     "max_mises": float(mises.max())})
    pvd.close()
    print(f"wrote {out / 'plasticity_demo.pvd'} (+12 .vtu files)")
    return {"steps": rows}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out_dir", nargs="?", default=".")
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    main(args.out_dir, device=args.device)
