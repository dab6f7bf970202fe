"""The system under test, as a user drives it: the port's mesh, function
space, Dirichlet set and law, and ``PackedSimulation`` with the
configuration's options. Every call into ``fenics_constitutive_tpu_torch``
that the benchmark makes goes through here."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _stretch_x(V, dirichlet):
    """x = 0 fixed in x, x = 1 moved in x (the load), y = 0 fixed in y,
    z = 0 fixed in z. Returns (bcs, the moved BC)."""

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    moved = dirichlet(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.0)
    bcs = [dirichlet(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0), moved,
           dirichlet(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
           dirichlet(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0)]
    return bcs, moved


BOUNDARIES = {"stretch_x": _stretch_x}


class Program:
    """One PackedSimulation of a configuration. ``solve(load)`` is one load
    step through ``PackedSimulation.solve()``."""

    def __init__(self, cfg: dict, mesh_module, inputs: dict, workdir, device, dtype):
        from fenics_constitutive_tpu_torch import models
        from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace
        from fenics_constitutive_tpu_torch.solver import PackedSimulation

        mesh = mesh_module.program_mesh(inputs, cfg["mesh"], workdir)
        V = FunctionSpace(mesh, cfg.get("degree", 1), 3)
        #: the coordinates of the space's dof nodes [n_dof_nodes, 3], in its
        #: own numbering (the mesh nodes at degree 1)
        self.dof_coords = V.dof_coords
        bcs, self._moved = BOUNDARIES[cfg["boundary"]](V, DirichletBC)
        law = getattr(models, cfg["law"]["name"])(cfg["law"]["params"])
        self.sim = PackedSimulation(law, V, bcs, cfg["q_degree"], device=device, dtype=dtype,
                                    **cfg["simulation"])

    def solve(self, load: float) -> tuple[int, bool]:
        self._moved.value = load
        return self.sim.solve()

    @property
    def state(self):
        return self.sim.state

    @state.setter
    def state(self, st) -> None:
        self.sim.state = st

    def eager(self):
        """A context in which every step runs eagerly (the port's
        ``disable_capture()``)."""
        from fenics_constitutive_tpu_torch.solver import disable_capture

        return disable_capture()

    @property
    def last_stats(self) -> dict:
        return self.sim.last_stats

    def public_u(self, u_state: torch.Tensor) -> torch.Tensor:
        """A state's displacement (as ``state.u`` holds it) in the public
        node-major dof order."""
        keep = self.sim.state
        try:
            self.sim.state = dataclasses.replace(keep, u=u_state)
            return self.sim.u.detach().clone()
        finally:
            self.sim.state = keep

    def fields(self, state) -> dict:
        """A state's stress and history fields per cell and point, mesh cell
        order: ``stress`` [C, Q, 6] and each history field [C, Q, h]."""
        keep = self.sim.state
        try:
            self.sim.state = state
            out = {"stress": torch.as_tensor(self.sim.stress)}
        finally:
            self.sim.state = keep
        geo = self.sim._geos[0]
        for name, v in state.histories[0].items():
            out[name] = geo.extract_cells(v).permute(2, 1, 0).to(torch.float64).cpu()
        return out

    # -- what the per-layer readers take from the program ---------------------------

    @property
    def geometry(self):
        return self.sim._geos[0]

    @property
    def preconditioner(self):
        return self.sim._mg


def launch_counts() -> dict:
    """The port's own launch counters of K1-K6 (K3 per V-cycle entry too),
    the replayed loops' trips settled first."""
    from fenics_constitutive_tpu_torch.ops import cuda_eval, cuda_matvec, cuda_smoother, cuda_window
    from fenics_constitutive_tpu_torch.solver.compiled import settle_counters

    settle_counters()
    return {"K1": cuda_matvec.launches, "K2": cuda_eval.launches, "K3": cuda_smoother.launches,
            **{f"K3.{k}": v for k, v in cuda_smoother.entry_launches.items()},
            "K4": cuda_window.launches["gather"], "K5": cuda_window.launches["scatter"],
            "K6": cuda_window.launches["bsr_matvec"]}
