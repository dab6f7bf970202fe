"""The system under test, as a user drives it: the port's mesh, function
space, Dirichlet set and laws, and ``PackedSimulation`` with the
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


def _model(models, law: dict):
    """The port's model of a law entry (its ``constraint`` by name, where
    the entry gives one)."""
    cls = getattr(models, law["name"])
    if "constraint" in law:
        return cls(law["params"], models.Constraint[law["constraint"]])
    return cls(law["params"])


class Program:
    """One PackedSimulation of a configuration. ``solve(load)`` is one load
    step through ``PackedSimulation.solve()``. ``laws`` is the harness's
    ``law_cells``: one law on every cell (cells None) goes in as the model
    alone, several as ``[(model, cells)]``."""

    def __init__(self, cfg: dict, mesh_module, inputs: dict, laws: list, workdir, device, dtype):
        from fenics_constitutive_tpu_torch import models
        from fenics_constitutive_tpu_torch.fem import DirichletBC, FunctionSpace
        from fenics_constitutive_tpu_torch.solver import PackedSimulation

        mesh = mesh_module.program_mesh(inputs, cfg["mesh"], workdir)
        V = FunctionSpace(mesh, cfg.get("degree", 1), 3)
        #: the coordinates of the space's dof nodes [n_dof_nodes, 3], in its
        #: own numbering (the mesh nodes at degree 1)
        self.dof_coords = V.dof_coords
        bcs, self._moved = BOUNDARIES[cfg["boundary"]](V, DirichletBC)
        if laws[0][1] is None:
            law = _model(models, laws[0][0])
        else:
            law = [(_model(models, spec), cells) for spec, cells in laws]
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
        """A state's fields per cell and point, on the host: ``stress`` [C,
        Q, 6] of the whole mesh in mesh cell order, and ``histories``, for
        each law its history fields [C_law, Q, h] on its own cells, in the
        order they were given."""
        keep = self.sim.state
        try:
            self.sim.state = state
            stress = torch.as_tensor(self.sim.stress)
        finally:
            self.sim.state = keep
        histories = [{name: geo.extract_cells(v).permute(2, 1, 0).to(torch.float64).cpu()
                      for name, v in hist.items()}
                     for geo, hist in zip(self.sim._geos, state.histories)]
        return {"stress": stress, "histories": histories}

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
