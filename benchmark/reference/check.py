"""The comparison that decides ``correct``: the program's answers against the
plain reference, recomputed from the benchmark's own inputs.

The reference follows the load path from the zero state: for each step it
takes the displacement the program returned (the answer being judged),
forms the strain increment from the step before, runs its own return map
from its own state, and assembles its own internal force. It never reads a
stress or history value of the program except to judge it. Numbers:

- ``bc_gap``: the largest gap between a Dirichlet dof of a returned
  displacement and its prescribed value, over that value (the program sets
  them exactly).
- ``newton_residual``: the largest ratio over the steps of the free dofs'
  residual norm at the returned displacement to that at the step's start
  (the step before's displacement with the new Dirichlet values), both
  worked out by the reference: the measure Newton's relative tolerance
  bounds.
- ``state_gap``: at the last step judged, the largest gap over all points
  and components between the program's stress and the reference's, over the
  reference's largest stress component, and the same for each law's history
  fields on its own cells, each over the larger of its largest value there
  and that law's strain scale.

Where a configuration gives several laws, each runs on its own cells (the
harness's ``law_cells``), with the time step ``dt`` of the configuration's
``del_t``; one law runs on every cell.

A space of degree 1 holds its dofs on the mesh nodes in the mesh's order,
and the displacements are taken as they come. A space of higher degree
numbers its dof nodes its own way: ``judge`` is then given their
coordinates, and matches each to the reference's node on the lattice of
``mesh["spacing"]`` (``node_map``), never by the program's numbering.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from ..harness import RunError
from .fem import Geometry

#: how far (in lattice spacings) a dof coordinate may lie from its lattice node
ON_LATTICE = 1e-6


def _close(x: np.ndarray, v: float) -> np.ndarray:
    return np.isclose(x, v)


def stretch_x(nodes: np.ndarray):
    """The unit cube pulled along x: x = 0 fixed in x, x = 1 moved by the
    load in x, y = 0 fixed in y, z = 0 fixed in z. Returns (dofs, weights):
    a dof's prescribed value is its weight times the load."""
    groups = [(_close(nodes[:, 0], 0.0), 0, 0.0), (_close(nodes[:, 0], 1.0), 0, 1.0),
              (_close(nodes[:, 1], 0.0), 1, 0.0), (_close(nodes[:, 2], 0.0), 2, 0.0)]
    dofs = np.concatenate([3 * np.nonzero(m)[0] + c for m, c, _ in groups])
    weights = np.concatenate([np.full(int(m.sum()), w) for m, _, w in groups])
    # a dof in two groups keeps the later one's value (as the BCs combine)
    _, last = np.unique(dofs[::-1], return_index=True)
    keep = np.sort(len(dofs) - 1 - last)
    return dofs[keep], weights[keep]


BOUNDARIES = {"stretch_x": stretch_x}


def law_module(name: str):
    return importlib.import_module(f"{__package__}.{name.lower()}")


def node_map(mesh: dict, dof_coords: np.ndarray) -> np.ndarray:
    """The reference node of each of the program's dof nodes: both sets of
    coordinates rounded to the lattice of spacing ``mesh["spacing"]``. Raises
    ``RunError`` where a coordinate lies off that lattice or on no node of
    the mesh, where two land on one node, or where the counts differ."""
    h, nodes = float(mesh["spacing"]), mesh["nodes"]
    ref = np.rint(nodes / h).astype(np.int64)
    scaled = np.asarray(dof_coords, np.float64) / h
    mine = np.rint(scaled)
    off = np.abs(scaled - mine).max(axis=1) > ON_LATTICE
    if off.any():
        i = int(np.argmax(off))
        raise RunError(f"dof node {i} at {dof_coords[i]} lies on no node of the "
                       f"{h:g} lattice")
    # one id per distinct lattice point, over the mesh's nodes then the program's
    _, ids = np.unique(np.vstack([ref, mine.astype(np.int64)]), axis=0, return_inverse=True)
    ids = ids.reshape(-1)
    owner = np.full(ids.max() + 1, -1, np.int64)
    owner[ids[:len(ref)]] = np.arange(len(ref))
    perm = owner[ids[len(ref):]]
    if (perm < 0).any():
        i = int(np.argmax(perm < 0))
        raise RunError(f"dof node {i} at {dof_coords[i]} lands on no node of the mesh")
    if len(np.unique(perm)) != len(perm):
        raise RunError("two of the program's dof nodes land on one lattice node")
    if len(perm) != len(nodes):
        raise RunError(f"the program has {len(perm)} dof nodes, the mesh {len(nodes)}")
    return perm


def judge(mesh: dict, laws: list, boundary: str, steps: list, last: dict, device,
          dt: float = 1.0, dof_coords=None) -> dict:
    """The numbers compared. ``mesh``: nodes, cells, cell_type (and spacing);
    ``laws``: [(law, cells)], each law's name and params on its mesh cells
    (None: every cell), as ``harness.law_cells`` gives them; ``steps``:
    [(load, u)] from the zero state, u node-major [3 n_dof_nodes]; ``last``:
    the program's ``stress`` [C, Q, 6] and, per law, its ``histories``
    fields [C_law, Q, h] after the last of them; ``dt``: the time step;
    ``dof_coords``: the program's dof node coordinates where they are not
    the mesh nodes in order (a space of degree above 1), matched by
    ``node_map``. Each law's points go through its own reference, and their
    stresses make one internal force."""
    if dof_coords is not None:
        perm = torch.as_tensor(node_map(mesh, dof_coords))

        def renumber(u):
            out = torch.empty(len(perm), 3, dtype=u.dtype)
            out[perm] = u.reshape(-1, 3)
            return out.reshape(-1)

        steps = [(load, renumber(torch.as_tensor(u))) for load, u in steps]
    if len(last["histories"]) != len(laws):
        raise RunError(f"the program gives {len(last['histories'])} laws' histories, the "
                       f"configuration has {len(laws)} laws")
    geo = Geometry(mesh["nodes"], mesh["cells"], mesh["cell_type"], device)
    C, Q = geo.cells.shape[0], geo.Q
    parts = []  # (reference, params, the law's points in [C * Q] or all)
    for law, cells in laws:
        if cells is None:
            pts, P = slice(None), C * Q
        else:
            c = torch.as_tensor(cells, dtype=torch.int64, device=device)
            pts = (c[:, None] * Q + torch.arange(Q, device=device)).reshape(-1)
            P = len(pts)
        parts.append((law_module(law["name"]), law["params"], pts, P))
    dofs_np, weights_np = BOUNDARIES[boundary](mesh["nodes"])
    dofs = torch.as_tensor(dofs_np, device=device)
    weights = torch.as_tensor(weights_np, dtype=torch.float64, device=device)
    free = torch.ones(3 * geo.n_nodes, dtype=torch.bool, device=device)
    free[dofs] = False
    states = [ref.zero_state(P, device) for ref, _, _, P in parts]
    eps_prev = torch.zeros((C * Q, 6), dtype=torch.float64, device=device)
    u_prev = torch.zeros(3 * geo.n_nodes, dtype=torch.float64, device=device)

    def whole_stress(laws_states):
        stress = torch.zeros((C * Q, 6), dtype=torch.float64, device=device)
        for (_, _, pts, _), st in zip(parts, laws_states):
            stress[pts] = st["stress"]
        return stress

    def residual(u):
        """(free residual norm, the laws' states, the strain) at u from the
        step before's states."""
        eps = geo.strain(u).reshape(C * Q, 6)
        d_eps = eps - eps_prev
        new = [ref.update(params, d_eps[pts], st, dt)
               for (ref, params, pts, _), st in zip(parts, states)]
        f = geo.internal_force(whole_stress(new).reshape(C, Q, 6))
        return float(torch.linalg.vector_norm(f[free])), new, eps

    bc_gap = newton = 0.0
    for load, u in steps:
        u = torch.as_tensor(u, dtype=torch.float64, device=device)
        target = load * weights
        bc_gap = max(bc_gap, float((u[dofs] - target).abs().max()) / abs(load))
        u0 = u_prev.clone()
        u0[dofs] = target
        r0 = residual(u0)[0]
        r, states, eps_prev = residual(u)
        newton = max(newton, r / r0)
        u_prev = u

    def gap(prog, mine, floor):
        prog = torch.as_tensor(prog, dtype=torch.float64, device=device)
        mine = mine.reshape(prog.shape[0], Q, -1)
        scale = max(float(mine.abs().max()), floor)
        diff = float((prog - mine).abs().max())
        return diff / scale if scale > 0 else (0.0 if diff == 0 else float("inf"))

    gaps = [gap(last["stress"], whole_stress(states), 0.0)]
    for (ref, params, _, _), st, hist in zip(parts, states, last["histories"]):
        scale = ref.strain_scale(params)
        gaps += [gap(hist[name], st[name], scale) for name in ref.HISTORY]
    return {"bc_gap": bc_gap, "newton_residual": newton, "state_gap": max(gaps)}
