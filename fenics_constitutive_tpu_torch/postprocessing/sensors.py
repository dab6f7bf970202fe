"""Point sensors for the displacement and for quadrature fields.

Point location runs once on the host (numpy): the Newton inverse map of the
geometry, verified by the forward map. A ``DisplacementSensor`` keeps the
space's shape-function weights at the located reference points and samples
``u`` as a small contraction on ``u``'s device; a ``QPSensor`` reads the
quadrature point nearest each physical point.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.elements import _interval_basis, _tensor_basis, _tetra_basis, _triangle_basis
from ..fem.kinematics import _geometry_grad_at, precompute_geometry
from ..fem.spaces import FunctionSpace, _geometry_basis_at

__all__ = ["DisplacementSensor", "QPSensor"]

_REF_MID = {
    "interval": [0.5],
    "triangle": [1 / 3, 1 / 3],
    "quad": [0.5, 0.5],
    "tetra": [0.25, 0.25, 0.25],
    "hex": [0.5, 0.5, 0.5],
}


def _try_cell(mesh, c, p, ref_mid, tol=1e-9):
    """Newton inverse map of point p into cell c: its reference coordinates,
    or None when p lies outside. Exact in one step on affine cells; it
    iterates on distorted quads and hexes and checks that the forward map
    gives p back, so a sliver cell near p is never taken by mistake."""
    verts = mesh.nodes[mesh.cells[c]]
    xi = ref_mid.copy()
    for _ in range(25):
        r = p - _geometry_basis_at(mesh.cell_type, xi[None])[0] @ verts
        if np.linalg.norm(r) <= 1e-12 * (1.0 + np.linalg.norm(p)):
            break
        J = verts.T @ _geometry_grad_at(mesh.cell_type, xi[None])[0]
        try:
            xi = xi + np.linalg.solve(J, r)
        except np.linalg.LinAlgError:
            return None
        if np.abs(xi).max() > 10.0:  # diverging: p is far from this cell
            return None
    else:
        return None
    inside = np.all(xi >= -tol)
    if mesh.cell_type in ("triangle", "tetra"):
        inside &= xi.sum() <= 1 + tol
    else:
        inside &= np.all(xi <= 1 + tol)
    return xi if inside else None


def _locate(mesh, points):
    """(cell index, reference coordinates) of each point: the 30 cells with
    the nearest midpoints first, then every other cell before a miss."""
    mids = mesh.cell_midpoints()
    ref_mid = np.asarray(_REF_MID[mesh.cell_type])
    cells_out, xi_out = [], []
    for p in np.atleast_2d(np.asarray(points, np.float64)):
        order = np.argsort(np.linalg.norm(mids - p, axis=1))
        for c in order:
            xi = _try_cell(mesh, c, p, ref_mid)
            if xi is not None:
                cells_out.append(c)
                xi_out.append(xi)
                break
        else:
            msg = f"point {p} not found in mesh"
            raise ValueError(msg)
    return np.asarray(cells_out), np.asarray(xi_out)


class DisplacementSensor:
    """Samples the displacement field at fixed physical points::

        sensor = DisplacementSensor(V, [[0.5, 0.5, 0.5]])
        values = sensor(problem.u)  # [n_points, value_size], u's device
    """

    def __init__(self, space: FunctionSpace, points):
        mesh = space.mesh
        cells, xis = _locate(mesh, points)
        deg = space.degree
        basis = {
            "interval": lambda p: _interval_basis(deg, p)[0],
            "triangle": lambda p: _triangle_basis(deg, p)[0],
            "tetra": lambda p: _tetra_basis(deg, p)[0],
            "quad": lambda p: _tensor_basis(deg, p, 2)[0],
            "hex": lambda p: _tensor_basis(deg, p, 3)[0],
        }[mesh.cell_type]
        self.dofs = torch.as_tensor(np.asarray(space.dofmap)[cells], dtype=torch.int64)  # [P, n, vs]
        self.weights = torch.as_tensor(basis(np.asarray(xis)))  # [P, n] float64

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        u_e = u[self.dofs.to(u.device)]  # [P, n, vs]
        w = self.weights.to(dtype=u.dtype, device=u.device)
        return (w[:, :, None] * u_e).sum(dim=1)


class QPSensor:
    """Reads the quadrature point nearest each physical point of a
    ``[C, Q, k]`` field (``problem.stress_0``, an AoS history)."""

    def __init__(self, space: FunctionSpace, q_degree: int, points):
        qp = precompute_geometry(space, q_degree).qp_coords  # [C, Q, g]
        flat = qp.reshape(-1, qp.shape[-1])
        pts = np.atleast_2d(np.asarray(points, np.float64))
        idx = np.argmin(np.linalg.norm(flat[None] - pts[:, None], axis=2), axis=1)
        self.cell = torch.as_tensor(idx // qp.shape[1])
        self.qp = torch.as_tensor(idx % qp.shape[1])

    def __call__(self, field: torch.Tensor) -> torch.Tensor:
        """field [C, Q, k] -> [n_points, k]."""
        return field[self.cell.to(field.device), self.qp.to(field.device)]
