"""Host geometry tabulation (numpy, evaluated once when a geometry is built).

``precompute_geometry`` tabulates physical shape-function gradients and
quadrature weights per cell, as ``fenics_constitutive_tpu.fem.kinematics``
does, but keeps them as host numpy arrays: the AMG host build
(solver/amg.py) assembles its elastic operator from them, and the engines
upload what they need themselves. ``_geometry_grad_at`` is the analytic
geometry-basis gradient the structured and windowed engines use.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .elements import tabulate_element
from .spaces import FunctionSpace, _geometry_basis_at

__all__ = ["Geometry", "_geometry_grad_at", "precompute_geometry"]


@dataclass(frozen=True)
class Geometry:
    """Per-cell, per-QP tabulated data (host numpy, float64)."""

    dN_dx: np.ndarray  # [C, Q, n, g] physical shape-function gradients
    w_detJ: np.ndarray  # [C, Q] quadrature weight x |det J|
    qp_coords: np.ndarray  # [C, Q, g]

    @property
    def n_cells(self) -> int:
        return self.dN_dx.shape[0]

    @property
    def n_qp(self) -> int:
        return self.dN_dx.shape[1]


def _geometry_grad_at(cell_type: str, ref_points: np.ndarray) -> np.ndarray:
    """Analytic d(geometry basis)/dxi at reference points: [Q, nverts, rdim]."""
    x = ref_points
    Q = x.shape[0]
    one = np.ones(Q)
    if cell_type == "interval":
        return np.stack([np.stack([-one], 1), np.stack([one], 1)], axis=1)
    if cell_type == "triangle":
        d = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        return np.tile(d, (Q, 1, 1))
    if cell_type == "tetra":
        d = np.array(
            [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
        )
        return np.tile(d, (Q, 1, 1))
    if cell_type == "quad":
        u, v = x[:, 0], x[:, 1]
        # node order (0,0),(1,0),(0,1),(1,1)
        du = np.stack([-(1 - v), (1 - v), -v, v], axis=1)
        dv = np.stack([-(1 - u), -u, (1 - u), u], axis=1)
        return np.stack([du, dv], axis=2)
    if cell_type == "hex":
        u, v, w = x[:, 0], x[:, 1], x[:, 2]
        out = np.zeros((Q, 8, 3))
        for a in range(8):
            dx, dy, dz = a & 1, (a >> 1) & 1, (a >> 2) & 1
            fx, gx = (u, one) if dx else (1 - u, -one)
            fy, gy = (v, one) if dy else (1 - v, -one)
            fz, gz = (w, one) if dz else (1 - w, -one)
            out[:, a, 0] = gx * fy * fz
            out[:, a, 1] = fx * gy * fz
            out[:, a, 2] = fx * fy * gz
        return out
    msg = f"unknown cell type {cell_type}"
    raise ValueError(msg)


def precompute_geometry(
    space: FunctionSpace, q_degree: int, cells: np.ndarray | None = None
) -> Geometry:
    """Tabulate dN/dx and w |detJ| for (a subset of) the mesh's cells.

    Args:
        space: the displacement function space (its degree selects the element).
        q_degree: quadrature degree (exactness).
        cells: optional cell-index subset.
    """
    mesh = space.mesh
    elem, quad = tabulate_element(mesh.cell_type, space.degree, q_degree)
    cell_ids = np.arange(mesh.num_cells) if cells is None else np.asarray(cells)
    verts = mesh.nodes[mesh.cells[cell_ids]]  # [C, nv, g]

    geomN = _geometry_basis_at(mesh.cell_type, quad.points)  # [Q, nv]
    geom_dN = _geometry_grad_at(mesh.cell_type, quad.points)  # [Q, nv, r]

    # J[c, q, i, j] = d x_i / d xi_j
    J = np.einsum("cvi,qvj->cqij", verts, geom_dN)
    detJ = np.linalg.det(J)
    Jinv = np.linalg.inv(J)
    # dN/dx_i = dN/dxi_j * (J^-1)_{j i}
    dN_dx = np.einsum("qaj,cqji->cqai", elem.dN_dxi, Jinv)
    w_detJ = quad.weights[None, :] * np.abs(detJ)
    qp = np.einsum("qv,cvg->cqg", geomN, verts)
    return Geometry(dN_dx=dN_dx, w_detJ=w_detJ, qp_coords=qp)
