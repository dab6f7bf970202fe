"""Plain PyTorch finite elements for the reference: shape-function
gradients at the quadrature points, the small-strain increment in Mandel
notation, and the assembled internal force.

Written from the element definitions alone (it imports nothing of the
program). Hexahedra: trilinear shape functions, the 2 x 2 x 2 Gauss rule
(point ``4 i + 2 j + k`` at ``(g_i, g_j, g_k)``, ``g = (1 -+ 1/sqrt 3) / 2``,
weight 1/8), corner ``dx + 2 dy + 4 dz``. Tetrahedra: linear shape
functions, whose gradient is constant in a cell, so one point of weight 1/6
stands for any rule (the program's four points of a cell all carry the
cell's one strain). 27-node hexahedra (``hex27``): triquadratic shape
functions, the tensor products of the 1D quadratic basis on the nodes 0,
1/2, 1 (local node ``dx + 3 dy + 9 dz`` at ``(dx, dy, dz) / 2``), and the
3 x 3 x 3 Gauss rule: point ``9 i + 3 j + k`` at ``(g_i, g_j, g_k)``, ``g =
(1 - sqrt(3/5), 1, 1 + sqrt(3/5)) / 2``, weight ``v_i v_j v_k`` with ``v =
(5, 8, 5) / 18`` (the program's order of the points at q_degree 4: x
slowest). Mandel order: xx, yy, zz, sqrt2 xy, sqrt2 xz, sqrt2 yz.

The force sums each dof's cell contributions one after the other, in the
order of the cells (a segment sum over the contributions sorted by dof), on
any device: the reference gives the same bits in every run, where an
``index_add_`` on the card adds with atomics in no fixed order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SQRT2 = math.sqrt(2.0)
SHEAR = ((0, 1), (0, 2), (1, 2))


def _hex_reference():
    g = np.array([0.5 - 0.5 / math.sqrt(3.0), 0.5 + 0.5 / math.sqrt(3.0)])
    pts = np.array([(g[i], g[j], g[k]) for i in (0, 1) for j in (0, 1) for k in (0, 1)])
    dN = np.zeros((8, 8, 3))
    for a in range(8):
        loc = (a % 2, (a // 2) % 2, a // 4)
        for q, p in enumerate(pts):
            val = [p[d] if loc[d] else 1.0 - p[d] for d in range(3)]
            der = [1.0 if loc[d] else -1.0 for d in range(3)]
            for d in range(3):
                dN[q, a, d] = der[d] * np.prod([val[e] for e in range(3) if e != d])
    return dN, np.full(8, 1.0 / 8.0)


def _tet_reference():
    dN = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    return dN[None], np.array([1.0 / 6.0])


def _hex27_reference():
    r = math.sqrt(3.0 / 5.0)
    g, v = np.array([0.5 - 0.5 * r, 0.5, 0.5 + 0.5 * r]), np.array([5.0, 8.0, 5.0]) / 18.0

    def basis(t):
        """The 1D quadratic Lagrange values and derivatives on 0, 1/2, 1 at t."""
        return ((2.0 * (t - 0.5) * (t - 1.0), 4.0 * t * (1.0 - t), 2.0 * t * (t - 0.5)),
                (4.0 * t - 3.0, 4.0 - 8.0 * t, 4.0 * t - 1.0))

    L, dL = (np.array(t) for t in basis(g))  # [node, point] in 1D
    pts = [(i, j, k) for i in range(3) for j in range(3) for k in range(3)]
    dN = np.zeros((27, 27, 3))
    for a in range(27):
        loc = (a % 3, (a // 3) % 3, a // 9)
        for q, p in enumerate(pts):
            val = [L[loc[d], p[d]] for d in range(3)]
            der = [dL[loc[d], p[d]] for d in range(3)]
            for d in range(3):
                dN[q, a, d] = der[d] * np.prod([val[e] for e in range(3) if e != d])
    return dN, np.array([v[i] * v[j] * v[k] for i, j, k in pts])


REFERENCE_CELLS = {"hex": _hex_reference, "tetra": _tet_reference, "hex27": _hex27_reference}


class Geometry:
    """Per cell and point: the physical shape-function gradients ``dNdx``
    [C, Q, k, 3] and the weights ``w`` [C, Q] (rule weight x |det J|)."""

    def __init__(self, nodes: np.ndarray, cells: np.ndarray, cell_type: str, device,
                 dtype=torch.float64):
        dN_ref, wq = REFERENCE_CELLS[cell_type]()
        x = torch.as_tensor(nodes, dtype=dtype, device=device)
        self.cells = torch.as_tensor(cells, dtype=torch.int64, device=device)
        self.n_nodes = len(nodes)
        dN_ref = torch.as_tensor(dN_ref, dtype=dtype, device=device)  # [Q, k, 3]
        xc = x[self.cells]  # [C, k, 3]
        # J[c, q, i, j] = sum_a x[c, a, i] dN_ref[q, a, j]
        J = torch.einsum("cai,qaj->cqij", xc, dN_ref)
        Jinv = torch.linalg.inv(J)
        # dN/dx[c, q, a, j] = sum_i dN_ref[q, a, i] Jinv[c, q, i, j]
        self.dNdx = torch.einsum("qai,cqij->cqaj", dN_ref, Jinv)
        self.w = torch.as_tensor(wq, dtype=dtype, device=device) * torch.linalg.det(J).abs()
        self.Q = dN_ref.shape[0]
        # the force's segment sum: contribution j of the flat [C, k, 3] force
        # goes to slot (dof, rank among the dof's contributions in cell order)
        # of a [3 n_nodes, width] table, whose columns are then added in turn
        dofs = (3 * self.cells[:, :, None] + torch.arange(3, device=device)).reshape(-1)
        order = torch.argsort(dofs, stable=True)
        counts = torch.bincount(dofs, minlength=3 * self.n_nodes)
        first = torch.cumsum(counts, 0) - counts
        rank = torch.empty_like(dofs)
        rank[order] = torch.arange(len(dofs), device=device) - first[dofs[order]]
        self._width = int(counts.max())
        self._slot = dofs * self._width + rank

    def strain(self, u: torch.Tensor) -> torch.Tensor:
        """Mandel strain [C, Q, 6] of a node-major displacement [3 n_nodes]."""
        ue = u.reshape(self.n_nodes, 3)[self.cells]  # [C, k, 3]
        grad = torch.einsum("cai,cqaj->cqij", ue, self.dNdx)
        comps = [grad[..., 0, 0], grad[..., 1, 1], grad[..., 2, 2]]
        comps += [(grad[..., i, j] + grad[..., j, i]) / SQRT2 for i, j in SHEAR]
        return torch.stack(comps, dim=-1)

    def internal_force(self, stress: torch.Tensor) -> torch.Tensor:
        """The assembled node-major internal force [3 n_nodes] of a Mandel
        stress [C, Q, 6]: sum over cells and points of w sigma . grad N."""
        s = stress
        sig = torch.stack([
            torch.stack([s[..., 0], s[..., 3] / SQRT2, s[..., 4] / SQRT2], dim=-1),
            torch.stack([s[..., 3] / SQRT2, s[..., 1], s[..., 5] / SQRT2], dim=-1),
            torch.stack([s[..., 4] / SQRT2, s[..., 5] / SQRT2, s[..., 2]], dim=-1),
        ], dim=-2)  # [C, Q, 3, 3]
        fe = torch.einsum("cq,cqij,cqaj->cai", self.w, sig, self.dNdx)  # [C, k, 3]
        table = torch.zeros(3 * self.n_nodes * self._width, dtype=fe.dtype, device=fe.device)
        table[self._slot] = fe.reshape(-1)
        table = table.reshape(3 * self.n_nodes, self._width)
        out = torch.zeros(3 * self.n_nodes, dtype=fe.dtype, device=fe.device)
        for j in range(self._width):
            out += table[:, j]
        return out
