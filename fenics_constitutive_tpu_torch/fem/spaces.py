"""Vector Lagrange function spaces with array dofmaps.

The reference uses dolfinx function spaces (`df.fem.functionspace(mesh,
("CG", 1, (3,)))`) plus basix quadrature elements for QP data
(solver/_spaces.py:19-47). Here a space is just:

  * ``dof_coords``  [n_dof_nodes, g] — physical coordinates of the Lagrange
    nodes (used for geometric BC location, like df.fem.locate_dofs_geometrical),
  * ``cell_dof_nodes``  [C, n] — per-cell global dof-node ids,
  * ``dofmap``  [C, n, vs] — per-cell global *dof* ids with the node-major
    layout ``dof = node * value_size + component``.

Quadrature "spaces" need no object at all: QP data is stored as [C, Q, ...]
arrays whose flattened layout matches the reference's flat per-QP vectors.

Dof-node identification (shared edge/face dofs for P2) is done by coordinate
dedup — exact for the affine structured meshes this layer generates, and it
keeps the implementation free of explicit edge/face topology.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .elements import tabulate_element
from .mesh import Mesh

__all__ = ["FunctionSpace"]


def _geometry_basis_at(cell_type: str, ref_points: np.ndarray) -> np.ndarray:
    """P1/Q1 geometry shape functions evaluated at reference points [P, nverts]."""
    x = ref_points
    if cell_type == "interval":
        return np.stack([1 - x[:, 0], x[:, 0]], axis=1)
    if cell_type == "triangle":
        return np.stack([1 - x[:, 0] - x[:, 1], x[:, 0], x[:, 1]], axis=1)
    if cell_type == "tetra":
        return np.stack(
            [1 - x.sum(axis=1), x[:, 0], x[:, 1], x[:, 2]], axis=1
        )
    if cell_type == "quad":
        u, v = x[:, 0], x[:, 1]
        return np.stack(
            [(1 - u) * (1 - v), u * (1 - v), (1 - u) * v, u * v], axis=1
        )
    if cell_type == "hex":
        u, v, w = x[:, 0], x[:, 1], x[:, 2]
        out = []
        for dz in (0, 1):
            for dy in (0, 1):
                for dx in (0, 1):
                    fx = u if dx else 1 - u
                    fy = v if dy else 1 - v
                    fz = w if dz else 1 - w
                    out.append(fx * fy * fz)
        # reorder to x-fastest index = dx + 2 dy + 4 dz
        arr = np.stack(out, axis=1)
        order = [dx + 2 * dy + 4 * dz for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
        inv = np.argsort(order)
        return arr[:, inv]
    msg = f"unknown cell type {cell_type}"
    raise ValueError(msg)


@dataclass(frozen=True)
class FunctionSpace:
    mesh: Mesh
    degree: int
    value_size: int
    dof_coords: np.ndarray = field(init=False)  # [n_dof_nodes, g]
    cell_dof_nodes: np.ndarray = field(init=False)  # [C, n]

    def __post_init__(self):
        if self.degree == 1:
            # P1/Q1: dof nodes ARE the mesh nodes, keeping mesh numbering —
            # this is what lets the structured stencil path reshape the dof
            # vector straight into the node grid (ops/structured.py).
            object.__setattr__(self, "dof_coords", self.mesh.nodes)
            object.__setattr__(
                self, "cell_dof_nodes", self.mesh.cells.astype(np.int32)
            )
            return
        elem, _ = tabulate_element(self.mesh.cell_type, self.degree, self.degree)
        geom_N = _geometry_basis_at(self.mesh.cell_type, elem.nodes)  # [n, nverts]
        # physical positions of every element-local dof node
        verts = self.mesh.nodes[self.mesh.cells]  # [C, nverts, g]
        local_coords = np.einsum("nv,cvg->cng", geom_N, verts)  # [C, n, g]
        flat = local_coords.reshape(-1, self.mesh.gdim)
        key = np.round(flat / 1e-10).astype(np.int64)
        _, first_idx, inverse = np.unique(
            key, axis=0, return_index=True, return_inverse=True
        )
        # renumber so dof-node ids are in first-appearance order (deterministic)
        order = np.argsort(first_idx)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        node_ids = rank[inverse].reshape(local_coords.shape[:2])
        coords = np.zeros((len(first_idx), self.mesh.gdim))
        coords[node_ids.reshape(-1)] = flat

        # box-structured tensor meshes: renumber dof nodes lattice-row-major
        # (x slowest, last axis fastest — the mesh.py node convention). The
        # degree-2 dof nodes then form exactly the node lattice of the
        # degree-times-refined grid, so the lattice stencil engine can
        # reshape the dof vector straight into the grid (no gathers) and the
        # P1-lattice multigrid applies with an identity permutation.
        if self.mesh.structured_shape is not None and self.mesh.cell_type in (
            "quad",
            "hex",
        ):
            k = np.round(coords / 1e-10).astype(np.int64)
            # np.lexsort: LAST key is primary -> x primary, last axis fastest
            lex = np.lexsort(tuple(k[:, d] for d in reversed(range(k.shape[1]))))
            rank2 = np.empty(len(lex), dtype=node_ids.dtype)
            rank2[lex] = np.arange(len(lex))
            coords = coords[lex]
            node_ids = rank2[node_ids]

        object.__setattr__(self, "dof_coords", coords)
        object.__setattr__(self, "cell_dof_nodes", node_ids.astype(np.int32))

    @property
    def n_dof_nodes(self) -> int:
        return self.dof_coords.shape[0]

    @property
    def ndofs(self) -> int:
        return self.n_dof_nodes * self.value_size

    @property
    def dofs_per_cell(self) -> int:
        return self.cell_dof_nodes.shape[1] * self.value_size

    @property
    def dofmap(self) -> np.ndarray:
        """[C, n, vs] global dof ids, node-major (dof = node*vs + comp)."""
        vs = self.value_size
        return (self.cell_dof_nodes[:, :, None] * vs + np.arange(vs)).astype(np.int32)

    def locate_dofs_geometrical(
        self, predicate, component: int | None = None
    ) -> np.ndarray:
        """Global dof ids whose node satisfies ``predicate(coords[N, g]) -> bool[N]``.

        Analog of df.fem.locate_dofs_geometrical; ``component`` restricts to one
        displacement component (the V.sub(i) pattern in the reference tests).
        """
        mask = np.asarray(predicate(self.dof_coords))
        nodes = np.nonzero(mask)[0]
        vs = self.value_size
        if component is None:
            return (nodes[:, None] * vs + np.arange(vs)).reshape(-1).astype(np.int32)
        return (nodes * vs + component).astype(np.int32)
