"""Minimal mesh layer: structured simplex/tensor meshes + imported connectivity.

The reference delegates meshing to dolfinx (`df.mesh.create_unit_interval/
square/cube`, e.g. tests/models/test_elasticity.py:27,241,338). Here meshes are
plain arrays — nodes [N, g] float64 and cells [C, n] int32 — so every downstream
structure (dofmaps, tabulated gradients, QP state) is a statically-shaped array
ready for jit and GSPMD sharding over the cell axis.

Connectivity is built host-side with numpy (setup cost, once); all hot-path
arrays are produced by fem.kinematics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "Mesh",
    "unit_interval_mesh",
    "unit_square_mesh",
    "unit_cube_mesh",
]


@dataclass(frozen=True)
class Mesh:
    nodes: np.ndarray  # [N, gdim] float64
    cells: np.ndarray  # [C, nodes_per_cell] int32
    cell_type: str  # interval | triangle | quad | tetra | hex
    #: cell counts per axis for box-structured tensor grids (enables the
    #: gather-free stencil fast path in ops/structured.py); None otherwise
    structured_shape: tuple | None = None
    #: material/region cell sets: tag -> cell index array. Populated by
    #: fem.io.read_gmsh from $PhysicalNames/$Elements (keys are the integer
    #: physical ids plus their names when named) — the analog of dolfinx
    #: cell tags the reference uses to define per-region laws
    #: (reference solver/_lawonsubmesh.py consumes such cell arrays).
    cell_sets: dict | None = None

    @property
    def gdim(self) -> int:
        return self.nodes.shape[1]

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_cells(self) -> int:
        return self.cells.shape[0]

    def cell_midpoints(self) -> np.ndarray:
        return self.nodes[self.cells].mean(axis=1)


def unit_interval_mesh(n: int) -> Mesh:
    """n cells on [0, 1] (analog of df.mesh.create_unit_interval)."""
    nodes = np.linspace(0.0, 1.0, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1).astype(np.int32)
    return Mesh(nodes, cells, "interval")


def _grid_nodes(*ns: int) -> np.ndarray:
    axes = [np.linspace(0.0, 1.0, n + 1) for n in ns]
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


def unit_square_mesh(nx: int, ny: int, cell_type: str = "triangle") -> Mesh:
    """nx-by-ny grid on the unit square, split into triangles or quads."""
    nodes = _grid_nodes(nx, ny)

    def nid(ix, iy):
        return ix * (ny + 1) + iy

    cells = []
    for ix in range(nx):
        for iy in range(ny):
            a, b = nid(ix, iy), nid(ix + 1, iy)
            c, d = nid(ix, iy + 1), nid(ix + 1, iy + 1)
            if cell_type == "triangle":
                cells.append([a, b, d])
                cells.append([a, d, c])
            elif cell_type == "quad":
                cells.append([a, b, c, d])  # tensor ordering: (0,0),(1,0),(0,1),(1,1)
            else:
                msg = f"unknown 2D cell type {cell_type}"
                raise ValueError(msg)
    # triangle meshes are 2-class Kuhn splits of the same grid: structured too
    structured = (nx, ny) if cell_type in ("quad", "triangle") else None
    return Mesh(nodes, np.asarray(cells, np.int32), cell_type, structured)


# Kuhn subdivision of the unit cube into 6 tetrahedra: each tet follows a
# monotone vertex path along one of the 3! axis orderings.
_KUHN_PATHS = [
    (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0),
]


def unit_cube_mesh(nx: int, ny: int, nz: int, cell_type: str = "tetra") -> Mesh:
    """nx-by-ny-by-nz grid on the unit cube, split into tets (6 per box) or hexes."""
    nodes = _grid_nodes(nx, ny, nz)

    def nid(ix, iy, iz):
        return (ix * (ny + 1) + iy) * (nz + 1) + iz

    cells = []
    for ix in range(nx):
        for iy in range(ny):
            for iz in range(nz):
                corner = np.array([ix, iy, iz])
                if cell_type == "hex":
                    # tensor ordering over (dx, dy, dz) in z-fastest bit order
                    c = [
                        nid(ix + dx, iy + dy, iz + dz)
                        for dx in (0, 1)
                        for dy in (0, 1)
                        for dz in (0, 1)
                    ]
                    # reorder to x-fastest tensor ordering consistent with
                    # elements.py: index = dx + 2*dy + 4*dz
                    tensor = [0] * 8
                    k = 0
                    for dx in (0, 1):
                        for dy in (0, 1):
                            for dz in (0, 1):
                                tensor[dx + 2 * dy + 4 * dz] = c[k]
                                k += 1
                    cells.append(tensor)
                elif cell_type == "tetra":
                    for path in _KUHN_PATHS:
                        verts = [corner.copy()]
                        v = corner.copy()
                        for axis in path:
                            v = v.copy()
                            v[axis] += 1
                            verts.append(v)
                        cells.append([nid(*vv) for vv in verts])
                else:
                    msg = f"unknown 3D cell type {cell_type}"
                    raise ValueError(msg)
    # tetra meshes are Kuhn subdivisions of the same box grid: translation-
    # invariant per class, so they get the structured fast path too
    structured = (nx, ny, nz) if cell_type in ("hex", "tetra") else None
    return Mesh(nodes, np.asarray(cells, np.int32), cell_type, structured)
