"""Boundary facets and Neumann (traction) load assembly (host numpy).

A Neumann load enters the step as an assembled external-force vector:
``PackedSimulation(..., f_ext=assemble_facet_traction(V, facets, t))``, or a
later assignment to ``sim.f_ext``. The same functions as
``fenics_constitutive_tpu.fem.facets``, carried over because that package
imports JAX when it is imported.
"""

from __future__ import annotations

import numpy as np

from .elements import tabulate_element
from .kinematics import _geometry_grad_at
from .mesh import Mesh
from .spaces import FunctionSpace, _geometry_basis_at

__all__ = ["locate_boundary_facets", "assemble_facet_traction"]

# facet-local vertex indices per cell type (consistent with mesh.py orderings)
_FACETS = {
    "interval": [(0,), (1,)],
    "triangle": [(0, 1), (1, 2), (2, 0)],
    "quad": [(0, 1), (1, 3), (3, 2), (2, 0)],  # tensor order (0,0),(1,0),(0,1),(1,1)
    "tetra": [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)],
    "hex": [
        (0, 2, 4, 6),  # x = 0 plane (tensor idx: dx=0)
        (1, 3, 5, 7),  # x = 1
        (0, 1, 4, 5),  # y = 0
        (2, 3, 6, 7),  # y = 1
        (0, 1, 2, 3),  # z = 0
        (4, 5, 6, 7),  # z = 1
    ],
}

_FACET_CELL_TYPE = {
    "interval": "point",
    "triangle": "interval",
    "quad": "interval",
    "tetra": "triangle",
    "hex": "quad",
}


def _all_facets(mesh: Mesh) -> np.ndarray:
    """[n_cells * n_facets_per_cell, m] global node ids of every cell facet."""
    local = np.asarray(_FACETS[mesh.cell_type])
    return mesh.cells[:, local].reshape(-1, local.shape[1])


def locate_boundary_facets(mesh: Mesh, predicate) -> np.ndarray:
    """Boundary facets (appearing in exactly one cell) whose nodes all satisfy
    ``predicate(coords[N, g]) -> bool[N]``. Returns [F, m] node ids.

    Analog of df.mesh.locate_entities_boundary (reference test usage)."""
    facets = _all_facets(mesh)
    key = np.sort(facets, axis=1)
    _, inv, counts = np.unique(
        key, axis=0, return_inverse=True, return_counts=True
    )
    boundary = facets[counts[inv] == 1]
    node_ok = np.asarray(predicate(mesh.nodes))
    mask = node_ok[boundary].all(axis=1)
    return boundary[mask]


def assemble_facet_traction(
    space: FunctionSpace, facets: np.ndarray, traction
) -> np.ndarray:
    """Equivalent nodal forces of ``integral(traction . v) dA`` over facets.

    Args:
        space: displacement space (degree 1 or 2).
        facets: [F, m] facet vertex node ids from locate_boundary_facets.
        traction: per-component load vector of length value_size (constant
            over the facet set, like the reference's df.fem.Constant load).

    Returns:
        numpy [ndofs] force vector (add to ``problem.f_ext``).
    """
    mesh = space.mesh
    vs = space.value_size
    t = np.broadcast_to(np.asarray(traction, float), (vs,))
    f = np.zeros(space.ndofs)

    fct = _FACET_CELL_TYPE[mesh.cell_type]
    if fct == "point":
        # 0D facet: point load at the node
        nodes = _coords_to_nodes(space, mesh.nodes[facets[:, 0]])
        f2 = f.reshape(-1, vs)
        np.add.at(f2, nodes, np.broadcast_to(t, (len(nodes), vs)))
        return f

    elem, quad = tabulate_element(fct, space.degree, 2 * space.degree)
    # facet geometry gradient (P1 on the facet reference cell)
    geom_dN = _geometry_grad_at(fct, quad.points)  # [Q, mverts, rdim]

    verts = mesh.nodes[facets]  # [F, m, g]
    J = np.einsum("fvi,qvj->fqij", verts, geom_dN)  # [F, Q, g, rdim]
    if J.shape[-2] == J.shape[-1] + 1:
        if J.shape[-1] == 1:  # curve in 2D
            dA = np.linalg.norm(J[..., 0], axis=-1)
        else:  # surface in 3D
            cr = np.cross(J[..., 0], J[..., 1])
            dA = np.linalg.norm(cr, axis=-1)
    else:
        dA = np.abs(np.linalg.det(J))

    # integral of each facet shape function: [F, n_facet_dofs]
    intN = np.einsum("q,fq,qa->fa", quad.weights, dA, elem.N)

    # physical positions of the facet element's dof nodes -> global dof nodes,
    # resolved in one vectorized sorted-key lookup (a per-dof Python dict walk
    # here becomes an O(F*n) host stall at production scale — the same class
    # of loop the reference has in maps.py:156-160)
    dof_pos = np.einsum("nv,fvg->fng", _geometry_basis_at(fct, elem.nodes), verts)
    nodes = _coords_to_nodes(space, dof_pos.reshape(-1, mesh.gdim))
    w = intN.reshape(-1)
    f2 = f.reshape(-1, vs)
    np.add.at(f2, nodes, w[:, None] * t)
    return f


def _coords_to_nodes(space: FunctionSpace, coords: np.ndarray) -> np.ndarray:
    """Vectorized physical-coordinate -> dof-node-index lookup (exact, via
    quantized integer keys and a sorted search)."""

    def keys(a):
        k = np.round(np.asarray(a, float) / 1e-10).astype(np.int64)
        k = np.ascontiguousarray(k)
        return k.view([("", k.dtype)] * k.shape[1]).ravel()

    space_keys = keys(space.dof_coords)
    query = keys(coords)
    order = np.argsort(space_keys)
    pos = np.searchsorted(space_keys, query, sorter=order)
    idx = order[np.clip(pos, 0, len(order) - 1)]
    if not (space_keys[idx] == query).all():
        msg = "facet dof position not found among space dof coordinates"
        raise ValueError(msg)
    return idx
