"""An imported tet mesh: the n^3 Kuhn tet box (6 tets a cube) with its node
numbering shuffled, written as an ASCII Gmsh v2.2 file before the set-up
clock starts (users hold their mesh file already) and read by the program
with ``read_gmsh``.

Cubes run over ``ix``, then ``iy``, then ``iz``; each holds the 6 tets of
the monotone vertex paths along the axis orders (0,1,2), (0,2,1), (1,0,2),
(1,2,0), (2,0,1), (2,1,0). The shuffle moves node ``k`` to ``pi[k]``, with
``pi`` the permutation of ``numpy.random.default_rng(shuffle_seed)``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .box_hex import grid_nodes

CELL_TYPE = "tetra"
PATHS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
GMSH_TETRA = 4


def inputs(spec: dict) -> dict:
    n = int(spec["n"])
    corner = np.stack([a.ravel() for a in np.meshgrid(*([np.arange(n)] * 3), indexing="ij")],
                      axis=1)
    tets = []
    for path in PATHS:
        v = corner.copy()
        verts = [v]
        for axis in path:
            v = v.copy()
            v[:, axis] += 1
            verts.append(v)
        tets.append(np.stack([(p[:, 0] * (n + 1) + p[:, 1]) * (n + 1) + p[:, 2] for p in verts],
                             axis=1))
    cells = np.stack(tets, axis=1).reshape(-1, 4)
    nodes = grid_nodes(n)
    pi = np.random.default_rng(int(spec["shuffle_seed"])).permutation(len(nodes))
    shuffled = np.empty_like(nodes)
    shuffled[pi] = nodes
    return {"nodes": shuffled, "cells": pi[cells].astype(np.int64), "cell_type": CELL_TYPE}


def mesh_file(workdir) -> Path:
    return Path(workdir) / "mesh.msh"


def prepare(inp: dict, spec: dict, workdir) -> None:
    """Write the mesh as ASCII Gmsh v2.2 (coordinates to 17 digits, so the
    read gives back the same doubles)."""
    nodes, cells = inp["nodes"], inp["cells"]
    with open(mesh_file(workdir), "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{len(nodes)}\n")
        ids = np.arange(1, len(nodes) + 1, dtype=np.float64)[:, None]
        np.savetxt(f, np.hstack([ids, nodes]), fmt=["%d", "%.17g", "%.17g", "%.17g"])
        f.write(f"$EndNodes\n$Elements\n{len(cells)}\n")
        head = np.zeros((len(cells), 5), np.int64)
        head[:, 0] = np.arange(1, len(cells) + 1)
        head[:, 1] = GMSH_TETRA
        head[:, 2] = 2
        np.savetxt(f, np.hstack([head, cells + 1]), fmt="%d")
        f.write("$EndElements\n")


def program_mesh(inp: dict, spec: dict, workdir):
    from fenics_constitutive_tpu_torch.fem import read_gmsh

    return read_gmsh(mesh_file(workdir))
