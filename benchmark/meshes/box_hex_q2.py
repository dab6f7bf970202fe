"""The n^3 unit cube of 27-node (Q2) hexahedra: the reference's own mesh of
the lattice that a degree-2 space on ``unit_cube_mesh(n, n, n, "hex")``
holds its dofs on.

The benchmark makes the nodes and cells itself (the reference's input); the
program builds the P1 box in its set-up, as a user does, and puts a
degree-2 space on it. The program numbers its dof nodes its own way, so the
comparison matches them to these nodes by coordinate.

Node ``(i, j, k)`` of the (2n+1)^3 lattice has the id ``(i (2n+1) + j)(2n+1)
+ k`` and sits at ``(i, j, k) / (2n)``. Cells run over ``ix``, then ``iy``,
then ``iz`` (``iz`` fastest), as the P1 box's do; a cell's local node ``dx + 3
dy + 9 dz`` (each of dx, dy, dz in 0, 1, 2) is lattice node ``(2 ix + dx, 2
iy + dy, 2 iz + dz)``: the corners, edge midpoints, face centres and the
centre of the cell in one tensor order.
"""

from __future__ import annotations

import numpy as np

CELL_TYPE = "hex27"
DEGREE = 2


def inputs(spec: dict) -> dict:
    n = int(spec["n"])
    m = DEGREE * n + 1
    axis = np.linspace(0.0, 1.0, m)
    nodes = np.stack([g.ravel() for g in np.meshgrid(axis, axis, axis, indexing="ij")], axis=1)
    ix, iy, iz = (DEGREE * a.ravel()
                  for a in np.meshgrid(*([np.arange(n)] * 3), indexing="ij"))
    local = [((ix + dx) * m + iy + dy) * m + iz + dz
             for dz in range(3) for dy in range(3) for dx in range(3)]
    return {"nodes": nodes, "cells": np.stack(local, axis=1).astype(np.int64),
            "cell_type": CELL_TYPE, "spacing": 1.0 / (DEGREE * n)}


def prepare(inp: dict, spec: dict, workdir) -> None:
    """Nothing to write: users build this mesh in their own script."""


def program_mesh(inp: dict, spec: dict, workdir):
    from fenics_constitutive_tpu_torch.fem import unit_cube_mesh

    n = int(spec["n"])
    return unit_cube_mesh(n, n, n, "hex")
