"""The n^3 unit cube of hexahedra, as the port builds it with ``unit_cube_mesh``.

The benchmark makes the nodes and cells itself (the reference's input) and
the program builds its own mesh in its set-up, as a user does; the run holds
the two equal.

Node ``(ix, iy, iz)`` has the id ``(ix (n+1) + iy)(n+1) + iz`` and sits at
``(ix, iy, iz) / n``; cells run over ``ix``, then ``iy``, then ``iz``, and a
cell's corner ``dx + 2 dy + 4 dz`` is node ``(ix+dx, iy+dy, iz+dz)``.
"""

from __future__ import annotations

import numpy as np

CELL_TYPE = "hex"


def grid_nodes(n: int) -> np.ndarray:
    axis = np.linspace(0.0, 1.0, n + 1)
    grids = np.meshgrid(axis, axis, axis, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


def inputs(spec: dict) -> dict:
    n = int(spec["n"])
    ix, iy, iz = (a.ravel() for a in np.meshgrid(*([np.arange(n)] * 3), indexing="ij"))
    corners = [((ix + dx) * (n + 1) + iy + dy) * (n + 1) + iz + dz
               for dz in (0, 1) for dy in (0, 1) for dx in (0, 1)]
    return {"nodes": grid_nodes(n), "cells": np.stack(corners, axis=1).astype(np.int64),
            "cell_type": CELL_TYPE}


def prepare(inp: dict, spec: dict, workdir) -> None:
    """Nothing to write: users build this mesh in their own script."""


def program_mesh(inp: dict, spec: dict, workdir):
    from fenics_constitutive_tpu_torch.fem import unit_cube_mesh

    n = int(spec["n"])
    return unit_cube_mesh(n, n, n, CELL_TYPE)
