"""Dirichlet boundary conditions.

Analog of df.fem.dirichletbc + df.fem.Constant: a BC owns a set of global dof
ids and a (mutable) value, so the reference's load-stepping pattern
``displacement.value = 0.02; solver.solve(u)`` carries over directly
(tests/models/test_elasticity.py:41-79).

The incremental semantics match dolfinx's lifting-on-the-increment: the solver
sets ``u[dofs] = value`` before each Newton solve and constrains the Newton
correction to zero there, so the second load step only solves for the delta
(SURVEY §7 'Dirichlet BC semantics in an incremental problem').
"""

from __future__ import annotations

import numpy as np

__all__ = ["DirichletBC"]


class DirichletBC:
    """Fixes ``u[dofs] = value``.

    Args:
        dofs: global dof indices (from FunctionSpace.locate_dofs_geometrical).
        value: scalar (broadcast over dofs), per-component array of length
            value_size (broadcast over nodes when dofs covers whole nodes in
            node-major order), or per-dof array of len(dofs).
    """

    def __init__(self, dofs: np.ndarray, value, value_size: int | None = None):
        self.dofs = np.asarray(dofs, np.int32)
        self.value = value
        self._value_size = value_size

    def dof_values(self) -> np.ndarray:
        v = np.asarray(self.value, dtype=np.float64)
        n = len(self.dofs)
        if v.ndim == 0:
            return np.full(n, float(v))
        if v.size == n:
            return v.reshape(-1)
        # per-component vector: dofs are node-major, so tile
        if n % v.size == 0:
            return np.tile(v.reshape(-1), n // v.size)
        msg = f"BC value of size {v.size} incompatible with {n} dofs"
        raise ValueError(msg)


def combine_bcs(bcs) -> tuple[np.ndarray, np.ndarray]:
    """Stack BCs into (dofs, values); later BCs win on overlap (like dolfinx,
    where the last-applied bc overwrites shared dofs)."""
    if not bcs:
        return np.zeros(0, np.int32), np.zeros(0)
    dofs = np.concatenate([bc.dofs for bc in bcs])
    vals = np.concatenate([bc.dof_values() for bc in bcs])
    # dedupe keeping the LAST occurrence
    _, last_idx = np.unique(dofs[::-1], return_index=True)
    keep = len(dofs) - 1 - last_idx
    keep.sort()
    return dofs[keep].astype(np.int32), vals[keep]
