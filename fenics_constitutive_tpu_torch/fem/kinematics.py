"""Host geometry helpers (numpy, evaluated once when a geometry is built).

Only the analytic geometry-basis gradient is carried over here: the
structured engine (ops/structured.py) needs it to form the constant cell
Jacobian of a box mesh. The per-cell tabulation of the general-mesh engines
is not part of this package yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["_geometry_grad_at"]


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
