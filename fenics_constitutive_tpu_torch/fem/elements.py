"""Reference elements and quadrature rules.

The reference gets these from basix (solver/_spaces.py builds basix quadrature
elements; the "default" scheme at q_degree integrates polynomials of that degree
exactly). Here we tabulate Lagrange shape functions and Gauss rules directly;
only the *values at quadrature points* ever leave this module, as dense arrays.

Supported: P1/P2 on interval/triangle/tetra, Q1/Q2 on quad/hex.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

__all__ = ["Quadrature", "TabulatedElement", "gauss_rule", "tabulate_element"]


@dataclass(frozen=True)
class Quadrature:
    points: np.ndarray  # [Q, rdim]
    weights: np.ndarray  # [Q]


@dataclass(frozen=True)
class TabulatedElement:
    """Shape functions tabulated at quadrature points."""

    N: np.ndarray  # [Q, n]
    dN_dxi: np.ndarray  # [Q, n, rdim]
    nodes: np.ndarray  # [n, rdim] reference dof coordinates (Lagrange points)
    degree: int


def _gauss_legendre_01(npts: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(npts)
    return 0.5 * (x + 1.0), 0.5 * w


# --- simplex rules (exact to the stated degree) -----------------------------

_TRI_RULES = {
    1: (np.array([[1 / 3, 1 / 3]]), np.array([0.5])),
    2: (
        np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
        np.full(3, 1 / 6),
    ),
    3: (
        np.array(
            [[1 / 3, 1 / 3], [0.2, 0.2], [0.6, 0.2], [0.2, 0.6]]
        ),
        np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96]),
    ),
}

_A4 = 0.5854101966249685  # (5 + 3 sqrt 5)/20
_B4 = 0.1381966011250105  # (5 - sqrt 5)/20
_TET_RULES = {
    1: (np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6])),
    2: (
        np.array(
            [
                [_A4, _B4, _B4],
                [_B4, _A4, _B4],
                [_B4, _B4, _A4],
                [_B4, _B4, _B4],
            ]
        ),
        np.full(4, 1 / 24),
    ),
    3: (
        np.array(
            [
                [0.25, 0.25, 0.25],
                [0.5, 1 / 6, 1 / 6],
                [1 / 6, 0.5, 1 / 6],
                [1 / 6, 1 / 6, 0.5],
                [1 / 6, 1 / 6, 1 / 6],
            ]
        ),
        np.array([-4 / 30, 9 / 120, 9 / 120, 9 / 120, 9 / 120]),
    ),
}


def _compositions(total: int, parts: int):
    """All tuples of ``parts`` nonnegative ints summing to ``total``."""
    if parts == 1:
        yield (total,)
        return
    for head in range(total + 1):
        for rest in _compositions(total - head, parts - 1):
            yield (head, *rest)


def _grundmann_moeller(dim: int, s: int) -> tuple[np.ndarray, np.ndarray]:
    """Grundmann-Möller simplex rule of index s (degree 2s+1) on the unit
    simplex in ``dim`` dimensions.

    The arbitrary-degree analog of the basix rules the reference gets from
    `basix.make_quadrature` (reference solver/_spaces.py:19-47 accepts any
    q_degree). Classic construction (Grundmann & Möller, SIAM J. Numer. Anal.
    15, 1978): a fully symmetric embedded family with points at odd
    barycentric lattice fractions; some weights are negative, which is fine
    for quadrature of smooth integrands (basix's Xiao-Gimbutas rules differ
    in points but integrate the same polynomial space exactly, which is all
    downstream numerics depend on).
    """
    from math import factorial

    d = 2 * s + 1
    pts: list[list[float]] = []
    wts: list[float] = []
    for i in range(s + 1):
        denom = d + dim - 2 * i
        w = (
            (-1.0) ** i
            * 2.0 ** (-2 * s)
            * float(denom) ** d
            / (factorial(i) * factorial(d + dim - i))
        )
        for k in _compositions(s - i, dim + 1):
            bary = [(2 * kj + 1) / denom for kj in k]
            pts.append(bary[1:])  # reference coords x_j = bary_{j+1}
            wts.append(w)
    return np.asarray(pts, float), np.asarray(wts, float)


def _simplex_rule(table, degree, name, dim):
    for d in sorted(table):
        if d >= degree:
            return Quadrature(*table[d])
    # arbitrary degree: smallest Grundmann-Möller index with 2s+1 >= degree
    s = degree // 2
    pts, wts = _grundmann_moeller(dim, s)
    return Quadrature(pts, wts)


@lru_cache(maxsize=None)
def gauss_rule(cell_type: str, degree: int) -> Quadrature:
    """Quadrature exact for polynomials of total degree ``degree``."""
    degree = max(degree, 1)
    if cell_type == "interval":
        p, w = _gauss_legendre_01((degree + 2) // 2)
        return Quadrature(p[:, None], w)
    if cell_type in ("quad", "hex"):
        p1, w1 = _gauss_legendre_01((degree + 2) // 2)
        dim = 2 if cell_type == "quad" else 3
        grids = np.meshgrid(*([p1] * dim), indexing="ij")
        pts = np.stack([g.ravel() for g in grids], axis=1)
        wgrids = np.meshgrid(*([w1] * dim), indexing="ij")
        wts = np.prod(np.stack([g.ravel() for g in wgrids], axis=1), axis=1)
        return Quadrature(pts, wts)
    if cell_type == "triangle":
        return _simplex_rule(_TRI_RULES, degree, "triangle", 2)
    if cell_type == "tetra":
        return _simplex_rule(_TET_RULES, degree, "tetra", 3)
    msg = f"unknown cell type {cell_type}"
    raise ValueError(msg)


# --- Lagrange shape functions -----------------------------------------------


def _interval_basis(degree, pts):
    x = pts[:, 0]
    if degree == 1:
        N = np.stack([1 - x, x], axis=1)
        dN = np.tile(np.array([[-1.0], [1.0]]), (len(x), 1, 1))
        nodes = np.array([[0.0], [1.0]])
    elif degree == 2:
        N = np.stack(
            [2 * (x - 0.5) * (x - 1), 2 * x * (x - 0.5), 4 * x * (1 - x)], axis=1
        )
        dN = np.stack(
            [4 * x - 3, 4 * x - 1, 4 - 8 * x], axis=1
        )[:, :, None]
        nodes = np.array([[0.0], [1.0], [0.5]])
    else:
        raise NotImplementedError(degree)
    return N, dN, nodes


def _triangle_basis(degree, pts):
    x, y = pts[:, 0], pts[:, 1]
    lam = np.stack([1 - x - y, x, y], axis=1)  # barycentric
    if degree == 1:
        N = lam
        dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        dN = np.tile(dlam, (len(x), 1, 1))
        nodes = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    elif degree == 2:
        dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
        # vertex functions lam_i(2 lam_i - 1), edge functions 4 lam_i lam_j
        # edge (local) ordering: (1,2), (0,2), (0,1) — matching dof nodes below
        edges = [(1, 2), (0, 2), (0, 1)]
        Nv = [lam[:, i] * (2 * lam[:, i] - 1) for i in range(3)]
        Ne = [4 * lam[:, i] * lam[:, j] for i, j in edges]
        N = np.stack(Nv + Ne, axis=1)
        dNv = [
            (4 * lam[:, i] - 1)[:, None] * dlam[i] for i in range(3)
        ]
        dNe = [
            4 * (lam[:, i][:, None] * dlam[j] + lam[:, j][:, None] * dlam[i])
            for i, j in edges
        ]
        dN = np.stack(dNv + dNe, axis=1)
        verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
        nodes = np.vstack([verts] + [0.5 * (verts[i] + verts[j]) for i, j in edges])
    else:
        raise NotImplementedError(degree)
    return N, dN, nodes


def _tetra_basis(degree, pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    lam = np.stack([1 - x - y - z, x, y, z], axis=1)
    dlam = np.array(
        [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    verts = np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    )
    if degree == 1:
        N = lam
        dN = np.tile(dlam, (len(x), 1, 1))
        nodes = verts
    elif degree == 2:
        edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        Nv = [lam[:, i] * (2 * lam[:, i] - 1) for i in range(4)]
        Ne = [4 * lam[:, i] * lam[:, j] for i, j in edges]
        N = np.stack(Nv + Ne, axis=1)
        dNv = [(4 * lam[:, i] - 1)[:, None] * dlam[i] for i in range(4)]
        dNe = [
            4 * (lam[:, i][:, None] * dlam[j] + lam[:, j][:, None] * dlam[i])
            for i, j in edges
        ]
        dN = np.stack(dNv + dNe, axis=1)
        nodes = np.vstack([verts] + [0.5 * (verts[i] + verts[j]) for i, j in edges])
    else:
        raise NotImplementedError(degree)
    return N, dN, nodes


def _tensor_basis_1d(degree, t):
    """1D Lagrange values and derivatives at t for tensor-product elements."""
    if degree == 1:
        vals = np.stack([1 - t, t], axis=-1)
        ders = np.stack([-np.ones_like(t), np.ones_like(t)], axis=-1)
        pts = np.array([0.0, 1.0])
    elif degree == 2:
        vals = np.stack(
            [2 * (t - 0.5) * (t - 1), 4 * t * (1 - t), 2 * t * (t - 0.5)], axis=-1
        )
        ders = np.stack([4 * t - 3, 4 - 8 * t, 4 * t - 1], axis=-1)
        pts = np.array([0.0, 0.5, 1.0])
    else:
        raise NotImplementedError(degree)
    return vals, ders, pts


def _tensor_basis(degree, pts, dim):
    per_axis = [_tensor_basis_1d(degree, pts[:, d]) for d in range(dim)]
    nb = per_axis[0][0].shape[-1]
    # node index = i0 + nb*i1 + nb^2*i2 (x fastest), matching mesh.py hex
    # ordering; built with an explicit loop to keep ordering obvious
    n_nodes = nb**dim
    Q = pts.shape[0]
    N = np.ones((Q, n_nodes))
    dN = np.zeros((Q, n_nodes, dim))
    nodes = np.zeros((n_nodes, dim))
    for a in range(n_nodes):
        rem = a
        locs = []
        for d in range(dim):
            locs.append(rem % nb)
            rem //= nb
        for d in range(dim):
            vals, ders, p1 = per_axis[d]
            N[:, a] *= vals[:, locs[d]]
            nodes[a, d] = p1[locs[d]]
        for d in range(dim):
            prod = np.ones(Q)
            for e in range(dim):
                vals, ders, _ = per_axis[e]
                prod *= ders[:, locs[e]] if e == d else vals[:, locs[e]]
            dN[:, a, d] = prod
    return N, dN, nodes


@lru_cache(maxsize=None)
def _tabulate_cached(cell_type: str, degree: int, q_degree: int):
    quad = gauss_rule(cell_type, q_degree)
    pts = quad.points
    if cell_type == "interval":
        N, dN, nodes = _interval_basis(degree, pts)
    elif cell_type == "triangle":
        N, dN, nodes = _triangle_basis(degree, pts)
    elif cell_type == "tetra":
        N, dN, nodes = _tetra_basis(degree, pts)
    elif cell_type == "quad":
        N, dN, nodes = _tensor_basis(degree, pts, 2)
    elif cell_type == "hex":
        N, dN, nodes = _tensor_basis(degree, pts, 3)
    else:
        msg = f"unknown cell type {cell_type}"
        raise ValueError(msg)
    return TabulatedElement(N, dN, nodes, degree), quad


def tabulate_element(
    cell_type: str, degree: int, q_degree: int
) -> tuple[TabulatedElement, Quadrature]:
    """Tabulated Lagrange element + quadrature rule for a cell type."""
    return _tabulate_cached(cell_type, degree, q_degree)
