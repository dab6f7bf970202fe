"""The gather engine, and the tangent representations on SoA quadrature fields.

``PackedGeometry`` serves any mesh: small imported meshes, interval bars,
degree-2 spaces, and every law on a cell subset. QP fields are ``[k, N]``
with ``N = Q * C`` q-major (``N = q * C + c``); dof vectors are node-major
``[ndofs]``. Kinematics gather each cell's dofs through ``dofmap_t [n, vs,
C]``; assembly is a gather followed by a sum: each dof reads its element
contributions through ``gather_idx [ndofs, maxval]`` (indices into the flat
``[n, vs, C]`` element-force array, with one zero pad slot) and sums them
over the padded axis in a fixed order, so a run repeats bit for bit (no
atomics). On uniform geometry (every cell shares one Jacobian) strain and
divergence fold into the constant matrices ``KEPS_c``/``KDIV_c``, two
full-precision products per apply (``structured._matmul``).

The hot models return their consistent tangent in a factored isotropic form
(``IsotropicTangent``), so the CG operator never touches a dense [6, 6, N]
field; every other law reaches the engines through the generic
``evaluate_packed`` adapter (models/interfaces.py) with a ``DenseTangent``.
Both apply pointwise, as broadcast multiplies and sums: no product here
runs in TF32 on the card, whatever the process-wide setting.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from . import mandel
from .mandel import Constraint
from .structured import _matmul

__all__ = [
    "DenseTangent",
    "IsotropicTangent",
    "PackedGeometry",
    "build_packed_geometry",
    "packed_grad",
    "packed_jacobi_diag",
    "packed_matvec",
    "packed_residual",
    "packed_strain",
]


@dataclass(frozen=True)
class CellSlots:
    """The cell layout of a q-major QP field ``[k, Q * n_slots]``: cell c's
    QPs sit in slot ``slot_of_cell[c]`` (a windowed plan, with padded
    slots), or in slot c when ``slot_of_cell`` is None (the gather engine)."""

    n_qp: int
    n_slots: int
    slot_of_cell: torch.Tensor | None = None

    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        """QP field [k, Q * n_slots] -> [k, Q, n_cells] in cell order."""
        f = field.reshape(field.shape[0], self.n_qp, self.n_slots)
        return f if self.slot_of_cell is None else f[:, :, self.slot_of_cell]

    def insert_cells(self, dense: torch.Tensor, dtype=None) -> torch.Tensor:
        """[k, Q, n_cells] in cell order -> the QP field [k, Q * n_slots] (of
        ``dtype``, default the field's; zero on padded slots)."""
        k = dense.shape[0]
        if self.slot_of_cell is None:
            return dense.reshape(k, -1).to(dtype or dense.dtype)
        out = dense.new_zeros((k, self.n_qp, self.n_slots), dtype=dtype)
        out[:, :, self.slot_of_cell] = dense.to(out.dtype)
        return out.reshape(k, -1)


class PackedGeometry(nn.Module):
    """SoA tabulated geometry of one law's cells on the gather engine.

    Buffers: ``dN`` [n, g, Q] when ``uniform`` else [n, g, N]; ``w`` [N]
    (quadrature weight x |detJ|); ``dofmap_t`` [n, vs, C] global dof ids;
    ``gather_idx`` [ndofs, maxval] (see ``_gather_plan``); ``KEPS_c`` [s*Q,
    n*vs] and ``KDIV_c`` [n*vs, s*Q] on uniform geometry, else None;
    ``mandel_T`` [s, g, g] (the Mandel map of ``ops/mandel.py``).
    """

    #: the engine this geometry serves (``PackedSimulation.engine``)
    engine = "gather"

    dN: torch.Tensor
    w: torch.Tensor
    dofmap_t: torch.Tensor
    gather_idx: torch.Tensor
    KEPS_c: torch.Tensor | None
    KDIV_c: torch.Tensor | None
    mandel_T: torch.Tensor

    def __init__(self, *, dN, w, dofmap_t, gather_idx, KEPS_c, KDIV_c, uniform: bool,
                 n_cells: int, n_qp: int, n_nodes: int, vs: int, ndofs: int,
                 constraint: Constraint):
        super().__init__()
        self.register_buffer("dN", dN)
        self.register_buffer("w", w)
        self.register_buffer("dofmap_t", dofmap_t)
        self.register_buffer("gather_idx", gather_idx)
        self.register_buffer("KEPS_c", KEPS_c)
        self.register_buffer("KDIV_c", KDIV_c)
        T = mandel._mandel_matrix_map(constraint)
        self.register_buffer("mandel_T", torch.as_tensor(T, dtype=w.dtype, device=w.device))
        self.uniform = uniform
        self.n_cells, self.n_qp, self.n_nodes = n_cells, n_qp, n_nodes
        self.vs, self.ndofs, self.constraint = vs, ndofs, constraint
        #: host seconds of the build: geometry (tabulation), gather_idx, upload
        self.build_seconds: dict[str, float] = {}

    @property
    def N(self) -> int:
        return self.n_qp * self.n_cells

    @property
    def sdim(self) -> int:
        return self.constraint.stress_strain_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.w.dtype

    @property
    def device(self) -> torch.device:
        return self.w.device

    def qp_shape(self, k: int) -> tuple:
        return (k, self.N)

    def grad(self, u: torch.Tensor) -> torch.Tensor:
        return packed_grad(u, self)

    def _gather_flat(self, u: torch.Tensor) -> torch.Tensor:
        """u [ndofs] -> element dof blocks [n*vs, C]."""
        return u[self.dofmap_t].reshape(self.n_nodes * self.vs, self.n_cells)

    def strain(self, u: torch.Tensor) -> torch.Tensor:
        """Node-major [ndofs] -> Mandel strain [s, N]."""
        if self.KEPS_c is not None:
            e = _matmul(self.KEPS_c.to(u.dtype), self._gather_flat(u))
            return e.reshape(self.sdim, self.N)
        return packed_strain(packed_grad(u, self), self.mandel_T.to(u.dtype))

    def residual(self, sigma: torch.Tensor) -> torch.Tensor:
        """Mandel stress [s, N] -> node-major assembled force [ndofs]."""
        return packed_residual(sigma, self)

    def matvec(self, v: torch.Tensor, tangent) -> torch.Tensor:
        return packed_matvec(v, tangent, self)

    def jacobi_diag(self, tangent) -> torch.Tensor:
        """diag(A) [ndofs] via the per-QP quadratic form B^T C B."""
        return packed_jacobi_diag(tangent, self)

    # -- observation -----------------------------------------------------------

    @property
    def slots(self) -> CellSlots:
        """The QP fields' cell layout: cell c in slot c."""
        return CellSlots(self.n_qp, self.n_cells)

    def extract_cells(self, field: torch.Tensor) -> torch.Tensor:
        """QP field [k, N] -> [k, Q, n_cells] in the law's cell order."""
        return self.slots.extract_cells(field)

    def insert_cells(self, dense: torch.Tensor, dtype=None) -> torch.Tensor:
        """[k, Q, n_cells] in the law's cell order -> the QP field [k, N]."""
        return self.slots.insert_cells(dense, dtype)


def _map_fields(tangent, N: int, fn):
    """The tangent with ``fn`` applied to every field of QP length N (scalar
    and broadcast entries stay as they are)."""
    def one(x):
        return fn(x) if isinstance(x, torch.Tensor) and x.dim() and x.shape[-1] == N else x

    return dataclasses.replace(
        tangent, **{f.name: one(getattr(tangent, f.name)) for f in dataclasses.fields(tangent)}
    )


def _gather_plan(dofmap_t: np.ndarray, ndofs: int) -> np.ndarray:
    """Assembly plan of the flat element-force layout ``[n, vs, C]``:
    row d lists, in ascending slot order, the slots that hold dof d, padded
    with the one-past-the-end slot (a zero). int64 [ndofs, maxval]; the
    JAX package builds the same array with a loop over the dofs."""
    flat_dofs = np.asarray(dofmap_t).reshape(-1)
    order = np.argsort(flat_dofs, kind="stable")
    counts = np.bincount(flat_dofs, minlength=ndofs)
    maxval = int(counts.max()) if len(counts) else 0
    starts = np.cumsum(counts) - counts
    sorted_dofs = flat_dofs[order]
    pos = np.arange(len(order)) - starts[sorted_dofs]
    plan = np.full((ndofs, maxval), len(flat_dofs), np.int64)
    plan[sorted_dofs, pos] = order
    return plan


def build_packed_geometry(
    space, q_degree: int, constraint: Constraint, cells: np.ndarray | None = None, *,
    device="cuda", dtype: torch.dtype,
) -> PackedGeometry:
    """Tabulate the gather engine's geometry (host-side, once per mesh or
    law) for any mesh and element degree; ``cells``: the law's cells
    (default every cell), in the order its QP fields follow."""
    from ..fem.elements import tabulate_element
    from ..fem.kinematics import _geometry_grad_at

    t0 = time.perf_counter()
    mesh = space.mesh
    elem, quad = tabulate_element(mesh.cell_type, space.degree, q_degree)
    cell_ids = np.arange(mesh.num_cells) if cells is None else np.asarray(cells, np.int64)
    C = len(cell_ids)
    Q = quad.points.shape[0]
    verts = mesh.nodes[mesh.cells[cell_ids]]

    geom_dN = _geometry_grad_at(mesh.cell_type, quad.points)  # [Q, nv, r]
    J = np.einsum("cvi,qvj->cqij", verts, geom_dN)
    detJ = np.abs(np.linalg.det(J))
    Jinv = np.linalg.inv(J)
    dN_dx = np.einsum("qaj,cqji->cqai", elem.dN_dxi, Jinv)  # [C, Q, n, g]
    w = quad.weights[None, :] * detJ  # [C, Q]

    uniform = bool(
        np.allclose(dN_dx, dN_dx[0:1], rtol=0, atol=1e-12)
        and np.allclose(detJ, detJ.flat[0], rtol=1e-12)
    )
    n, g = dN_dx.shape[2], dN_dx.shape[3]
    vs = space.value_size
    # q-major flat ordering: N index = q * C + c
    if uniform:
        dN = dN_dx[0].transpose(1, 2, 0)  # [n, g, Q]
    else:
        dN = dN_dx.transpose(2, 3, 1, 0).reshape(n, g, Q * C)  # [n, g, N]

    # uniform geometry: fold the Mandel map, gradients and weights into
    # constant matrices (the construction of ops/structured.py)
    KEPS_c = KDIV_c = None
    if uniform:
        sdim = constraint.stress_strain_dim
        M_map = mandel._mandel_matrix_map(constraint)  # [s, g, g]
        KE = np.einsum("sij,aiq->sqaj", M_map, dN)  # [s, Q, n, vs]
        KEPS_c = KE.reshape(sdim * Q, n * vs)
        KDIV_c = (KE * w[0][None, :, None, None]).reshape(sdim * Q, n * vs).T.copy()
    dofmap_t = np.asarray(space.dofmap)[cell_ids].transpose(1, 2, 0)  # [n, vs, C]
    t1 = time.perf_counter()
    gather_idx = _gather_plan(dofmap_t, space.ndofs)
    t2 = time.perf_counter()

    def dev(x, dt=dtype):
        return None if x is None else torch.as_tensor(np.ascontiguousarray(x), dtype=dt)

    geo = PackedGeometry(
        dN=dev(dN), w=dev(w.T.reshape(-1)), dofmap_t=dev(dofmap_t, torch.int64),
        gather_idx=dev(gather_idx, torch.int64), KEPS_c=dev(KEPS_c), KDIV_c=dev(KDIV_c),
        uniform=uniform, n_cells=C, n_qp=Q, n_nodes=n, vs=vs, ndofs=space.ndofs,
        constraint=constraint,
    )
    geo.to(device)  # every buffer in one step
    geo.build_seconds = {"geometry": t1 - t0, "gather_idx": t2 - t1,
                         "upload": time.perf_counter() - t2}
    return geo


# ---------------------------------------------------------------------------
# kinematics and assembly in the SoA layout
# ---------------------------------------------------------------------------


def packed_grad(u: torch.Tensor, geo: PackedGeometry) -> torch.Tensor:
    """Displacement gradient at the QPs: [g, vs, N], grad[i, j] = d u_j / d x_i."""
    u_e = u[geo.dofmap_t]  # [n, vs, C]
    n, vs, C, Q = geo.n_nodes, geo.vs, geo.n_cells, geo.n_qp
    g = geo.dN.shape[1]
    if geo.uniform:
        # one [g*Q, n] x [n, vs*C] product
        dN = geo.dN.to(u.dtype).permute(1, 2, 0).reshape(g * Q, n)
        out = _matmul(dN, u_e.reshape(n, vs * C)).reshape(g, Q, vs, C)
        return out.permute(0, 2, 1, 3).reshape(g, vs, geo.N)
    u_eN = u_e[:, :, None, :].expand(n, vs, Q, C).reshape(n, vs, geo.N)
    out = None
    for a in range(n):
        term = geo.dN[a][:, None, :] * u_eN[a][None]
        out = term if out is None else out + term
    return out


def packed_strain(grad: torch.Tensor, constraint) -> torch.Tensor:
    """Mandel strain [s, N] from grad [g, vs, N] (``ops.mandel.
    strain_from_grad_u``'s convention, component axis leading).
    ``constraint``: a ``Constraint``, or its Mandel map [s, g, g] as a
    tensor of grad's dtype (what a geometry keeps as ``mandel_T``)."""
    if isinstance(constraint, Constraint):
        constraint = mandel.device_constant(mandel._mandel_matrix_map(constraint), grad.dtype,
                                            grad.device)
    mandel_T = constraint
    s, g = mandel_T.shape[0], mandel_T.shape[1]
    return _matmul(mandel_T.reshape(s, g * g), grad.reshape(g * g, -1))


def _elem_force(sig_w: torch.Tensor, geo: PackedGeometry) -> torch.Tensor:
    """sigma tensor times weight [g, vs, N] -> element forces [n, vs, C]
    (the general path: dN [n, g, N])."""
    g, vs = sig_w.shape[0], sig_w.shape[1]
    n, Q, C = geo.n_nodes, geo.n_qp, geo.n_cells
    t = None
    for i in range(g):
        term = geo.dN[:, i, None, :] * sig_w[i][None]  # [n, vs, N]
        t = term if t is None else t + term
    return t.reshape(n, vs, Q, C).sum(dim=2)


def _assemble(f_e: torch.Tensor, geo: PackedGeometry) -> torch.Tensor:
    """Deterministic gather-based assembly: [n, vs, C] element forces -> [ndofs]."""
    flat = torch.cat([f_e.reshape(-1), f_e.new_zeros(1)])
    return flat[geo.gather_idx].sum(dim=1)


def packed_residual(sigma: torch.Tensor, geo: PackedGeometry) -> torch.Tensor:
    """r = integral eps_m(v) . sigma: sigma [s, N] -> [ndofs]; one
    ``KDIV_c`` product on uniform geometry."""
    if geo.KDIV_c is not None:
        F = _matmul(geo.KDIV_c.to(sigma.dtype), sigma.reshape(-1, geo.n_cells))
        return _assemble(F.reshape(geo.n_nodes, geo.vs, geo.n_cells), geo)
    T = geo.mandel_T.to(sigma.dtype)
    s, g = T.shape[0], T.shape[1]
    sig_t = _matmul(T.reshape(s, g * g).T, sigma).reshape(g, g, -1)  # Mandel -> tensor
    return _assemble(_elem_force(sig_t * geo.w, geo), geo)


def packed_matvec(v: torch.Tensor, tangent, geo: PackedGeometry) -> torch.Tensor:
    """Matrix-free tangent action: [ndofs] -> [ndofs]."""
    return packed_residual(tangent.apply(geo.strain(v)), geo)


def packed_jacobi_diag(tangent, geo: PackedGeometry) -> torch.Tensor:
    """diag(A) via the per-QP quadratic form B^T C B, SoA layout."""
    Q, C = geo.n_qp, geo.n_cells
    cols = []
    if geo.KEPS_c is not None:
        # per-node B_a is a constant [s, vs, Q]: broadcast it against the
        # tangent's fields reshaped to [Q, C], with no [.., N]-wide temporary
        KE = geo.KEPS_c.reshape(geo.sdim, Q, geo.n_nodes, geo.vs)
        tg = _map_fields(tangent, geo.N, lambda x: x.reshape(*x.shape[:-1], Q, C))
        w_qc = geo.w.reshape(Q, C)
        for a in range(geo.n_nodes):
            B_a = KE[:, :, a, :].permute(0, 2, 1)[..., None]  # [s, vs, Q, 1]
            cols.append((tg.quad_diag(B_a) * w_qc).sum(dim=1))  # [vs, C]
        return _assemble(torch.stack(cols, dim=0), geo)
    T = geo.mandel_T
    for a in range(geo.n_nodes):
        # B_a[s, j] = sum_i T[s, i, j] dN[a, i]
        B_a = (T[:, :, :, None] * geo.dN[a][None, :, None, :]).sum(dim=1)  # [s, vs, N]
        q = tangent.quad_diag(B_a)  # [vs, N]
        cols.append((q * geo.w).reshape(geo.vs, Q, C).sum(dim=1))
    return _assemble(torch.stack(cols, dim=0), geo)


# ---------------------------------------------------------------------------
# tangent representations
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class IsotropicTangent:
    """C = kappa (I2 x I2) + beta P_dev + gamma (n x n) in Mandel space.

    kappa: scalar; beta, gamma: scalars or fields broadcastable to the QP
    axes ([Q, M] on the structured engine); n: [6, *qp] (unit deviatoric
    direction, zero where elastic) or [6, 1, 1] for a uniform tangent.
    """

    kappa: float | torch.Tensor
    beta: float | torch.Tensor
    gamma: float | torch.Tensor
    n: torch.Tensor

    def apply(self, eps: torch.Tensor) -> torch.Tensor:
        """[s, *qp] -> [s, *qp]: beta eps + gamma (n . eps) n, plus
        (kappa - beta/3) tr(eps) on the three diagonal slots."""
        tr = eps[0] + eps[1] + eps[2]
        ndote = (self.n * eps).sum(dim=0)
        out = self.beta * eps + (self.gamma * ndote) * self.n
        corr = (self.kappa - self.beta / 3.0) * tr
        return torch.cat([out[:3] + corr, out[3:]], dim=0)

    def quad_diag(self, B: torch.Tensor) -> torch.Tensor:
        """B^T C B for B [s, vs, *qp] -> [vs, *qp] (qp axes broadcastable).

        Uses dev(B):dev(B) = B:B - tr(B)^2/3, so no [s, vs, *qp] deviator."""
        trB = B[0] + B[1] + B[2]
        BB = (B * B).sum(dim=0)
        ndotB = (self.n[:, None] * B).sum(dim=0)
        return (
            self.kappa * trB**2
            + self.beta * (BB - trB**2 / 3.0)
            + self.gamma * ndotB**2
        )

    def full_matrix(self) -> torch.Tensor:
        """The tangent as a dense [6, 6, N] matrix (for debugging and tests)."""
        ioi = torch.as_tensor(3.0 * mandel.projection_vol(6), dtype=self.n.dtype,
                              device=self.n.device)
        pdev = torch.as_tensor(mandel.projection_dev(6), dtype=self.n.dtype, device=self.n.device)
        return (
            self.kappa * ioi[:, :, None]
            + self.beta * pdev[:, :, None]
            + self.gamma * self.n[:, None, :] * self.n[None, :, :]
        )


@dataclass(frozen=True)
class DenseTangent:
    """A general tangent C [s, s, *qp] (row s, column t), for laws without
    the factored form. ``apply`` and ``quad_diag`` sum over the component
    axes one term at a time, so no [s, s, vs, *qp] temporary is formed."""

    C: torch.Tensor

    def apply(self, eps: torch.Tensor) -> torch.Tensor:
        """[s, *qp] -> [s, *qp]: sum_t C[:, t] eps[t]."""
        out = self.C[:, 0] * eps[0]
        for t in range(1, self.C.shape[1]):
            out = out + self.C[:, t] * eps[t]
        return out

    def quad_diag(self, B: torch.Tensor) -> torch.Tensor:
        """B^T C B for B [s, vs, *qp] -> [vs, *qp] (qp axes broadcastable)."""
        out = None
        for s in range(self.C.shape[0]):
            # (C B)[s] = sum_t C[s, t] B[t]
            cb = (self.C[s][:, None] * B).sum(dim=0)
            term = B[s] * cb
            out = term if out is None else out + term
        return out
