"""Element-local compute and assembly in Mandel space on AoS ``[C, Q, ...]``
fields (the reference-parity layout of ``solver.IncrSmallStrainProblem``'s
"aos" engine and ``solver.make_load_step``).

The residual is ``r_e = int grad(v) : T(sigma)`` per cell, summed into the
global dof vector; the tangent is applied matrix-free (``B^T C B v``), so no
global matrix exists.

Two rules of the port hold here:
  * assembly is deterministic: element values are summed into the dofs as a
    gather and a sum in a fixed order (``flat[plan].sum(1)``, the plan of
    ``ops/packed.py::_gather_plan``), never by a float ``index_add_``, which
    uses atomics on CUDA;
  * the small contractions are broadcast multiplies and sums, so none runs
    in TF32 on a float32 CUDA tensor.

A law's dofmap is a :class:`CellDofmap` (``build_cell_dofmap``), which
carries its assembly plan, built once; ``ndofs`` stays in the signatures as
in the JAX package, the plan having fixed it. ``geo`` is a
``fem.kinematics.Geometry`` whose ``dN_dx`` [C, Q, n, g] and ``w_detJ``
[C, Q] are tensors (:func:`device_geometry`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import mandel
from ..ops.mandel import Constraint
from ..ops.packed import _gather_plan
from .kinematics import Geometry

__all__ = [
    "CellDofmap",
    "assemble_jacobi_diag",
    "assemble_residual",
    "build_cell_dofmap",
    "device_geometry",
    "gather_element_dofs",
    "grad_at_qp",
    "tangent_matvec",
]


@dataclass(frozen=True)
class CellDofmap:
    """A law's cell dofmap with its assembly plan.

    ``idx`` [C, n, vs] int64 global dofs; ``plan`` [ndofs, k] int64: row d
    lists, in ascending order, the flat ``[C, n, vs]`` slots that hold dof d,
    padded with the one-past-the-end slot (a zero)."""

    idx: torch.Tensor
    plan: torch.Tensor


def build_cell_dofmap(dofmap, ndofs: int, *, device="cuda") -> CellDofmap:
    """A :class:`CellDofmap` from a host ``[C, n, vs]`` dofmap (host build)."""
    dm = np.asarray(dofmap, np.int64)
    return CellDofmap(
        idx=torch.as_tensor(dm, device=device),
        plan=torch.as_tensor(_gather_plan(dm, ndofs), device=device),
    )


def device_geometry(geo: Geometry, *, dtype: torch.dtype, device="cuda") -> Geometry:
    """The host Geometry's tables as tensors of ``dtype`` on ``device``."""

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    return Geometry(dN_dx=dev(geo.dN_dx), w_detJ=dev(geo.w_detJ), qp_coords=dev(geo.qp_coords))


def gather_element_dofs(u: torch.Tensor, dofmap: CellDofmap) -> torch.Tensor:
    """u [ndofs] -> u_e [C, n, vs]."""
    return u[dofmap.idx]


def grad_at_qp(u: torch.Tensor, dofmap: CellDofmap, geo: Geometry) -> torch.Tensor:
    """Displacement gradient at the QPs, ``grad[c, q, i, j] = d u_j / d x_i``
    (nabla_grad convention): [C, Q, g, vs]."""
    u_e = gather_element_dofs(u, dofmap)  # [C, n, vs]
    dN = geo.dN_dx.to(u.dtype)  # [C, Q, n, g]
    return (dN[..., None] * u_e[:, None, :, None, :]).sum(dim=2)


def _scatter_add(dofmap: CellDofmap, values: torch.Tensor) -> torch.Tensor:
    """Deterministic sum of element values [C, n, vs] into [ndofs]: a gather
    through the plan and a sum in its fixed order (no atomics)."""
    flat = torch.cat([values.reshape(-1), values.new_zeros(1)])
    return flat[dofmap.plan].sum(dim=1)


def assemble_residual(sigma: torch.Tensor, dofmap: CellDofmap, geo: Geometry,
                      constraint: Constraint, ndofs: int) -> torch.Tensor:
    """r = int eps_mandel(v) . sigma dx over every cell: sigma [C, Q, s] ->
    [ndofs], through the adjoint identity inner(eps_m(v), sigma) =
    grad(v) : T(sigma)."""
    sig_t = mandel.mandel_to_matrix(sigma, constraint)  # [C, Q, g, g]
    sig_w = sig_t * geo.w_detJ.to(sigma.dtype)[:, :, None, None]
    dN = geo.dN_dx.to(sigma.dtype)  # [C, Q, n, g]
    # f_e[c, a, j] = sum_q sum_i dN[c, q, a, i] sig_w[c, q, i, j]
    f_e = (dN[..., None] * sig_w[:, :, None, :, :]).sum(dim=(1, 3))
    return _scatter_add(dofmap, f_e)


def tangent_matvec(v: torch.Tensor, tangent: torch.Tensor, dofmap: CellDofmap, geo: Geometry,
                   constraint: Constraint, ndofs: int) -> torch.Tensor:
    """The consistent tangent's action v -> A v (tangent [C, Q, s, s])."""
    eps_v = mandel.strain_from_grad_u(grad_at_qp(v, dofmap, geo), constraint)  # [C, Q, s]
    sig_v = (tangent * eps_v[:, :, None, :]).sum(dim=-1)
    return assemble_residual(sig_v, dofmap, geo, constraint, ndofs)


def assemble_jacobi_diag(tangent: torch.Tensor, dofmap: CellDofmap, geo: Geometry,
                         constraint: Constraint, ndofs: int) -> torch.Tensor:
    """diag(A) for the Jacobi preconditioner of the matrix-free operator.

    Local dof (a, j) contributes sum_q w B^T C B with B[s] = M[s, i, j]
    dN_a/dx_i; one local node a at a time, so the full B tensor never
    exists."""
    dtype = tangent.dtype
    M = torch.as_tensor(mandel._mandel_matrix_map(constraint), dtype=dtype,
                         device=tangent.device)  # [s, g, g]
    dN = geo.dN_dx.to(dtype)
    w = geo.w_detJ.to(dtype)
    cols = []
    for a in range(dN.shape[2]):
        dn_a = dN[:, :, a, :]  # [C, Q, g]
        # B[c, q, s, j] = sum_i M[s, i, j] dn_a[c, q, i]
        B = (M[None, None] * dn_a[:, :, None, :, None]).sum(dim=3)
        CB = (tangent[..., None] * B[:, :, None, :, :]).sum(dim=3)  # [C, Q, s, j]
        cols.append(((B * CB).sum(dim=2) * w[..., None]).sum(dim=1))  # [C, j]
    return _scatter_add(dofmap, torch.stack(cols, dim=1))
