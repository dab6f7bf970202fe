"""Global norms over quadrature fields: "l2" integrates f . f and takes the
square root, "inf" is the max norm. The reductions are plain ones: a sharded
problem's observed fields (``stress_0``, ``dxm``) are whole on every rank, so
the norm is already global there."""

from __future__ import annotations

import torch

__all__ = ["dof_norm", "norm", "qp_norm"]


def qp_norm(field: torch.Tensor, w_detJ: torch.Tensor, norm_type: str = "l2") -> torch.Tensor:
    """Norm of a quadrature-point field.

    Args:
        field: [C, Q] or [C, Q, k] values at the quadrature points.
        w_detJ: [C, Q] quadrature weights (``problem.dxm``).
        norm_type: "l2" (integral norm) or "inf" (max abs).
    """
    if norm_type == "l2":
        sq = field**2 if field.dim() == 2 else (field**2).sum(dim=-1)
        return torch.sqrt((sq * w_detJ).sum())
    if norm_type == "inf":
        return field.abs().max()
    msg = f"unknown norm type {norm_type}"
    raise ValueError(msg)


def dof_norm(vec: torch.Tensor, norm_type: str = "l2") -> torch.Tensor:
    """Norm of a global dof vector."""
    if norm_type == "l2":
        return torch.linalg.vector_norm(vec)
    if norm_type == "inf":
        return vec.abs().max()
    msg = f"unknown norm type {norm_type}"
    raise ValueError(msg)


def norm(f, dx, comm=None, norm_type: str = "l2") -> torch.Tensor:
    """The reference's signature ``norm(f, dx, comm, norm_type)``; ``dx`` is
    the quadrature measure (``problem.dxm``). ``comm`` is accepted and
    ignored, as in the JAX package: the fields are whole on every rank."""
    del comm
    return qp_norm(f, dx, norm_type)
