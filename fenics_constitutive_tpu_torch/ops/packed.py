"""Tangent representations on SoA quadrature fields.

The hot models return their consistent tangent in a factored isotropic form
(``IsotropicTangent``), so the CG operator never touches a dense [6, 6, N]
field; every other law reaches the engines through the generic
``evaluate_packed`` adapter (models/interfaces.py) with a ``DenseTangent``.
Both apply pointwise, as broadcast multiplies and sums: no product here
runs in TF32 on the card, whatever the process-wide setting.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["DenseTangent", "IsotropicTangent"]


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
