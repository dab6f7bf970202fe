"""Factored isotropic tangents on SoA quadrature fields.

The structured engine never forms a dense [6, 6, N] tangent: every model on
the main path returns its consistent tangent in the closed form below, and
the CG operator applies it pointwise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["IsotropicTangent"]


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
