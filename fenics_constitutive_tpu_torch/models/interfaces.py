"""The constitutive-model protocol of the packed (SoA) engines.

A model owns its material parameters (``params``, a dict of Python floats,
so they follow the dtype of the fields they meet), its stress-strain
``constraint`` and the per-QP shape of its history variables
(``history_dim``). The engines call

    evaluate_packed(t, dt, eps [s, *qp], stress [s, *qp], history {k: [d, *qp]})
        -> (stress' [s, *qp], tangent, history')

where ``eps`` is the Mandel strain increment and ``tangent`` a factored
representation (ops.packed.IsotropicTangent). Stress is Mandel notation
(shear x sqrt2). Nothing is mutated: the committed state is whichever
tensors the caller keeps.
"""

from __future__ import annotations

import abc

import torch

from ..ops.mandel import Constraint

__all__ = ["Constraint", "History", "IncrSmallStrainModel"]

History = dict[str, torch.Tensor] | None


class IncrSmallStrainModel(abc.ABC):
    """Base class for incremental small strain models."""

    params: dict[str, float]

    @abc.abstractmethod
    def evaluate_packed(
        self,
        t: float | torch.Tensor,
        del_t: float | torch.Tensor,
        eps: torch.Tensor,
        stress: torch.Tensor,
        history: History,
    ):
        """Return ``(stress_new, tangent, history_new)`` for one increment."""

    @property
    @abc.abstractmethod
    def constraint(self) -> Constraint: ...

    @property
    @abc.abstractmethod
    def history_dim(self) -> dict[str, int] | None:
        """Name -> number of per-QP components of each history variable."""
