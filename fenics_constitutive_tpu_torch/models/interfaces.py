"""The constitutive-model protocol.

A model owns its material parameters (``params``, a dict of Python floats,
so they follow the dtype of the fields they meet), its stress-strain
``constraint`` and the per-QP shape of its history variables
(``history_dim``: an int for a vector entry, a ``(rows, cols)`` tuple for a
matrix entry). Every model implements the AoS update

    evaluate(t, dt, grad_del_u [Q, g, g], stress [Q, s], history {k: [Q, ...]})
        -> (stress' [Q, s], tangent [Q, s, s], history')

and the engines call the packed (SoA) update

    evaluate_packed(t, dt, eps [s, *qp], stress [s, *qp], history {k: [d, *qp]})
        -> (stress' [s, *qp], tangent, history')

where ``eps`` is the Mandel strain increment. The hot models override
``evaluate_packed`` with SoA twins that return a factored
``ops.packed.IsotropicTangent``; every other model runs through the generic
adapter below, which reshapes to the AoS ``evaluate`` and wraps its dense
tangent as an ``ops.packed.DenseTangent``. Stress is Mandel notation (shear
x sqrt2). Nothing is mutated: the committed state is whichever tensors the
caller keeps.
"""

from __future__ import annotations

import abc
import math
from typing import Any

import torch

from ..ops import mandel
from ..ops.mandel import Constraint
from ..ops.packed import DenseTangent

__all__ = ["Constraint", "History", "IncrSmallStrainModel", "as_param_dict", "rotate_history"]

History = dict[str, torch.Tensor] | None


class IncrSmallStrainModel(abc.ABC):
    """Base class for incremental small strain models."""

    params: dict[str, float]
    #: True when ``evaluate_packed`` returns an ``IsotropicTangent`` (a hot
    #: model's SoA twin), the tangent the CUDA operator of
    #: ``ops/cuda_matvec.py`` applies; the generic adapter's is dense
    factored_tangent: bool = False
    #: why ``evaluate_packed`` reads values back to the host (a loop whose
    #: trip count or shapes follow the data, a call into a host library), or
    #: None: a step over a law with a reason is never captured in a CUDA
    #: graph (``solver/compiled.py``)
    host_sync: str | None = None

    @abc.abstractmethod
    def evaluate(
        self,
        t: float | torch.Tensor,
        del_t: float | torch.Tensor,
        grad_del_u: torch.Tensor,
        stress: torch.Tensor,
        history: History,
    ) -> tuple[torch.Tensor, torch.Tensor, History]:
        r"""Evaluate the model over a batch of quadrature points.

        Args:
            t: time :math:`t_n` at the start of the increment.
            del_t: time increment.
            grad_del_u: ``[Q, g, g]`` gradients of the displacement increment,
                ``grad[i, j] = d(delta u_j)/dx_i``.
            stress: ``[Q, s]`` Mandel stress at :math:`t_n`.
            history: committed history ``{name: [Q, ...]}`` or None.

        Returns:
            ``(stress_new, tangent [Q, s, s], history_new)``, the tangent
            consistent with the stress update.
        """

    @property
    @abc.abstractmethod
    def constraint(self) -> Constraint: ...

    @property
    def stress_strain_dim(self) -> int:
        return self.constraint.stress_strain_dim

    @property
    def geometric_dim(self) -> int:
        return self.constraint.geometric_dim

    @property
    @abc.abstractmethod
    def history_dim(self) -> dict[str, int | tuple[int, int]] | None:
        """Name -> per-QP shape of each history variable: an int for a
        vector entry, a ``(rows, cols)`` tuple for a matrix entry."""

    @property
    def rotatable_history(self) -> frozenset[str]:
        """Names of the history entries attached to the material frame: they
        co-rotate with the material under a rotation increment
        (:func:`rotate_history`). Default: nothing rotates (small-strain
        models are frame-fixed)."""
        return frozenset()

    def init_history(self, n_qp: int, *, dtype=torch.float64, device="cpu") -> History:
        """Zero history for ``n_qp`` points in the AoS layout: ``[Q, d]`` for
        a vector entry, ``[Q, rows, cols]`` for a matrix entry."""
        hd = self.history_dim
        if hd is None:
            return None
        return {
            name: torch.zeros((n_qp, dim) if isinstance(dim, int) else (n_qp, *dim),
                              dtype=dtype, device=device)
            for name, dim in hd.items()
        }

    def evaluate_packed(self, t, del_t, eps, stress, history):
        """The generic SoA adapter: any model on the packed engines.

        Reshapes the packed fields to the AoS ``evaluate`` contract and wraps
        its dense tangent as a ``DenseTangent`` [s, s, *qp]. The gradient
        handed to ``evaluate`` is the SYMMETRIC tensor rebuilt from the Mandel
        strain increment (``mandel_to_matrix``); a small-strain model reads
        only the symmetric part, so this is exact. Packed history entries
        are ``[d, *qp]`` with a matrix entry flattened to ``d = rows * cols``.

        The new stress and history come back contiguous, as the engines lay
        out the state they build: a compiled step copies each call's state
        into buffers laid out like its first call's, and a reduction's
        summation order follows its input's layout, so a state laid out
        otherwise would make the replayed step differ from the eager one in
        the last bits.
        """
        c = self.constraint
        s = c.stress_strain_dim
        qp_shape = tuple(eps.shape[1:])
        n = math.prod(qp_shape)
        grad = mandel.mandel_to_matrix(eps.reshape(s, n).T, c)
        stress_aos = stress.reshape(s, n).T
        hd = self.history_dim or {}

        def unpack(k, v):  # packed [d, *qp] -> AoS [n, *entry]
            aos = v.reshape(v.shape[0], n).T
            return aos if isinstance(hd[k], int) else aos.reshape(n, *hd[k])

        def pack(v):  # AoS [n, *entry] -> packed [d, *qp]
            flat = v.reshape(n, -1)
            return flat.T.reshape(flat.shape[1], *qp_shape).contiguous()

        hist_aos = None if history is None else {k: unpack(k, v) for k, v in history.items()}
        s_new, tg, h_new = self.evaluate(t, del_t, grad, stress_aos, hist_aos)
        s_out = s_new.T.reshape(s, *qp_shape).contiguous()
        tangent = DenseTangent(tg.permute(1, 2, 0).reshape(s, s, *qp_shape))
        h_out = None if h_new is None else {k: pack(v) for k, v in h_new.items()}
        return s_out, tangent, h_out


def flat_history_dim(dim: int | tuple[int, int]) -> int:
    """Components of one history entry in the packed layout ``[d, *qp]``."""
    return dim if isinstance(dim, int) else math.prod(dim)


def as_param_dict(parameters: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A user parameter dict (floats, numpy scalars) as 0-d float64 tensors.

    A 0-d tensor takes part in type promotion by its category only, so a
    float32 field it meets stays float32 (as a float64 tensor with
    dimensions would not), and a CPU 0-d tensor combines with CUDA fields.
    """
    return {k: torch.tensor(float(v), dtype=torch.float64) for k, v in parameters.items()}


def _conjugate(R: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """R A R^T per point, [Q, g, g] (R broadcasts over Q), as broadcast
    multiplies and sums (never TF32)."""
    RA = (R[:, :, :, None] * A[:, None, :, :]).sum(dim=2)
    return (RA[:, :, None, :] * R[:, None, :, :]).sum(dim=-1)


def rotate_history(model: IncrSmallStrainModel, history: History, R) -> History:
    """Co-rotate a model's frame-attached history entries by ``R``.

    Entries named in ``model.rotatable_history`` transform under a uniform
    (``[g, g]``) or per-point (``[Q, g, g]``) rotation; every other entry
    passes through untouched, and a model that declares nothing rotatable
    gets its history back as it is.

    Rules per declared entry shape (AoS history ``{name: [Q, ...]}``):
      * a Mandel vector (dim == stress_strain_dim): ``mandel(R A R^T)``
        through the exact Mandel <-> matrix maps;
      * a geometric vector (dim == geometric_dim): ``R v``;
      * a ``(g, g)`` matrix: ``R H R^T``.
    """
    if history is None or not model.rotatable_history:
        return history
    c = model.constraint
    s, g = c.stress_strain_dim, c.geometric_dim
    hd = model.history_dim or {}
    out = {}
    for name, v in history.items():
        if name not in model.rotatable_history:
            out[name] = v
            continue
        Rt = torch.as_tensor(R, dtype=v.dtype, device=v.device)
        if Rt.dim() == 2:
            Rt = Rt[None]  # a uniform rotation broadcasts over the points
        dim = hd[name]
        if isinstance(dim, tuple):
            if dim != (g, g):
                msg = f"rotatable matrix history '{name}' must be ({g},{g}), got {dim}"
                raise ValueError(msg)
            out[name] = _conjugate(Rt, v)
        elif dim == s:
            out[name] = mandel.matrix_to_mandel(
                _conjugate(Rt, mandel.mandel_to_matrix(v, c)), c
            )
        elif dim == g:
            out[name] = (Rt * v[:, None, :]).sum(dim=-1)
        else:
            msg = (
                f"rotatable history '{name}' has dim {dim}; expected the "
                f"Mandel dim {s}, the geometric dim {g}, or a ({g},{g}) matrix"
            )
            raise ValueError(msg)
    return out
