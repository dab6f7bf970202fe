"""Model-conversion wrappers: run a FULL-3D model under a lower-dimensional
constraint by padding the gradient to 3D and taking the constraint's blocks
back. The full 3D stress is carried as the auxiliary history entry
``"stress_3d"``, so the out-of-plane components persist across steps while
``evaluate`` stays free of side effects (history is the committed state,
untouched until a step commits). Wrappers have no SoA twin: the engines run
them through the generic dense-tangent adapter.
"""

from __future__ import annotations

import torch

from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel

__all__ = ["PlaneStrainFrom3D", "UniaxialStrainFrom3D"]

_AUX = "stress_3d"


class _From3DBase(IncrSmallStrainModel):
    #: Mandel slots of the 3D stress that the constraint observes
    _slots: int

    def __init__(self, model: IncrSmallStrainModel):
        if model.constraint != Constraint.FULL:
            msg = f"{type(self).__name__} wraps a FULL model, got {model.constraint}"
            raise ValueError(msg)
        self.model = model

    @property
    def history_dim(self) -> dict[str, int]:
        return {**(self.model.history_dim or {}), _AUX: 6}

    @property
    def host_sync(self) -> str | None:
        return self.model.host_sync

    def _grad_3d(self, grad_del_u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        k = self._slots
        grad_3d = self._grad_3d(grad_del_u)
        # the 3D stress of the committed aux history with the observed slots
        # refreshed from the incoming stress
        s3 = history[_AUX].to(stress.dtype)
        stress_3d = torch.cat([stress, s3[:, k:]], dim=1)
        inner = None
        if self.model.history_dim is not None:
            inner = {name: v for name, v in history.items() if name != _AUX}
        stress_3d, tangent_3d, inner_new = self.model.evaluate(
            t, del_t, grad_3d, stress_3d, inner
        )
        history_new = dict(inner_new) if inner_new is not None else {}
        history_new[_AUX] = stress_3d
        return stress_3d[:, :k], tangent_3d[:, :k, :k], history_new


class UniaxialStrainFrom3D(_From3DBase):
    """A FULL 3D model as a UNIAXIAL_STRAIN model: only d(u_x)/dx is nonzero;
    the lateral stresses persist through ``stress_3d``."""

    _slots = 1

    @property
    def constraint(self) -> Constraint:
        return Constraint.UNIAXIAL_STRAIN

    def _grad_3d(self, grad_del_u):
        g = grad_del_u.new_zeros((grad_del_u.shape[0], 3, 3))
        g[:, 0, 0] = grad_del_u[:, 0, 0]
        return g


class PlaneStrainFrom3D(_From3DBase):
    """A FULL 3D model as a PLANE_STRAIN model: the 2D gradient fills the
    upper-left 2 x 2 block; the 2D Mandel slots [xx, yy, zz, xy] are the
    first four 3D slots, and the out-of-plane shears persist through
    ``stress_3d``."""

    _slots = 4

    @property
    def constraint(self) -> Constraint:
        return Constraint.PLANE_STRAIN

    def _grad_3d(self, grad_del_u):
        g = grad_del_u.new_zeros((grad_del_u.shape[0], 3, 3))
        g[:, :2, :2] = grad_del_u[:, :2, :2]
        return g
