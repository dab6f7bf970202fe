"""Von Mises plasticity with nonlinear (saturating exponential) isotropic
hardening, on the packed engines."""

from __future__ import annotations

from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .packed_models import _vonmises_evaluate_packed

__all__ = ["VonMises3D"]


class VonMises3D(IncrSmallStrainModel):
    r"""Von Mises plasticity with exponential isotropic hardening; FULL
    constraint only.

    Yield: :math:`\|\sigma'\| - \sqrt{2/3}\,(y_0 + (y_\infty - y_0)(1 - e^{-\omega\alpha}))`.

    Args:
        param: ``p_ka`` bulk modulus, ``p_mu`` shear modulus, ``p_y0`` initial
            yield stress, ``p_y00`` final yield stress, ``p_w`` saturation rate.
    """

    #: local Newton controls: absolute and relative tolerance, iteration cap
    newton_tol = 1e-12
    newton_rtol = 1e-8
    newton_max_iter = 100

    def __init__(self, param: dict[str, float]):
        self.params = {
            k: float(param[k]) for k in ("p_ka", "p_mu", "p_y0", "p_y00", "p_w")
        }

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self) -> dict[str, int]:
        return {"eps_n": 6, "alpha": 1}

    evaluate_packed = _vonmises_evaluate_packed
