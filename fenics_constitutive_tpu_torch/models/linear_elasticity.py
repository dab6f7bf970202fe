"""Linear elasticity on the packed engines (FULL constraint)."""

from __future__ import annotations

from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .packed_models import _linear_elasticity_evaluate_packed

__all__ = ["LinearElasticityModel"]


class LinearElasticityModel(IncrSmallStrainModel):
    """Hooke's law: ``stress += D : eps``, tangent D, no history.

    Args:
        parameters: "E" (Young's modulus) and "nu" (Poisson ratio).
        constraint: the stress-strain constraint. Only ``Constraint.FULL`` is
            ported; the four others (uniaxial strain and stress, plane strain
            and stress) raise NotImplementedError (ROADMAP.md Queue 1 item 14).
    """

    def __init__(self, parameters: dict[str, float], constraint: Constraint):
        if constraint != Constraint.FULL:
            msg = (
                f"LinearElasticityModel with {constraint.name} is not ported yet "
                "(ROADMAP.md Queue 1 item 14); the port takes Constraint.FULL"
            )
            raise NotImplementedError(msg)
        self._constraint = constraint
        self.params = {"E": float(parameters["E"]), "nu": float(parameters["nu"])}

    @property
    def constraint(self) -> Constraint:
        return self._constraint

    @property
    def history_dim(self) -> None:
        return None

    evaluate_packed = _linear_elasticity_evaluate_packed
