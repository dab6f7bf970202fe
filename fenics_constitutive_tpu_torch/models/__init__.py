"""Constitutive model library. Every model implements the AoS ``evaluate``;
the engines call ``evaluate_packed``, a SoA twin with a factored tangent for
the hot models and the generic dense-tangent adapter for the rest."""

from ..ops.mandel import Constraint, StressStrainConstraint
from .conversions import PlaneStrainFrom3D, UniaxialStrainFrom3D
from .drucker_prager import DruckerPrager3D, DruckerPragerHyperbolic3D
from .interfaces import IncrSmallStrainModel
from .linear_elasticity import LinearElasticityModel
from .mises import MisesPlasticityLinearHardening3D, VonMises3D
from .viscoelasticity import SpringKelvinModel, SpringMaxwellModel

__all__ = [
    "Constraint",
    "StressStrainConstraint",
    "IncrSmallStrainModel",
    "LinearElasticityModel",
    "VonMises3D",
    "MisesPlasticityLinearHardening3D",
    "DruckerPrager3D",
    "DruckerPragerHyperbolic3D",
    "SpringKelvinModel",
    "SpringMaxwellModel",
    "UniaxialStrainFrom3D",
    "PlaneStrainFrom3D",
]
