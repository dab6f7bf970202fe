"""Constitutive models of the packed engines."""

from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .linear_elasticity import LinearElasticityModel
from .mises import VonMises3D

__all__ = ["Constraint", "IncrSmallStrainModel", "LinearElasticityModel", "VonMises3D"]
