"""Constitutive models of the packed engines."""

from ..ops.mandel import Constraint
from .interfaces import IncrSmallStrainModel
from .mises import VonMises3D

__all__ = ["Constraint", "IncrSmallStrainModel", "VonMises3D"]
