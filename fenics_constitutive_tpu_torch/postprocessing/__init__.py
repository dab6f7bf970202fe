"""Postprocessing: global norms over quadrature fields, and point sensors."""

from .norms import dof_norm, norm, qp_norm
from .sensors import DisplacementSensor, QPSensor

__all__ = ["DisplacementSensor", "QPSensor", "dof_norm", "norm", "qp_norm"]
