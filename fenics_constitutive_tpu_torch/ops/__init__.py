"""Operators: Mandel constants, factored tangents, the structured engine and
the CUDA kernels (compiled on first use, never at import)."""

from .mandel import Constraint
from .packed import IsotropicTangent
from .structured import StructuredGeometry, build_structured_geometry

__all__ = [
    "Constraint",
    "IsotropicTangent",
    "StructuredGeometry",
    "build_structured_geometry",
]
