"""Operators: Mandel constants, factored tangents, the structured and
windowed engines, the windowed BSR level format and the CUDA kernels
(compiled on first use, never at import)."""

from .mandel import Constraint
from .packed import DenseTangent, IsotropicTangent
from .structured import StructuredGeometry, build_structured_geometry
from .windowed import (
    WindowedExchange,
    WindowedGeometry,
    build_windowed_exchange,
    build_windowed_geometry,
    reverse_cuthill_mckee,
)
from .windowed_bsr import WindowedBsr, build_windowed_bsr

__all__ = [
    "Constraint",
    "DenseTangent",
    "IsotropicTangent",
    "StructuredGeometry",
    "WindowedBsr",
    "WindowedExchange",
    "WindowedGeometry",
    "build_structured_geometry",
    "build_windowed_bsr",
    "build_windowed_exchange",
    "build_windowed_geometry",
    "reverse_cuthill_mckee",
]
