"""Operators: Mandel constants, factored tangents, the structured,
structured-tet, lattice, windowed and gather engines, the windowed BSR level format
and the CUDA kernels (compiled on first use, never at import)."""

from . import mandel
from .mandel import (
    Constraint,
    StressStrainConstraint,
    get_elastic_tangent,
    get_identity,
    isotropic_elastic_tangent,
    isotropic_elastic_tangent_inv,
    lame_parameters,
    mandel_to_matrix,
    matrix_to_mandel,
    strain_from_grad_u,
)
from .packed import DenseTangent, IsotropicTangent, PackedGeometry, build_packed_geometry
from .structured import (
    LatticeGeometry,
    StructuredGeometry,
    StructuredTetGeometry,
    build_lattice_geometry,
    build_structured_geometry,
    build_structured_tet_geometry,
    restrict_structured_geometry,
    restrict_structured_tet_geometry,
)
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
    "LatticeGeometry",
    "PackedGeometry",
    "StructuredGeometry",
    "StructuredTetGeometry",
    "WindowedBsr",
    "WindowedExchange",
    "WindowedGeometry",
    "build_lattice_geometry",
    "build_packed_geometry",
    "build_structured_geometry",
    "build_structured_tet_geometry",
    "build_windowed_bsr",
    "build_windowed_exchange",
    "build_windowed_geometry",
    "restrict_structured_geometry",
    "restrict_structured_tet_geometry",
    "reverse_cuthill_mckee",
    # the JAX package's ops names: the Mandel algebra
    "StressStrainConstraint",
    "get_elastic_tangent",
    "get_identity",
    "isotropic_elastic_tangent",
    "isotropic_elastic_tangent_inv",
    "lame_parameters",
    "mandel",
    "mandel_to_matrix",
    "matrix_to_mandel",
    "strain_from_grad_u",
]
