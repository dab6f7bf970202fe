"""FEM core: box meshes, Lagrange elements and Gauss rules, dofmaps,
Dirichlet BCs, geometry tabulation, boundary facets and Neumann loads, Gmsh
(ASCII and binary) and VTU I/O (host numpy), and the AoS element assembly
(tensors). The same modules as ``fenics_constitutive_tpu.fem``, carried over
because that package imports JAX when it is imported."""

from .assembly import (
    CellDofmap,
    assemble_jacobi_diag,
    assemble_residual,
    build_cell_dofmap,
    device_geometry,
    gather_element_dofs,
    grad_at_qp,
    tangent_matvec,
)
from .bcs import DirichletBC, combine_bcs
from .elements import gauss_rule, tabulate_element
from .facets import assemble_facet_traction, locate_boundary_facets
from .io import PVDWriter, read_gmsh, read_vtu, write_gmsh, write_gmsh41_binary, write_vtu
from .kinematics import Geometry, precompute_geometry
from .mesh import Mesh, unit_cube_mesh, unit_interval_mesh, unit_square_mesh
from .spaces import FunctionSpace

__all__ = [
    "CellDofmap",
    "DirichletBC",
    "FunctionSpace",
    "Geometry",
    "Mesh",
    "PVDWriter",
    "assemble_facet_traction",
    "assemble_jacobi_diag",
    "assemble_residual",
    "build_cell_dofmap",
    "combine_bcs",
    "device_geometry",
    "gather_element_dofs",
    "gauss_rule",
    "grad_at_qp",
    "locate_boundary_facets",
    "precompute_geometry",
    "read_gmsh",
    "read_vtu",
    "tabulate_element",
    "tangent_matvec",
    "unit_cube_mesh",
    "unit_interval_mesh",
    "unit_square_mesh",
    "write_gmsh",
    "write_gmsh41_binary",
    "write_vtu",
]
