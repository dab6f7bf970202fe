"""Host FEM core (numpy): box meshes, Lagrange elements and Gauss rules,
dofmaps, Dirichlet BCs, geometry tabulation, boundary facets and Neumann
loads, and ASCII Gmsh I/O. The same modules as ``fenics_constitutive_tpu.fem``,
carried over because that package imports JAX when it is imported."""

from .bcs import DirichletBC, combine_bcs
from .elements import gauss_rule, tabulate_element
from .facets import assemble_facet_traction, locate_boundary_facets
from .io import read_gmsh, write_gmsh
from .kinematics import Geometry, precompute_geometry
from .mesh import Mesh, unit_cube_mesh, unit_interval_mesh, unit_square_mesh
from .spaces import FunctionSpace

__all__ = [
    "DirichletBC",
    "FunctionSpace",
    "Geometry",
    "Mesh",
    "assemble_facet_traction",
    "combine_bcs",
    "gauss_rule",
    "locate_boundary_facets",
    "precompute_geometry",
    "read_gmsh",
    "tabulate_element",
    "unit_cube_mesh",
    "unit_interval_mesh",
    "unit_square_mesh",
    "write_gmsh",
]
