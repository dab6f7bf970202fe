"""Host FEM core (numpy): box meshes, Lagrange elements and Gauss rules,
dofmaps and Dirichlet BCs. The same modules as ``fenics_constitutive_tpu.fem``,
carried over because that package imports JAX when it is imported."""

from .bcs import DirichletBC, combine_bcs
from .elements import gauss_rule, tabulate_element
from .mesh import Mesh, unit_cube_mesh, unit_interval_mesh, unit_square_mesh
from .spaces import FunctionSpace

__all__ = [
    "DirichletBC",
    "FunctionSpace",
    "Mesh",
    "combine_bcs",
    "gauss_rule",
    "tabulate_element",
    "unit_cube_mesh",
    "unit_interval_mesh",
    "unit_square_mesh",
]
