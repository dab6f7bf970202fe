"""Gmsh I/O of the port (fem/io.py) against the JAX package's.

* read_gmsh reads ASCII v2.2 files written by the JAX package's write_gmsh
  (tets and hexes, with physical groups and names) and gives the same mesh:
  nodes, cells and cell sets equal.
* The port's write_gmsh writes what both readers read back unchanged.
* An ASCII v4.1 file with entity blocks and physical names reads as in JAX.
* A binary v4.1 file (the JAX package's write_gmsh41_binary) raises a
  ValueError that names the missing binary reader.
"""

import numpy as np
import pytest

from fenics_constitutive_tpu.fem import unit_cube_mesh as jax_cube
from fenics_constitutive_tpu.fem.io import read_gmsh as jax_read
from fenics_constitutive_tpu.fem.io import write_gmsh as jax_write
from fenics_constitutive_tpu.fem.io import write_gmsh41_binary as jax_write_binary
from fenics_constitutive_tpu.fem.mesh import Mesh as JMesh
from fenics_constitutive_tpu_torch.fem import Mesh, read_gmsh, unit_cube_mesh, write_gmsh

V41 = """$MeshFormat
4.1 0 8
$EndMeshFormat
$PhysicalNames
2
2 10 "lower"
2 20 "upper"
$EndPhysicalNames
$Entities
0 0 2 0
1 0 0 0 1 1 0 1 10 0
2 0 0 0 1 1 0 1 20 0
$EndEntities
$Nodes
2 4 1 4
2 1 0 2
1
2
0 0 0
1 0 0
2 2 0 2
3
4
1 1 0
0 1 0
$EndNodes
$Elements
2 2 1 2
2 1 2 1
1 1 2 3
2 2 2 1
2 1 3 4
$EndElements
"""


def tagged(mesh_cls, mesh):
    """The mesh with two named material regions (x below / above 0.5)."""
    left = np.flatnonzero(mesh.cell_midpoints()[:, 0] < 0.5).astype(np.int32)
    right = np.flatnonzero(mesh.cell_midpoints()[:, 0] >= 0.5).astype(np.int32)
    sets = {1: left, 2: right, "soft": left, "stiff": right}
    return mesh_cls(mesh.nodes, mesh.cells, mesh.cell_type, cell_sets=sets)


def assert_same_mesh(got, ref):
    assert got.cell_type == ref.cell_type
    np.testing.assert_array_equal(got.nodes, ref.nodes)
    np.testing.assert_array_equal(got.cells, ref.cells)
    assert (got.cell_sets is None) == (ref.cell_sets is None)
    if ref.cell_sets:
        assert set(got.cell_sets) == set(ref.cell_sets)
        for k in ref.cell_sets:
            np.testing.assert_array_equal(got.cell_sets[k], ref.cell_sets[k])


@pytest.mark.parametrize("cell_type", ["tetra", "hex"])
@pytest.mark.parametrize("with_sets", [False, True], ids=["plain", "cell_sets"])
def test_reads_jax_written_file(tmp_path, cell_type, with_sets):
    mesh = jax_cube(3, 2, 2, cell_type)
    if with_sets:
        mesh = tagged(JMesh, mesh)
    path = tmp_path / "m.msh"
    jax_write(path, mesh)
    assert_same_mesh(read_gmsh(path), jax_read(path))


@pytest.mark.parametrize("cell_type", ["tetra", "hex"])
def test_write_roundtrips_through_both_readers(tmp_path, cell_type):
    mesh = tagged(Mesh, unit_cube_mesh(3, 2, 2, cell_type))
    path = tmp_path / "m.msh"
    write_gmsh(path, mesh)
    got = read_gmsh(path)
    assert got.structured_shape is None
    np.testing.assert_array_equal(got.nodes, mesh.nodes)
    np.testing.assert_array_equal(got.cells, mesh.cells)
    assert_same_mesh(got, jax_read(path))


def test_reads_ascii_v41(tmp_path):
    path = tmp_path / "v41.msh"
    path.write_text(V41)
    mesh = read_gmsh(path)
    assert mesh.cell_type == "triangle" and mesh.num_cells == 2
    np.testing.assert_array_equal(mesh.cells, [[0, 1, 2], [0, 2, 3]])
    np.testing.assert_array_equal(mesh.cell_sets["lower"], [0])
    assert_same_mesh(mesh, jax_read(path))


def test_binary_file_raises(tmp_path):
    path = tmp_path / "b.msh"
    jax_write_binary(path, jax_cube(2, 2, 2, "tetra"))
    with pytest.raises(ValueError, match="binary"):
        read_gmsh(path)
    with pytest.raises(ValueError, match="not a Gmsh"):
        (tmp_path / "x.msh").write_text("hello\n")
        read_gmsh(tmp_path / "x.msh")
