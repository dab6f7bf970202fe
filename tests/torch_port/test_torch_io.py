"""Mesh and field I/O of the port (fem/io.py) against the JAX package's.

* read_gmsh reads ASCII v2.2 files written by the JAX package's write_gmsh
  (tets and hexes, with physical groups and names) and gives the same mesh:
  nodes, cells and cell sets equal.
* The port's write_gmsh writes what both readers read back unchanged.
* An ASCII v4.1 file with entity blocks and physical names reads as in JAX.
* Binary v4.1: the port's write_gmsh41_binary round-trips every cell type
  with cell sets and names, reads as the ASCII file of the same mesh does,
  and reads in JAX; a file the JAX package wrote reads in the port as in
  JAX. Binary v2.2 raises ValueError, as in JAX.
* The two faults of the JAX package's binary I/O are not copied: a section
  marker's bytes inside a binary payload are not taken for the section, and
  untagged cells beside a cell set keep no tag.
* write_vtu/read_vtu round-trip a mesh and its point and cell fields bit for
  bit, and read what the JAX package wrote (and the other way round);
  PVDWriter indexes a time series.
"""

import numpy as np
import pytest

from fenics_constitutive_tpu.fem import unit_cube_mesh as jax_cube
from fenics_constitutive_tpu.fem.io import read_gmsh as jax_read
from fenics_constitutive_tpu.fem.io import write_gmsh as jax_write
from fenics_constitutive_tpu.fem.io import read_vtu as jax_read_vtu
from fenics_constitutive_tpu.fem.io import write_gmsh41_binary as jax_write_binary
from fenics_constitutive_tpu.fem.io import write_vtu as jax_write_vtu
from fenics_constitutive_tpu.fem.mesh import Mesh as JMesh
from fenics_constitutive_tpu_torch.fem import (
    Mesh,
    PVDWriter,
    read_gmsh,
    read_vtu,
    unit_cube_mesh,
    unit_interval_mesh,
    unit_square_mesh,
    write_gmsh,
    write_gmsh41_binary,
    write_vtu,
)

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
    """Binary files read now; a binary v2.2 file raises ValueError (as in the
    JAX package, which reads binary v4.1 only), and so does a file without
    $MeshFormat."""
    path = tmp_path / "b.msh"
    jax_write_binary(path, jax_cube(2, 2, 2, "tetra"))
    assert read_gmsh(path).num_cells == 48
    v22 = tmp_path / "b22.msh"
    v22.write_bytes(b"$MeshFormat\n2.2 1 8\n\x01\x00\x00\x00\n$EndMeshFormat\n")
    with pytest.raises(ValueError, match="binary .msh v2.2"):
        read_gmsh(v22)
    with pytest.raises(ValueError, match="not a Gmsh"):
        (tmp_path / "x.msh").write_text("hello\n")
        read_gmsh(tmp_path / "x.msh")


#: one mesh per cell type, small
CELLS = {
    "tetra": lambda: unit_cube_mesh(3, 2, 2, "tetra"),
    "hex": lambda: unit_cube_mesh(3, 2, 2, "hex"),
    "triangle": lambda: unit_square_mesh(3, 2, "triangle"),
    "quad": lambda: unit_square_mesh(3, 2, "quad"),
    "interval": lambda: unit_interval_mesh(6),
}


def blocks(mesh):
    """The mesh with two named regions of contiguous cells (the cell order
    survives the binary writer's one element block per region)."""
    half = mesh.num_cells // 2
    lo = np.arange(half, dtype=np.int32)
    hi = np.arange(half, mesh.num_cells, dtype=np.int32)
    return Mesh(mesh.nodes, mesh.cells, mesh.cell_type,
                cell_sets={1: lo, 2: hi, "soft": lo, "stiff": hi})


@pytest.mark.parametrize("cell_type", sorted(CELLS))
def test_binary_roundtrip_per_cell_type(tmp_path, cell_type):
    mesh = blocks(CELLS[cell_type]())
    binary, ascii_ = tmp_path / "b.msh", tmp_path / "a.msh"
    write_gmsh41_binary(binary, mesh)
    write_gmsh(ascii_, mesh)
    got = read_gmsh(binary)
    assert_same_mesh(got, mesh)
    assert_same_mesh(got, read_gmsh(ascii_))
    assert_same_mesh(got, jax_read(binary))


@pytest.mark.parametrize("cell_type", ["tetra", "hex"])
def test_reads_jax_written_binary(tmp_path, cell_type):
    path = tmp_path / "j.msh"
    jax_write_binary(path, tagged(JMesh, jax_cube(3, 2, 2, cell_type)))
    assert_same_mesh(read_gmsh(path), jax_read(path))


def test_marker_bytes_inside_a_payload(tmp_path):
    """Node coordinates whose bytes spell "$Elements" and "$Nodes" sit in the
    $Entities and $Nodes payloads; the reader walks the sections by their
    counts, so it reads the mesh back exactly."""
    import struct

    mesh = unit_cube_mesh(2, 1, 1, "tetra")
    nodes = mesh.nodes.copy()
    nodes[-1] = struct.unpack("<3d", b"$Elements\n$Nodes\n" + bytes(7))
    planted = Mesh(nodes, mesh.cells, "tetra")
    path = tmp_path / "p.msh"
    write_gmsh41_binary(path, planted)
    data = path.read_bytes()
    assert data.find(b"$Nodes") < data.find(b"$EndEntities")  # inside $Entities
    assert data.find(b"$Elements") < data.find(b"$EndNodes") < data.rfind(b"$Elements")
    got = read_gmsh(path)
    np.testing.assert_array_equal(got.nodes, planted.nodes)
    np.testing.assert_array_equal(got.cells, planted.cells)


def test_binary_parametric_node_block(tmp_path):
    """A node block saved with parametric coordinates (Mesh.SaveParametric)
    stores each node as x y z u v: the reader keeps x y z of every node."""
    import struct

    xyz = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    uv = np.array([[0.5, 0.25], [0.75, 0.125], [0.375, 0.0625], [0.875, 0.5]])
    nodes = b"".join(struct.pack("<5d", *x, *p) for x, p in zip(xyz, uv))
    data = (b"$MeshFormat\n4.1 1 8\n" + struct.pack("<i", 1) + b"\n$EndMeshFormat\n"
            + b"$Nodes\n" + struct.pack("<4Q", 1, 4, 1, 4) + struct.pack("<3i", 2, 1, 1)
            + struct.pack("<Q", 4) + struct.pack("<4Q", 1, 2, 3, 4) + nodes
            + b"\n$EndNodes\n$Elements\n" + struct.pack("<4Q", 1, 2, 1, 2)
            + struct.pack("<3i", 2, 1, 2) + struct.pack("<Q", 2)
            + struct.pack("<8Q", 1, 1, 2, 3, 2, 1, 3, 4) + b"\n$EndElements\n")
    path = tmp_path / "param.msh"
    path.write_bytes(data)
    got = read_gmsh(path)
    np.testing.assert_array_equal(got.nodes[:, :2], xyz[:, :2])
    np.testing.assert_array_equal(got.cells, [[0, 1, 2], [0, 2, 3]])


def test_untagged_cells_beside_a_cell_set(tmp_path):
    """Cells outside every cell set next to a set tagged 3: the untagged
    entity's tag collides with no physical tag, so the set reads back as
    written and the other cells stay untagged."""
    mesh = unit_cube_mesh(2, 2, 2, "tetra")
    tagged3 = np.arange(10, 20, dtype=np.int32)
    path = tmp_path / "u.msh"
    write_gmsh41_binary(path, Mesh(mesh.nodes, mesh.cells, "tetra", cell_sets={3: tagged3}))
    got = read_gmsh(path)
    assert set(got.cell_sets) == {3}
    np.testing.assert_array_equal(got.cells[got.cell_sets[3]], mesh.cells[tagged3])
    assert got.num_cells == mesh.num_cells


def fields(mesh, rng):
    return ({"u": rng.normal(size=(mesh.num_nodes, 3)), "T": rng.normal(size=mesh.num_nodes)},
            {"stress": rng.normal(size=(mesh.num_cells, 6)),
             "alpha": rng.normal(size=mesh.num_cells).astype(np.float32)})


@pytest.mark.parametrize("cell_type", sorted(CELLS))
def test_vtu_roundtrip_bit_equal(tmp_path, cell_type):
    mesh = CELLS[cell_type]()
    pdata, cdata = fields(mesh, np.random.default_rng(4))
    path = tmp_path / "f.vtu"
    write_vtu(path, mesh, pdata, cdata)
    got, p2, c2 = read_vtu(path)
    assert got.cell_type == cell_type
    np.testing.assert_array_equal(got.nodes, mesh.nodes)
    np.testing.assert_array_equal(got.cells, mesh.cells)
    for ref, back in ((pdata, p2), (cdata, c2)):
        assert set(back) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(back[k], np.asarray(v, np.float64))
    mj, pj, cj = jax_read_vtu(path)
    np.testing.assert_array_equal(mj.cells, mesh.cells)
    for k in pdata:
        np.testing.assert_array_equal(pj[k], p2[k])


def test_reads_jax_written_vtu(tmp_path):
    mesh = jax_cube(2, 2, 2, "hex")
    pdata, cdata = fields(mesh, np.random.default_rng(5))
    path = tmp_path / "j.vtu"
    jax_write_vtu(path, mesh, pdata, cdata)
    got, p2, c2 = read_vtu(path)
    np.testing.assert_array_equal(got.cells, mesh.cells)
    np.testing.assert_array_equal(got.nodes, mesh.nodes)
    np.testing.assert_array_equal(p2["u"], pdata["u"])
    np.testing.assert_array_equal(c2["stress"], cdata["stress"])


def test_pvd_series(tmp_path):
    import xml.etree.ElementTree as ET

    mesh = unit_cube_mesh(2, 1, 1, "tetra")
    pvd = PVDWriter(tmp_path / "run.pvd")
    rng = np.random.default_rng(6)
    written = [pvd.write(mesh, time=0.5 * k, point_data={"u": rng.normal(size=(12, 3))})
               for k in range(3)]
    pvd.close()
    sets = ET.parse(tmp_path / "run.pvd").getroot().findall("Collection/DataSet")
    assert [float(d.get("timestep")) for d in sets] == [0.0, 0.5, 1.0]
    assert [d.get("file") for d in sets] == [f"run_{k:06d}.vtu" for k in range(3)]
    assert read_vtu(written[2])[1]["u"].shape == (12, 3)
