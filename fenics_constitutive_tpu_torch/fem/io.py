"""Mesh and field import and export.

A mesh is plain arrays, so any reader works by constructing
``Mesh(nodes, cells, cell_type)``; this module holds what
``fenics_constitutive_tpu.fem.io`` does:

* ``read_gmsh`` reads Gmsh ``.msh`` files, ASCII v2.2 and v4.1 and binary
  v4.1 (Gmsh's default output), with physical groups as ``mesh.cell_sets``;
* ``write_gmsh`` writes ASCII v2.2 and ``write_gmsh41_binary`` binary v4.1;
* ``write_vtu``/``read_vtu`` write and read VTK XML UnstructuredGrid files
  (ASCII, every float at 17 significant digits, so a field round-trips bit
  for bit) for ParaView, and ``PVDWriter`` keeps a time series of them.

The binary reader walks the file section by section, reading each payload
by its counts, so a marker's bytes inside a payload are never taken for a
section; untagged cells of ``write_gmsh41_binary`` go to an entity whose tag
no cell set uses.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .mesh import Mesh

__all__ = ["PVDWriter", "read_gmsh", "read_vtu", "write_gmsh", "write_gmsh41_binary",
           "write_vtu"]

# gmsh element type id -> (cell_type, n_nodes)
_GMSH_TYPES = {
    1: ("interval", 2),
    2: ("triangle", 3),
    3: ("quad", 4),
    4: ("tetra", 4),
    5: ("hex", 8),
}
_GMSH_IDS = {v[0]: k for k, v in _GMSH_TYPES.items()}

# node counts of the other standard gmsh element types, to skip their records
# in binary files (which have no lines to resynchronise on)
_GMSH_SKIP_NODES = {
    6: 6, 7: 5, 8: 3, 9: 6, 10: 9, 11: 10, 12: 27, 13: 18, 14: 14,
    15: 1, 16: 8, 17: 20, 18: 15, 19: 13,
}

# node-order permutations gmsh -> ours (ours: tensor ordering for quad/hex)
_FROM_GMSH_PERM = {
    "interval": [0, 1],
    "triangle": [0, 1, 2],
    "tetra": [0, 1, 2, 3],
    # gmsh quad: counterclockwise 0,1,2,3; ours: (0,0),(1,0),(0,1),(1,1)
    "quad": [0, 1, 3, 2],
    # gmsh hex: bottom face ccw 0-3, top face ccw 4-7;
    # ours: index = dx + 2 dy + 4 dz
    "hex": [0, 1, 3, 2, 4, 5, 7, 6],
}

_DIM_RANK = {"interval": 1, "triangle": 2, "quad": 2, "tetra": 3, "hex": 3}


class _Scanner:
    """Section-seeking line scanner over the text of a .msh file."""

    def __init__(self, text: str):
        self.lines = [ln.strip() for ln in text.splitlines()]
        self.i = 0

    def seek(self, tag: str) -> bool:
        j = 0
        while j < len(self.lines) and self.lines[j] != tag:
            j += 1
        if j >= len(self.lines):
            return False
        self.i = j + 1
        return True

    def line(self) -> str:
        ln = self.lines[self.i]
        self.i += 1
        return ln


def _read_physical_names(sc: _Scanner) -> dict[tuple[int, int], str]:
    """(dim, physical id) -> name, from an optional $PhysicalNames section."""
    names: dict[tuple[int, int], str] = {}
    if not sc.seek("$PhysicalNames"):
        return names
    n = int(sc.line())
    for _ in range(n):
        parts = sc.line().split(maxsplit=2)
        names[(int(parts[0]), int(parts[1]))] = parts[2].strip().strip('"')
    return names


def _read_gmsh_v22(sc: _Scanner):
    sc.seek("$Nodes")
    n_nodes = int(sc.line())
    nodes = np.zeros((n_nodes, 3))
    id_map: dict[int, int] = {}
    for k in range(n_nodes):
        parts = sc.line().split()
        id_map[int(parts[0])] = k
        nodes[k] = [float(x) for x in parts[1:4]]

    sc.seek("$Elements")
    n_elems = int(sc.line())
    by_type: dict[str, list] = {}
    tags_by_type: dict[str, list] = {}
    for _ in range(n_elems):
        parts = sc.line().split()
        etype = int(parts[1])
        if etype not in _GMSH_TYPES:
            continue
        name, nn = _GMSH_TYPES[etype]
        n_tags = int(parts[2])
        phys = int(parts[3]) if n_tags >= 1 else 0
        conn = [id_map[int(x)] for x in parts[3 + n_tags : 3 + n_tags + nn]]
        by_type.setdefault(name, []).append(conn)
        tags_by_type.setdefault(name, []).append(phys)
    return nodes, by_type, tags_by_type


def _read_gmsh_v41(sc: _Scanner):
    # $Entities maps (dim, entity tag) -> physical tags
    ent_phys: dict[tuple[int, int], int] = {}
    if sc.seek("$Entities"):
        counts = [int(x) for x in sc.line().split()]  # points curves surf vol
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                parts = sc.line().split()
                # points: tag x y z numPhys [...]; others: tag 6-bbox numPhys
                base = 4 if dim == 0 else 7
                n_phys = int(parts[base])
                phys = int(parts[base + 1]) if n_phys >= 1 else 0
                ent_phys[(dim, int(parts[0]))] = phys

    sc.seek("$Nodes")
    hdr = sc.line().split()
    n_blocks, n_nodes = int(hdr[0]), int(hdr[1])
    nodes = np.zeros((n_nodes, 3))
    id_map: dict[int, int] = {}
    pos = 0
    for _ in range(n_blocks):
        n_in = int(sc.line().split()[3])
        tags = [int(sc.line()) for _ in range(n_in)]
        for j, t in enumerate(tags):
            id_map[t] = pos + j
        for j in range(n_in):
            parts = sc.line().split()
            nodes[pos + j] = [float(x) for x in parts[:3]]
        pos += n_in

    sc.seek("$Elements")
    n_blocks = int(sc.line().split()[0])
    by_type: dict[str, list] = {}
    tags_by_type: dict[str, list] = {}
    for _ in range(n_blocks):
        ent_dim, ent_tag, etype, n_in = (int(x) for x in sc.line().split()[:4])
        if etype not in _GMSH_TYPES:
            for _ in range(n_in):
                sc.line()
            continue
        name, nn = _GMSH_TYPES[etype]
        phys = ent_phys.get((ent_dim, ent_tag), 0)
        for _ in range(n_in):
            parts = sc.line().split()
            conn = [id_map[int(x)] for x in parts[1 : 1 + nn]]
            by_type.setdefault(name, []).append(conn)
            tags_by_type.setdefault(name, []).append(phys)
    return nodes, by_type, tags_by_type


class _BinReader:
    """Typed cursor over the raw bytes of a binary .msh file."""

    def __init__(self, data: bytes, off: int, dsize: int, bo: str):
        self.data = data
        self.o = off
        self._i4 = np.dtype(bo + "i4")
        self._sz = np.dtype(bo + ("u8" if dsize == 8 else "u4"))
        self._f8 = np.dtype(bo + "f8")

    def _take(self, dtype, n: int) -> np.ndarray:
        if self.o + dtype.itemsize * n > len(self.data):
            msg = "binary .msh: a section ends before its counts say"
            raise ValueError(msg)
        a = np.frombuffer(self.data, dtype, n, self.o)
        self.o += dtype.itemsize * n
        return a

    def ints(self, n: int) -> np.ndarray:
        return self._take(self._i4, n)

    def sizes(self, n: int) -> np.ndarray:
        return self._take(self._sz, n)

    def doubles(self, n: int) -> np.ndarray:
        return self._take(self._f8, n)


def _line(data: bytes, off: int) -> tuple[bytes, int]:
    """The stripped line starting at ``off`` and the offset past it."""
    end = data.find(b"\n", off)
    end = len(data) if end < 0 else end
    return data[off:end].strip(), end + 1


def _end_marker(data: bytes, off: int, name: bytes) -> int:
    """Offset past the ``$End<name>`` line that must follow at ``off`` (after
    the newline that ends a binary payload)."""
    while off < len(data) and data[off : off + 1] in b" \r\n":
        off += 1
    line, nxt = _line(data, off)
    if line != b"$End" + name:
        msg = f"binary .msh: expected $End{name.decode()} where the ${name.decode()} payload ends"
        raise ValueError(msg)
    return nxt


def _bin_entities(r: _BinReader) -> dict[tuple[int, int], int]:
    """$Entities payload: (dim, entity tag) -> first physical tag."""
    ent_phys: dict[tuple[int, int], int] = {}
    counts = [int(x) for x in r.sizes(4)]  # points curves surfaces volumes
    for dim, cnt in enumerate(counts):
        for _ in range(cnt):
            tag = int(r.ints(1)[0])
            r.doubles(3 if dim == 0 else 6)  # point xyz | bounding box
            n_phys = int(r.sizes(1)[0])
            phys = r.ints(n_phys)
            ent_phys[(dim, tag)] = int(phys[0]) if n_phys else 0
            if dim > 0:
                r.ints(int(r.sizes(1)[0]))  # bounding entities
    return ent_phys


def _bin_nodes(r: _BinReader):
    """$Nodes payload: coordinates [n, 3] and the node-tag -> index map."""
    n_blocks, n_nodes, _min_t, max_t = (int(x) for x in r.sizes(4))
    nodes = np.zeros((n_nodes, 3))
    tag_to_idx = np.full(max_t + 1, -1, np.int64)
    pos = 0
    for _ in range(n_blocks):
        edim, _etag, parametric = (int(x) for x in r.ints(3))
        n_in = int(r.sizes(1)[0])
        tags = r.sizes(n_in).astype(np.int64)
        # node by node: x y z, then edim parametric coordinates (unused)
        width = 3 + (edim if parametric else 0)
        nodes[pos : pos + n_in] = r.doubles(width * n_in).reshape(n_in, width)[:, :3]
        tag_to_idx[tags] = np.arange(pos, pos + n_in)
        pos += n_in
    return nodes, tag_to_idx


def _bin_elements(r: _BinReader, tag_to_idx, ent_phys):
    """$Elements payload: connectivity and physical tag per supported type."""
    n_blocks = int(r.sizes(4)[0])
    by_type: dict[str, list] = {}
    tags_by_type: dict[str, list] = {}
    for _ in range(n_blocks):
        ent_dim, ent_tag, etype = (int(x) for x in r.ints(3))
        n_in = int(r.sizes(1)[0])
        if etype not in _GMSH_TYPES:
            nn = _GMSH_SKIP_NODES.get(etype)
            if nn is None:
                msg = f"binary .msh: unknown element type {etype}"
                raise ValueError(msg)
            r.sizes(n_in * (1 + nn))
            continue
        name, nn = _GMSH_TYPES[etype]
        rows = r.sizes(n_in * (1 + nn)).astype(np.int64).reshape(n_in, 1 + nn)
        phys = ent_phys.get((ent_dim, ent_tag), 0)
        by_type.setdefault(name, []).extend(tag_to_idx[rows[:, 1:]].tolist())
        tags_by_type.setdefault(name, []).extend([phys] * n_in)
    return by_type, tags_by_type


def _read_gmsh_v41_binary(data: bytes, off: int, dsize: int, bo: str):
    """Binary Gmsh v4.1 from ``off`` (past $EndMeshFormat): walks the
    sections in file order, reading each binary payload by its counts and
    checking its $End marker, until $Nodes and $Elements are read.
    ($PhysicalNames stays ASCII in binary files; a section this reader does
    not know is skipped to its $End line, which holds for text sections.)

    Format reference: gmsh.info/doc/texinfo/gmsh.html#MSH-file-format.
    """
    names: dict[tuple[int, int], str] = {}
    ent_phys: dict[tuple[int, int], int] = {}
    nodes = tag_to_idx = elements = None
    while elements is None:
        mark = off
        line, off = _line(data, off)
        if off > len(data):
            msg = "binary .msh: no $Nodes and $Elements sections"
            raise ValueError(msg)
        if not line:
            continue
        if not line.startswith(b"$"):
            msg = f"binary .msh: expected a section marker, found {line[:40]!r}"
            raise ValueError(msg)
        name = line[1:]
        if name == b"PhysicalNames":
            end = data.find(b"\n$EndPhysicalNames", off)
            if end < 0:
                msg = "binary .msh: section $PhysicalNames has no end marker"
                raise ValueError(msg)
            names = _read_physical_names(_Scanner(data[mark:end].decode()))
            off = _end_marker(data, end, name)
        elif name in (b"Entities", b"Nodes", b"Elements"):
            r = _BinReader(data, off, dsize, bo)
            if name == b"Entities":
                ent_phys = _bin_entities(r)
            elif name == b"Nodes":
                nodes, tag_to_idx = _bin_nodes(r)
            elif nodes is None:
                msg = "binary .msh: $Elements before $Nodes"
                raise ValueError(msg)
            else:
                elements = _bin_elements(r, tag_to_idx, ent_phys)
            off = _end_marker(data, r.o, name)
        else:
            end = data.find(b"$End" + name, off)
            if end < 0:
                msg = f"binary .msh: section ${name.decode()} has no end marker"
                raise ValueError(msg)
            off = _line(data, end)[1]
    return names, nodes, *elements


def read_gmsh(path) -> Mesh:
    """Read a Gmsh ``.msh`` file: ASCII v2.2 or v4.1, or binary v4.1
    (highest-dimension cells only).

    Physical groups become ``mesh.cell_sets``: a dict mapping each physical
    id (and its ``$PhysicalNames`` name, when present) to the cell indices
    carrying that tag. A binary file of another version raises ValueError.
    """
    with open(path, "rb") as f:
        data = f.read()
    j = data.find(b"$MeshFormat")
    if j < 0:
        msg = f"{path}: not a Gmsh .msh file (no $MeshFormat)"
        raise ValueError(msg)
    hdr_start = data.index(b"\n", j) + 1
    hdr_end = data.index(b"\n", hdr_start)
    fmt = data[hdr_start:hdr_end].split()
    version, is_binary, dsize = fmt[0].decode(), int(fmt[1]), int(fmt[2])
    if is_binary:
        if not version.startswith("4"):
            msg = f"{path}: binary .msh v{version} not supported (use binary v4.1 or ASCII)"
            raise ValueError(msg)
        # the binary int 1 after the format line gives the byte order
        one_le = int.from_bytes(data[hdr_end + 1 : hdr_end + 5], "little")
        bo = "<" if one_le == 1 else ">"
        off = _end_marker(data, hdr_end + 5, b"MeshFormat")
        names, nodes, by_type, tags_by_type = _read_gmsh_v41_binary(data, off, dsize, bo)
    else:
        text = data.decode()
        names = _read_physical_names(_Scanner(text))
        if version.startswith("2"):
            nodes, by_type, tags_by_type = _read_gmsh_v22(_Scanner(text))
        elif version.startswith("4"):
            nodes, by_type, tags_by_type = _read_gmsh_v41(_Scanner(text))
        else:
            msg = f"{path}: unsupported .msh version {version} (use 2.2 or 4.1)"
            raise ValueError(msg)

    cell_type = max(by_type, key=lambda t: _DIM_RANK[t])
    perm = _FROM_GMSH_PERM[cell_type]
    cells = np.asarray(by_type[cell_type], np.int32)[:, perm]
    tags = np.asarray(tags_by_type[cell_type], np.int64)

    cell_sets: dict = {}
    dim = _DIM_RANK[cell_type]
    for t in np.unique(tags):
        if t == 0:
            continue
        idx = np.nonzero(tags == t)[0].astype(np.int32)
        cell_sets[int(t)] = idx
        if (dim, int(t)) in names:
            cell_sets[names[(dim, int(t))]] = idx

    # drop trailing zero coordinate axes beyond the topological dimension
    return Mesh(
        np.ascontiguousarray(nodes[:, :dim]),
        cells,
        cell_type,
        cell_sets=cell_sets or None,
    )


def write_gmsh(path, mesh: Mesh) -> None:
    """Write an ASCII Gmsh v2.2 ``.msh`` file.

    ``mesh.cell_sets`` (int-keyed entries) become per-cell physical tags;
    str-keyed entries whose indices match an int set become $PhysicalNames,
    so material regions round-trip through write_gmsh/read_gmsh.
    """
    inv = np.argsort(_FROM_GMSH_PERM[mesh.cell_type])
    etype = _GMSH_IDS[mesh.cell_type]
    tags, names = _cell_tags_and_names(mesh)
    dim = _DIM_RANK[mesh.cell_type]
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        if names:
            f.write(f"$PhysicalNames\n{len(names)}\n")
            for ik, nm in sorted(names.items()):
                f.write(f'{dim} {ik} "{nm}"\n')
            f.write("$EndPhysicalNames\n")
        f.write(f"$Nodes\n{mesh.num_nodes}\n")
        for k, p in enumerate(mesh.nodes):
            xyz = list(p) + [0.0] * (3 - mesh.gdim)
            f.write(f"{k + 1} {xyz[0]} {xyz[1]} {xyz[2]}\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{mesh.num_cells}\n")
        for k, c in enumerate(mesh.cells):
            conn = " ".join(str(int(c[j]) + 1) for j in inv)
            f.write(f"{k + 1} {etype} 2 {tags[k]} 0 {conn}\n")
        f.write("$EndElements\n")


def _cell_tags_and_names(mesh: Mesh) -> tuple[np.ndarray, dict[int, str]]:
    """Per-cell physical tags + id -> name map from ``mesh.cell_sets``."""
    tags = np.zeros(mesh.num_cells, np.int64)
    names: dict[int, str] = {}
    if mesh.cell_sets:
        for key, idx in mesh.cell_sets.items():
            if isinstance(key, int):
                tags[np.asarray(idx)] = key
        for key, idx in mesh.cell_sets.items():
            if isinstance(key, str):
                for ik, iidx in mesh.cell_sets.items():
                    if isinstance(ik, int) and np.array_equal(iidx, idx):
                        names[ik] = key
                        break
    return tags, names


def write_gmsh41_binary(path, mesh: Mesh) -> None:
    """Write a binary Gmsh v4.1 ``.msh`` file (Gmsh's default output format).

    One entity per physical tag (the int keys of ``mesh.cell_sets``), whose
    entity tag is the physical tag; untagged cells go to an entity without a
    physical group, tagged one past the largest physical tag so that it
    collides with none. One node block and one element block per entity,
    the structure ``read_gmsh`` reads back, so cell sets and names
    round-trip.
    """
    dim = _DIM_RANK[mesh.cell_type]
    etype = _GMSH_IDS[mesh.cell_type]
    inv = np.argsort(_FROM_GMSH_PERM[mesh.cell_type])
    tags, names = _cell_tags_and_names(mesh)

    def sz(*vals):  # size_t = 8 bytes little-endian
        return struct.pack(f"<{len(vals)}Q", *vals)

    def i4(*vals):
        return struct.pack(f"<{len(vals)}i", *vals)

    pts3 = np.zeros((mesh.num_nodes, 3))
    pts3[:, : mesh.gdim] = mesh.nodes
    lo, hi = pts3.min(axis=0), pts3.max(axis=0)

    phys_tags = sorted({int(t) for t in np.unique(tags)})
    untagged = max(phys_tags) + 1  # the entity tag of untagged cells
    ent = {t: (t if t != 0 else untagged) for t in phys_tags}
    with open(path, "wb") as f:
        f.write(b"$MeshFormat\n4.1 1 8\n")
        f.write(struct.pack("<i", 1))
        f.write(b"\n$EndMeshFormat\n")
        if names:
            f.write(f"$PhysicalNames\n{len(names)}\n".encode())
            for ik, nm in sorted(names.items()):
                f.write(f'{dim} {ik} "{nm}"\n'.encode())
            f.write(b"$EndPhysicalNames\n")

        # counts are numPoints numCurves numSurfaces numVolumes
        counts = [0, 0, 0, 0]
        counts[dim] = len(phys_tags)
        f.write(b"$Entities\n")
        f.write(sz(*counts))
        for t in phys_tags:
            f.write(i4(ent[t]))
            f.write(struct.pack("<6d", *lo, *hi))
            f.write(sz(1) + i4(t) if t != 0 else sz(0))
            f.write(sz(0))  # no bounding entities
        f.write(b"\n$EndEntities\n")

        f.write(b"$Nodes\n")
        f.write(sz(1, mesh.num_nodes, 1, mesh.num_nodes))
        f.write(i4(dim, ent[phys_tags[0]], 0))
        f.write(sz(mesh.num_nodes))
        f.write(np.arange(1, mesh.num_nodes + 1, dtype="<u8").tobytes())
        f.write(pts3.astype("<f8").tobytes())
        f.write(b"\n$EndNodes\n")

        f.write(b"$Elements\n")
        f.write(sz(len(phys_tags), mesh.num_cells, 1, mesh.num_cells))
        conn_g = mesh.cells[:, inv].astype(np.int64) + 1
        for t in phys_tags:
            idx = np.nonzero(tags == t)[0]
            f.write(i4(dim, ent[t], etype))
            f.write(sz(len(idx)))
            rows = np.empty((len(idx), 1 + conn_g.shape[1]), "<u8")
            rows[:, 0] = idx + 1  # element tags
            rows[:, 1:] = conn_g[idx]
            f.write(rows.tobytes())
        f.write(b"\n$EndElements\n")


# -- VTU (VTK XML UnstructuredGrid) ------------------------------------------------

# VTK cell type ids; VTK's node order is gmsh's, so ours -> VTK is the
# inverse of _FROM_GMSH_PERM
_VTK_TYPES = {"interval": 3, "triangle": 5, "quad": 9, "tetra": 10, "hex": 12}
_VTK_NAMES = {v: k for k, v in _VTK_TYPES.items()}


def _as_fields(data: dict | None, n: int, what: str) -> dict[str, np.ndarray]:
    """name -> [n] or [n, ...] arrays as float64 [n, comps]."""
    out = {}
    for name, arr in (data or {}).items():
        a = np.asarray(arr, dtype=np.float64)
        a = a.reshape(a.shape[0], -1) if a.ndim else a.reshape(1, 1)
        if a.shape[0] != n:
            msg = f"{what}[{name!r}] has {a.shape[0]} rows, the mesh has {n}"
            raise ValueError(msg)
        out[name] = a
    return out


def _write_darray(f, name: str, arr: np.ndarray, kind: str) -> None:
    comps = arr.shape[1]
    f.write(f'        <DataArray type="{kind}" Name="{name}" '
            f'NumberOfComponents="{comps}" format="ascii">\n')
    fmt = "%d" if kind.startswith(("Int", "UInt")) else "%.17g"
    for row in np.asarray(arr):
        f.write("          " + " ".join(fmt % x for x in row) + "\n")
    f.write("        </DataArray>\n")


def write_vtu(path, mesh: Mesh, point_data: dict | None = None,
              cell_data: dict | None = None) -> None:
    """Write a VTK XML UnstructuredGrid (.vtu) file for ParaView.

    Args:
        mesh: the mesh (P1 geometry; for a P2 field pass the values at the
            mesh vertices).
        point_data: name -> [num_nodes] or [num_nodes, k] arrays.
        cell_data: name -> [num_cells] or [num_cells, ...] arrays (e.g. the
            QP-averaged Mandel stress ``stress.mean(axis=1)``).
    Values are written as float64 at 17 significant digits, so ``read_vtu``
    gives them back bit for bit.
    """
    pdata = _as_fields(point_data, mesh.num_nodes, "point_data")
    cdata = _as_fields(cell_data, mesh.num_cells, "cell_data")
    pts3 = np.zeros((mesh.num_nodes, 3))
    pts3[:, : mesh.gdim] = mesh.nodes
    conn = mesh.cells[:, np.argsort(_FROM_GMSH_PERM[mesh.cell_type])]
    npc = mesh.cells.shape[1]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="UnstructuredGrid" version="0.1" byte_order="LittleEndian">\n')
        f.write("  <UnstructuredGrid>\n")
        f.write(f'    <Piece NumberOfPoints="{mesh.num_nodes}" '
                f'NumberOfCells="{mesh.num_cells}">\n')
        f.write("      <Points>\n")
        _write_darray(f, "Points", pts3, "Float64")
        f.write("      </Points>\n")
        f.write("      <Cells>\n")
        _write_darray(f, "connectivity", conn.astype(np.int64), "Int64")
        offsets = np.arange(1, mesh.num_cells + 1, dtype=np.int64) * npc
        _write_darray(f, "offsets", offsets[:, None], "Int64")
        types = np.full((mesh.num_cells, 1), _VTK_TYPES[mesh.cell_type], np.uint8)
        _write_darray(f, "types", types, "UInt8")
        f.write("      </Cells>\n")
        for tag, fields in (("PointData", pdata), ("CellData", cdata)):
            f.write(f"      <{tag}>\n")
            for name, a in fields.items():
                _write_darray(f, name, a, "Float64")
            f.write(f"      </{tag}>\n")
        f.write("    </Piece>\n")
        f.write("  </UnstructuredGrid>\n")
        f.write("</VTKFile>\n")


def read_vtu(path) -> tuple[Mesh, dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Read an ASCII .vtu of one cell type, as ``write_vtu`` writes it.

    Returns (mesh, point_data, cell_data); single-component fields come back
    as 1D arrays.
    """
    import xml.etree.ElementTree as ET

    piece = ET.parse(path).getroot().find("UnstructuredGrid/Piece")

    def parse(el, dtype):
        vals = np.array(el.text.split(), dtype=dtype)
        return vals.reshape(-1, int(el.get("NumberOfComponents", "1")))

    pts = parse(piece.find("Points/DataArray"), np.float64)
    arrays = {el.get("Name"): el for el in piece.findall("Cells/DataArray")}
    conn = parse(arrays["connectivity"], np.int64)
    cell_type = _VTK_NAMES[int(parse(arrays["types"], np.int64)[0, 0])]
    perm = _FROM_GMSH_PERM[cell_type]
    cells = conn.reshape(-1, len(perm))[:, perm].astype(np.int32)
    mesh = Mesh(np.ascontiguousarray(pts[:, : _DIM_RANK[cell_type]]), cells, cell_type)

    def fields(tag):
        out = {}
        for el in piece.findall(f"{tag}/DataArray"):
            a = parse(el, np.float64)
            out[el.get("Name")] = a[:, 0] if a.shape[1] == 1 else a
        return out

    return mesh, fields("PointData"), fields("CellData")


class PVDWriter:
    """ParaView .pvd time-series index over per-step .vtu files, written
    next to it as ``<base>_000000.vtu``, ... The index is rewritten after
    every step, so it is valid whenever a run stops.

    Example::

        pvd = PVDWriter("out/run.pvd")
        for step in ...:
            ...solve...
            pvd.write(mesh, time=t, point_data={"u": u.reshape(-1, 3)})
        pvd.close()
    """

    def __init__(self, path):
        self.path = str(path)
        self.base, _ = os.path.splitext(self.path)
        self.entries: list[tuple[float, str]] = []

    def write(self, mesh, time, point_data=None, cell_data=None) -> str:
        """Write one step's .vtu and index it at ``time``; returns its path."""
        fname = f"{self.base}_{len(self.entries):06d}.vtu"
        write_vtu(fname, mesh, point_data, cell_data)
        self.entries.append((float(time), os.path.basename(fname)))
        self.close()
        return fname

    def close(self) -> None:
        """Write the index of the steps so far."""
        with open(self.path, "w") as f:
            f.write('<?xml version="1.0"?>\n')
            f.write('<VTKFile type="Collection" version="0.1" byte_order="LittleEndian">\n'
                    "  <Collection>\n")
            for t, name in self.entries:
                f.write(f'    <DataSet timestep="{t!r}" part="0" file="{name}"/>\n')
            f.write("  </Collection>\n</VTKFile>\n")
