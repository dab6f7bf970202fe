"""Gmsh mesh import and export (ASCII).

A mesh is plain arrays, so any reader works by constructing
``Mesh(nodes, cells, cell_type)``; this module reads ASCII Gmsh ``.msh``
files (v2.2 and v4.1, with physical groups as ``mesh.cell_sets``) and writes
ASCII v2.2, as ``fenics_constitutive_tpu.fem.io`` does. Binary ``.msh``
files are refused with a ``ValueError``: their reader is not ported yet.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh

__all__ = ["read_gmsh", "write_gmsh"]

# gmsh element type id -> (cell_type, n_nodes)
_GMSH_TYPES = {
    1: ("interval", 2),
    2: ("triangle", 3),
    3: ("quad", 4),
    4: ("tetra", 4),
    5: ("hex", 8),
}
_GMSH_IDS = {v[0]: k for k, v in _GMSH_TYPES.items()}

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


def read_gmsh(path) -> Mesh:
    """Read an ASCII Gmsh ``.msh`` file (v2.2 or v4.1; highest-dimension
    cells only).

    Physical groups become ``mesh.cell_sets``: a dict mapping each physical
    id (and its ``$PhysicalNames`` name, when present) to the cell indices
    carrying that tag. A binary file raises ``ValueError``.
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
    version, is_binary = fmt[0].decode(), int(fmt[1])
    if is_binary:
        msg = (
            f"{path}: binary .msh v{version}; the binary Gmsh reader (v4.1) is "
            "not yet ported to this package (see ROADMAP.md). Write the mesh "
            "as ASCII (gmsh -format msh22 or msh41 with Mesh.Binary = 0)."
        )
        raise ValueError(msg)
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
