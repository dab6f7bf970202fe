"""Sharding of ``IncrSmallStrainProblem`` and of the packed step over the
ranks of a ``torch.distributed`` process group.

The reference splits its mesh over MPI ranks and accumulates ghost
contributions after every assembly; the JAX package shards per-cell arrays
over a device mesh and lets XLA insert the all-reduce. Here one process runs
per rank, as the reference runs under ``mpirun``; the caller starts the
ranks (``torch.multiprocessing``, ``torchrun``) and initialises the process
group. Then:

* **the split** is a pure function of the mesh, the law's cells and the
  world size, so every rank computes every rank's part alone: a contiguous
  range of each law's cells in its engine's own cell order (mesh order on
  the AoS and gather engines, the windowed plan's order, slabs of cell
  layers along the slowest grid axis on the box engines);
* **state is rank-local**: stress, tangents, histories and the geometry
  tables hold the rank's cells only (``slab_geometry`` on a box, a plan of
  the rank's cells on its window of the whole RCM order, a gather geometry
  of its cells), about 1/n of the whole;
* **dof vectors are replicated**: ``u``, ``u_prev``, ``f_ext``, every CG
  vector and the preconditioner's input and output are whole on every rank,
  so CG's dots stay local and every host decision (Newton's ||r||, the line
  search, an adaptive CG's exit) reads the same values on every rank;
* **the all-reduce points**: a rank's residual, operator apply and Jacobi
  diagonal are summed by one ``all_reduce(SUM)``, whose result every rank
  receives bit for bit: a full-length vector of the engine's working layout
  (AoS, gather, windowed), or on a box the element arrays before assembly,
  which every rank then assembles whole, so that a box's sums round as in
  one process;
* **observation is whole**: stress, histories, ``dxm``, the displacement
  gradient and checkpoints gather the ranks' cells with ``all_gather`` and
  place them by index (no float sum), so they equal the one-process values.

The code calls ``torch.distributed`` collectives on the default group and
nothing else, so it does not depend on the backend; the tests run gloo on
the CPU, and gloo's collectives accept CUDA tensors too.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F_nn

from ..ops.packed import CellSlots, build_packed_geometry
from ..ops.structured import slab_geometry
from ..ops.windowed import build_windowed_geometry
from ..solver.packed_step import PackedState

__all__ = [
    "DeviceMesh",
    "LawShard",
    "make_device_mesh",
    "shard_packed_state",
    "shard_problem",
    "whole_packed_state",
]


#: collectives issued through a DeviceMesh in this process, by kind
collectives = {"all_reduce": 0, "all_gather": 0}


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A 1-D mesh over the ranks of the initialised (default) process group:
    this rank, the world size and the device this rank computes on."""

    rank: int
    size: int
    device: torch.device
    axis: str = "cells"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks, in place and returned; every rank
        receives the same values."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM)
        collectives["all_reduce"] += 1
        return x

    def all_gather(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (one shape on every rank), in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        collectives["all_gather"] += 1
        return parts


def make_device_mesh(n_devices: int | None = None, axis: str = "cells", *,
                     device=None) -> DeviceMesh:
    """Describe the initialised process group as a 1-D mesh.

    ``n_devices``, when given, must equal the group's world size. ``device``
    (default, or "cuda" without an index) is ``cuda:{rank % device_count}``,
    so several ranks may share a card; pass ``device="cpu"`` to shard on the
    CPU.
    """
    if not dist.is_available() or not dist.is_initialized():
        msg = ("make_device_mesh describes an initialised process group: call "
               "torch.distributed.init_process_group in every rank first")
        raise RuntimeError(msg)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        msg = f"n_devices={n_devices}, but the process group has {size} ranks"
        raise ValueError(msg)
    if device is None:
        if not torch.cuda.is_available():
            msg = "no CUDA device: pass device='cpu' to shard on the CPU"
            raise RuntimeError(msg)
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":  # the rank's current card, its CUDA state set up
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.cuda.init()
    return DeviceMesh(rank=rank, size=size, device=device, axis=axis)


@dataclasses.dataclass(frozen=True)
class LawShard:
    """One law's split: ``pos[r]`` lists, in rank r's own order, the
    positions of rank r's cells in the law's dense cell axis (the order of
    its histories and of ``extract_cells``)."""

    mesh: DeviceMesh
    pos: tuple
    n_cells: int

    @property
    def mine(self) -> np.ndarray:
        return self.pos[self.mesh.rank]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows ``[len(mine), ...]`` -> the whole law's
        ``[n_cells, ...]``: every rank's rows, placed by index."""
        n_max = max(len(p) for p in self.pos)
        pad = x.new_zeros((n_max, *x.shape[1:]))
        pad[: len(x)] = x
        out = x.new_empty((self.n_cells, *x.shape[1:]))
        for p, part in zip(self.pos, self.mesh.all_gather(pad)):
            out[torch.as_tensor(p, device=x.device)] = part[: len(p)]
        return out


# -- the split -------------------------------------------------------------------


def _ranges(n: int, size: int, what: str) -> list:
    """``size`` contiguous, non-empty, balanced ranges of ``range(n)``."""
    if n < size:
        msg = (f"{what}: {n} cannot be split over {size} ranks; every rank needs at "
               "least one (use fewer ranks)")
        raise ValueError(msg)
    edges = np.linspace(0, n, size + 1).round().astype(np.int64)
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def _cell_layer(geo) -> np.ndarray:
    """The axis-0 cell layer of each cell of a box geometry's dense cell axis."""
    n_plane = int(np.prod(geo.grid[1:]))
    if geo.engine == "lattice":
        return np.arange(geo.n_cells) // n_plane
    plane = int(np.prod([g + 1 for g in geo.grid[1:]]))
    origin_layer = geo.cell_index.cpu().numpy() // plane
    if geo.engine == "structured":
        return origin_layer
    K = geo.n_classes
    if geo.tet_index is None:
        return np.repeat(origin_layer, K)
    return (geo.tet_index.cpu().numpy() // K) // n_plane


# -- rank-local geometries behind the whole geometry's ops --------------------------

#: attributes a wrapper reads from its rank-local geometry
_LOCAL = frozenset({"engine", "constraint", "n_qp", "dtype", "device", "qp_shape",
                    "extract_cells", "insert_cells"})


class _Sharded:
    """Common part of the wrappers: ``local`` (the rank's geometry), ``law``
    (its LawShard), ``layout`` (the whole law's ``extract_cells``/
    ``insert_cells``, for whole-layout state: the whole box geometry, or the
    ``CellSlots`` of the whole windowed plan or gather geometry)."""

    sharded = True

    def __init__(self, local, law: LawShard, layout):
        self.local, self.law, self.layout = local, law, layout

    @property
    def mesh(self) -> DeviceMesh:
        return self.law.mesh

    def __getattr__(self, name):
        if name in _LOCAL:
            return getattr(self.local, name)
        msg = f"{type(self).__name__} has no attribute {name!r}"
        raise AttributeError(msg)

    def local_nodes(self, u: torch.Tensor) -> torch.Tensor:
        """A whole node-major vector -> the local geometry's (observation)."""
        return u


class ShardedBox(_Sharded):
    """A rank's slab of a box geometry (structured, structured-tet,
    lattice) behind the whole box's grid-major ops. The slab's nodes are the
    flat range ``[lo, lo + M_s)`` of each component, and its element arrays
    (one column per cell origin, per cell on the lattice) are the columns
    ``[c0, c1)`` of the whole box's.

    A residual, operator apply or Jacobi diagonal all-reduces the element
    arrays, each column nonzero on one rank only, and assembles them whole on
    every rank: every node's terms are added in the one-process order, so
    the results are the one-process results bit for bit. (Summing the ranks'
    assembled vectors instead rounds the nodes of a slab boundary
    differently; on a singular tangent, hexes at q 1, that rounding puts a
    part of the right-hand side outside the operator's range, and CG
    diverges.)"""

    def __init__(self, local, lo: int, cols: tuple, whole, law: LawShard):
        super().__init__(local, law, whole)
        self.lo, self.M_s = lo, local.M
        self.c0, self.c1 = cols
        self.n_cols = whole.n_cells if whole.engine == "lattice" else whole.M
        self.M, self.vs, self.ndofs = whole.M, whole.vs, whole.ndofs

    def to_grid_major(self, u: torch.Tensor) -> torch.Tensor:
        return u.reshape(self.M, self.vs).T.reshape(-1)

    def to_node_major(self, u_gm: torch.Tensor) -> torch.Tensor:
        return u_gm.reshape(self.vs, self.M).T.reshape(-1)

    def _cut(self, v_gm: torch.Tensor) -> torch.Tensor:
        return v_gm.reshape(self.vs, self.M)[:, self.lo : self.lo + self.M_s].reshape(-1)

    def _assemble(self, f_loc: torch.Tensor) -> torch.Tensor:
        f = f_loc.new_zeros((f_loc.shape[0], self.n_cols))
        f[:, self.c0 : self.c1] = f_loc[:, : self.c1 - self.c0]
        return self.layout.assemble_gm(self.mesh.all_reduce(f))

    def strain_gm(self, u_gm: torch.Tensor) -> torch.Tensor:
        return self.local.strain_gm(self._cut(u_gm))

    def residual_gm(self, sigma: torch.Tensor) -> torch.Tensor:
        return self._assemble(self.local.element_forces_gm(sigma))

    def matvec_gm(self, v_gm: torch.Tensor, tangent) -> torch.Tensor:
        sigma = tangent.apply(self.local.strain_gm(self._cut(v_gm)))
        return self._assemble(self.local.element_forces_gm(sigma))

    def jacobi_diag_gm(self, tangent) -> torch.Tensor:
        return self._assemble(self.local.element_diag_gm(tangent))

    def local_nodes(self, u: torch.Tensor) -> torch.Tensor:
        return u.reshape(self.M, self.vs)[self.lo : self.lo + self.M_s].reshape(-1)


class ShardedWindowed(_Sharded):
    """A rank's windowed plan on the window ``[n0, n1)`` of the whole RCM
    order, behind the whole internal layout ``[vs, M_pad]``."""

    def __init__(self, local, n0: int, whole, law: LawShard):
        super().__init__(local, law, whole.slots)
        self.n0, self.n1 = n0, n0 + local.M
        self.vs, self.M, self.ndofs, self.M_pad = whole.vs, whole.M, whole.ndofs, whole.ex.M_pad
        self.perm_dev, self.invperm_dev = whole.perm_dev, whole.invperm_dev

    @property
    def ndofs_int(self) -> int:
        return self.vs * self.M_pad

    # the whole internal layout's boundary transforms (WindowedGeometry's)
    def to_internal(self, u: torch.Tensor) -> torch.Tensor:
        out = u.new_zeros((self.vs, self.M_pad))
        out[:, : self.M] = u.reshape(self.M, self.vs).T[:, self.invperm_dev]
        return out.reshape(-1)

    def from_internal(self, ui: torch.Tensor) -> torch.Tensor:
        return ui.reshape(self.vs, self.M_pad)[:, self.perm_dev].T.reshape(-1)

    def bc_internal(self, bc_dofs: torch.Tensor) -> torch.Tensor:
        return (bc_dofs % self.vs) * self.M_pad + self.perm_dev[bc_dofs // self.vs]

    def free_internal(self, bc_dofs: torch.Tensor) -> torch.Tensor:
        valid = torch.zeros(self.M_pad, dtype=torch.bool, device=self.device)
        valid[: self.M] = True
        free = valid.repeat(self.vs)
        free[self.bc_internal(bc_dofs)] = False
        return free

    def _cut(self, v: torch.Tensor) -> torch.Tensor:
        w = v.reshape(self.vs, self.M_pad)[:, self.n0 : self.n1]
        return F_nn.pad(w, (0, self.local.ex.M_pad - self.local.M)).reshape(-1)

    def _sum(self, r_loc: torch.Tensor) -> torch.Tensor:
        out = r_loc.new_zeros((self.vs, self.M_pad))
        out[:, self.n0 : self.n1] = r_loc.reshape(self.vs, -1)[:, : self.local.M]
        return self.mesh.all_reduce(out).reshape(-1)

    def strain(self, du: torch.Tensor) -> torch.Tensor:
        return self.local.strain(self._cut(du))

    def residual(self, sigma: torch.Tensor) -> torch.Tensor:
        return self._sum(self.local.residual(sigma))

    def matvec(self, v: torch.Tensor, tangent) -> torch.Tensor:
        return self._sum(self.local.matvec(self._cut(v), tangent))

    def jacobi_diag(self, tangent) -> torch.Tensor:
        return self._sum(self.local.jacobi_diag(tangent))


class ShardedGather(_Sharded):
    """A rank's gather geometry of its cells: node-major throughout."""

    def __init__(self, local, law: LawShard):
        super().__init__(local, law, CellSlots(local.n_qp, law.n_cells))
        self.vs, self.ndofs = local.vs, local.ndofs

    def strain(self, u: torch.Tensor) -> torch.Tensor:
        return self.local.strain(u)

    def residual(self, sigma: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(self.local.residual(sigma))

    def matvec(self, v: torch.Tensor, tangent) -> torch.Tensor:
        return self.mesh.all_reduce(self.local.matvec(v, tangent))

    def jacobi_diag(self, tangent) -> torch.Tensor:
        return self.mesh.all_reduce(self.local.jacobi_diag(tangent))


def _check_device(device, mesh: DeviceMesh, what: str) -> None:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:  # the current card
        device = torch.device("cuda", torch.cuda.current_device())
    if device != mesh.device:
        msg = f"the {what} lives on {device}, the mesh's rank computes on {mesh.device}"
        raise ValueError(msg)


def _shard_geometry(geo, mesh: DeviceMesh):
    """The rank's wrapped part of one law's packed geometry."""
    if getattr(geo, "sharded", False):
        msg = "the geometry is sharded already"
        raise ValueError(msg)
    _check_device(geo.device, mesh, "geometry")
    if geo.engine in ("structured", "structured_tet", "lattice"):
        slabs = _ranges(geo.grid[0], mesh.size, "the cell layers of the box's first axis")
        layer = _cell_layer(geo)
        pos = tuple(np.flatnonzero((layer >= a) & (layer < b)) for a, b in slabs)
        x0, x1 = slabs[mesh.rank]
        local, lo, mine = slab_geometry(geo, x0, x1)
        assert np.array_equal(mine, pos[mesh.rank])
        # element-array columns of one cell layer: cells on the lattice, cell
        # origins (nodes) otherwise
        width = int(np.prod(geo.grid[1:] if geo.engine == "lattice"
                            else [g + 1 for g in geo.grid[1:]]))
        return ShardedBox(local, lo, (x0 * width, x1 * width), geo,
                          LawShard(mesh, pos, int(len(layer))))
    source = getattr(geo, "law_source", None)
    if source is None:
        msg = ("a windowed or gather geometry is sharded from its law's cells: build it "
               "through build_packed_problem")
        raise ValueError(msg)
    space, q_degree, cells = source
    opts = dict(device=mesh.device, dtype=geo.dtype)
    if geo.engine == "gather":
        pos = tuple(np.arange(a, b) for a, b in _ranges(len(cells), mesh.size, "the law's cells"))
        local = build_packed_geometry(space, q_degree, geo.constraint, cells[pos[mesh.rank]],
                                      **opts)
        return ShardedGather(local, LawShard(mesh, pos, len(cells)))
    # windowed: the plan's order (cells by their lowest RCM node), and the
    # rank's window of the whole RCM order
    perm = geo.ex.perm
    rcm = perm[space.cell_dof_nodes[cells]]
    order = np.argsort(rcm.min(axis=1), kind="stable")
    pos = tuple(order[a:b] for a, b in _ranges(len(cells), mesh.size, "the law's cells"))
    nodes = rcm[pos[mesh.rank]]
    n0, n1 = int(nodes.min()), int(nodes.max()) + 1
    local = build_windowed_geometry(space, q_degree, geo.constraint, cells[pos[mesh.rank]],
                                    tile=geo.ex.T, perm=perm, node_range=(n0, n1), **opts)
    return ShardedWindowed(local, n0, geo, LawShard(mesh, pos, len(cells)))


def _local_field(geo: _Sharded, field: torch.Tensor) -> torch.Tensor:
    """A QP field of the whole law's layout -> the rank's layout."""
    dense = geo.layout.extract_cells(field)
    return geo.local.insert_cells(dense[:, :, torch.as_tensor(geo.law.mine, device=field.device)])


def _whole_field(geo: _Sharded, field: torch.Tensor) -> torch.Tensor:
    """A QP field of the rank's layout -> the whole law's (every rank)."""
    dense = geo.local.extract_cells(field).permute(2, 0, 1)
    return geo.layout.insert_cells(geo.law.gather(dense).permute(1, 2, 0).contiguous())


def _map_state(fn, geos, stresses, histories) -> tuple:
    stress = tuple(fn(g, s) for g, s in zip(geos, stresses))
    hists = tuple(None if h is None else {k: fn(g, v) for k, v in h.items()}
                  for g, h in zip(geos, histories))
    return stress, hists


def shard_packed_state(geos: tuple, state: PackedState, mesh: DeviceMesh) -> tuple:
    """``(geos, state)`` of ``build_packed_problem`` -> the rank's
    ``(geos, state)``: wrapped rank-local geometries and a PackedState whose
    stress and histories hold the rank's cells, so ``make_packed_step`` runs
    sharded as it is. ``state.u`` stays whole (internal on the windowed
    engine, as in one process)."""
    wrapped = tuple(_shard_geometry(g, mesh) for g in geos)
    stress, hists = _map_state(_local_field, wrapped, state.stress, state.histories)
    return wrapped, PackedState(u=state.u, stress=stress, histories=hists, t=state.t)


def whole_packed_state(geos: tuple, state: PackedState) -> PackedState:
    """The inverse of ``shard_packed_state``'s state map: the whole
    problem's PackedState, the same on every rank (a collective)."""
    stress, hists = _map_state(_whole_field, geos, state.stress, state.histories)
    return PackedState(u=state.u, stress=stress, histories=hists, t=state.t)


# -- IncrSmallStrainProblem ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProblemShard:
    """What a sharded IncrSmallStrainProblem keeps of its split: the mesh and
    one LawShard per law."""

    mesh: DeviceMesh
    laws: tuple

    # -- whole-problem state (observation, checkpoints) ---------------------------

    def whole_state(self, problem, stress, histories) -> tuple:
        """The rank-local (stress, histories) -> the one-process layout."""
        if problem.engine == "packed":
            return _map_state(_whole_field, problem._pk_geos, stress, histories)
        return problem._aos_whole_stress(stress), tuple(problem._aos_histories(histories))

    def whole_like(self, problem) -> tuple:
        """Zero (stress, histories) of the one-process layout (no collective)."""
        if problem.engine == "packed":
            def zero(g, f):
                k, Q = f.shape[0], g.n_qp
                return g.layout.insert_cells(f.new_zeros((k, Q, g.law.n_cells)))

            return _map_state(zero, problem._pk_geos, problem._stress_prev, problem._histories)
        C = problem.space.mesh.num_cells
        stress = problem._stress_prev.new_zeros((C, *problem._stress_prev.shape[1:]))
        hists = tuple(
            None if h is None else {
                k: v.new_zeros((law.n_cells * problem._n_qp, *v.shape[1:])) for k, v in h.items()
            }
            for law, h in zip(self.laws, problem._histories)
        )
        return stress, hists

    def local_state(self, problem, stress, histories) -> tuple:
        """The one-process layout's (stress, histories) -> the rank's."""
        if problem.engine == "packed":
            return _map_state(_local_field, problem._pk_geos, stress, histories)
        Q = problem._n_qp
        rows = [stress[torch.as_tensor(cells[law.mine], device=stress.device)]
                for law, cells in zip(self.laws, problem._law_cells)]

        def mine(law, v):
            blk = v.reshape(law.n_cells, Q, *v.shape[1:])
            blk = blk[torch.as_tensor(law.mine, device=v.device)]
            return blk.reshape(-1, *v.shape[1:])

        hists = tuple(None if h is None else {k: mine(law, v) for k, v in h.items()}
                      for law, h in zip(self.laws, histories))
        return torch.cat(rows), hists


def shard_problem(problem, mesh: DeviceMesh, axis: str = "cells") -> None:
    """Shard an ``IncrSmallStrainProblem`` in place over ``mesh``'s ranks.

    Call it in every rank on the same problem (built from the same inputs);
    from then on ``solve()``/``update()`` run as one SPMD program whose
    ranks hold their own cells and exchange full-length dof vectors at the
    all-reduce points. Works on both engines and every packed engine
    (structured, structured-tet, lattice, windowed, gather). Raises
    ValueError when a law has fewer cells (or a box fewer cell layers) than
    the mesh has ranks. The committed state is carried over, so a problem
    may be sharded after some steps; the trial state of a step in progress
    is dropped.
    """
    if getattr(problem, "_shard", None) is not None:
        msg = "the problem is sharded already"
        raise ValueError(msg)
    if axis != mesh.axis:
        msg = f"axis {axis!r} is not the mesh's axis {mesh.axis!r}"
        raise ValueError(msg)
    _check_device(problem.device, mesh, "problem")
    if problem.engine == "packed":
        geos = tuple(_shard_geometry(g, mesh) for g in problem._pk_geos)
        stress, hists = _map_state(_local_field, geos, problem._stress_prev, problem._histories)
        problem._pk_geos = geos
        shard = ProblemShard(mesh, tuple(g.law for g in geos))
    else:
        laws = tuple(
            LawShard(mesh, tuple(np.arange(a, b) for a, b in
                                 _ranges(len(c), mesh.size, "the law's cells")), len(c))
            for c in problem._law_cells
        )
        shard = ProblemShard(mesh, laws)
        stress, hists = shard.local_state(problem, problem._stress_prev, problem._histories)
    problem._shard = shard
    problem._stress_prev = problem._stress_curr = stress
    problem._histories = problem._histories_trial = hists
    problem._law_data_cache = None
    problem._dxm = None
    problem._tangents = None
