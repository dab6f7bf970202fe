"""Fused multigrid smoothing: hand-written CUDA kernels (K3) and their plain
twins.

``build_fused_smoother(geo, ke, inv_d, mask, nu=, zero_start=, emit_residual=)``
returns one level's damped-Jacobi chain ``x <- x + inv_d * (b - A x)``, ``nu``
sweeps of the constant-coefficient elastic operator ``A`` (element matrix
``ke`` on the masked corner dofs of ``geo``), optionally followed by the
free-masked residual ``[inv_d != 0] * (b - A x)``. The semantics are those of
the JAX package's ``ops/pallas_smoother.py::build_fused_smoother``:

* ``inv_d`` is zero at Dirichlet dofs, so ``x`` stays zero there and ``b``
  is never read there;
* a zero start makes the first sweep ``inv_d * b``, with no operator apply;
* cells are masked by ``mask`` on the gathered corner values.

``FusedVcycle`` runs a whole V-cycle of such chains with the transfers (R =
P^T trilinear, the free masks) and the coarse solve, through three entries:

* ``pre_restrict(lvl, b) -> (x, b_coarse)``: the pre-chain, its residual and
  the residual's restriction to the next level's right-hand side;
* ``prolong_post(lvl, x, b, xc) -> x``: ``x + [free] P xc``, then the
  post-chain;
* ``tail(b, lvl) -> x``: the V-cycle from level ``lvl`` down, coarse solve
  included.

The kernels take the levels of 3D hex hierarchies and of 2D quad hierarchies
(the corner layouts of the structured engine, and of the structured-tet
engine's corner channels); any other level raises ValueError on the card.
On CUDA tensors each of them, and each ``FusedChain`` call, is ONE launch of
``csrc/smoother.cu``: a cooperative launch with grid-wide barriers between
the sweeps for a fine level's chain, one block in shared memory for the tail.
The V-cycle runs ``pre_restrict`` on the levels above the tail's first level
(``tail_start``, from the level sizes, the type and the shared memory the
card holds per block), one ``tail``, then ``prolong_post`` upwards: 5 launches
on the 50^3 hierarchy. A chain on a level large enough (``brick_plan``: the
51^3 and 65^3 fine levels) runs its sweeps and residual on bricks of staged
nodes, 4-node runs a thread, in the same one launch; ``brick_launches``
counts those launches. On CPU tensors every entry runs its plain PyTorch twin
(``*_plain``, and ``plain`` for the tail and the whole cycle), and on the card
nothing calls the twins: an unsupported input there raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ._cuda_build import entry_point, launch_check, launched, load_library
from .cuda_matvec import hex_corner_layout
from .structured import StructuredGeometry, _matmul

__all__ = [
    "FusedChain",
    "FusedVcycle",
    "brick_launches",
    "brick_plan",
    "build_fused_smoother",
    "chain_bytes",
    "coarse_len",
    "entry_launches",
    "launches",
    "pattern_stencils",
    "prolong_gm",
    "quad_corner_layout",
    "restrict_gm",
    "smoother_geometry_ok",
    "smoother_plain",
    "stencil_k",
    "stencil_values",
    "tail_bytes",
    "tail_start",
]

#: number of kernel launches made by this module (every entry)
launches = 0
#: the same launches per entry point
entry_launches = dict.fromkeys(("chain", "pre_restrict", "prolong_post", "tail"), 0)
#: chain launches that ran their stencil phases on bricks (``brick_plan``)
brick_launches = 0

#: levels the one-block tail can hold (``kMaxTail`` of csrc/smoother.cu)
MAX_TAIL_LEVELS = 8
#: vectors of vs M values each tail level keeps in shared memory: x, b, scratch
TAIL_VECTORS = 3


# -- transfers (grid-major [vs, *grid] vectors) ------------------------------------


def coarse_len(L: int) -> int:
    return (L - 1) // 2 + 1


def _restrict_last(x: torch.Tensor) -> torch.Tensor:
    """1D restriction along the last axis: out[i] = x[2i-1]/2 + x[2i] + x[2i+1]/2
    (zero outside), of length (L - 1)//2 + 1."""
    L = x.shape[-1]
    out = x[..., 0::2].clone()
    odd = 0.5 * x[..., 1::2]  # odd[i] = x[2i+1] / 2
    n_odd = odd.shape[-1]
    out[..., :n_odd] += odd
    out[..., 1 : 1 + n_odd] += odd[..., : coarse_len(L) - 1]
    return out


def _prolong_last(x: torch.Tensor, Lf: int) -> torch.Tensor:
    """1D trilinear interpolation along the last axis onto Lf nodes:
    out[2i] = x[i], out[2i+1] = (x[i] + x[i+1]) / 2 with x past the end read
    as 0. On a non-nested level (Lf = 2 Lc) the last fine node is x[-1]/2,
    the extra row of the JAX package's (1, Lf - 2 Lc + 2) padding."""
    Lc = x.shape[-1]
    out = x.new_zeros((*x.shape[:-1], Lf))
    out[..., 0::2] = x[..., : (Lf + 1) // 2]
    half = 0.5 * x
    n_odd = Lf // 2
    out[..., 1::2] = half[..., :n_odd]
    out[..., 1 : 2 * (Lc - 1) : 2] += half[..., 1:Lc]
    return out


def restrict_gm(x: torch.Tensor, fine_grid) -> torch.Tensor:
    """Restriction R = P^T of a grid-major vector on the node grid
    ``fine_grid`` to the next coarser grid (no 1/2^d scaling: residuals are
    integrated functionals)."""
    g = x.reshape((-1, *fine_grid))
    for d in range(1, g.dim()):
        g = _restrict_last(g.movedim(d, -1)).movedim(-1, d)
    return g.reshape(-1)


def prolong_gm(xc: torch.Tensor, coarse_grid, fine_grid) -> torch.Tensor:
    """Trilinear prolongation of a grid-major vector from ``coarse_grid`` onto
    ``fine_grid`` (nested, Lf = 2 Lc - 1, or not, Lf = 2 Lc, per axis)."""
    g = xc.reshape((-1, *coarse_grid))
    for d, Lf in enumerate(fine_grid, start=1):
        g = _prolong_last(g.movedim(d, -1), Lf).movedim(-1, d)
    return g.reshape(-1)


# -- level data of the kernels -------------------------------------------------------


def _corner_offset(a: int, gdim: int = 3) -> np.ndarray:
    """Corner a = dx + 2 dy (+ 4 dz) -> its offsets along the grid's axes."""
    return np.array([(a >> d) & 1 for d in range(gdim)])


#: one component's stencil values ([3^gdim][vs] per k, padded to 16 bytes):
#: 27 x 3 -> 84 in 3D, 9 x 2 -> 20 in 2D (kStencilK of csrc/smoother.cu)
_STENCIL_K = {3: 84, 2: 20}


def stencil_k(gdim: int) -> int:
    """One component's stencil values of a pattern, padded to 16 bytes."""
    return _STENCIL_K[gdim]


def stencil_values(gdim: int) -> int:
    """Values of one pattern's stencil: [k][d][j] for vs = gdim components."""
    return gdim * stencil_k(gdim)


def pattern_stencils(ke, mask, node_grid):
    """The 3^gdim-point stencils of vs x vs blocks of the level's nodes, for a
    cell mask of 0 and 1 (vs = gdim = len(node_grid)).

    A node's pattern is the set of its 2^gdim cells (corner a: the cell at
    origin n - off_a) that exist and have mask 1; its stencil sums Ke's
    blocks over those cells, coef[k][d][j] = sum_a sum_{bb: off_bb - off_a =
    d} Ke[a*vs+j, bb*vs+k], so A x at the node is the stencil applied to its
    3^gdim neighbours (float64 on the host). A box has at most 3^gdim
    patterns, and 8 cells at most 256. Returns (pid uint8 [M]: each node's
    pattern; table float64 [P * stencil_values(gdim)])."""
    ke = np.asarray(ke, np.float64)
    gdim = vs = len(node_grid)
    n_corners, n_nb = 2**gdim, 3**gdim
    # cell values at origin + 1, 0 outside
    cells = np.zeros(tuple(n + 1 for n in node_grid))
    inner = tuple(slice(1, n) for n in node_grid)
    cells[inner] = np.asarray(mask, np.float64).reshape(node_grid)[(slice(None, -1),) * gdim]
    bits = np.zeros(node_grid, np.int64)
    for a in range(n_corners):
        o = _corner_offset(a, gdim)
        m = cells[tuple(slice(1 - o[d], 1 - o[d] + node_grid[d]) for d in range(gdim))]
        bits |= (m == 1.0).astype(np.int64) << a
    used, pid = np.unique(bits, return_inverse=True)
    table = np.zeros((len(used), vs, stencil_k(gdim)))
    for p, pattern in enumerate(used):
        coef = np.zeros((vs, n_nb, vs))  # [k][d][j]
        for a in range(n_corners):
            if not (pattern >> a) & 1:
                continue
            for bb in range(n_corners):
                dd = _corner_offset(bb, gdim) - _corner_offset(a, gdim) + 1
                d = int(sum(int(x) * 3 ** (gdim - 1 - ax) for ax, x in enumerate(dd)))
                coef[:, d, :] += ke[vs * a : vs * a + vs, vs * bb : vs * bb + vs].T
        table[p, :, : n_nb * vs] = coef.reshape(vs, n_nb * vs)
    return pid.reshape(-1).astype(np.uint8), table.reshape(-1)


def tail_bytes(node_grids, patterns, itemsize: int, first: int, vs: int = 3) -> int:
    """Shared memory the one-block tail needs from level ``first`` down: x, b
    and a scratch vector and the ``patterns[l]`` stencils of every level
    (``tail_level_values`` of csrc/smoother.cu; vs = gdim)."""
    return sum((TAIL_VECTORS * vs * math.prod(g) + p * stencil_values(vs)) * itemsize
               for g, p in zip(node_grids[first:], patterns[first:]))


def tail_start(node_grids, patterns, itemsize: int, smem_bytes: int, vs: int = 3) -> int:
    """The first level of the one-block tail: the finest level from which the
    tail's levels (at most ``MAX_TAIL_LEVELS``) fit in ``smem_bytes`` of
    shared memory. Raises if not even the coarsest level fits."""
    L = len(node_grids)
    first = L
    for lvl in range(L - 1, max(L - MAX_TAIL_LEVELS, 0) - 1, -1):
        if tail_bytes(node_grids, patterns, itemsize, lvl, vs) > smem_bytes:
            break
        first = lvl
    if first == L:
        msg = (f"the coarsest multigrid level {tuple(node_grids[-1])} needs "
               f"{tail_bytes(node_grids, patterns, itemsize, L - 1, vs)} bytes of shared "
               f"memory for the one-block tail, the card holds {smem_bytes} per block")
        raise ValueError(msg)
    return first


# -- bricks ------------------------------------------------------------------------------

#: nodes a thread takes along axis 0 in a stencil phase on bricks (kBrickRun
#: of csrc/smoother.cu)
BRICK_RUN = 4
#: the warps of runs each SM must get for a level to take bricks
BRICK_MIN_WARPS = 4
#: most columns (threads) of a brick's tile, and most nodes of its rows
BRICK_TILE, BRICK_ROW = 192, 64


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def chain_bytes(node_grid, plan, n_patterns: int, itemsize: int) -> int:
    """Shared memory one block of a chain launch asks for: the level's
    ``n_patterns`` stencils with one node a thread (``plan`` None), or on
    bricks (``plan`` = (run, p1, p2)) the staged brick at the largest tile
    e1 x e2: x with its halo, [3][e1 + 2][e2 + 2] columns of (run + 2) | 1
    values, and b and inv_d, 2 x [3][e1][e2] columns of run | 1 values (the
    stencils are then read through L1)."""
    if plan is None:
        return n_patterns * stencil_values(len(node_grid)) * itemsize
    run, p1, p2 = plan
    e1, e2 = _ceil(node_grid[1], p1), _ceil(node_grid[2], p2)
    return (3 * (e1 + 2) * (e2 + 2) * ((run + 2) | 1) + 6 * e1 * e2 * (run | 1)) * itemsize


def brick_plan(node_grid, itemsize: int, sms: int, smem_bytes: int):
    """How a chain's stencil phases run on a level: ``(run, p1, p2)`` for
    bricks, or None for one node a thread.

    Bricks cover the level: along axis 0 runs of ``run`` nodes over the
    planes 1 .. n0 - 2 and runs of one node on the planes 0 and n0 - 1, the
    (axis 1, axis 2) plane cut evenly into p1 x p2 tiles, one thread a
    column. A 3D level takes
    bricks where its runs give each of the card's ``sms`` SMs at least
    ``BRICK_MIN_WARPS`` warps. A tile's rows are axis 2 cut into the fewest
    parts of at most ``BRICK_ROW`` nodes, and it takes as many rows as
    ``BRICK_TILE`` threads hold, fewer where its block would not fit in
    ``smem_bytes`` (on the H100 the fastest of every cut of the 51^3 and
    65^3 levels in float64, PERF.md)."""
    if len(node_grid) != 3 or node_grid[0] < 3:
        return None
    n0, n1, n2 = node_grid
    if (2 + _ceil(n0 - 2, BRICK_RUN)) * n1 * n2 < BRICK_MIN_WARPS * 32 * sms:
        return None
    p2 = _ceil(n2, BRICK_ROW)
    e2 = _ceil(n2, p2)
    for tile in range(BRICK_TILE, 32, -32):
        if tile < e2:
            break
        plan = (BRICK_RUN, _ceil(n1, tile // e2), p2)
        if chain_bytes(node_grid, plan, 0, itemsize) <= smem_bytes:
            return plan
    return None


# -- the C interface ---------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


class _Level(ctypes.Structure):
    _fields_ = [("invd", _P), ("pid", _P), ("st", _P), ("n0", _I), ("n1", _I), ("n2", _I),
                ("nu", _I), ("n_pat", _I)]


class _Chain(ctypes.Structure):
    _fields_ = [("lv", _Level), ("x", _P), ("b", _P), ("xc", _P), ("xout", _P), ("tmp", _P),
                ("r", _P), ("bc", _P), ("c0", _I), ("c1", _I), ("c2", _I),
                ("zero_start", _I), ("residual", _I), ("prolong", _I), ("restrict_to", _I),
                ("run", _I), ("p1", _I), ("p2", _I)]


class _Tail(ctypes.Structure):
    _fields_ = [("lv", _Level * MAX_TAIL_LEVELS), ("n_levels", _I), ("coarse_inv", _P),
                ("b", _P), ("xout", _P)]


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_entries: dict = {}
_smem: dict = {}
_sms: dict = {}


def _entry(kind: str, dtype: torch.dtype, gdim: int = 3):
    key = (kind, dtype, gdim)
    if key not in _entries:
        dim = "_2d" if gdim == 2 else ""
        _entries[key] = entry_point("smoother", f"fct_{kind}{dim}_{_SUFFIX[dtype]}", [_P, _P])
    return _entries[key]


def _grid3(grid) -> tuple:
    """A node grid as the C interface's three sizes (2D: the third is 1)."""
    return (*grid, 1) if len(grid) == 2 else tuple(grid)


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors."""
    index = _index(device)
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


def smem_optin(device: torch.device) -> int:
    """Shared memory one block may hold on the card (bytes), as it reports."""
    index = _index(device)
    if index not in _smem:
        fn = load_library("smoother").fct_smem_optin
        fn.argtypes, fn.restype = [_I], _I
        _smem[index] = int(fn(index))
        if _smem[index] <= 0:
            msg = f"cudaDeviceGetAttribute(MaxSharedMemoryPerBlockOptin) failed on cuda:{index}"
            raise RuntimeError(msg)
    return _smem[index]


# -- one chain ---------------------------------------------------------------------------


def quad_corner_layout(geo: StructuredGeometry) -> bool:
    """True for the 2D P1 quad corner layout: 2 components, corner a = dx +
    2 dy at the flat node n + dx*s0 + dy."""
    if (geo.gdim, geo.vs, geo.n_nodes) != (2, 2, 4):
        return False
    s0 = geo.offsets[1]
    return geo.offsets == tuple((a & 1) * s0 + ((a >> 1) & 1) for a in range(4))


def smoother_geometry_ok(geo: StructuredGeometry) -> bool:
    """True for the corner layouts the kernel is written for: the 3D hex and
    the 2D quad layout (every level of a hex or quad hierarchy, the
    synthetic coarse levels and a Kuhn box's corner channels included)."""
    return (hex_corner_layout(geo) or quad_corner_layout(geo)) and geo.vs * geo.M < 2**31


def _apply_plain(geo, ke, mask, x):
    """Raw elastic operator: masked corner gather -> Ke product -> the
    geometry's deterministic shifted-add scatter."""
    U = geo._corner_dofs(x.reshape(geo.vs, geo.M)) * mask
    return geo._scatter_corners(_matmul(ke, U)).reshape(-1)


def smoother_plain(geo, ke, inv_d, mask, x, b, *, nu: int, zero_start: bool,
                   emit_residual: bool):
    """The chain in plain PyTorch (``x`` is ignored with ``zero_start``)."""
    if zero_start:
        x = inv_d * b if nu >= 1 else torch.zeros_like(b)
        sweeps = max(nu - 1, 0)
    else:
        sweeps = nu
    for _ in range(sweeps):
        x = x + inv_d * (b - _apply_plain(geo, ke, mask, x))
    if not emit_residual:
        return x
    r = b - _apply_plain(geo, ke, mask, x)
    return x, torch.where(inv_d != 0.0, r, torch.zeros_like(r))


def _check(geo, t: torch.Tensor, name: str) -> None:
    if t.device != geo.device:
        msg = f"{name}: tensor on {t.device}, level on {geo.device}"
        raise ValueError(msg)
    if t.dtype != geo.dtype:
        msg = f"{name}: tensor of {t.dtype}, level of {geo.dtype}"
        raise TypeError(msg)
    if t.numel() != geo.vs * geo.M or not t.is_contiguous():
        msg = f"{name}: expected a contiguous vector of {geo.vs * geo.M} values"
        raise ValueError(msg)


def _check_card_level(chain) -> None:
    """Raise unless the K3 kernels take this chain's level."""
    geo = chain.geo
    if not smoother_geometry_ok(geo):
        msg = "the K3 kernel supports the 3D P1 hex and the 2D P1 quad corner layouts only"
        raise ValueError(msg)
    if geo.dtype not in _SUFFIX:
        msg = f"the K3 kernel takes float32 or float64, got {geo.dtype}"
        raise TypeError(msg)
    if chain.st is None:
        msg = "the K3 kernel takes a cell mask of 0 and 1 only"
        raise ValueError(msg)


class FusedChain:
    """One level's chain (see ``build_fused_smoother``); ``plain`` runs the
    plain PyTorch version on the same level data whatever the device."""

    def __init__(self, geo, ke, inv_d, mask, *, nu, zero_start, emit_residual, st=None,
                 pid=None):
        self.geo, self.ke, self.inv_d, self.mask = geo, ke, inv_d, mask
        self.nu, self.zero_start, self.emit_residual = nu, zero_start, emit_residual
        #: the kernel's pattern stencils and uint8 [M] pattern ids
        #: (``pattern_stencils``; None unless a hex or quad level with a 0/1 mask)
        self.st, self.pid = st, pid
        self.grid = tuple(g + 1 for g in geo.grid)
        self._level = None
        self._plans: dict = {}

    def _opts(self) -> dict:
        return dict(nu=self.nu, zero_start=self.zero_start, emit_residual=self.emit_residual)

    def _split(self, args):
        return (None, *args) if self.zero_start else args

    def __call__(self, *args):
        x, b = self._split(args)
        if not b.is_cuda:
            return self.plain(*args)
        return self._kernel(x, b)

    def plain(self, *args):
        x, b = self._split(args)
        return smoother_plain(self.geo, self.ke, self.inv_d, self.mask, x, b, **self._opts())

    @property
    def n_patterns(self) -> int:
        """Stencils in ``st`` (the level's patterns of cells)."""
        return self.st.numel() // stencil_values(self.geo.gdim)

    def level(self) -> _Level:
        """The level's constant data for the C interface (built once)."""
        if self._level is None:
            self._level = _Level(self.inv_d.data_ptr(), self.pid.data_ptr(), self.st.data_ptr(),
                                 *_grid3(self.grid), self.nu, self.n_patterns)
        return self._level

    def plan(self, device) -> tuple | None:
        """The stencil phases' plan on this card (``brick_plan``)."""
        key = _index(device)
        if key not in self._plans:
            self._plans[key] = brick_plan(self.grid, self.inv_d.element_size(),
                                          sm_count(device), smem_optin(device))
        return self._plans[key]

    def _kernel(self, x, b, plan=None):
        """One launch; ``plan`` (a ``brick_plan`` value, or () for one node
        a thread) replaces the card's rule, for measurements."""
        _check_card_level(self)
        _check(self.geo, b, "b")
        if not self.zero_start:
            _check(self.geo, x, "x")
        xout, r, _ = _launch(self, "chain", x=x, b=b, residual=self.emit_residual, plan=plan)
        return (xout, r) if self.emit_residual else xout


def build_fused_smoother(geo: StructuredGeometry, ke, inv_d, mask, *, nu: int,
                         zero_start: bool, emit_residual: bool) -> FusedChain:
    """Build one level's chain.

    Args:
        geo: the level's StructuredGeometry (vs, M, corner offsets).
        ke: [24, 24] (2D: [8, 8]) element matrix (host float64, beta*KE_I +
            (kappa - beta/3)*KE_V at the level moduli), cast to the level's
            dtype.
        inv_d: [vs*M] damped inverse Jacobi diagonal, zero at Dirichlet dofs.
        mask: [M] cell-origin validity mask.
        nu: sweeps in the chain; zero_start: start from x = 0;
        emit_residual: also return the free-masked residual.

    Returns a callable ``fn(b_gm)`` (zero start) or ``fn(x_gm, b_gm)``, giving
    ``x_gm`` or ``(x_gm, r_gm)``: the kernel for CUDA tensors, the plain
    version for CPU tensors. Nothing is compiled until the first call on a
    CUDA tensor.
    """
    dtype, device = geo.dtype, geo.device
    ke64 = np.asarray(ke, np.float64)
    ke_t = torch.as_tensor(ke64, dtype=dtype, device=device)
    inv_d = torch.as_tensor(inv_d, dtype=dtype, device=device).reshape(-1).contiguous()
    mask = torch.as_tensor(mask, dtype=dtype, device=device).reshape(-1).contiguous()
    if ke_t.shape != (geo.n_nodes * geo.vs,) * 2 or inv_d.numel() != geo.vs * geo.M:
        msg = "build_fused_smoother: ke or inv_d does not fit the level"
        raise ValueError(msg)
    st = pid = None
    mask_host = mask.cpu().numpy()
    if smoother_geometry_ok(geo) and np.isin(mask_host, (0.0, 1.0)).all():
        grid = tuple(g + 1 for g in geo.grid)
        pid, table = pattern_stencils(ke64, mask_host, grid)
        st = torch.as_tensor(table, dtype=dtype, device=device)
        pid = torch.as_tensor(pid, device=device)
    return FusedChain(geo, ke_t.contiguous(), inv_d, mask, nu=nu, zero_start=zero_start,
                      emit_residual=emit_residual, st=st, pid=pid)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(kind: str, bricks: bool = False) -> None:
    global launches, brick_launches
    n = launched()
    launches += n
    entry_launches[kind] += n
    brick_launches += n * bricks


def _launch(chain: FusedChain, kind: str, *, x, b, residual: bool, xc=None, coarse=None,
            restrict: bool = False, plan=None):
    """One cooperative launch of a chain: the first write (inv_d * b, or x
    with ``xc`` prolonged, masked and added), the sweeps, and with
    ``residual`` the residual and with ``restrict`` its restriction onto the
    grid ``coarse``, the stencil phases by ``chain.plan`` (or ``plan``).
    Returns (x, r or None, b_coarse or None)."""
    plan = chain.plan(b.device) if plan is None else plan
    sweeps = max(chain.nu - 1, 0) if chain.zero_start else chain.nu
    xout = torch.empty_like(b)
    tmp = torch.empty_like(b) if sweeps else None
    r = torch.empty_like(b) if residual else None
    bc = b.new_empty(chain.geo.vs * math.prod(coarse)) if restrict else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    a = _Chain(chain.level(), ptr(x), ptr(b), ptr(xc), ptr(xout), ptr(tmp), ptr(r), ptr(bc),
               *(_grid3(coarse) if coarse else (0, 0, 0)), int(chain.zero_start),
               int(residual), int(xc is not None), int(restrict), *(plan or (0, 0, 0)))
    with torch.cuda.device(b.device):
        rc = _entry("chain", b.dtype, chain.geo.gdim)(ctypes.byref(a), _stream(b))
    launch_check("smoother", rc)
    _count(kind, bool(plan))
    return xout, r, bc


# -- the V-cycle -------------------------------------------------------------------------


class FusedVcycle:
    """The fused V-cycle over per-level chains (see the module docstring).

    ``chains``: one dict per level, {"pre", "post"} above the coarsest and
    {"coarse"} at it (the coarse chain runs unless ``coarse_inv``, the dense
    inverse of the coarsest constrained operator, is given). ``node_grids``:
    the levels' node grids. The chains are baked at the build's moduli,
    dtype and device.
    """

    def __init__(self, chains, node_grids, coarse_inv=None):
        self.chains = tuple(chains)
        self.node_grids = tuple(tuple(g) for g in node_grids)
        self.coarse_inv = coarse_inv
        self.n_levels = len(self.chains)
        self._tail_start: dict = {}

    def _chain(self, lvl: int) -> FusedChain:
        """A chain of level ``lvl`` (the level data are the same in each)."""
        c = self.chains[lvl]
        return c["coarse"] if "coarse" in c else c["pre"]

    def patterns(self) -> list:
        """Each level's number of stencils (patterns of cells)."""
        return [self._chain(t).n_patterns for t in range(self.n_levels)]

    def tail_start(self, device) -> int:
        """The first level of the tail on this card (``tail_start``)."""
        key = torch.device(device).index
        if key not in self._tail_start:
            c0 = self._chain(0)
            self._tail_start[key] = tail_start(self.node_grids, self.patterns(),
                                               c0.inv_d.element_size(), smem_optin(device),
                                               c0.geo.vs)
        return self._tail_start[key]

    # -- the plain twins ---------------------------------------------------------------

    def pre_restrict_plain(self, lvl: int, b: torch.Tensor):
        x, r = self.chains[lvl]["pre"].plain(b)
        return x, restrict_gm(r, self.node_grids[lvl])

    def prolong_post_plain(self, lvl: int, x, b, xc):
        post = self.chains[lvl]["post"]
        fine = prolong_gm(xc, self.node_grids[lvl + 1], self.node_grids[lvl])
        x = x + torch.where(post.inv_d != 0.0, fine, torch.zeros_like(fine))
        return post.plain(x, b)

    def coarse_plain(self, b: torch.Tensor) -> torch.Tensor:
        chain = self.chains[-1]["coarse"]
        if self.coarse_inv is None:
            return chain.plain(b)
        free, zero = chain.inv_d != 0.0, b.new_zeros(())
        z = _matmul(self.coarse_inv.to(b.dtype), torch.where(free, b, zero))
        return torch.where(free, z, zero)

    def plain(self, b: torch.Tensor, lvl: int = 0) -> torch.Tensor:
        """The V-cycle from level ``lvl`` down in plain PyTorch: the twin of
        ``tail`` and of the whole cycle."""
        if lvl == self.n_levels - 1:
            return self.coarse_plain(b)
        x, bc = self.pre_restrict_plain(lvl, b)
        return self.prolong_post_plain(lvl, x, b, self.plain(bc, lvl + 1))

    # -- the kernel entries ------------------------------------------------------------

    def pre_restrict(self, lvl: int, b: torch.Tensor):
        """Pre-chain, residual and restriction: (x, b of level lvl + 1)."""
        if not b.is_cuda:
            return self.pre_restrict_plain(lvl, b)
        pre = self.chains[lvl]["pre"]
        _check_card_level(pre)
        _check(pre.geo, b, "b")
        x, _, bc = _launch(pre, "pre_restrict", x=None, b=b, residual=True,
                           coarse=self.node_grids[lvl + 1], restrict=True)
        return x, bc

    def prolong_post(self, lvl: int, x, b, xc):
        """x + [free] P xc, then the post-chain."""
        if not b.is_cuda:
            return self.prolong_post_plain(lvl, x, b, xc)
        post = self.chains[lvl]["post"]
        _check_card_level(post)
        _check(post.geo, b, "b")
        _check(post.geo, x, "x")
        _check(self._chain(lvl + 1).geo, xc, "xc")
        xout, _, _ = _launch(post, "prolong_post", x=x, b=b, residual=False, xc=xc,
                             coarse=self.node_grids[lvl + 1])
        return xout

    def tail(self, b: torch.Tensor, lvl: int) -> torch.Tensor:
        """The V-cycle from level ``lvl`` down in one block."""
        if not b.is_cuda:
            return self.plain(b, lvl)
        levels = [self._chain(t) for t in range(lvl, self.n_levels)]
        for c in levels:
            _check_card_level(c)
        _check(levels[0].geo, b, "b")
        vs = levels[0].geo.vs
        need = tail_bytes(self.node_grids, self.patterns(), b.element_size(), lvl, vs)
        smem = smem_optin(b.device)
        if need > smem or len(levels) > MAX_TAIL_LEVELS:
            msg = (f"the one-block tail from level {lvl} (node grids {self.node_grids[lvl:]}) "
                   f"needs {need} bytes of shared memory and {len(levels)} levels; the card "
                   f"holds {smem} bytes per block and the kernel {MAX_TAIL_LEVELS} levels")
            raise ValueError(msg)
        xout = torch.empty_like(b)
        a = _Tail()
        for t, c in enumerate(levels):
            a.lv[t] = c.level()
        a.n_levels = len(levels)
        cinv = None
        if self.coarse_inv is not None:
            cinv = self.coarse_inv
            if cinv.dtype != b.dtype or cinv.device != b.device or not cinv.is_contiguous():
                msg = "coarse_inv must be a contiguous tensor of the level's dtype and device"
                raise ValueError(msg)
        a.coarse_inv = None if cinv is None else cinv.data_ptr()
        a.b, a.xout = b.data_ptr(), xout.data_ptr()
        with torch.cuda.device(b.device):
            rc = _entry("tail", b.dtype, levels[0].geo.gdim)(ctypes.byref(a), _stream(b))
        launch_check("smoother", rc)
        _count("tail")
        return xout

    def __call__(self, b: torch.Tensor, lvl: int = 0) -> torch.Tensor:
        """One V-cycle from level ``lvl``: the kernels on CUDA tensors (one
        launch per level above the tail, one tail, one per level on the way
        up), the plain twins on CPU tensors."""
        if not b.is_cuda:
            return self.plain(b, lvl)
        first = max(lvl, self.tail_start(b.device))
        xs, bs = [], []
        for level in range(lvl, first):
            x, bc = self.pre_restrict(level, b)
            xs.append(x)
            bs.append(b)
            b = bc
        x = self.tail(b, first)
        for level in reversed(range(lvl, first)):
            x = self.prolong_post(level, xs[level - lvl], bs[level - lvl], x)
        return x
