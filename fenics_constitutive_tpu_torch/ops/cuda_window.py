"""Windowed gather, scatter, BSR SpMV and the tet operator's cell part:
hand-written CUDA kernels (K4, K5, K6, K7 of ``csrc/window.cu``) and their
plain PyTorch twins.

``windowed_gather(ex, u2)``, ``windowed_scatter(ex, f)``,
``windowed_bsr_matvec(w, x)`` and ``windowed_cell_apply(geo, u2, tangent)``
launch the kernels on CUDA tensors and raise on anything else: an
unsupported input never falls back to the plain version.
``WindowedExchange.gather``/``scatter`` and ``WindowedBsr.matvec`` call them
for CUDA tensors and the plain versions (``gather_plain``,
``scatter_plain``, ``bsr_matvec_plain``) for CPU tensors;
``WindowedGeometry.matvec`` calls K7 for CUDA tensors where
``cell_apply_form`` holds (an IsotropicTangent on affine P1 tets) and
``cell_apply_plain`` everywhere else. Nothing is compiled until the first launch.

The launch path is lean, since K6 runs 96 times in a general-tet load step:
a plan's own invariants (index types, contiguity, alignment, 32-bit sizes,
block shape) are checked at its first launch; each call checks only what
the caller hands in (device, dtype, shape, contiguity), switches the
current device only when it differs, and passes PyTorch's current raw
stream handle.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import entry_point, launch_check, launched
from .cuda_matvec import coefficients
from .mandel import Constraint
from .packed import IsotropicTangent

__all__ = [
    "bsr_matvec_plain",
    "bsr_rows_plain",
    "cell_apply_form",
    "cell_apply_plain",
    "gather_plain",
    "launches",
    "scatter_plain",
    "windowed_bsr_matvec",
    "windowed_cell_apply",
    "windowed_gather",
    "windowed_scatter",
]

#: kernel launches made by the wrappers of this module, per kernel
launches = {"gather": 0, "scatter": 0, "bsr_matvec": 0, "cell_apply": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "gather": [_P] * 3 + [_I] * 5 + [_P],
    "scatter": [_P] * 4 + [_I] * 3 + [_P],
    "bsr": [_P] * 5 + [_I] * 6 + [_P],
    "cell_apply": [_P] * 10 + [_I] * 9 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_BSR_SHAPES = ((3, 3), (3, 6), (6, 3), (6, 6))
_LANES = (1, 2, 4, 8, 16, 32)
_I32 = 2**31
_entries: dict = {}


def _entry(kind: str, dtype: torch.dtype):
    key = (kind, dtype)
    if key not in _entries:
        _entries[key] = entry_point(
            "window", f"fct_window_{kind}_{_SUFFIX[dtype]}", _ARGTYPES[kind]
        )
    return _entries[key]


def _launch(fn, index: int, *args) -> None:
    """Call entry point ``fn`` with PyTorch's current stream on device
    ``index`` (switching the current device only if it differs), and raise
    on its error."""
    if torch._C._cuda_getDevice() == index:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    launch_check("window", rc)


def _check_device(name: str, t: torch.Tensor, plan: torch.Tensor) -> int:
    """Raise unless ``t`` is a CUDA tensor on the device of the plan's
    buffer ``plan``; return the device index."""
    if not t.is_cuda:
        msg = f"{name}: the CUDA kernel takes CUDA tensors, got one on {t.device}"
        raise ValueError(msg)
    index = t.get_device()
    if index != plan.get_device():
        msg = f"{name}: tensor on {t.device}, plan on {plan.device}"
        raise ValueError(msg)
    return index


def _check_layout(name: str, t: torch.Tensor, shape) -> None:
    """Raise unless ``t`` has a kernel's dtype, ``shape`` and is contiguous."""
    if t.dtype not in _SUFFIX:
        msg = f"{name}: the CUDA kernel takes float32 or float64, got {t.dtype}"
        raise TypeError(msg)
    if t.shape != shape:
        msg = f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}"
        raise ValueError(msg)
    if not t.is_contiguous():
        msg = f"{name}: the CUDA kernel takes contiguous tensors"
        raise ValueError(msg)


def _check_call(name: str, t: torch.Tensor, plan: torch.Tensor, shape) -> int:
    """Raise unless the kernel can take ``t`` beside a plan whose buffers lie
    like ``plan``; return the device index."""
    index = _check_device(name, t, plan)
    _check_layout(name, t, shape)
    return index


def _check_plan_once(plan, key: int, check, *args):
    """``check(*args)``, run at a plan's first launch and again once the plan
    has moved or been cast (``key``, a buffer's address, changed); returns
    what the check returned then."""
    done = plan.__dict__.get("_launch_key")
    if done is None or done[0] != key:
        done = (key, check(*args))
        plan._launch_key = done
    return done[1]


def _require(name: str, ok: bool, what: str) -> None:
    if not ok:
        msg = f"{name}: {what}"
        raise ValueError(msg)


def _int32(*tensors) -> bool:
    return all(t.dtype == torch.int32 and t.is_contiguous() for t in tensors)


def _exchange_invariants(name: str, ex) -> int:
    """Raise unless K4/K5 can take the exchange plan; return the most
    components K its 32-bit indices allow."""
    _require(name, _int32(ex.loc, ex.node_ptr, ex.node_rows),
             "the plan's loc, node_ptr and node_rows must be contiguous int32")
    _require(name, ex.Rn % 4 == 0 and ex.loc.data_ptr() % 16 == 0,
             f"K4 reads loc as int4: Rn ({ex.Rn}) must be a multiple of 4, loc aligned")
    _require(name, max(ex.loc.numel(), ex.node_rows.numel()) < _I32,
             "the plan overflows the kernel's 32-bit indices")
    return (_I32 - 1) // max(ex.B * ex.Rn, ex.M_pad)


def _bsr_invariants(w) -> None:
    name = "windowed_bsr_matvec"
    _require(name, (w.br, w.bc) in _BSR_SHAPES, f"blocks {w.br}x{w.bc} not in {_BSR_SHAPES}")
    _require(name, _int32(w.row_ptr, w.col) and w.blk.is_contiguous()
             and w.row_ptr.numel() == w.NR_pad + 1,
             "the row layout must be contiguous, int32 indices, NR_pad + 1 row pointers")
    _require(name, w.lanes in _LANES, f"the plan's lanes ({w.lanes}) must be in {_LANES}")
    _require(name, max(w.blk.numel(), w.br * w.NR_pad, w.bc * w.NC_pad, 32 * w.NR_pad) < _I32,
             "the plan overflows the kernel's 32-bit indices")


def _cell_invariants(geo) -> None:
    """Raise unless K7 can take the geometry. K7 reads the shear factor c of
    its Mandel map (FULL: e3 = c (H01 + H10), e4 = c (H02 + H20), e5 = c (H12
    + H21)) from ``mandel_T`` itself."""
    name = "windowed_cell_apply"
    ex = geo.ex
    _require(name, geo.compact and (geo.n_nodes, geo.vs) == (4, 3),
             "K7 takes affine P1 tets: one gradient per cell, 4 nodes, 3 components")
    _require(name, geo.constraint == Constraint.FULL and tuple(geo.mandel_T.shape) == (6, 3, 3),
             "K7 takes the FULL constraint's [6, 3, 3] Mandel map")
    _require(name, geo.dN.shape == (4, 3, ex.C_pad) and geo.w.shape == (geo.N,)
             and all(t.is_contiguous() and t.dtype == geo.dN.dtype
                     for t in (geo.dN, geo.w, geo.mandel_T)),
             "dN [4, 3, C_pad], w [N] and mandel_T must be contiguous, of one dtype")
    _require(name, ex.C_pad % 128 == 0 and 6 * geo.N < _I32,
             "the plan overflows the kernel's 32-bit indices")


# -- plain versions (the CPU path, and the reference the kernels are held to) --


def gather_plain(ex, u2: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: ``WindowedExchange.gather_ref``."""
    return ex.gather_ref(u2)


def scatter_plain(ex, f: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``WindowedExchange.scatter_ref``."""
    return ex.scatter_ref(f)


def cell_apply_plain(geo, u2: torch.Tensor, tangent) -> torch.Tensor:
    """Plain version of K7: ``WindowedGeometry.cell_apply_ref`` (the gather,
    strain, tangent and divergence of every cell, as K5's input rows)."""
    return geo.cell_apply_ref(u2, tangent)


def bsr_matvec_plain(w, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ``WindowedBsr.matvec_ref``."""
    return w.matvec_ref(x)


def bsr_rows_plain(w, x: torch.Tensor) -> torch.Tensor:
    """The product K6 computes, on the row layout (``row_ptr``/``col``/
    ``blk``), in plain PyTorch: a reference for the tests of that layout."""
    sel = x.reshape(w.bc, w.NC_pad)[:, w.col.long()]  # [bc, nnzb]
    if w.select_passes == 1 and sel.dtype == torch.float32:
        sel = sel.to(torch.bfloat16).to(torch.float32)
    contrib = (w.blk.reshape(-1, w.br, w.bc) * sel.T[:, None, :]).sum(dim=2)
    rows = torch.repeat_interleave(
        torch.arange(w.NR_pad, device=x.device), torch.diff(w.row_ptr.long())
    )
    y = x.new_zeros((w.NR_pad, w.br)).index_add_(0, rows, contrib)
    return y.T.reshape(-1)


# -- the kernels -------------------------------------------------------------------


def windowed_gather(ex, u2: torch.Tensor) -> torch.Tensor:
    """K4: u2 [K, M_pad] node rows -> [B, K, Rn] cell-local rows (pads 0).

    Replaces ``fenics_constitutive_tpu/ops/pallas_window.py::windowed_gather``;
    the output is bit-identical to ``gather_plain``.
    """
    K = u2.shape[0] if u2.dim() == 2 else -1
    loc = ex.loc
    index = _check_call("windowed_gather", u2, loc, (K, ex.M_pad))
    if K > _check_plan_once(ex, loc.data_ptr(), _exchange_invariants, "windowed_gather", ex):
        msg = f"windowed_gather: {K} rows overflow the kernel's 32-bit indices"
        raise ValueError(msg)
    out = u2.new_empty((ex.B, K, ex.Rn))
    _launch(_entry("gather", u2.dtype), index, u2.data_ptr(), loc.data_ptr(),
            out.data_ptr(), K, ex.B, ex.Rn, ex.T, ex.M_pad)
    launches["gather"] += launched()
    return out


def windowed_scatter(ex, f: torch.Tensor) -> torch.Tensor:
    """K5: f [B, K, Rn] cell-local rows -> [K, M_pad] node rows, duplicates
    summed in the plan's fixed order (no atomics; pad rows are ignored).

    Replaces ``fenics_constitutive_tpu/ops/pallas_window.py::windowed_scatter``;
    equals ``scatter_plain`` up to the order of each node's sum.
    """
    K = f.shape[1] if f.dim() == 3 else -1
    loc = ex.loc
    index = _check_call("windowed_scatter", f, loc, (ex.B, K, ex.Rn))
    if K > _check_plan_once(ex, loc.data_ptr(), _exchange_invariants, "windowed_scatter", ex):
        msg = f"windowed_scatter: {K} rows overflow the kernel's 32-bit indices"
        raise ValueError(msg)
    out = f.new_empty((K, ex.M_pad))
    _launch(_entry("scatter", f.dtype), index, f.data_ptr(), ex.node_ptr.data_ptr(),
            ex.node_rows.data_ptr(), out.data_ptr(), K, ex.Rn, ex.M_pad)
    launches["scatter"] += launched()
    return out


def windowed_bsr_matvec(w, x: torch.Tensor, *, lanes: int | None = None) -> torch.Tensor:
    """K6: y [br * NR_pad] = A x [bc * NC_pad] on the row layout of plan ``w``
    (``row_ptr``/``col``/``blk``), with ``w.lanes`` threads per row.

    Replaces ``fenics_constitutive_tpu/ops/pallas_window.py::
    windowed_bsr_matvec``. With ``w.select_passes == 1`` a float32 ``x`` is
    rounded to bfloat16 in the column select, as in ``bsr_matvec_plain``.
    ``lanes`` overrides the plan's threads per row (a power of two up to
    32); only the lanes sweep of ``chip_smoke.py`` sets it.
    """
    if w.blk is None:
        msg = ("windowed_bsr_matvec: the plan has no row layout (row_ptr, col, blk) "
               "for the CUDA kernel; build it with build_windowed_bsr")
        raise ValueError(msg)
    blk = w.blk
    index = _check_call("windowed_bsr_matvec", x, blk, (w.bc * w.NC_pad,))
    if x.dtype != blk.dtype:
        msg = f"windowed_bsr_matvec: x of {x.dtype}, plan of {blk.dtype}"
        raise TypeError(msg)
    _check_plan_once(w, blk.data_ptr(), _bsr_invariants, w)
    if lanes is None:
        lanes = w.lanes
    elif lanes not in _LANES:
        msg = f"windowed_bsr_matvec: lanes must be in {_LANES}, got {lanes}"
        raise ValueError(msg)
    round_bf16 = int(w.select_passes == 1 and x.dtype == torch.float32)
    y = x.new_empty(w.br * w.NR_pad)
    _launch(_entry("bsr", x.dtype), index, x.data_ptr(), w.row_ptr.data_ptr(),
            w.col.data_ptr(), blk.data_ptr(), y.data_ptr(), w.br, w.bc, w.NR_pad,
            w.NC_pad, lanes.bit_length() - 1, round_bf16)
    launches["bsr_matvec"] += launched()
    return y


def cell_apply_form(geo, tangent) -> bool:
    """True when ``WindowedGeometry.matvec`` runs its cells' part as K7 on
    CUDA tensors: an IsotropicTangent on affine P1 tets of 3 components
    under the FULL constraint, in float32 or float64. The geometry and the
    tangent's type alone decide, before any capture; ``windowed_cell_apply``
    takes each of the tangent's entries in any dtype and layout of a valid
    size, or raises. A DenseTangent, non-affine cells, 2D constraints and
    every CPU tensor run ``cell_apply_plain``."""
    return (isinstance(tangent, IsotropicTangent) and geo.dtype in _SUFFIX and geo.compact
            and (geo.n_nodes, geo.vs) == (4, 3) and geo.constraint == Constraint.FULL)


def _tangent_entry(name: str, key: str, x: torch.Tensor, k: int, N: int, dtype, dev):
    """A tangent entry of ``k`` components as K7 reads it: (values, QP
    stride). A field of the QPs comes as [k, N] q-major with QP stride 1; a
    uniform entry (k values, or a view that repeats k values along the QPs)
    as k values with QP stride 0. Each is converted to ``dtype`` (a uniform
    one also to ``dev``, as ``coefficients`` moves kappa) and made
    contiguous once, where it is not already."""
    if x.numel() == k * N:
        x = x.reshape(k, N)
        if x.stride(1) != 0:
            if x.device != dev:
                msg = f"{name}: the tangent's {key} is on {x.device}, the node rows on {dev}"
                raise ValueError(msg)
            return x.to(dtype).contiguous(), 1
        x = x[:, :1]
    elif x.numel() != k:
        msg = (f"{name}: the tangent's {key} must hold {k} or {k} x N = {k * N} values "
               f"(N = {N}), got {x.numel()}")
        raise ValueError(msg)
    return x.reshape(k).to(dev, dtype).contiguous(), 0


def windowed_cell_apply(geo, u2: torch.Tensor, tangent) -> torch.Tensor:
    """K7: u2 [3, M_pad] node rows -> f [B, 3, Rn] cell-local rows, each
    cell's forces A_e u_e under the factored tangent (K5's input; pad rows 0).

    Fuses what ``cell_apply_plain`` runs as some 20 ops: the gather (K4's
    work), strain, tangent, weights and divergence. Equals it up to the order
    of the sums; two launches agree bit for bit. kappa, and a beta or gamma
    given as a host number, are read from a 3-value device tensor
    (``coefficients``, kept per geometry); a tensor entry is read where it
    lies once it has the working dtype and a contiguous layout.
    """
    name = "windowed_cell_apply"
    ex = geo.ex
    _check_plan_once(geo, geo.dN.data_ptr(), _cell_invariants, geo)
    _check_layout(name, u2, (3, ex.M_pad))
    if u2.dtype != geo.dtype:
        msg = f"{name}: node rows of {u2.dtype}, geometry of {geo.dtype}"
        raise TypeError(msg)
    if not isinstance(tangent, IsotropicTangent):
        msg = f"{name}: K7 applies an IsotropicTangent, got {type(tangent).__name__}"
        raise TypeError(msg)
    dtype, dev, N = u2.dtype, u2.device, geo.N
    kappa = tangent.kappa
    if isinstance(kappa, torch.Tensor) and kappa.numel() != 1:
        msg = f"{name}: kappa must be one value, got {kappa.numel()}"
        raise ValueError(msg)
    if not isinstance(tangent.n, torch.Tensor):
        msg = f"{name}: the tangent's n must be a tensor"
        raise TypeError(msg)
    entries = {key: _tangent_entry(name, key, x, k, N, dtype, dev)
               for key, x, k in (("beta", tangent.beta, 1), ("gamma", tangent.gamma, 1),
                                 ("n", tangent.n, 6)) if isinstance(x, torch.Tensor)}
    index = _check_device(name, u2, ex.loc)
    _check_plan_once(ex, ex.loc.data_ptr(), _exchange_invariants, name, ex)
    coef = coefficients(
        (kappa, *(0.0 if isinstance(x, torch.Tensor) else x
                  for x in (tangent.beta, tangent.gamma))), dtype, dev,
        geo.__dict__.setdefault("_coef_cache", {}))
    size = coef.element_size()
    beta, gamma = (
        (entries[key][0].data_ptr(), entries[key][1]) if key in entries
        else (coef.data_ptr() + slot * size, 0) for slot, key in ((1, "beta"), (2, "gamma")))
    n, n_qp_stride = entries["n"]
    f = u2.new_empty((ex.B, 3, ex.Rn))
    _launch(_entry("cell_apply", dtype), index, u2.data_ptr(), ex.loc.data_ptr(),
            geo.dN.data_ptr(), geo.w.data_ptr(), beta[0], gamma[0], n.data_ptr(),
            coef.data_ptr(), geo.mandel_T.data_ptr(), f.data_ptr(), ex.C_B, ex.B, ex.T,
            ex.M_pad, geo.n_qp, beta[1], gamma[1], N if n_qp_stride else 1, n_qp_stride)
    launches["cell_apply"] += launched()
    return f
