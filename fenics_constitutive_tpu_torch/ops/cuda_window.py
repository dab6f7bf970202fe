"""Windowed gather, scatter and BSR SpMV: hand-written CUDA kernels (K4, K5,
K6 of ``csrc/window.cu``) and their plain PyTorch twins.

``windowed_gather(ex, u2)``, ``windowed_scatter(ex, f)`` and
``windowed_bsr_matvec(w, x)`` launch the kernels on CUDA tensors and raise
on anything else: an unsupported input never falls back to the plain
version. ``WindowedExchange.gather``/``scatter`` and ``WindowedBsr.matvec``
call them for CUDA tensors and the plain versions (``gather_plain``,
``scatter_plain``, ``bsr_matvec_plain``) for CPU tensors. Nothing is
compiled until the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import entry_point, launch_check

__all__ = [
    "bsr_matvec_plain",
    "gather_plain",
    "launches",
    "scatter_plain",
    "windowed_bsr_matvec",
    "windowed_gather",
    "windowed_scatter",
]

#: kernel launches made by the wrappers of this module, per kernel
launches = {"gather": 0, "scatter": 0, "bsr_matvec": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "gather": [_P] * 3 + [_I] * 5 + [_P],
    "scatter": [_P] * 4 + [_I] * 3 + [_P],
    "bsr": [_P] * 5 + [_I] * 8 + [_P],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_BSR_SHAPES = ((3, 3), (3, 6), (6, 3), (6, 6))
_entries: dict = {}


def _entry(kind: str, dtype: torch.dtype):
    key = (kind, dtype)
    if key not in _entries:
        _entries[key] = entry_point(
            "window", f"fct_window_{kind}_{_SUFFIX[dtype]}", _ARGTYPES[kind]
        )
    return _entries[key]


def _check(name: str, t: torch.Tensor, plan: torch.Tensor, shape: tuple) -> None:
    """Raise unless the kernel can take ``t`` beside a plan on ``plan.device``."""
    if not t.is_cuda:
        msg = f"{name}: the CUDA kernel takes CUDA tensors, got one on {t.device}"
        raise ValueError(msg)
    if t.device != plan.device:
        msg = f"{name}: tensor on {t.device}, plan on {plan.device}"
        raise ValueError(msg)
    if t.dtype not in _SUFFIX:
        msg = f"{name}: the CUDA kernel takes float32 or float64, got {t.dtype}"
        raise TypeError(msg)
    if tuple(t.shape) != shape:
        msg = f"{name}: expected shape {shape}, got {tuple(t.shape)}"
        raise ValueError(msg)
    if not t.is_contiguous():
        msg = f"{name}: the CUDA kernel takes contiguous tensors"
        raise ValueError(msg)
    if t.numel() >= 2**31:
        msg = f"{name}: {t.numel()} values overflow the kernel's 32-bit indices"
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -- plain versions (the CPU path, and the reference the kernels are held to) --


def gather_plain(ex, u2: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: ``WindowedExchange.gather_ref``."""
    return ex.gather_ref(u2)


def scatter_plain(ex, f: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: ``WindowedExchange.scatter_ref``."""
    return ex.scatter_ref(f)


def bsr_matvec_plain(w, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ``WindowedBsr.matvec_ref``."""
    return w.matvec_ref(x)


# -- the kernels -------------------------------------------------------------------


def windowed_gather(ex, u2: torch.Tensor) -> torch.Tensor:
    """K4: u2 [K, M_pad] node rows -> [B, K, Rn] cell-local rows (pads 0).

    Replaces ``fenics_constitutive_tpu/ops/pallas_window.py::windowed_gather``;
    the output is bit-identical to ``gather_plain``.
    """
    K = u2.shape[0] if u2.dim() == 2 else -1
    _check("windowed_gather", u2, ex.loc, (K, ex.M_pad))
    out = torch.empty((ex.B, K, ex.Rn), dtype=u2.dtype, device=u2.device)
    with torch.cuda.device(u2.device):
        rc = _entry("gather", u2.dtype)(
            u2.data_ptr(), ex.loc.data_ptr(), out.data_ptr(),
            K, ex.B, ex.Rn, ex.T, ex.M_pad, _stream(u2),
        )
    launch_check("window", rc)
    launches["gather"] += 1
    return out


def windowed_scatter(ex, f: torch.Tensor) -> torch.Tensor:
    """K5: f [B, K, Rn] cell-local rows -> [K, M_pad] node rows, duplicates
    summed in the plan's fixed order (no atomics; pad rows are ignored).

    Replaces ``fenics_constitutive_tpu/ops/pallas_window.py::windowed_scatter``;
    equals ``scatter_plain`` up to the order of each node's sum.
    """
    K = f.shape[1] if f.dim() == 3 else -1
    _check("windowed_scatter", f, ex.loc, (ex.B, K, ex.Rn))
    out = torch.empty((K, ex.M_pad), dtype=f.dtype, device=f.device)
    with torch.cuda.device(f.device):
        rc = _entry("scatter", f.dtype)(
            f.data_ptr(), ex.node_ptr.data_ptr(), ex.node_rows.data_ptr(),
            out.data_ptr(), K, ex.Rn, ex.M_pad, _stream(f),
        )
    launch_check("window", rc)
    launches["scatter"] += 1
    return out


def windowed_bsr_matvec(w, x: torch.Tensor) -> torch.Tensor:
    """K6: y [br * NR_pad] = A x [bc * NC_pad] over the windowed BSR plan ``w``.

    Replaces ``fenics_constitutive_tpu/ops/pallas_window.py::
    windowed_bsr_matvec``. With ``w.select_passes == 1`` a float32 ``x`` is
    rounded to bfloat16 in the column select, as in ``bsr_matvec_plain``.
    """
    _check("windowed_bsr_matvec", x, w.vals, (w.bc * w.NC_pad,))
    if x.dtype != w.vals.dtype:
        msg = f"windowed_bsr_matvec: x of {x.dtype}, plan of {w.vals.dtype}"
        raise TypeError(msg)
    if (w.br, w.bc) not in _BSR_SHAPES:
        msg = f"windowed_bsr_matvec: blocks {w.br}x{w.bc} not in {_BSR_SHAPES}"
        raise ValueError(msg)
    if w.vals.numel() >= 2**31:
        msg = "windowed_bsr_matvec: plan values overflow the kernel's 32-bit indices"
        raise ValueError(msg)
    round_bf16 = int(w.select_passes == 1 and x.dtype == torch.float32)
    y = torch.empty(w.br * w.NR_pad, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _entry("bsr", x.dtype)(
            x.data_ptr(), w.loc.data_ptr(), w.vals.data_ptr(), w.jb.data_ptr(),
            y.data_ptr(), w.br, w.bc, w.k, w.T_r, w.B, w.NC_pad, w.NR_pad,
            round_bf16, _stream(x),
        )
    launch_check("window", rc)
    launches["bsr_matvec"] += 1
    return y
