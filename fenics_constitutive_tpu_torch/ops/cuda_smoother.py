"""Fused multigrid smoothing chains: hand-written CUDA kernel (K3) and its
plain twin.

``build_fused_smoother(geo, ke, inv_d, mask, nu=, zero_start=, emit_residual=)``
returns one level's damped-Jacobi chain ``x <- x + inv_d * (b - A x)``, ``nu``
sweeps of the constant-coefficient elastic operator ``A`` (element matrix
``ke`` on the masked corner dofs of ``geo``), optionally followed by the
free-masked residual ``[inv_d != 0] * (b - A x)``. The semantics are those of
the JAX package's ``ops/pallas_smoother.py::build_fused_smoother``:

* ``inv_d`` is zero at Dirichlet dofs, so ``x`` stays zero there;
* a zero start makes the first sweep ``inv_d * b``, with no operator apply;
* cells are masked by ``mask`` on the gathered corner values.

On CUDA tensors each sweep (and the residual) is one launch of
``csrc/smoother.cu``, ping-ponging between two buffers; a zero-start chain's
first sweep is folded into the next launch. On CPU tensors the chain runs in
plain PyTorch (``smoother_plain``). It never falls back from the kernel to
the plain version: an unsupported input on the card raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._cuda_build import entry_point, launch_check
from .cuda_matvec import hex_corner_layout
from .structured import StructuredGeometry, _matmul

__all__ = [
    "FusedChain",
    "build_fused_smoother",
    "launches",
    "smoother_geometry_ok",
    "smoother_plain",
]

#: number of kernel launches made by the chains of this module
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 7 + [ctypes.c_int] * 5 + [_P]
_SYMBOL = {torch.float32: "fct_smooth_f32", torch.float64: "fct_smooth_f64"}
_entries: dict = {}


def _entry(dtype: torch.dtype):
    if dtype not in _entries:
        _entries[dtype] = entry_point("smoother", _SYMBOL[dtype], _ARGTYPES)
    return _entries[dtype]


def smoother_geometry_ok(geo: StructuredGeometry) -> bool:
    """True for the 3D hex corner layout the kernel is written for (every
    level of a hex hierarchy, the synthetic coarse levels included)."""
    return hex_corner_layout(geo) and 3 * geo.M < 2**31


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


class FusedChain:
    """One level's chain (see ``build_fused_smoother``); ``plain`` runs the
    plain PyTorch version on the same level data whatever the device."""

    def __init__(self, geo, ke, inv_d, mask, *, nu, zero_start, emit_residual):
        self.geo, self.ke, self.inv_d, self.mask = geo, ke, inv_d, mask
        self.nu, self.zero_start, self.emit_residual = nu, zero_start, emit_residual

    def _opts(self) -> dict:
        return dict(nu=self.nu, zero_start=self.zero_start, emit_residual=self.emit_residual)

    def _split(self, args):
        return (None, *args) if self.zero_start else args

    def __call__(self, *args):
        x, b = self._split(args)
        if not b.is_cuda:
            return self.plain(*args)
        return _chain_kernel(self.geo, self.ke, self.inv_d, self.mask, x, b, **self._opts())

    def plain(self, *args):
        x, b = self._split(args)
        return smoother_plain(self.geo, self.ke, self.inv_d, self.mask, x, b, **self._opts())


def build_fused_smoother(geo: StructuredGeometry, ke, inv_d, mask, *, nu: int,
                         zero_start: bool, emit_residual: bool) -> FusedChain:
    """Build one level's chain.

    Args:
        geo: the level's StructuredGeometry (vs, M, corner offsets).
        ke: [24, 24] element matrix (host float64, beta*KE_I + (kappa -
            beta/3)*KE_V at the level moduli), cast to the level's dtype.
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
    ke_t = torch.as_tensor(np.asarray(ke, np.float64), dtype=dtype, device=device)
    inv_d = torch.as_tensor(inv_d, dtype=dtype, device=device).reshape(-1).contiguous()
    mask = torch.as_tensor(mask, dtype=dtype, device=device).reshape(-1).contiguous()
    if ke_t.shape != (geo.n_nodes * geo.vs,) * 2 or inv_d.numel() != geo.vs * geo.M:
        msg = "build_fused_smoother: ke or inv_d does not fit the level"
        raise ValueError(msg)
    return FusedChain(geo, ke_t.contiguous(), inv_d, mask, nu=nu, zero_start=zero_start,
                      emit_residual=emit_residual)


def _chain_kernel(geo, ke, inv_d, mask, x, b, *, nu, zero_start, emit_residual):
    if geo.gdim == 2:
        msg = (
            "the K3 kernel takes 3D hex levels; 2D quad levels on the card are "
            "not ported yet (ROADMAP.md Queue 1, K3 on 2D quad levels)"
        )
        raise NotImplementedError(msg)
    if not smoother_geometry_ok(geo):
        msg = "the K3 kernel supports the 3D P1 hex corner layout only"
        raise ValueError(msg)
    if geo.dtype not in _SYMBOL:
        msg = f"the K3 kernel takes float32 or float64, got {geo.dtype}"
        raise TypeError(msg)
    _check(geo, b, "b")
    M, s0, s1 = geo.M, geo.offsets[1], geo.offsets[2]
    entry = _entry(b.dtype)
    stream = torch.cuda.current_stream(b.device).cuda_stream

    def launch(src, xout, rout, from_b, residual):
        global launches
        rc = entry(
            src.data_ptr(), b.data_ptr(), inv_d.data_ptr(), ke.data_ptr(),
            mask.data_ptr(), None if xout is None else xout.data_ptr(),
            None if rout is None else rout.data_ptr(), int(from_b), int(residual),
            M, s0, s1, stream,
        )
        launch_check("smoother", rc)
        launches += 1

    # src: the current iterate; from_b: it is x1 = inv_d * b, not yet written
    if zero_start:
        src, from_b = (b, True) if nu >= 1 else (torch.zeros_like(b), False)
        sweeps = max(nu - 1, 0)
    else:
        _check(geo, x, "x")
        src, from_b, sweeps = x, False, nu
    with torch.cuda.device(b.device):
        bufs = [torch.empty_like(b) for _ in range(min(sweeps, 2))]
        for i in range(sweeps):
            out = bufs[i % 2]
            launch(src, out, None, from_b, False)
            src, from_b = out, False
        if emit_residual:
            r = torch.empty_like(b)
            xout = torch.empty_like(b) if from_b else None
            launch(src, xout, r, from_b, True)
            return (src if xout is None else xout), r
    # a one-sweep zero-start chain applies no operator: x1 = inv_d * b
    return inv_d * b if from_b else src
