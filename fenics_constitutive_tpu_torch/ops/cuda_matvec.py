"""Fused CG operator apply: hand-written CUDA kernel and its plain twin.

``build_cuda_matvec(geo)`` returns ``matvec(u_gm, tangent) -> r_gm`` for the
structured hex engine (P1, 2x2x2 Gauss, FULL constraint). On a CUDA tensor
it launches ``csrc/matvec.cu`` (gather, strain, tangent apply and divergence
fused per cell origin) and then sums the 24 per-corner force channels onto
the nodes with the geometry's deterministic shifted adds. On a CPU tensor it
runs the plain PyTorch version, ``StructuredGeometry.matvec_gm``. It never
falls back from the kernel to the plain version: an unsupported input on
the card raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda_build import entry_point, launch_check
from .packed import IsotropicTangent
from .structured import StructuredGeometry

__all__ = ["build_cuda_matvec", "launches", "matvec_plain"]

#: number of kernel launches made by the wrappers of this module
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 8 + [ctypes.c_double] * 3 + [ctypes.c_int] * 4 + [_P]
_SYMBOL = {torch.float32: "fct_matvec_f32", torch.float64: "fct_matvec_f64"}
_entries: dict = {}


def _entry(dtype: torch.dtype):
    if dtype not in _entries:
        _entries[dtype] = entry_point("matvec", _SYMBOL[dtype], _ARGTYPES)
    return _entries[dtype]


def hot_path_geometry(geo: StructuredGeometry) -> bool:
    """True for the geometry the structured-hex kernels are written for."""
    if (geo.gdim, geo.n_qp, geo.vs, geo.sdim, geo.n_nodes) != (3, 8, 3, 6, 8):
        return False
    s0, s1 = geo.offsets[1], geo.offsets[2]
    expected = tuple(
        (a & 1) * s0 + ((a >> 1) & 1) * s1 + ((a >> 2) & 1) for a in range(8)
    )
    return geo.offsets == expected and 48 * geo.M < 2**31


def check_cuda_args(geo: StructuredGeometry, *tensors: torch.Tensor) -> None:
    """Raise unless the kernels can take these tensors of this geometry."""
    if not hot_path_geometry(geo):
        msg = "the CUDA kernels support the 3D P1 hex engine with 2x2x2 Gauss points"
        raise ValueError(msg)
    dtype = geo.dtype
    if dtype not in (torch.float32, torch.float64):
        msg = f"the CUDA kernels take float32 or float64, got {dtype}"
        raise TypeError(msg)
    for t in tensors:
        if t.device != geo.device:
            msg = f"tensor on {t.device}, geometry on {geo.device}"
            raise ValueError(msg)
        if t.dtype != dtype:
            msg = f"tensor of {t.dtype}, geometry of {dtype}"
            raise TypeError(msg)
        if not t.is_contiguous():
            msg = "the CUDA kernels take contiguous tensors"
            raise ValueError(msg)


def matvec_plain(geo: StructuredGeometry, u_gm: torch.Tensor, tangent) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function."""
    return geo.matvec_gm(u_gm, tangent)


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.numel() == 1


def build_cuda_matvec(geo: StructuredGeometry):
    """Return ``matvec(u_gm, tangent) -> r_gm`` (see module docstring).

    ``tangent`` is an IsotropicTangent in the engine's layout: beta, gamma
    [Q, M] and n [6, Q, M], or a uniform tangent (scalar beta and gamma, n of
    6 values). kappa is passed at each call, so a new tangent needs no
    rebuild. Nothing is compiled until the first call on a CUDA tensor.
    """
    M, Q = geo.M, geo.n_qp
    s0 = s1 = 0
    if hot_path_geometry(geo):
        s0, s1 = geo.offsets[1], geo.offsets[2]

    def matvec(u_gm: torch.Tensor, tangent: IsotropicTangent) -> torch.Tensor:
        global launches
        if not u_gm.is_cuda:
            return matvec_plain(geo, u_gm, tangent)
        check_cuda_args(geo, u_gm)
        if u_gm.numel() != 3 * M:
            msg = f"u_gm has {u_gm.numel()} values, expected {3 * M}"
            raise ValueError(msg)
        dtype, dev = u_gm.dtype, u_gm.device
        uniform = (
            _is_scalar(tangent.beta) and _is_scalar(tangent.gamma)
            and tangent.n.numel() == 6
        )
        if uniform:
            beta_u, gamma_u = float(tangent.beta), float(tangent.gamma)
            nf = tangent.n.reshape(6).to(dev, dtype).contiguous()
            beta = gamma = nf
        else:
            beta_u = gamma_u = 0.0
            beta = torch.as_tensor(tangent.beta, dtype=dtype, device=dev)
            beta = beta.expand(Q, M).contiguous()
            gamma = torch.as_tensor(tangent.gamma, dtype=dtype, device=dev)
            gamma = gamma.expand(Q, M).contiguous()
            nf = tangent.n.expand(6, Q, M).contiguous()
        check_cuda_args(geo, beta, gamma, nf)
        F = torch.empty((24, M), dtype=dtype, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _entry(dtype)(
                u_gm.data_ptr(), beta.data_ptr(), gamma.data_ptr(), nf.data_ptr(),
                geo.mask.data_ptr(), geo.KEPS_c.data_ptr(), geo.KDIV_c.data_ptr(),
                F.data_ptr(), float(tangent.kappa), beta_u, gamma_u, int(uniform),
                M, s0, s1, stream,
            )
        launch_check("matvec", rc)
        launches += 1
        return geo._scatter_corners(F).reshape(-1)

    return matvec
