"""Fused CG operator apply: hand-written CUDA kernel and its plain twin.

``build_cuda_matvec(geo)`` returns ``matvec(u_gm, tangent) -> r_gm`` for the
structured hex engine (P1, 2x2x2 Gauss, FULL constraint). On a CUDA tensor
it makes ONE launch of ``csrc/matvec.cu`` (gather, strain, tangent apply and
divergence fused per cell, and the sum of the 8 cells' corner forces onto
each node in the order of the plain version's shifted adds), which writes
the node values ``[3, M]``; no op runs after it. On a CPU tensor it runs the
plain PyTorch version, ``StructuredGeometry.matvec_gm``. It never falls back
from the kernel to the plain version: an unsupported input on the card
raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._cuda_build import entry_point, launch_check, launched
from . import mandel
from .packed import IsotropicTangent
from .structured import StructuredGeometry, StructuredTetGeometry

__all__ = [
    "build_cuda_matvec", "coefficients", "hex_corner_layout", "hex_tables", "launches",
    "matvec_plain",
]

#: number of kernel launches made by the wrappers of this module
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = [_P] * 9 + [ctypes.c_double] + [ctypes.c_int] * 7 + [_P]
_SYMBOL = {torch.float32: "fct_matvec_f32", torch.float64: "fct_matvec_f64"}
_entries: dict = {}


def _entry(dtype: torch.dtype):
    if dtype not in _entries:
        _entries[dtype] = entry_point("matvec", _SYMBOL[dtype], _ARGTYPES)
    return _entries[dtype]


def hex_corner_layout(geo: StructuredGeometry) -> bool:
    """True for the 3D P1 hex corner layout: 3 components, corner a = dx +
    2 dy + 4 dz at the flat node n + dx*s0 + dy*s1 + dz."""
    if (geo.gdim, geo.vs, geo.n_nodes) != (3, 3, 8):
        return False
    s0, s1 = geo.offsets[1], geo.offsets[2]
    expected = tuple(
        (a & 1) * s0 + ((a >> 1) & 1) * s1 + ((a >> 2) & 1) for a in range(8)
    )
    return geo.offsets == expected


def hot_path_geometry(geo) -> bool:
    """True for the geometry the structured-hex kernels (K1, K2) are written
    for. A structured-tet geometry shares the hex corner layout but not the
    8-point hex rule the kernels assume, so it is refused whatever its n_qp;
    every geometry of another engine (lattice, windowed, gather) by type."""
    return (
        isinstance(geo, StructuredGeometry)
        and not isinstance(geo, StructuredTetGeometry)
        and hex_corner_layout(geo) and (geo.n_qp, geo.sdim) == (8, 6) and 48 * geo.M < 2**31
    )


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


def hex_tables(geo: StructuredGeometry) -> dict:
    """What the brick kernels (K1, K2) read of a hot-path geometry, in its
    dtype and device: the cells' gradient table ``dn`` [q][a][i], the
    quadrature weights ``w`` and the Mandel shear factor ``c`` of the
    constraint."""
    dn = np.ascontiguousarray(np.transpose(geo.dN_host, (2, 0, 1)))
    return {
        "dn": torch.as_tensor(dn, dtype=geo.dtype, device=geo.device),
        "w": torch.as_tensor(geo.w_host, dtype=geo.dtype, device=geo.device),
        "c": float(mandel._mandel_matrix_map(geo.constraint)[3, 0, 1]),
    }


def brick(node_grid) -> tuple[int, int, int]:
    """The brick of nodes one block of the kernel owns: 4 x 8 across, and
    along z the fewest runs of at most 17 nodes. Its (b0+1)(b1+1)(b2+1)
    cells' forces fill 77.8 KB (float32) or 155.5 KB (float64) of shared
    memory at 4 x 8 x 17. Within 3% of the best brick of chip_smoke.py's
    sweep (phase 3) on the H100 at 50^3: 0.0312 ms float32 and 0.0617 ms
    float64 on the card, against 0.0404 and 0.0801 ms for 8 x 8 x 13."""
    n0, n1, n2 = node_grid
    runs = -(-n2 // 17)
    return min(4, n0), min(8, n1), -(-n2 // runs)


def _is_scalar(x) -> bool:
    return not isinstance(x, torch.Tensor) or x.numel() == 1


#: coefficient tensors of host numbers a cache keeps (the oldest go first)
_MAX_COEFS = 8


def coefficients(values, dtype, dev, cache: dict) -> torch.Tensor:
    """kappa, beta and gamma as the kernels (K1, K7) read them: 3 values of
    the working type on the device. A device tensor is converted on the card
    (an SLS law's follows dt, so a replay reads each call's value); host
    numbers are filled on the card inside a capture and kept in ``cache``
    between eager calls, so a step captured after its eager warm-up reads
    the kept tensor and makes no fill."""
    if any(isinstance(c, torch.Tensor) for c in values):
        return torch.stack([c.reshape(()).to(dev, dtype) if isinstance(c, torch.Tensor)
                            else torch.full((), float(c), dtype=dtype, device=dev)
                            for c in values])
    key = (*map(float, values), dtype, dev)
    hit = cache.get(key)
    if hit is not None:
        return hit
    coef = torch.empty(3, dtype=dtype, device=dev)
    for i, c in enumerate(key[:3]):
        coef[i].fill_(c)
    if not torch.cuda.is_current_stream_capturing():
        if len(cache) >= _MAX_COEFS:
            cache.pop(next(iter(cache)))
        cache[key] = coef
    return coef


def build_cuda_matvec(geo: StructuredGeometry, *, brick_nodes=None):
    """Return ``matvec(u_gm, tangent) -> r_gm`` (see module docstring).

    ``tangent`` is an IsotropicTangent in the engine's layout: beta, gamma
    [Q, M] and n [6, Q, M], or a uniform tangent (scalar beta and gamma, n of
    6 values). kappa is passed at each call, so a new tangent needs no
    rebuild. Nothing is compiled until the first call on a CUDA tensor.
    ``brick_nodes`` overrides ``brick`` (for a sweep on the card only).
    """
    M, Q = geo.M, geo.n_qp
    node_grid = tuple(g + 1 for g in geo.grid)
    tables = {}
    if hot_path_geometry(geo):
        tables = {**hex_tables(geo),
                  "brick": tuple(brick_nodes) if brick_nodes else brick(node_grid)}

    #: (kappa, beta, gamma, dtype, device) of host numbers -> their device tensor
    coef_cache: dict = {}

    def launch(u_gm, beta, gamma, nf, coef: torch.Tensor, uniform: bool) -> torch.Tensor:
        global launches
        check_cuda_args(geo, beta, gamma, nf, coef)
        r = torch.empty(3 * M, dtype=u_gm.dtype, device=u_gm.device)
        with torch.cuda.device(u_gm.device):
            stream = torch.cuda.current_stream(u_gm.device).cuda_stream
            rc = _entry(u_gm.dtype)(
                u_gm.data_ptr(), beta.data_ptr(), gamma.data_ptr(), nf.data_ptr(),
                geo.mask.data_ptr(), tables["dn"].data_ptr(), tables["w"].data_ptr(),
                r.data_ptr(), coef.data_ptr(), tables["c"], int(uniform), *node_grid,
                *tables["brick"], stream,
            )
        launch_check("matvec", rc)
        launches += launched()
        return r

    def matvec(u_gm: torch.Tensor, tangent: IsotropicTangent) -> torch.Tensor:
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
            nf = tangent.n.reshape(6).to(dev, dtype).contiguous()
            coef = coefficients((tangent.kappa, tangent.beta, tangent.gamma), dtype, dev,
                                coef_cache)
            return launch(u_gm, nf, nf, nf, coef, True)
        beta = torch.as_tensor(tangent.beta, dtype=dtype, device=dev)
        beta = beta.expand(Q, M).contiguous()
        gamma = torch.as_tensor(tangent.gamma, dtype=dtype, device=dev)
        gamma = gamma.expand(Q, M).contiguous()
        nf = tangent.n.expand(6, Q, M).contiguous()
        coef = coefficients((tangent.kappa, 0.0, 0.0), dtype, dev, coef_cache)
        return launch(u_gm, beta, gamma, nf, coef, False)

    return matvec
