"""The degree-2 lattice operator: hand-written CUDA kernel (K8 of
``csrc/lattice.cu``) and its plain PyTorch twin.

``LatticeGeometry.matvec_gm`` calls ``lattice_apply(geo, v_gm, tangent)``
for a CUDA vector where ``lattice_apply_form(geo, tangent)`` holds (an
IsotropicTangent on 27-node hexes with 27 Gauss points, 3 components, the
FULL constraint, float32 or float64), and its plain body everywhere else.
K8 is ONE cooperative launch an apply: the gather, the strain, the factored
tangent, the weighted divergence and the node sums, with the gradients of
the uniform box factored into 1-D tables (``lattice_tables``).
``lattice_apply_plain`` computes the same sum-factorised contractions in
PyTorch and assembles with the plain slice adds; the kernel equals it up to
the order of the sums. Nothing is compiled until the first launch.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ._cuda_build import entry_point, launch_check, launched
from .cuda_matvec import coefficients
from .cuda_window import _tangent_entry
from .mandel import Constraint, _mandel_matrix_map
from .packed import IsotropicTangent
from .structured import LatticeGeometry

__all__ = ["lattice_apply", "lattice_apply_form", "lattice_apply_plain", "lattice_brick",
           "lattice_tables", "launches"]

#: kernel launches made by ``lattice_apply``: the operator applies that took K8
launches = {"lattice_apply": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 8 + [_I] * 10 + [_P]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_I32 = 2**31
_entries: dict = {}


def _entry(dtype: torch.dtype):
    if dtype not in _entries:
        _entries[dtype] = entry_point("lattice", f"fct_lattice_apply_{_SUFFIX[dtype]}", _ARGTYPES)
    return _entries[dtype]


def lattice_apply_form(geo, tangent) -> bool:
    """True when ``LatticeGeometry.matvec_gm`` runs as K8 on CUDA tensors: an
    IsotropicTangent on a 3D box of 27-node hexes (degree 2) with 27 Gauss
    points, 3 components, the FULL constraint, in float32 or float64. The
    geometry and the tangent's type alone decide, before any capture;
    ``lattice_apply`` takes each of the tangent's entries as a field or a
    uniform value, or raises. A DenseTangent, quads, other quadratures and
    constraints, and every CPU tensor run the plain operator."""
    return (isinstance(tangent, IsotropicTangent) and isinstance(geo, LatticeGeometry)
            and geo.dtype in _SUFFIX and geo.constraint == Constraint.FULL
            and (geo.gdim, geo.degree, geo.n_nodes, geo.n_qp, geo.vs) == (3, 2, 27, 27, 3))


def lattice_brick(grid, dtype: torch.dtype) -> tuple[int, int, int]:
    """The brick of cells one block of K8 owns: rows of at most 32 cells
    along axis 2 (one a lane), 4 x 2 of them in float64 (one block an SM:
    132.3 KB of shared memory with the stage buffer) and 2 x 2 in float32
    (three blocks an SM: 50.6 KB each). Fewer, larger bricks share fewer
    nodes through the face buffer; float32 needs the blocks to fill the SMs
    (csrc/lattice.cu has the times)."""
    g0, g1, g2 = grid
    b0 = 4 if dtype == torch.float64 else 2
    return min(b0, g0), min(2, g1), min(32, g2)


def lattice_tables(geo) -> dict:
    """The 1-D tables K8 and its twin read, from the geometry's host
    gradients (kept on the geometry after the first call):

    ``B`` [p][o] = phi_o(xi_p) and ``D`` [k][p][o] = phi_o'(xi_p) / h_k at
    the 3 Gauss points of [0, 1], ``w`` [27] the weights times |det J| at
    q = 9 p0 + 3 p1 + p2, ``c`` the Mandel shear factor, and ``host`` the
    64 doubles the kernel takes (B, D, w, c). Raises where the gradients
    ``dN_host`` [a = o0 + 3 o1 + 9 o2, i, q] do not factor into them to
    1e-12 (a box that is not uniform and axis-aligned)."""
    cached = geo.__dict__.get("_lattice_tables")
    if cached is not None:
        return cached
    from ..fem.elements import _gauss_legendre_01, _tensor_basis_1d

    xi, w1 = _gauss_legendre_01(3)
    B, dB, _ = _tensor_basis_1d(2, xi)  # [p, o]
    # the factored gradient before the scaling of each axis, [o2, o1, o0, i, p0, p1, p2]
    unit = np.stack([
        np.einsum("ax,by,cz->zyxabc", dB, B, B),
        np.einsum("ax,by,cz->zyxabc", B, dB, B),
        np.einsum("ax,by,cz->zyxabc", B, B, dB),
    ], axis=3)
    dN = np.asarray(geo.dN_host, dtype=np.float64).reshape(unit.shape)
    scale = np.array([(dN[:, :, :, k] * unit[:, :, :, k]).sum() / (unit[:, :, :, k] ** 2).sum()
                      for k in range(3)])
    if not np.allclose(unit * scale[None, None, None, :, None, None, None], dN, rtol=1e-12,
                       atol=1e-12 * np.abs(dN).max()):
        msg = "the lattice's gradients do not factor into 1-D tables (a non-uniform box)"
        raise ValueError(msg)
    D = dB[None] * scale[:, None, None]
    w = np.einsum("a,b,c->abc", w1, w1, w1).reshape(27) / abs(float(np.prod(scale)))
    c = float(_mandel_matrix_map(Constraint.FULL)[3, 0, 1])
    host = (ctypes.c_double * 64)(*np.concatenate([B.ravel(), D.ravel(), w, [c]]))
    tables = {"B": B, "D": D, "w": w, "c": c, "host": host}
    geo._lattice_tables = tables
    return tables


def lattice_apply_plain(geo, v_gm: torch.Tensor, tangent) -> torch.Tensor:
    """Plain PyTorch version of K8: grid-major [3 M] -> grid-major [3 M].

    The kernel's contractions in its order (``csrc/lattice.cu``: A, B, C,
    BT, AT) on every cell at once, the tangent's ``apply``, then the plain
    slice adds of ``LatticeGeometry.assemble_gm``. Holds where
    ``lattice_apply_form`` does."""
    t = lattice_tables(geo)
    dtype, dev, C = v_gm.dtype, v_gm.device, geo.n_cells

    def tab(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    B, D0, D1, D2 = tab(t["B"]), tab(t["D"][0]), tab(t["D"][1]), tab(t["D"][2])
    c = t["c"]
    U = geo._elem_dofs_cm(v_gm.reshape(3, geo.M)).reshape(3, 3, 3, 3, C)  # [o2, o1, o0, j, C]
    # A: contract o2 -> [o0, o1, p2, j, C]
    TB = torch.einsum("ro,oyxjc->xyrjc", B, U)
    TD = torch.einsum("ro,oyxjc->xyrjc", D2, U)
    # B: contract o1 -> [o0, p1, p2, j, C]
    BB = torch.einsum("qy,xyrjc->xqrjc", B, TB)
    DB = torch.einsum("qy,xyrjc->xqrjc", D1, TB)
    BD = torch.einsum("qy,xyrjc->xqrjc", B, TD)
    # C: contract o0 -> the gradient H[i][j] at [p0, p1, p2]
    H = [torch.einsum("px,xqrjc->pqrjc", T0, X).reshape(27, 3, C)
         for T0, X in ((D0, BB), (B, DB), (B, BD))]
    e = torch.stack([H[0][:, 0], H[1][:, 1], H[2][:, 2], c * (H[0][:, 1] + H[1][:, 0]),
                     c * (H[0][:, 2] + H[2][:, 0]), c * (H[1][:, 2] + H[2][:, 1])])
    sig = tangent.apply(e) * tab(t["w"])[None, :, None]  # [6, 27, C]
    s0, s1, s2, s3, s4, s5 = sig[0], sig[1], sig[2], c * sig[3], c * sig[4], c * sig[5]
    G = [torch.stack(row, dim=1).reshape(3, 3, 3, 3, C)  # [p0, p1, p2, j, C]
         for row in ((s0, s3, s4), (s3, s1, s5), (s4, s5, s2))]
    # C transposed: contract p0 -> [o0, p1, p2, j, C]
    S0 = torch.einsum("px,pqrjc->xqrjc", D0, G[0])
    S1 = torch.einsum("px,pqrjc->xqrjc", B, G[1])
    S2 = torch.einsum("px,pqrjc->xqrjc", B, G[2])
    # BT: contract p1 -> [o0, o1, p2, j, C]
    Ra = torch.einsum("qy,xqrjc->xyrjc", B, S0) + torch.einsum("qy,xqrjc->xyrjc", D1, S1)
    Rb = torch.einsum("qy,xqrjc->xyrjc", B, S2)
    # AT: contract p2 -> the forces [o2, o1, o0, j, C], rows (a, j)
    f = torch.einsum("rz,xyrjc->zyxjc", B, Ra) + torch.einsum("rz,xyrjc->zyxjc", D2, Rb)
    return geo.assemble_gm(f.reshape(81, C))


def lattice_apply(geo, v_gm: torch.Tensor, tangent) -> torch.Tensor:
    """K8: grid-major v [3 M] -> grid-major A v [3 M] in one launch.

    Equals ``lattice_apply_plain`` (and the plain ``matvec_gm``) up to the
    order of the sums; two launches agree bit for bit. kappa, and a beta or
    gamma given as a host number, are read from a 3-value device tensor
    (``cuda_matvec.coefficients``, kept per geometry), so a captured replay
    reads each call's values; a tensor entry is read where it lies once it
    has the working dtype and a contiguous layout (a uniform one, or a view
    that repeats its values along the Gauss points, with QP stride 0).
    """
    name = "lattice_apply"
    if not lattice_apply_form(geo, tangent):
        msg = (f"{name}: K8 applies an IsotropicTangent on 3D 27-node hexes with 27 Gauss "
               "points and the FULL constraint in float32 or float64")
        raise ValueError(msg)
    if not v_gm.is_cuda:
        msg = f"{name}: the CUDA kernel takes CUDA tensors, got one on {v_gm.device}"
        raise ValueError(msg)
    if v_gm.dtype != geo.dtype:
        msg = f"{name}: a vector of {v_gm.dtype}, geometry of {geo.dtype}"
        raise TypeError(msg)
    M, N = geo.M, geo.N
    if v_gm.shape != (3 * M,) or not v_gm.is_contiguous():
        msg = f"{name}: expected a contiguous vector of {3 * M} values, got {tuple(v_gm.shape)}"
        raise ValueError(msg)
    if 6 * N >= _I32 or 3 * M >= _I32:
        msg = f"{name}: the box overflows the kernel's 32-bit indices"
        raise ValueError(msg)
    kappa = tangent.kappa
    if isinstance(kappa, torch.Tensor) and kappa.numel() != 1:
        msg = f"{name}: kappa must be one value, got {kappa.numel()}"
        raise ValueError(msg)
    if not isinstance(tangent.n, torch.Tensor):
        msg = f"{name}: the tangent's n must be a tensor"
        raise TypeError(msg)
    dtype, dev = v_gm.dtype, v_gm.device
    entries = {key: _tangent_entry(name, key, x, k, N, dtype, dev)
               for key, x, k in (("beta", tangent.beta, 1), ("gamma", tangent.gamma, 1),
                                 ("n", tangent.n, 6)) if isinstance(x, torch.Tensor)}
    coef = coefficients(
        (kappa, *(0.0 if isinstance(x, torch.Tensor) else x
                  for x in (tangent.beta, tangent.gamma))), dtype, dev,
        geo.__dict__.setdefault("_coef_cache", {}))
    size = coef.element_size()
    beta, gamma = (
        (entries[key][0].data_ptr(), entries[key][1]) if key in entries
        else (coef.data_ptr() + slot * size, 0) for slot, key in ((1, "beta"), (2, "gamma")))
    n, n_qs = entries["n"]
    grid = geo.grid
    brick = lattice_brick(grid, dtype)
    n_bricks = math.prod(-(-g // b) for g, b in zip(grid, brick))
    face = v_gm.new_empty(n_bricks * 3 * math.prod(2 * b + 1 for b in brick))
    r = torch.empty_like(v_gm)
    args = (v_gm.data_ptr(), beta[0], gamma[0], n.data_ptr(), coef.data_ptr(), r.data_ptr(),
            face.data_ptr(), ctypes.addressof(lattice_tables(geo)["host"]), *grid, *brick,
            beta[1], gamma[1], N if n_qs else 1, n_qs)
    # PyTorch's current raw stream, switching the current device only if it differs
    index = v_gm.get_device()
    if torch._C._cuda_getDevice() == index:
        rc = _entry(dtype)(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = _entry(dtype)(*args, torch._C._cuda_getCurrentRawStream(index))
    launch_check("lattice", rc)
    launches["lattice_apply"] += launched()
    return r
