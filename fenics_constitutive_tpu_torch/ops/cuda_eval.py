"""Fused constitutive eval + assembly: hand-written CUDA kernel and its
plain twin.

``build_cuda_eval(geo, model)`` returns
``eval_assemble(du_gm, stress, history) -> (r_gm, stress', (beta, gamma, n),
history')`` for ``VonMises3D`` on the structured hex engine. ``r_gm`` is the
assembled residual [3*M] (grid-major), the tangent fields are beta, gamma
[Q, M] and n [6, Q, M] (kappa is the model's bulk modulus), and the history
is ``{"eps_n": [6, Q, M], "alpha": [1, Q, M]}``.

On a CUDA tensor it makes ONE cooperative launch of ``csrc/eval.cu``: every
cell's corner gather, strain, radial return and new state, a grid-wide
barrier, then each node's sum of its 8 cells' corner forces (formed from
the new stress) in the order of the plain version's shifted adds. It writes
the node values and every state output; no op runs after it. On a
CPU tensor it runs the plain PyTorch version (``eval_plain``: strain_gm ->
the SoA radial return -> residual_gm, the plain step's own computation). It
never falls back from the kernel to the plain version: an unsupported input
on the card raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.mises import VonMises3D
from ..models.packed_models import newton_controls
from ._cuda_build import entry_point, launch_check, launched
from .cuda_matvec import check_cuda_args, hex_tables, hot_path_geometry
from .structured import StructuredGeometry

__all__ = ["build_cuda_eval", "eval_plain", "launches"]

#: number of kernel launches made by the wrappers of this module
launches = 0

_P = ctypes.c_void_p
_ARGTYPES = (
    [_P] * 14 + [ctypes.c_double] * 7 + [ctypes.c_int] + [ctypes.c_double] * 2
    + [ctypes.c_int] * 3 + [_P]
)
_SYMBOL = {torch.float32: "fct_eval_f32", torch.float64: "fct_eval_f64"}
_entries: dict = {}


def _entry(dtype: torch.dtype):
    if dtype not in _entries:
        _entries[dtype] = entry_point("eval", _SYMBOL[dtype], _ARGTYPES)
    return _entries[dtype]


def eval_plain(geo: StructuredGeometry, model, du_gm, stress, history):
    """Plain PyTorch version of the kernel's function, in its layout."""
    Q, M = geo.n_qp, geo.M
    eps = geo.strain_gm(du_gm)
    s_new, tg, h_new = model.evaluate_packed(0.0, 1.0, eps, stress, history)
    fields = (
        torch.as_tensor(tg.beta).expand(Q, M),
        torch.as_tensor(tg.gamma).expand(Q, M),
        tg.n.expand(6, Q, M),
    )
    return geo.residual_gm(s_new), s_new, fields, h_new


def build_cuda_eval(geo: StructuredGeometry, model: VonMises3D):
    """Return ``eval_assemble(du_gm, stress, history)`` (module docstring).

    The model's parameters are read at each call, so changing them needs no
    rebuild. Nothing is compiled until the first call on a CUDA tensor.
    """
    if not isinstance(model, VonMises3D):
        msg = f"the fused eval implements VonMises3D, got {type(model).__name__}: use 'plain'"
        raise ValueError(msg)
    M, Q = geo.M, geo.n_qp
    node_grid = tuple(g + 1 for g in geo.grid)
    tables = hex_tables(geo) if hot_path_geometry(geo) else {}

    def eval_assemble(du_gm, stress, history):
        global launches
        if not du_gm.is_cuda:
            return eval_plain(geo, model, du_gm, stress, history)
        eps_n, alpha = history["eps_n"], history["alpha"]
        check_cuda_args(geo, du_gm, stress, eps_n, alpha)
        for name, t, shape in (
            ("du_gm", du_gm, (3 * M,)),
            ("stress", stress, (6, Q, M)),
            ("eps_n", eps_n, (6, Q, M)),
            ("alpha", alpha, (1, Q, M)),
        ):
            if tuple(t.shape) != shape:
                msg = f"{name} has shape {tuple(t.shape)}, expected {shape}"
                raise ValueError(msg)
        dtype, dev = du_gm.dtype, du_gm.device

        def empty(*shape):
            return torch.empty(shape, dtype=dtype, device=dev)

        r = empty(3 * M)
        s_new, e_new, n_new = empty(6, Q, M), empty(6, Q, M), empty(6, Q, M)
        a_new, beta, gamma = empty(1, Q, M), empty(Q, M), empty(Q, M)
        p = model.params
        tol, rtol, max_it = newton_controls(model, dtype)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = _entry(dtype)(
                du_gm.data_ptr(), stress.data_ptr(), eps_n.data_ptr(),
                alpha.data_ptr(), geo.mask.data_ptr(), tables["dn"].data_ptr(),
                tables["w"].data_ptr(), r.data_ptr(), s_new.data_ptr(),
                e_new.data_ptr(), a_new.data_ptr(), beta.data_ptr(),
                gamma.data_ptr(), n_new.data_ptr(),
                p["p_ka"], p["p_mu"], p["p_y0"], p["p_y00"], p["p_w"],
                tol, rtol, max_it, torch.finfo(dtype).eps, tables["c"],
                *node_grid, stream,
            )
        launch_check("eval", rc)
        launches += launched()
        return r, s_new, (beta, gamma, n_new), {"eps_n": e_new, "alpha": a_new}

    return eval_assemble
