"""Drucker-Prager's implicit return map as one hand-written CUDA kernel (K9
of ``csrc/return_map.cu``), one thread a quadrature point.

``_DruckerPragerBase.evaluate`` (``models/drucker_prager.py``) calls
``dp_return_map(model, stress, del_eps, alpha)`` for CUDA tensors where
``dp_return_map_form(model, stress)`` holds: a ``DruckerPrager3D`` or
``DruckerPragerHyperbolic3D`` (the class, not a subclass, decides the J2
term), float32 or float64. Every other input, and every CPU tensor, runs the
plain twin ``models/plasticity_general.py::implicit_return_map``, which K9
equals up to rounding: the same residual, Jacobian, stopping rule and
consistent tangent, a trip's 8 x 8 solve taken as the 7 x 7 block of
(sigma, lam) and the hardening row. On a CUDA tensor ``dp_return_map``
launches K9 or raises; it never falls back. Nothing is compiled until the
first launch.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..utils.timers import scope
from . import mandel
from ._cuda_build import entry_point, launch_check, launched

__all__ = ["dp_return_map", "dp_return_map_form", "launches"]

#: kernel launches made by ``dp_return_map``: the Drucker-Prager evaluations that took K9
launches = {"dp_return_map": 0}

_P = ctypes.c_void_p
_D = ctypes.c_double
_I = ctypes.c_int
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 7 + [_D] * 11 + [_I] * 2 + [_L] * 6 + [_P]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_entries: dict = {}


def _entry(dtype: torch.dtype):
    if dtype not in _entries:
        _entries[dtype] = entry_point("return_map", f"fct_dp_return_map_{_SUFFIX[dtype]}",
                                      _ARGTYPES)
    return _entries[dtype]


def _cone(model) -> bool | None:
    """True for DruckerPrager3D (J2 clamped at 1e-30), False for
    DruckerPragerHyperbolic3D (J2 + d^2), None for any other law."""
    from ..models.drucker_prager import DruckerPrager3D, DruckerPragerHyperbolic3D

    return {DruckerPrager3D: True, DruckerPragerHyperbolic3D: False}.get(type(model))


def dp_return_map_form(model, stress: torch.Tensor) -> bool:
    """True when ``model.evaluate`` runs as K9: a DruckerPrager3D or
    DruckerPragerHyperbolic3D on a CUDA stress of float32 or float64. The
    law's class and the stress alone decide; ``dp_return_map`` then takes
    the other inputs or raises."""
    return stress.is_cuda and stress.dtype in _SUFFIX and _cone(model) is not None


@lru_cache(maxsize=None)
def _elastic(mu: float, kappa: float, dtype: torch.dtype) -> tuple[float, float, float]:
    """C's normal diagonal, normal off-diagonal and shear diagonal entries,
    rounded as ``mandel.isotropic_elastic_tangent`` forms C in ``dtype``
    (2 mu P_dev + 3 kappa P_vol, each product and the sum rounded to it).
    Host numpy: a first call inside a captured step reads no tensor back."""
    t = np.float32 if dtype == torch.float32 else np.float64
    C = (t(2.0 * mu) * mandel.projection_dev(6).astype(t)
         + t(3.0 * kappa) * mandel.projection_vol(6).astype(t))
    return float(C[0, 0]), float(C[0, 1]), float(C[3, 3])


def dp_return_map(model, stress: torch.Tensor, del_eps: torch.Tensor, alpha: torch.Tensor):
    """K9: the return map of a Drucker-Prager law at Q points in one launch.

    Args: ``stress`` [Q, 6] committed Mandel stress, ``del_eps`` [Q, 6]
    strain increment, ``alpha`` [Q, 1] committed hardening variable, each
    read through its strides, all of one dtype (float32 or float64) on one
    CUDA device.

    Returns ``(sigma_1 [Q, 6], tangent [Q, 6, 6], alpha_1 [Q, 1],
    del_plastic_strain [Q, 6])`` as ``implicit_return_map`` does: sigma_1,
    alpha_1 and the plastic strain increment as views of [6, Q] and [1, Q]
    buffers (the layout the generic adapter packs without a copy), the
    tangent with strides (36, 1, 6), each point's matrix column-major, the
    memory order of the plain map's batched solve that the dense-tangent
    operator reads. Runs inside the scope ``law.return_map``; two launches
    agree bit for bit.
    """
    name = "dp_return_map"
    cone = _cone(model)
    if cone is None:
        msg = (f"{name}: K9 runs DruckerPrager3D and DruckerPragerHyperbolic3D, got "
               f"{type(model).__name__}")
        raise ValueError(msg)
    Q = stress.shape[0] if stress.dim() == 2 else -1
    for key, x, shape in (("stress", stress, (Q, 6)), ("del_eps", del_eps, (Q, 6)),
                          ("alpha", alpha, (Q, 1))):
        if Q < 0 or tuple(x.shape) != shape:
            msg = f"{name}: expected {key} of shape {('Q', *shape[1:])}, got {tuple(x.shape)}"
            raise ValueError(msg)
    dtype = stress.dtype
    if dtype not in _SUFFIX or del_eps.dtype != dtype or alpha.dtype != dtype:
        msg = (f"{name}: the CUDA kernel takes float32 or float64, all alike; got stress "
               f"{dtype}, del_eps {del_eps.dtype}, alpha {alpha.dtype}")
        raise TypeError(msg)
    dev = stress.device
    if del_eps.device != dev or alpha.device != dev:
        msg = (f"{name}: mixed devices: stress on {dev}, del_eps on {del_eps.device}, alpha "
               f"on {alpha.device}")
        raise ValueError(msg)
    if not stress.is_cuda:
        msg = f"{name}: the CUDA kernel takes CUDA tensors, got them on {dev}"
        raise ValueError(msg)
    p = model.params
    c_d, c_o, c_s = _elastic(p["mu"], p["kappa"], dtype)
    with scope("law.return_map"):
        sig1 = stress.new_empty((6, Q))
        tangent = stress.new_empty((Q, 6, 6))
        alpha1 = stress.new_empty((1, Q))
        depsp = stress.new_empty((6, Q))
        if Q:
            args = (stress.data_ptr(), del_eps.data_ptr(), alpha.data_ptr(), sig1.data_ptr(),
                    tangent.data_ptr(), alpha1.data_ptr(), depsp.data_ptr(), c_d, c_o, c_s,
                    0.5 / p["mu"], 1.0 / (9.0 * p["kappa"]), p["a"], p["b"], p["b_flow"],
                    0.0 if cone else p["d"] ** 2, model.newton_atol, model.newton_rtol,
                    int(model.newton_maxit), int(cone), Q, *stress.stride(), *del_eps.stride(),
                    alpha.stride(0))
            # PyTorch's current raw stream, switching the current device only if it differs
            index = stress.get_device()
            if torch._C._cuda_getDevice() == index:
                rc = _entry(dtype)(*args, torch._C._cuda_getCurrentRawStream(index))
            else:
                with torch.cuda.device(index):
                    rc = _entry(dtype)(*args, torch._C._cuda_getCurrentRawStream(index))
            launch_check("return_map", rc)
            launches["dp_return_map"] += launched()
    return sig1.T, tangent.transpose(1, 2), alpha1.T, depsp.T
