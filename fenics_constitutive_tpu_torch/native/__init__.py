"""ctypes bindings of the native (C++) model library and the UMAT harness.

The C API is ``native/include/comfe.h``; its sources (``native/src``,
``native/umat``) are compiled here directly with the system's ``c++`` and
``cc`` (and ``gfortran`` for the Fortran UMAT, where one exists) into
``fenics_constitutive_tpu_torch/_build/native/<hash of the sources>/``, at
the first use. A model runs on the host: ``evaluate`` copies its operands to
contiguous float64 host arrays, calls the library, and returns new tensors on
the caller's device and dtype; the operands are never written. Assembly and
the solver stay on the device. A failed build raises; nothing falls back to
a Python model.

A law of one's own in C or C++ takes the same route (``examples/torch/
elasticity_cpp``, ``examples/torch/mises_c``): ``build_shared_library``
compiles its sources once, and ``host_copy`` / ``device_copy`` move its
operands to the host and its results back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ..models.interfaces import IncrSmallStrainModel
from ..ops.mandel import Constraint

__all__ = [
    "LinearElasticity3D",
    "NativeModel",
    "UmatModel",
    "build_shared_library",
    "device_copy",
    "ensure_built",
    "host_copy",
    "load_library",
    "umat_demo_path",
    "umat_fortran_path",
]

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "_build"
_BUILD_ROOT = _BUILD / "native"
_LIB = None

#: target -> (compiler, sources, extra flags)
_TARGETS = {
    "libcomfe.so": ("c++", ("src/models.cpp", "src/umat_harness.cpp"),
                    ("-std=c++17", "-I" + str(_NATIVE_DIR / "include"))),
    "libumat_linear_elastic.so": ("cc", ("umat/umat_linear_elastic.c",), ()),
    "libumat_fortran_linear_elastic.so": ("gfortran", ("umat/umat_linear_elastic.f",), ()),
}


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for sub in ("include", "src", "umat"):
        for f in sorted((_NATIVE_DIR / sub).glob("*")):
            if f.is_file():
                h.update(f.name.encode())
                h.update(f.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _compile_atomic(out: pathlib.Path, attempts: list[list[str]]) -> None:
    """Run the first of ``attempts`` (compiler commands without their output)
    that succeeds, writing ``out`` atomically (a temporary file, then a
    rename, so concurrent builds never load a half-written library); raise
    RuntimeError with the compiler's message if none does."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        for i, cmd in enumerate(attempts):
            cmd = [*cmd, "-o", tmp]
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            if proc.returncode == 0:
                os.replace(tmp, out)
                return
            if i == len(attempts) - 1:
                msg = f"building {out.name} failed: {' '.join(cmd)}\n{proc.stderr}"
                raise RuntimeError(msg)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _compile(target: str, out: pathlib.Path) -> None:
    """Compile one target of the library into ``out``."""
    compiler, sources, flags = _TARGETS[target]
    srcs = [str(_NATIVE_DIR / s) for s in sources]
    base = [compiler, "-O3", "-shared", "-fPIC", *flags, *srcs]
    _compile_atomic(out, [base + ["-fopenmp", "-ldl"], base + ["-ldl"]]
                    if target == "libcomfe.so" else [base])


def build_shared_library(sources, name: str, *, compiler: str = "c++",
                         flags=("-O2",)) -> pathlib.Path:
    """Compile C or C++ ``sources`` with ``compiler -shared -fPIC`` into the
    library ``name`` under ``fenics_constitutive_tpu_torch/_build/examples/
    <hash of the sources, compiler and flags>/``, unless it is there already;
    return its path. ``flags`` follow the sources on the command line, so
    they may name libraries (``-lm``). A missing compiler or a failed build
    raises RuntimeError."""
    srcs = [pathlib.Path(s).resolve() for s in sources]
    h = hashlib.sha256(" ".join([compiler, *flags]).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = _BUILD / "examples" / h.hexdigest()[:16] / name
    if not out.exists():
        if shutil.which(compiler) is None:
            msg = f"building {name} needs the compiler '{compiler}', which is not on PATH"
            raise RuntimeError(msg)
        out.parent.mkdir(parents=True, exist_ok=True)
        _compile_atomic(out, [[compiler, "-shared", "-fPIC", *map(str, srcs), *flags]])
    return out


def ensure_built(force: bool = False) -> pathlib.Path:
    """Build the native library and the C demo UMAT if needed (and the
    Fortran UMAT where ``gfortran`` exists); return the library's path."""
    d = _build_dir()
    d.mkdir(parents=True, exist_ok=True)
    for target, (compiler, _, _) in _TARGETS.items():
        out = d / target
        if compiler == "gfortran" and shutil.which("gfortran") is None:
            continue
        if force or not out.exists():
            if shutil.which(compiler) is None:
                msg = f"building {target} needs the compiler '{compiler}', which is not on PATH"
                raise RuntimeError(msg)
            _compile(target, out)
    return d / "libcomfe.so"


def umat_demo_path() -> pathlib.Path:
    """Path of the built linear-elastic demo UMAT (C, Abaqus ABI)."""
    return ensure_built().parent / "libumat_linear_elastic.so"


def umat_fortran_path() -> pathlib.Path | None:
    """Path of the gfortran-built linear-elastic UMAT, or None where the
    machine has no Fortran compiler."""
    p = ensure_built().parent / "libumat_fortran_linear_elastic.so"
    return p if p.exists() else None


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(ensure_built()))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.comfe_history_size.argtypes = [ctypes.c_char_p]
    lib.comfe_history_size.restype = ctypes.c_int
    lib.comfe_n_params.argtypes = [ctypes.c_char_p]
    lib.comfe_n_params.restype = ctypes.c_int
    lib.comfe_evaluate.argtypes = [
        ctypes.c_char_p, dp, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        dp, dp, dp, dp, ctypes.c_long,
    ]
    lib.comfe_evaluate.restype = ctypes.c_long
    lib.comfe_umat_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.comfe_umat_open.restype = ctypes.c_void_p
    lib.comfe_umat_close.argtypes = [ctypes.c_void_p]
    lib.comfe_umat_evaluate.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        dp, dp, dp, dp, ctypes.c_int, dp, dp, ctypes.c_int, ctypes.c_long,
    ]
    lib.comfe_umat_evaluate.restype = ctypes.c_int
    _LIB = lib
    return lib


def host_copy(x) -> np.ndarray:
    """A new flat, contiguous float64 host array of ``x`` (a tensor on any
    device, or an array): never a view of ``x``, because C code writes
    through its pointer."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64, copy=True).numpy()
    return np.array(x, dtype=np.float64, copy=True).reshape(-1)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def device_copy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host array as a new tensor of ``like``'s dtype and device."""
    return torch.as_tensor(a).to(dtype=like.dtype, device=like.device)


class NativeModel(IncrSmallStrainModel):
    """A model of the native library, FULL constraint:
    ``NativeModel("mises_linear_hardening3d", {"mu": ..., "kappa": ...,
    "y_0": ..., "h": ...})``. History is one flat entry ``{"history": h}``
    ([alpha, plastic strain x 6] for the plastic models). A point whose local
    Newton diverges comes back NaN at that point only (the library poisons
    it)."""

    #: parameter order per model (native/src/models.cpp)
    PARAM_ORDER = {
        "linear_elasticity3d": ("mu", "kappa"),
        "mises_linear_hardening3d": ("mu", "kappa", "y_0", "h"),
        "drucker_prager3d": ("mu", "kappa", "a", "b", "b_flow"),
        "drucker_prager_hyperbolic3d": ("mu", "kappa", "a", "b", "d", "b_flow"),
    }

    def __init__(self, name: str, parameters: dict[str, float]):
        if name not in self.PARAM_ORDER:
            msg = f"unknown native model {name!r}"
            raise ValueError(msg)
        self._name = name
        self._hsize = load_library().comfe_history_size(name.encode())
        self.params = {k: float(np.asarray(parameters[k]).reshape(()))
                       for k in self.PARAM_ORDER[name]}

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self):
        return {"history": self._hsize} if self._hsize else None

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        q, h = grad_del_u.shape[0], self._hsize
        grad = host_copy(grad_del_u)
        sig = host_copy(stress)
        tangent = np.zeros(q * 36)
        hist = host_copy(history["history"]) if h else None
        params = np.asarray(list(self.params.values()), np.float64)
        load_library().comfe_evaluate(
            self._name.encode(), _ptr(params), len(params), float(t), float(del_t),
            _ptr(grad), _ptr(sig), _ptr(tangent), _ptr(hist) if h else None, q,
        )
        h_new = {"history": device_copy(hist.reshape(q, h), stress)} if h else None
        return (device_copy(sig.reshape(q, 6), stress),
                device_copy(tangent.reshape(q, 6, 6), stress), h_new)


class UmatModel(IncrSmallStrainModel):
    """An Abaqus UMAT (a shared library exporting ``symbol``) driven through
    the harness, FULL constraint. History: ``{"statev": n_statev, "strain":
    6}``, the harness keeping the total Mandel strain."""

    def __init__(self, so_path, props, n_statev: int = 1, symbol: str = "umat_"):
        self._so_path = str(so_path)
        self._symbol = symbol
        self._n_statev = max(int(n_statev), 1)
        if isinstance(props, dict):
            props = list(props.values())
        self.props = [float(p) for p in props]
        self._handle = None

    def _get_handle(self):
        if self._handle is None:
            h = load_library().comfe_umat_open(self._so_path.encode(), self._symbol.encode())
            if not h:
                msg = f"failed to dlopen {self._so_path}:{self._symbol}"
                raise OSError(msg)
            self._handle = h
        return self._handle

    @property
    def constraint(self) -> Constraint:
        return Constraint.FULL

    @property
    def history_dim(self):
        return {"statev": self._n_statev, "strain": 6}

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        q, nsv = grad_del_u.shape[0], self._n_statev
        grad = host_copy(grad_del_u)
        sig = host_copy(stress)
        statev = host_copy(history["statev"])
        strain = host_copy(history["strain"])
        tangent = np.zeros(q * 36)
        props = np.asarray(self.props, np.float64)
        rc = load_library().comfe_umat_evaluate(
            self._get_handle(), float(t), float(del_t), _ptr(grad), _ptr(sig), _ptr(tangent),
            _ptr(statev), nsv, _ptr(strain), _ptr(props), len(props), q,
        )
        if rc != 0:
            msg = f"the UMAT harness failed (rc={rc})"
            raise RuntimeError(msg)
        return (
            device_copy(sig.reshape(q, 6), stress),
            device_copy(tangent.reshape(q, 6, 6), stress),
            {"statev": device_copy(statev.reshape(q, nsv), stress),
             "strain": device_copy(strain.reshape(q, 6), stress)},
        )


def LinearElasticity3D(parameters: dict) -> NativeModel:
    """The native linear elasticity model, parameters {"mu", "kappa"}."""
    return NativeModel("linear_elasticity3d", parameters)
