"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` exposes a plain C interface. On first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``fenics_constitutive_tpu_torch/_build/``, named by a hash of the sources and
flags so an edited kernel is rebuilt, and loaded with ``ctypes``. Nothing
here runs when the module is imported. A missing ``nvcc`` or a failed build
raises with the compiler's message; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_log", "entry_point", "launch_check", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # register and spill report of every kernel, kept in build_log
    "-Xptxas=-v",
)

#: name -> {"seconds": build time (0.0 if the library was already built),
#: "log": nvcc's output, "path": the library}
build_log: dict[str, dict] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    msg = "nvcc not found (set CUDA_HOME or put nvcc on PATH) to build the CUDA kernels"
    raise RuntimeError(msg)


def _source_hash(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    with _lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}_{_source_hash(src)}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                msg = f"nvcc failed for {src.name} (exit {proc.returncode}):\n{log}"
                raise RuntimeError(msg)
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.fct_error_string.argtypes = [ctypes.c_int]
        lib.fct_error_string.restype = ctypes.c_char_p
        build_log[name] = {"seconds": seconds, "log": log, "path": str(out)}
        _libs[name] = lib
        return lib


def entry_point(name: str, symbol: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``name``, typed for ctypes
    (every pointer and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def launch_check(name: str, rc: int) -> None:
    """Raise if an entry point of library ``name`` returned a CUDA error."""
    if rc != 0:
        err = _libs[name].fct_error_string(rc).decode()
        msg = f"{name} kernel: CUDA launch failed: {err} (cudaError {rc})"
        raise RuntimeError(msg)
