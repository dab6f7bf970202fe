"""Named profiler scopes, and timers with a registry.

``scope("name")`` opens a ``torch.profiler.record_function`` scope while a
profiler runs and does nothing otherwise: without a profiler it costs one
check of the profiler's state. The port names its layers with it inside the
step (``newton.iter``, ``cg.solve``, ``law.eval``, ...): code that a CUDA
graph captures runs its Python once per capture, not once per replay, so a
count or a clock kept on the host there would be wrong under replay. Such
spans are read from a profiled eager run (``disable_capture()``), where every
trip runs its Python.

``timing("name")`` is the same scope around host code, and also adds the
call's wall-clock seconds to a global registry (``get_timings()``). Wall time
around CUDA work measures the launches, not the device time, unless the
device is synchronised: ``timed(name, block=True)`` synchronises the device
of the result's tensors before the clock stops.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch

__all__ = ["get_timings", "reset_timings", "scope", "timed", "timing"]

_REGISTRY: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def scope(name: str):
    """A ``record_function`` scope named ``name`` while a profiler is active;
    otherwise a context that does nothing. Keeps no count and no clock."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NULL


@contextlib.contextmanager
def timing(name: str):
    """Context manager: a profiler scope (``scope``) and a wall-clock
    registry entry."""
    with scope(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            entry = _REGISTRY[name]
            entry[0] += 1
            entry[1] += time.perf_counter() - t0


def _synchronize(out) -> None:
    """Wait for the CUDA devices that hold a tensor of ``out`` (nested
    tuples, lists and dicts)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)

    visit(out)
    for d in devices:
        torch.cuda.synchronize(d)


def timed(name: str, block: bool = False):
    """Decorator version of :func:`timing`; ``block=True`` waits for the
    result's device before the clock stops."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with timing(name):
                out = fn(*args, **kwargs)
                if block:
                    _synchronize(out)
                return out

        return inner

    return wrap


def get_timings() -> dict[str, tuple[int, float]]:
    """{name: (n_calls, total_seconds)}."""
    return {k: (v[0], v[1]) for k, v in _REGISTRY.items()}


def reset_timings() -> None:
    _REGISTRY.clear()
