"""The packed step compiled: one captured CUDA graph, replayed once a step.

The JAX package never runs its step op by op: ``PackedSimulation`` jits it
(``fenics_constitutive_tpu/solver/simulation.py``, ``jax.jit(step)``), and
``solve_schedule`` compiles the whole load path as one ``jax.jit(lax.scan(
...))``. The port's counterpart is ``compile_step(step)``: the step of
``make_packed_step`` captured into a ``torch.cuda.CUDAGraph`` and replayed
once per call, so that the host issues one launch a step where the eager
step issues some hundreds.

Capture. A call copies its inputs into static device buffers (``state.u``,
the stresses, the histories, ``t``, ``bc_vals``, ``f_ext`` and ``dt`` as a
0-d tensor, so that a law that reads ``dt`` sees each call's value) and runs
the step on them. The first call of a key runs the step once eagerly (the
warm-up: it makes the kernels' one-time set-up calls, and its result is the
call's result), then captures one call into a graph; every later call
copies in and replays. A new capture is taken when a shape, a dtype, the
Dirichlet dofs or a model object changes (JAX's retrace); the Dirichlet set
is prepared outside the graph, once per capture (``step.prepare``).

Value semantics. A replay overwrites the graph's outputs, so each call
returns a clone of them: a state the caller holds never changes. That is
one device-to-device copy of the state a call (and one into the static
buffers): about 56 MB each way for the 1M-QP box in float32.

What can be captured: a step that reads nothing back to the host
(``step.host_syncs`` is empty: ``max_newton == 1``, a fixed CG count, an
unsharded geometry) over laws that declare no ``host_sync``. JAX compiles
the other steps through ``lax.while_loop``; a plain CUDA graph cannot hold a
loop whose trip count follows the data, so ``capture=True`` refuses them
with ``ValueError`` and the default runs them eagerly. Inside the captured
region the host may read nothing: ``no_host_sync()`` makes every read raise
(and tells the code of the step, through ``host_reads_allowed()``, to take
its sync-free form: the Mises local Newton runs every trip). A capture or a
replay that fails raises; nothing falls back to the eager step or to the
CPU. TF32 stays off in the graph as it does eagerly: the products of the
step run through ``ops.structured._matmul``, which switches it off around
each call, and a graph keeps the setting of its capture.

Launch counters. The kernels' wrappers count at call time, and a replay
calls no wrapper: the counts a capture makes are recorded (and taken back,
since a capture launches nothing) and added at every replay, so a counter
reads the same after K replays as after K eager steps.

On the CPU the step runs eagerly (``capture=None``, the default). With
``capture=True`` it runs the static-buffer path without a graph (copy in,
the step under ``no_host_sync()``, clone out), which the tests hold to the
plain step; ``recorder`` lets a test stand in for the graph.
"""

from __future__ import annotations

import contextlib
import importlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "LAUNCH_COUNTERS",
    "CompiledStep",
    "HostSyncError",
    "compile_step",
    "disable_capture",
    "host_reads_allowed",
    "no_host_sync",
    "read_counters",
]

_PKG = __name__.rsplit(".", 2)[0]

#: the kernels' launch counters, (module or object, attribute): an int or
#: a dict of ints each
LAUNCH_COUNTERS: list = [
    (f"{_PKG}.ops.cuda_matvec", "launches"),
    (f"{_PKG}.ops.cuda_eval", "launches"),
    (f"{_PKG}.ops.cuda_smoother", "launches"),
    (f"{_PKG}.ops.cuda_smoother", "entry_launches"),
    (f"{_PKG}.ops.cuda_window", "launches"),
]

#: captures a CompiledStep keeps (the least recently used goes first)
MAX_CAPTURES = 4

#: the Tensor methods that read a value back to the host
GUARDED = ("item", "__bool__", "__float__", "__int__", "cpu", "numpy", "tolist")

_disabled = 0
_guarded = 0


class HostSyncError(RuntimeError):
    """A value read back to the host where a captured step may read none."""


@contextlib.contextmanager
def disable_capture():
    """Run every compiled step eagerly inside the block (the counterpart of
    ``jax.disable_jit()``)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


@contextlib.contextmanager
def no_host_sync():
    """Make every host read of a tensor (``GUARDED``) raise ``HostSyncError``
    inside the block, on any device, and tell the step's code to take its
    sync-free form (``host_reads_allowed()`` is false)."""
    global _guarded
    if _guarded:
        _guarded += 1
        try:
            yield
        finally:
            _guarded -= 1
        return
    own = {name: torch.Tensor.__dict__.get(name) for name in GUARDED}

    def refuse(name):
        def method(self, *args, **kwargs):
            msg = (f"Tensor.{name}() reads a value back to the host inside a step that is "
                   "captured in a CUDA graph")
            raise HostSyncError(msg)

        return method

    for name in GUARDED:
        setattr(torch.Tensor, name, refuse(name))
    _guarded = 1
    try:
        yield
    finally:
        _guarded = 0
        for name, method in own.items():
            if method is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, method)


def host_reads_allowed() -> bool:
    """False inside ``no_host_sync()``: code of the step takes its sync-free
    form there."""
    return _guarded == 0


# -- launch counters ------------------------------------------------------------------


def _owner(owner):
    return importlib.import_module(owner) if isinstance(owner, str) else owner


def read_counters() -> list:
    """[((owner, attribute), value)] of every counter in LAUNCH_COUNTERS (dict
    values copied)."""
    out = []
    for owner, attr in LAUNCH_COUNTERS:
        value = getattr(_owner(owner), attr)
        out.append(((owner, attr), dict(value) if isinstance(value, dict) else value))
    return out


def _set_counters(values: list) -> None:
    for (owner, attr), value in values:
        obj = _owner(owner)
        current = getattr(obj, attr)
        if isinstance(current, dict):
            current.update(value)  # the same dict: callers zero its keys in place
        else:
            setattr(obj, attr, value)


def _diff(after: list, before: list) -> list:
    out = []
    for (key, a), (_, b) in zip(after, before):
        out.append((key, {k: a[k] - b.get(k, 0) for k in a} if isinstance(a, dict) else a - b))
    return out


def _advance(delta: list) -> None:
    for (owner, attr), d in delta:
        obj = _owner(owner)
        current = getattr(obj, attr)
        if isinstance(current, dict):
            for k, v in d.items():
                current[k] = current.get(k, 0) + v
        else:
            setattr(obj, attr, current + d)


# -- pytrees of the step --------------------------------------------------------------


def _map(fn, *trees):
    """fn over the tensors of one or several trees of the same structure (a
    PackedState, tuples, dicts, None); other leaves are taken from the first."""
    from .packed_step import PackedState

    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, PackedState):
        return PackedState(*(_map(fn, *(getattr(t, f) for t in trees))
                             for f in ("u", "stress", "histories", "t")))
    if isinstance(first, tuple):
        return tuple(_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return first


def _signature(tree) -> str:
    """The structure, shapes, dtypes and devices of a tree."""
    return repr(_map(lambda t: (tuple(t.shape), t.dtype, t.device), tree))


def _clone(tree):
    return _map(torch.clone, tree)


def _law_syncs(models) -> tuple:
    """Each law's ``host_sync``, named."""
    return tuple(f"{type(m).__name__}: {m.host_sync}" for m in models
                 if getattr(m, "host_sync", None))


# -- the recorder ---------------------------------------------------------------------


class CudaGraphRecorder:
    """Records ``fn()`` into a ``torch.cuda.CUDAGraph`` on ``device`` (whose
    private memory pool holds the outputs) and replays it on the current
    stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, fn):
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


class _Entry:
    """One capture: the static input buffers, the prepared boundary, the
    recorder and its outputs, and the launch counts of one replay."""

    def __init__(self, step, models, state, bc_dofs, bc_vals, f_ext):
        self.models = models  # held, so that the key's ids stay theirs
        self.state = _map(torch.empty_like, state)
        vals = torch.as_tensor(bc_vals)
        self.bc_vals = torch.empty(vals.shape, dtype=state.u.dtype, device=state.u.device)
        self.f_ext = torch.empty_like(f_ext)
        self.dt = torch.zeros((), dtype=state.u.dtype, device=state.u.device)
        self.boundary = step.prepare(bc_dofs)
        self.run = step.run
        self.recorder = None
        self.out = None
        self.counts: list = []

    def copy_in(self, state, bc_vals, f_ext, dt) -> None:
        _map(lambda dst, src: dst.copy_(src), self.state, state)
        self.bc_vals.copy_(torch.as_tensor(bc_vals))
        self.f_ext.copy_(f_ext)
        if isinstance(dt, torch.Tensor):
            self.dt.copy_(dt)
        else:
            self.dt.fill_(float(dt))

    def body(self):
        return self.run(self.models, self.state, self.boundary, self.bc_vals, self.f_ext,
                        self.dt)


class CompiledStep:
    """``step(models, state, bc_dofs, bc_vals, f_ext, dt) -> (state', stats)``
    through a captured CUDA graph (module docstring). ``captured`` says
    whether calls replay a graph; ``host_syncs`` why they cannot, when they
    do not; ``captures`` and ``replays`` count both."""

    def __init__(self, step, *, capture: bool | None = None, models=(), recorder=None):
        syncs = getattr(step, "host_syncs", None)
        if syncs is None or not hasattr(step, "run"):
            syncs = ("the step is not one of make_packed_step",)
        syncs = tuple(syncs) + _law_syncs(models)
        if capture and syncs:
            msg = "the step cannot be captured in a CUDA graph: " + "; ".join(syncs)
            raise ValueError(msg)
        self.step = step
        self.device = torch.device(getattr(step, "device", "cpu"))
        self.host_syncs = syncs
        self._recorder = recorder if recorder is not None else (
            CudaGraphRecorder if self.device.type == "cuda" else None)
        #: calls go through the static buffers (and the recorder, where there is one)
        self.static = (bool(capture) if capture is not None
                       else not syncs and self._recorder is not None)
        self._entries: OrderedDict = OrderedDict()
        self._bc = None
        self.captures = 0
        self.replays = 0

    @property
    def captured(self) -> bool:
        """True when calls replay a captured graph (outside ``disable_capture``)."""
        return self.static and self._recorder is not None

    def __call__(self, models, state, bc_dofs, bc_vals, f_ext, dt):
        if not self.static or _disabled:
            return self.step(models, state, bc_dofs, bc_vals, f_ext, dt)
        entry = self._entry(models, state, bc_dofs, bc_vals, f_ext)
        entry.copy_in(state, bc_vals, f_ext, dt)
        if self._recorder is None:
            with no_host_sync():
                out = entry.body()
        elif entry.recorder is None:
            out = self._record(entry)
        else:
            entry.recorder.replay()
            _advance(entry.counts)
            self.replays += 1
            out = entry.out
        return _clone(out)

    def _bc_key(self, bc_dofs) -> bytes:
        """The Dirichlet dofs as host bytes. A device tensor is read once per
        tensor object (and again when modified in place), outside any replay."""
        if isinstance(bc_dofs, torch.Tensor):
            hit = self._bc
            if hit is not None and hit[0] is bc_dofs and hit[1] == bc_dofs._version:
                return hit[2]
            key = np.asarray(bc_dofs.detach().cpu().numpy(), np.int64).tobytes()
            self._bc = (bc_dofs, bc_dofs._version, key)
            return key
        return np.asarray(bc_dofs, np.int64).tobytes()

    def _entry(self, models, state, bc_dofs, bc_vals, f_ext) -> _Entry:
        bad = _law_syncs(models)
        if bad:
            msg = "the step cannot be captured in a CUDA graph: " + "; ".join(bad)
            raise ValueError(msg)
        key = (tuple(map(id, models)), _signature(state), self._bc_key(bc_dofs),
               tuple(torch.as_tensor(bc_vals).shape), _signature(f_ext))
        entry = self._entries.get(key)
        if entry is None:
            entry = _Entry(self.step, tuple(models), state, bc_dofs, bc_vals, f_ext)
            self._entries[key] = entry
            while len(self._entries) > MAX_CAPTURES:
                self._entries.popitem(last=False)
        self._entries.move_to_end(key)
        return entry

    def _record(self, entry: _Entry):
        """The warm-up call (its launches counted, its result the call's),
        then the capture (whose counts are taken back and kept for replays)."""
        with no_host_sync():
            out = entry.body()
        before = read_counters()
        recorder = self._recorder(self.device)
        try:
            with no_host_sync():
                entry.out = recorder.capture(entry.body)
        except HostSyncError:
            raise
        except RuntimeError as err:
            msg = f"capturing the step in a CUDA graph failed: {err}"
            raise RuntimeError(msg) from err
        entry.counts = _diff(read_counters(), before)
        _set_counters(before)
        entry.recorder = recorder
        self.captures += 1
        return out


def compile_step(step, *, capture: bool | None = None, models=(), recorder=None
                 ) -> CompiledStep:
    """The counterpart of ``jax.jit`` for a step of ``make_packed_step``.

    ``capture``: None (default) captures on a CUDA device (or wherever
    ``recorder`` records) when the step and ``models`` read nothing back to
    the host, and runs eagerly otherwise;
    True captures or raises ``ValueError`` naming the host sync (on the CPU
    it runs the static-buffer path without a graph); False always runs
    eagerly. ``models``: the laws the step will take, where known, so that
    one that syncs (``host_sync``) decides here. ``recorder``: a stand-in
    for ``CudaGraphRecorder`` (the tests')."""
    return CompiledStep(step, capture=capture, models=models, recorder=recorder)
