"""The packed step compiled: one CUDA graph, replayed once a step, loops included.

The JAX package never runs its step op by op: ``PackedSimulation`` jits it
(``fenics_constitutive_tpu/solver/simulation.py``, ``jax.jit(step)``), and
``solve_schedule`` compiles the whole load path as one ``jax.jit(lax.scan(
...))``, with every data-dependent loop of the step (converged Newton,
adaptive CG, the Mises local Newton) inside the program as a
``lax.while_loop``. The port's counterparts are ``compile_step(step)``, the
step of ``make_packed_step`` captured into one CUDA graph and replayed once
per call, and ``device_while(cond, body, carry)``, a loop whose trip count
the device decides.

Capture. A call copies its inputs into static device buffers (``state.u``,
the stresses, the histories, ``t``, ``bc_vals``, ``f_ext`` and ``dt`` as a
0-d tensor, so that a law that reads ``dt`` sees each call's value) and runs
the step on them. The first call of a key runs the step once eagerly (the
warm-up: it makes the kernels' one-time set-up calls, and its result is the
call's result), then captures one call; every later call copies in and
replays. A new capture is taken when a shape, a dtype, the Dirichlet dofs
or a model object changes (JAX's retrace). The key holds the Dirichlet dofs
as host bytes (``PackedSimulation`` passes a host array; a device tensor is
read back); the set is uploaded and prepared outside the graph, once per
capture (``step.prepare``).

Loops. ``device_while`` runs eagerly as ``while cond(carry): carry =
body(carry)``, reading the 0-d bool predicate back once a trip: the only
host read a step makes. Under capture it becomes a CUDA graph while node
(``solver/graph_loop.py``, ``csrc/graph_loop.cu``): the step is captured in
straight-line segments (before the loop, the loop's body, after it), each a
``torch.cuda.CUDAGraph(keep_graph=True)`` in one shared memory pool, so
torch's caching allocator keeps every address; the segments are composed
into one parent graph of child-graph nodes and while nodes. The loop's
carry lives in static buffers allocated before the node (clones of the
initial carry, or, where the caller hands it over, its own tensors); a trip
runs the body, copies its result into them, evaluates ``cond`` on them into the
predicate buffer, and a one-thread kernel writes the predicate into the
node's handle. Eager and replayed runs evaluate the same predicate
expression on the device, so they take the same trips and agree bit for
bit. Loops nest (CG inside a Newton trip, the local Newton inside an
evaluation).

Value semantics. A replay overwrites the graph's outputs, so each call
returns a clone of them: a state the caller holds never changes. That is
one device-to-device copy of the state a call (and one into the static
buffers): about 56 MB each way for the 1M-QP box in float32.

What can be captured: every step of ``make_packed_step`` on one process
(``step.host_syncs`` is empty) over laws that declare no ``host_sync``: every
law of the library, several on one part and dense-tangent ones included
(Drucker-Prager's local Newton is a ``device_while``), but the native ones,
which run on the host. A sharded step
all-reduces through the host (gloo), so ``capture=True`` refuses it with
``ValueError`` and the default runs it eagerly. Inside the captured region
the host may read nothing: ``no_host_sync()`` makes every read raise, apart
from ``device_while``'s own predicate read in the eager warm-up. A capture,
a composition or a replay that fails raises; nothing falls back to the
eager step or to the CPU. TF32 stays off in the graph as it does eagerly:
the products of the step run through ``ops.structured._matmul``, which
switches it off around each call, and a graph keeps the setting of its
capture.

Launch counters. A kernel's wrapper counts a launch only where it runs one
(``ops/_cuda_build.launched``): a capture records kernels and launches
none, and a replay calls no wrapper, so neither adds a count. To count what
a replayed step launches, run the step once inside ``disable_capture()``.

Scopes. A call names its host parts with ``utils.timers.timing``:
``step.key`` (the capture's key), ``step.copy_in``, ``step.capture`` (the
first call of a key: warm-up and capture) or ``step.replay``, and
``step.clone_out``. Inside the step the scopes are ``utils.timers.scope``
(``device_while(..., name=...)`` names each trip): a capture runs their
Python once, so they show per trip only in a profiled eager run.

On the CPU the step runs eagerly (``capture=None``, the default). With
``capture=True`` it runs the static-buffer path without a graph (copy in,
the step under ``no_host_sync()``, clone out), which the tests hold to the
plain step; ``recorder`` lets a test stand in for the graph
(``GraphRecorder``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from collections import OrderedDict

import numpy as np
import torch

from ..utils.timers import scope, timing

__all__ = [
    "CompiledStep",
    "CudaGraphRecorder",
    "GraphRecorder",
    "HostSyncError",
    "compile_step",
    "device_while",
    "disable_capture",
    "host_reads_allowed",
    "no_host_sync",
    "settle_counters",
]

#: captures a CompiledStep keeps (the least recently used goes first)
MAX_CAPTURES = 4

#: the Tensor methods that read a value back to the host
GUARDED = ("item", "__bool__", "__float__", "__int__", "cpu", "numpy", "tolist")

#: the unguarded read: device_while's predicate
_BOOL = torch.Tensor.__bool__

_disabled = 0
_guarded = 0
#: the recorder capturing (or, in a stand-in, replaying) the current call
_recording = None


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
    inside the block, on any device (``host_reads_allowed()`` is false)."""
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
    """False inside ``no_host_sync()``."""
    return _guarded == 0


def device_while(cond, body, carry, *, name, reads=None):
    """The counterpart of ``jax.lax.while_loop(cond, body, carry)``.

    ``cond(carry)`` returns a 0-d bool tensor on the carry's device;
    ``body(carry)`` a carry of the same structure (tensors, tuples, dicts,
    dataclasses; other leaves must stay equal). Eagerly (on the CPU, inside
    ``disable_capture()``): ``while cond(carry): carry = body(carry)``, one
    read of the predicate a trip. Inside a capture: a CUDA graph while node
    over static carry buffers (module docstring); the returned carry is
    those buffers.

    ``reads``: the tensors (a tree) that the body reads besides the carry.
    Given them, the caller hands the initial carry over to the loop: under
    capture a tensor of it that owns its whole storage, appears once in the
    carry and shares no storage with ``reads`` becomes its static buffer
    itself, where by default (None) every tensor is cloned into one.

    ``name``: eagerly, each trip's body runs in ``utils.timers.scope(name)``
    (a profiler scope per trip while a profiler runs). A capture records no
    scope for the trips: a replay runs no Python per trip."""
    rec = _recording
    if rec is not None:
        return rec.loop(cond, body, carry, reads)
    while _BOOL(cond(carry)):
        with scope(name):
            carry = body(carry)
    return carry


def settle_counters() -> None:
    """Does nothing: a replay adds no launch count (module docstring)."""


# -- pytrees of the step --------------------------------------------------------------


def _map(fn, *trees):
    """fn over the tensors of one or several trees of the same structure
    (dataclasses such as PackedState and the tangents, tuples, dicts, None);
    other leaves are taken from the first."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return type(first)(**{f.name: _map(fn, *(getattr(t, f.name) for t in trees))
                              for f in dataclasses.fields(first)})
    if isinstance(first, tuple):
        return tuple(_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return first


def _signature(tree) -> str:
    """The structure, shapes, dtypes and devices of a tree (and its other leaves)."""
    return repr(_map(lambda t: (tuple(t.shape), t.dtype, t.device), tree))


def _clone(tree):
    return _map(torch.clone, tree)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _static_carry(carry, reads):
    """The static buffers of a loop's carry: clones, or with ``reads`` given
    the carry's own tensors where that is safe (``device_while``)."""
    if reads is None:
        return _clone(carry)
    taken: set = set()
    _map(lambda t: taken.add(_storage(t)), reads)
    counts: dict = {}

    def count(t):
        counts[_storage(t)] = counts.get(_storage(t), 0) + 1

    _map(count, carry)

    def pick(t):
        whole = (t.is_contiguous() and t.storage_offset() == 0
                 and t.untyped_storage().nbytes() == t.numel() * t.element_size())
        key = _storage(t)
        return t if whole and key not in taken and counts[key] == 1 else t.clone()

    return _map(pick, carry)


def _copy_into(static, new) -> None:
    if _signature(new) != _signature(static):
        msg = (f"device_while: the body changed the carry's structure: {_signature(static)} "
               f"became {_signature(new)}")
        raise ValueError(msg)
    _map(torch.Tensor.copy_, static, new)


def _law_syncs(models) -> tuple:
    """Each law's ``host_sync``, named."""
    return tuple(f"{type(m).__name__}: {m.host_sync}" for m in models
                 if getattr(m, "host_sync", None))


# -- the recorders --------------------------------------------------------------------


class _Loop:
    """One while node: the static carry, the predicate buffer and the body's
    program."""

    def __init__(self, static, pred: torch.Tensor):
        self.static, self.pred = static, pred
        self.body: list = []


class GraphRecorder:
    """Records ``fn()`` as a program of straight-line segments and the while
    loops between them (``device_while``), and replays it.

    ``capture`` runs ``fn`` once, cutting a segment at each loop's entry,
    at the start and end of its body and at its exit. A loop under capture
    clones its carry into static buffers, evaluates ``cond`` into a
    predicate buffer, runs the body once on the buffers, copies the result
    into them and evaluates ``cond`` again. Subclasses capture the segments
    (``begin_segment``, ``end_segment``), compose them (``finish``) and
    launch the result (``replay``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.program: list = []
        self.loops: list = []
        #: host seconds of the capture and of the composition
        self.seconds = {"capture": 0.0, "compose": 0.0}

    # the hooks of a subclass
    def begin_segment(self) -> None:
        pass

    def end_segment(self):
        return None

    def abort(self) -> None:
        """End an open segment after a failure inside ``fn``."""

    def finish(self) -> None:
        pass

    def replay(self) -> None:
        raise NotImplementedError

    # recording
    def capture(self, fn):
        global _recording
        self._items = [self.program]
        prev, _recording = _recording, self
        t0 = time.perf_counter()
        try:
            self.begin_segment()
            out = fn()
            self._cut()
        except BaseException:
            self.abort()
            raise
        finally:
            _recording = prev
        t1 = time.perf_counter()
        self.finish()
        self.seconds = {"capture": t1 - t0, "compose": time.perf_counter() - t1}
        return out

    def _cut(self) -> None:
        self._items[-1].append(("graph", self.end_segment()))

    def loop(self, cond, body, carry, reads=None):
        static = _static_carry(carry, reads)
        pred = torch.empty((), dtype=torch.bool, device=self.device)
        pred.copy_(cond(static))
        self._cut()
        loop = _Loop(static, pred)
        self.loops.append(loop)
        self._items[-1].append(("while", loop))
        self._items.append(loop.body)
        self.begin_segment()
        _copy_into(static, body(static))
        pred.copy_(cond(static))
        self._cut()
        self._items.pop()
        self.begin_segment()
        return static


class CudaGraphRecorder(GraphRecorder):
    """Captures each segment as a ``torch.cuda.CUDAGraph(keep_graph=True)``
    on a side stream, every one in one memory pool (so that a tensor one
    segment writes stays where a later one reads it), and composes them into
    one executable graph with a while node per loop
    (``graph_loop.compose``), launched on the current stream."""

    def __init__(self, device):
        super().__init__(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        #: the captured segments: they own the pool, so they live as long as the graph
        self.graphs: list = []
        self._open = None
        self.graph = None

    def capture(self, fn):
        with torch.cuda.device(self.device):
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            try:
                with torch.cuda.stream(self.stream):
                    return super().capture(fn)
            finally:
                current.wait_stream(self.stream)

    def begin_segment(self) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        g.capture_begin(pool=self.pool)
        self._open = g

    def end_segment(self):
        g, self._open = self._open, None
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # an empty segment (a loop right after a loop)
            g.capture_end()
        self.graphs.append(g)
        return g.raw_cuda_graph()

    def abort(self) -> None:
        if self._open is not None:
            g, self._open = self._open, None
            with contextlib.suppress(Exception):
                g.capture_end()

    def finish(self) -> None:
        from . import graph_loop

        def program(items):
            return [item if item[0] == "graph" else ("while", item[1].pred,
                                                     program(item[1].body))
                    for item in items]

        self.graph = graph_loop.compose(program(self.program), self.device)

    def replay(self) -> None:
        self.graph.launch(torch.cuda.current_stream(self.device).cuda_stream)


class _Entry:
    """One capture: the static input buffers, the prepared boundary, the
    recorder and its outputs."""

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
        self.captures = 0
        self.replays = 0

    @property
    def captured(self) -> bool:
        """True when calls replay a captured graph (outside ``disable_capture``)."""
        return self.static and self._recorder is not None

    def __call__(self, models, state, bc_dofs, bc_vals, f_ext, dt):
        if not self.static or _disabled:
            return self.step(models, state, bc_dofs, bc_vals, f_ext, dt)
        with timing("step.key"):
            entry = self._entry(models, state, bc_dofs, bc_vals, f_ext)
        with timing("step.copy_in"):
            entry.copy_in(state, bc_vals, f_ext, dt)
        if self._recorder is None:
            with no_host_sync():
                out = entry.body()
        elif entry.recorder is None:
            out = self._record(entry)
        else:
            with timing("step.replay"):
                entry.recorder.replay()
            self.replays += 1
            out = entry.out
        with timing("step.clone_out"):
            return _clone(out)

    def _entry(self, models, state, bc_dofs, bc_vals, f_ext) -> _Entry:
        bad = _law_syncs(models)
        if bad:
            msg = "the step cannot be captured in a CUDA graph: " + "; ".join(bad)
            raise ValueError(msg)
        # the Dirichlet dofs as host bytes (a tensor a caller passes is read back)
        key = (tuple(map(id, models)), _signature(state),
               np.asarray(torch.as_tensor(bc_dofs).cpu(), np.int64).tobytes(),
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
        """The warm-up call (its result the call's), then the capture."""
        with timing("step.capture"):
            with no_host_sync():
                out = entry.body()
            recorder = self._recorder(self.device)
            try:
                with no_host_sync():
                    entry.out = recorder.capture(entry.body)
            except HostSyncError:
                raise
            except RuntimeError as err:
                msg = f"capturing the step in a CUDA graph failed: {err}"
                raise RuntimeError(msg) from err
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
    one that syncs (``host_sync``) decides here. ``recorder``: a
    ``GraphRecorder`` class standing in for ``CudaGraphRecorder`` (the
    tests')."""
    return CompiledStep(step, capture=capture, models=models, recorder=recorder)
