"""Compose captured CUDA graphs and while nodes into one executable graph.

The host half of ``csrc/graph_loop.cu``, which ``solver/compiled.py`` uses
to replay a step whose loops the device decides (``device_while``, the
counterpart of ``jax.lax.while_loop``). A program is a list of items:

- ``("graph", raw)``: a captured graph (``torch.cuda.CUDAGraph(
  keep_graph=True).raw_cuda_graph()``), added as a child-graph node;
- ``("while", pred, body)``: a while node. Before it, the set-conditional
  kernel writes the 0-d bool tensor ``pred`` into the node's handle; its
  body graph is the program ``body`` followed by the same kernel, so the
  body runs again for as long as ``pred`` holds after a trip. Loops nest.

``compose(program, device)`` builds the parent graph, refuses any captured
node that a conditional body may not hold (``check``), and instantiates it.
The library is built by nvcc for sm_90a at first use (``ops/_cuda_build``)
and needs CUDA 12.4 or later; a missing nvcc, an older toolkit or driver, a
refused node or a failed instantiation raises. Nothing falls back.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from ..ops._cuda_build import entry_point, launch_check

__all__ = ["ComposedGraph", "check", "compose", "node_count", "versions"]

#: CUDA's cudaGraphNodeType names, for the refusal message
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait event", 7: "event record", 8: "external semaphore signal",
              9: "external semaphore wait", 10: "memory allocation", 11: "memory free",
              12: "batch memory op", 13: "conditional"}

_P = ctypes.c_void_p
_POUT = ctypes.POINTER(ctypes.c_void_p)
_U64 = ctypes.POINTER(ctypes.c_ulonglong)
_I32 = ctypes.POINTER(ctypes.c_int)
_SIGS = {
    "fct_graph_create": [_POUT],
    "fct_graph_count": [_P, _U64],
    "fct_graph_check": [_P, _I32],
    "fct_graph_add_child": [_P, _P, _P, _POUT],
    "fct_graph_add_while": [_P, _P, _P, _POUT, _POUT, _U64],
    "fct_graph_add_set": [_P, _P, ctypes.c_ulonglong, _P, _POUT],
    "fct_graph_instantiate": [_P, _POUT, _I32],
    "fct_graph_launch": [_P, _P],
    "fct_graph_destroy": [_P, _P],
    "fct_graph_runtime_version": [_I32, _I32],
}
_fns: dict = {}


def _call(symbol: str, *args) -> None:
    if symbol not in _fns:
        _fns[symbol] = entry_point("graph_loop", symbol, _SIGS[symbol])
    launch_check("graph_loop", _fns[symbol](*args))


def versions() -> tuple[int, int]:
    """(CUDA runtime version the library was built with, driver version),
    e.g. (12080, 12080); raises below 12.4, where CUDA has no while node."""
    build, driver = ctypes.c_int(0), ctypes.c_int(0)
    _call("fct_graph_runtime_version", ctypes.byref(build), ctypes.byref(driver))
    if min(build.value, driver.value) < 12040:
        msg = (f"CUDA graph while nodes need CUDA 12.4 or later: nvcc's runtime is "
               f"{build.value}, the driver {driver.value}")
        raise RuntimeError(msg)
    return build.value, driver.value


def node_count(raw: int) -> int:
    """The nodes of a graph (0: an empty segment, which is left out)."""
    n = ctypes.c_ulonglong(0)
    _call("fct_graph_count", _P(raw), ctypes.byref(n))
    return n.value


def check(raw: int) -> None:
    """Raise unless every node of the graph (and of its child graphs) is one
    a while node's body may hold: kernel, memset, device-to-device memcpy,
    empty, child graph or conditional."""
    bad = ctypes.c_int(-1)
    _call("fct_graph_check", _P(raw), ctypes.byref(bad))
    if bad.value >= 0:
        kind = NODE_TYPES.get(bad.value, str(bad.value))
        msg = (f"a captured segment holds a {kind} node, which a CUDA graph while node's "
               "body may not hold")
        raise RuntimeError(msg)


class ComposedGraph:
    """The parent graph of a program and its executable graph."""

    def __init__(self, graph: int, exec_: int, sets: int):
        self.graph, self.exec = graph, exec_
        #: set-conditional kernel nodes in the graph
        self.sets = sets
        self._finalizer = weakref.finalize(self, _destroy, graph, exec_)

    def launch(self, stream: int) -> None:
        _call("fct_graph_launch", _P(self.exec), _P(stream))


def _destroy(graph: int, exec_: int) -> None:
    fn = _fns.get("fct_graph_destroy")
    if fn is None:
        fn = _fns["fct_graph_destroy"] = entry_point("graph_loop", "fct_graph_destroy",
                                                     _SIGS["fct_graph_destroy"])
    fn(_P(graph), _P(exec_))


def _add(graph: int, program: list, dep: int | None) -> tuple[int | None, int]:
    """Append ``program`` to ``graph`` after node ``dep``; returns (the last
    node, the set-conditional nodes added)."""
    sets = 0
    for item in program:
        node = ctypes.c_void_p(0)
        if item[0] == "graph":
            raw = item[1]
            check(raw)
            if node_count(raw) == 0:
                continue
            _call("fct_graph_add_child", _P(graph), _P(dep), _P(raw), ctypes.byref(node))
        else:
            _, pred, body = item
            if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
                msg = "a while node's predicate must be a 0-d bool tensor on the card"
                raise TypeError(msg)
            sub, handle = ctypes.c_void_p(0), ctypes.c_ulonglong(0)
            _call("fct_graph_add_while", _P(graph), _P(dep), _P(pred.data_ptr()),
                  ctypes.byref(node), ctypes.byref(sub), ctypes.byref(handle))
            last, inner = _add(sub.value, body, None)
            end = ctypes.c_void_p(0)
            _call("fct_graph_add_set", _P(sub.value), _P(last), handle,
                  _P(pred.data_ptr()), ctypes.byref(end))
            sets += 2 + inner
        dep = node.value
    return dep, sets


def compose(program: list, device) -> ComposedGraph:
    """One executable graph of ``program`` (module docstring) on ``device``."""
    with torch.cuda.device(torch.device(device)):
        versions()
        graph = ctypes.c_void_p(0)
        _call("fct_graph_create", ctypes.byref(graph))
        try:
            _, sets = _add(graph.value, program, None)
            exec_, result = ctypes.c_void_p(0), ctypes.c_int(0)
            fn = entry_point("graph_loop", "fct_graph_instantiate",
                             _SIGS["fct_graph_instantiate"])
            rc = fn(_P(graph.value), ctypes.byref(exec_), ctypes.byref(result))
        except Exception:
            _destroy(graph.value, 0)
            raise
        if rc != 0 or result.value != 0:
            _destroy(graph.value, exec_.value or 0)
            msg = (f"instantiating the composed CUDA graph failed: cudaError {rc}, "
                   f"cudaGraphInstantiateResult {result.value}")
            raise RuntimeError(msg)
        return ComposedGraph(graph.value, exec_.value, sets)
