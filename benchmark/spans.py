"""The program's own scopes in a trace: which layer launched each device event.

The port names its layers with ``torch.profiler.record_function`` scopes
while a profiler runs (``utils/timers.py``: ``solve``, ``step.*``,
``newton.iter``, ``newton.assemble``, ``law.eval``, ``law.trip``,
``cg.solve``, ``cg.iter``, ``cg.operator``, ``cg.precond``). Each is a
``user_annotation`` event on the host's clock. A device event belongs to the
innermost scope that was open when the host issued it: the start of its
launch call, a ``cuda_runtime`` event (``e["issued"]``) or a ``cuda_driver``
one such as the ``cuLaunchKernel`` of cuBLAS and CUTLASS, which
``costs.Trace`` does not match; an event with neither goes by its own
start. Scopes nest on the one thread that runs the step.

Counts are numbers of scope events. Inclusive time of a name is the device
time of the events under any scope of that name; self time that of the
events whose innermost scope has the name. Read from the eager trace, where
every loop trip runs its Python and so opens its scope; a replayed trace has
the host-level scopes only, which name the idle gaps.
"""

from __future__ import annotations

import bisect

#: host events that launch device work, matched to it by correlation id
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class Spans:
    """The scopes of a ``costs.Trace`` and the owner of each device event."""

    def __init__(self, tr):
        self.trace = tr
        launched = {e["args"]["correlation"]: e["ts"] for e in tr.host
                    if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}

        def issued(e):
            return launched.get(e.get("args", {}).get("correlation"), e["ts"])

        #: device seconds of the events whose launch call the trace does not hold
        self.unlaunched_s = 1e-6 * sum(e["dur"] for e in tr.device
                                       if e.get("args", {}).get("correlation") not in launched)
        scopes = sorted((e for e in tr.host if e.get("cat") == "user_annotation"),
                        key=lambda e: (e["ts"], -e["dur"]))
        self.scopes = scopes
        #: for each scope, the names of it and every scope around it
        self.names: list = []
        stack: list = []
        for s in scopes:
            while stack and _end(scopes[stack[-1]]) <= s["ts"]:
                stack.pop()
            outer = self.names[stack[-1]] if stack else frozenset()
            self.names.append(outer | {s["name"]})
            stack.append(len(self.names) - 1)
        #: (device event, index of its innermost scope or None)
        self.owned: list = []
        stack, j = [], 0
        for t, e in sorted(((issued(e), e) for e in tr.device), key=lambda te: te[0]):
            while j < len(scopes) and scopes[j]["ts"] <= t:
                while stack and _end(scopes[stack[-1]]) <= scopes[j]["ts"]:
                    stack.pop()
                stack.append(j)
                j += 1
            while stack and _end(scopes[stack[-1]]) < t:
                stack.pop()
            self.owned.append((e, stack[-1] if stack else None))

    def count(self, name: str) -> int:
        """The number of scopes called ``name``."""
        return sum(s["name"] == name for s in self.scopes)

    def inclusive_s(self, name: str) -> float:
        """Device seconds of the events under a scope called ``name``."""
        return 1e-6 * sum(e["dur"] for e, i in self.owned
                          if i is not None and name in self.names[i])

    def self_s(self, *names: str) -> float:
        """Device seconds of the events whose innermost scope is one of ``names``."""
        return 1e-6 * sum(e["dur"] for e, i in self.owned
                          if i is not None and self.scopes[i]["name"] in names)

    def outside_s(self) -> float:
        """Device seconds of the events under no scope of the program."""
        return 1e-6 * sum(e["dur"] for e, i in self.owned if i is None)

    def device_s(self) -> float:
        return 1e-6 * sum(e["dur"] for e, _ in self.owned)

    def idle_s(self, name: str) -> float:
        """Idle seconds of the device (between ``busy_intervals()`` and at the
        window's ends) whose gap's middle lies inside a scope called ``name``."""
        tr = self.trace
        spans = sorted((s["ts"], _end(s)) for s in self.scopes if s["name"] == name)
        starts = [a for a, _ in spans]
        edges = [tr.t0] + [x for iv in tr.busy_intervals() for x in iv] + [tr.t1]
        total = 0.0
        for a, b in zip(edges[0::2], edges[1::2]):
            mid = 0.5 * (a + b)
            k = bisect.bisect_right(starts, mid) - 1
            if b > a and k >= 0 and spans[k][1] >= mid:
                total += b - a
        return total * 1e-6


def _end(e) -> float:
    return e["ts"] + e["dur"]


def of(ctx, key: str = "kernel_trace"):
    """The Spans of the run's eager trace (``kernel_trace``) or replayed trace
    (``trace``), made once a run; None without that trace."""
    tr = ctx.get(key)
    if tr is None:
        return None
    cache = ctx.setdefault("spans", {})
    if id(tr) not in cache:
        cache[id(tr)] = Spans(tr)
    return cache[id(tr)]


def per_step_ms(ctx, name: str, seconds) -> float | None:
    """``seconds(spans)`` in ms per step of the eager trace, or None where the
    trace holds no scope called ``name`` (a program without the scope)."""
    sp = of(ctx)
    if sp is None or sp.count(name) == 0:
        return None
    return seconds(sp) * 1e3 / ctx["trace_steps"]
