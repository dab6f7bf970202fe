"""solve.idle_ms_per_step: idle time of the device per load step while
``PackedSimulation.solve()`` runs (the entry, ``solver/simulation.py``): the
gaps between the replayed cycle's busy intervals whose middle lies inside a
``solve`` scope (``benchmark/spans.py``). The rest of the idle time is the
harness's own, between calls."""

from benchmark import spans


def read(ctx):
    sp = spans.of(ctx, "trace")
    if sp is None or sp.count("solve") == 0:
        return None
    return sp.idle_s("solve") * 1e3 / ctx["trace_steps"]
