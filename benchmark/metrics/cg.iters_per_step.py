"""cg.iters_per_step: CG iterations per load step, summed over every Newton
trip of the step (the Krylov layer, ``solver/linear.py``): the ``cg.iter``
scopes of the traced eager cycle over its steps (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.count("cg.solve") == 0:
        return None
    return sp.count("cg.iter") / ctx["trace_steps"]
