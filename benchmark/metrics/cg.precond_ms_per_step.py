"""cg.precond_ms_per_step: device time of the preconditioner per load step
(the K3 V-cycle on the box, the windowed AMG with K6 and its Jacobi updates
on the tets, and the masks around them): the events under the
``cg.precond`` scopes of the traced eager cycle (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "cg.precond", lambda sp: sp.inclusive_s("cg.precond"))
