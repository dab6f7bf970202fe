"""cg.operator_ms_per_step: device time of the CG operator per load step (K1
on the box, the windowed operator with K4/K5 on the tets, and the masks
around them): the events under the ``cg.operator`` scopes of the traced
eager cycle (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "cg.operator", lambda sp: sp.inclusive_s("cg.operator"))
