"""newton.assemble_ms_per_step: device time of the Newton step's assembly
per load step (``solver/packed_step.py``): the events whose innermost scope
is ``newton.assemble`` in the traced eager cycle: the strain, the residual's
divergence and the sums, not the law (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "newton.assemble",
                             lambda sp: sp.self_s("newton.assemble"))
