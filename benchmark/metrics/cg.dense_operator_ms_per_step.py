"""cg.dense_operator_ms_per_step: device time of the dense-tangent part of
the windowed CG operator per load step (``ops/windowed.py``: the gather and
strain, ``DenseTangent.apply`` and the divergence of the cells of a law
without a factored tangent, inside ``cg.operator``): the events under the
``cg.operator.dense`` scopes of the traced eager cycle
(``benchmark/spans.py``). None where the program has no such scope."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "cg.operator.dense",
                             lambda sp: sp.inclusive_s("cg.operator.dense"))
