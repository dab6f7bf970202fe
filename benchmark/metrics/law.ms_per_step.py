"""law.ms_per_step: device time of the constitutive update per load step
(``models/packed_models.py``): the events under the ``law.eval`` scopes of
the traced eager cycle, its local-Newton trips included
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "law.eval", lambda sp: sp.inclusive_s("law.eval"))
