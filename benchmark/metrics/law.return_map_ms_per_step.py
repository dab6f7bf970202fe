"""law.return_map_ms_per_step: device time of the general implicit return
map per load step (``models/plasticity_general.py``, Drucker-Prager's local
Newton on 8 unknowns a point): the events under the ``law.return_map``
scopes of the traced eager cycle, its ``law.trip`` trips and the consistent
tangent included (``benchmark/spans.py``). None where the program has no
such scope."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "law.return_map",
                             lambda sp: sp.inclusive_s("law.return_map"))
