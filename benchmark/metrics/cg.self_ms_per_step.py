"""cg.self_ms_per_step: device time of the Krylov layer itself per load step
(``solver/linear.py``): the events whose innermost scope is ``cg.solve`` or
``cg.iter`` in the traced eager cycle: dots, axpys, the loop predicate, not
the operator or the preconditioner (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    return spans.per_step_ms(ctx, "cg.solve", lambda sp: sp.self_s("cg.solve", "cg.iter"))
