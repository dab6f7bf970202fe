"""law.trips_per_eval: trips of the law's local Newton per evaluation (the
constitutive update, ``models/packed_models.py``): the ``law.trip`` scopes of
the traced eager cycle over its ``law.eval`` scopes (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    sp = spans.of(ctx)
    if sp is None or sp.count("law.eval") == 0:
        return None
    return sp.count("law.trip") / sp.count("law.eval")
