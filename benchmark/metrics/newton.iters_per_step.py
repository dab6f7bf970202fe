"""newton.iters_per_step: Newton iterations per load step over the window,
as ``PackedSimulation.solve()`` returns them (the Newton step,
``solver/packed_step.py``)."""


def read(ctx):
    recs = ctx["records"]
    return sum(r["newton"] for r in recs) / len(recs)
