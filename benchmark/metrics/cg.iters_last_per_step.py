"""cg.iters_last_per_step: the CG iterations of each step's last Newton
iteration (``last_stats["cg_iters_last"]``, the Krylov layer,
``solver/linear.py``), averaged over the window's steps."""


def read(ctx):
    recs = ctx["records"]
    return sum(r["cg_last"] for r in recs) / len(recs)
