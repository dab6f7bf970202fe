"""step_ms: the window's wall time over the load steps completed in it (host
clock from the first ``solve()`` call to the return of the last)."""


def read(ctx):
    return ctx["window_s"] * 1e3 / len(ctx["records"])
