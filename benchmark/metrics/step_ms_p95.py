"""step_ms_p95: the 95th percentile of the wall latency of every ``solve()``
call in the window, each from call to return (host clock)."""

import statistics


def read(ctx):
    ms = [r["s"] * 1e3 for r in ctx["records"]]
    if len(ms) < 2:
        return ms[0]
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
