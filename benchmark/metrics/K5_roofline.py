"""K5_roofline: the scatter of the CG operator and the residual on the tet
mesh (``ops/windowed.py``, ``ops/cuda_window.py``), in %: the frozen bound
of one call on the plan times the launches the port counted over the traced
cycle, over the device time of its kernel events there."""

from benchmark import costs

KERNELS = ("scatter_kernel",)
COUNTER = "K5"


def read(ctx):
    tr, n = ctx["kernel_trace"], ctx["launches"].get(COUNTER, 0)
    if tr is None or n == 0:
        return None
    events = tr.kernels(KERNELS)
    if len(events) != n:
        ctx["note"](f"K5_roofline: {len(events)} kernel events for {n} launches; not read")
        return None
    cost = costs.window_costs(ctx["program"].geometry.ex, ctx["itemsize"])["K5"]
    return 100.0 * n * costs.bound_s(*cost, ctx["itemsize"]) / tr.seconds(events)
