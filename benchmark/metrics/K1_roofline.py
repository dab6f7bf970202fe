"""K1_roofline: the CG operator on the box (``ops/cuda_matvec.py``), in %:
the frozen bound of one apply times the launches the port counted over the
traced eager cycle, over the device time of its kernel events there."""

from benchmark import costs

KERNELS = ("matvec_kernel",)
COUNTER = "K1"


def read(ctx):
    tr, n = ctx["kernel_trace"], ctx["launches"].get(COUNTER, 0)
    if tr is None or n == 0:
        return None
    events = tr.kernels(KERNELS)
    if len(events) != n:
        ctx["note"](f"K1_roofline: {len(events)} kernel events for {n} launches; not read")
        return None
    bound = n * costs.bound_s(*costs.k1_cost(ctx["program"].geometry, ctx["itemsize"]),
                              ctx["itemsize"])
    return 100.0 * bound / tr.seconds(events)
