"""K6_roofline: the windowed-BSR SpMV of the AMG V-cycle on the tet mesh
(``solver/amg.py``, ``ops/windowed_bsr.py``), in %: the frozen bound of one
V-cycle's applies (``costs.amg_vcycle_k6``) times the V-cycles the port's
launch counter gives over the traced cycle, over the device time of its
kernel events there."""

from benchmark import costs

KERNELS = ("bsr_rows_kernel",)
COUNTER = "K6"


def read(ctx):
    tr, n = ctx["kernel_trace"], ctx["launches"].get(COUNTER, 0)
    if tr is None or n == 0:
        return None
    events = tr.kernels(KERNELS)
    if len(events) != n:
        ctx["note"](f"K6_roofline: {len(events)} kernel events for {n} launches; not read")
        return None
    per_cycle, nbytes, flops = costs.amg_vcycle_k6(ctx["program"].preconditioner)
    if n % per_cycle:
        ctx["note"](f"K6_roofline: {n} launches are not whole V-cycles of {per_cycle}; not read")
        return None
    bound = n // per_cycle * costs.bound_s(nbytes, flops, ctx["itemsize"])
    return 100.0 * bound / tr.seconds(events)
