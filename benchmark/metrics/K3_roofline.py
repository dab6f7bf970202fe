"""K3_roofline: the fused V-cycle on the box (``solver/multigrid.py``,
``ops/cuda_smoother.py``), its three entries summed, in %: the frozen bound
of one V-cycle's entries times the V-cycles the port counted over the traced
cycle (one tail each), over the device time of their kernel events."""

from benchmark import costs

KERNELS = ("chain_kernel", "tail_kernel")
COUNTER = "K3"


def read(ctx):
    tr, launches = ctx["kernel_trace"], ctx["launches"]
    n = launches.get(COUNTER, 0)
    if tr is None or n == 0:
        return None
    events = tr.kernels(KERNELS)
    if len(events) != n:
        ctx["note"](f"K3_roofline: {len(events)} kernel events for {n} launches; not read")
        return None
    fc = ctx["program"].preconditioner.fused_cycle
    first = fc.tail_start(ctx["device"])
    entries = costs.vcycle_costs(fc, ctx["itemsize"], first)
    cycles = launches["K3.tail"]
    if n != cycles * len(entries):
        ctx["note"](f"K3_roofline: {n} launches are not {cycles} V-cycles of "
                    f"{len(entries)} entries; not read")
        return None
    bound = cycles * sum(costs.bound_s(*c, ctx["itemsize"]) for _, _, c in entries)
    return 100.0 * bound / tr.seconds(events)
