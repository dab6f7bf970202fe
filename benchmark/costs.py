"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the H100's peaks, the operations and bytes of the port's
kernels at a cell's shapes (copied from ``scripts/torch_bench/roofline.py``,
which a CPU test holds equal), and the reading of a torch.profiler trace
(the union of device intervals, the idle gaps).

A kernel's bound is the larger of its bytes (each input read once, each
output written once) over 3.35 TB/s and its operations over the peak rate of
its type outside the tensor cores (67 TFLOP/s float32, 34 float64): NVIDIA's
data sheet, H100 SXM, 700 W.
"""

from __future__ import annotations

import bisect
import json
import re

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 34e12}  # by value size in bytes


def bound_s(nbytes: float, flops: float, itemsize: int) -> float:
    """The least time the card could take, in seconds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[itemsize])


# -- operations and bytes (roofline.py's functions, unchanged) ------------------------


def k1_cost(geo, itemsize: int = 4) -> tuple[float, float]:
    """(bytes, flops) of one K1 apply with values of ``itemsize`` bytes:
    u -> r reads u, beta, gamma [8, M], n [48, M] and the mask and writes r;
    per valid cell the strain and divergence products (2 x 1152
    multiply-adds) and ~40 operations per Gauss point for the tangent."""
    M, cells = geo.M, float(geo.mask.sum())
    return itemsize * (3 + 8 + 8 + 48 + 1 + 3) * M, cells * (4 * 1152 + 8 * 40) + 21 * M


def window_costs(ex, itemsize: int = 4) -> dict:
    """(bytes, flops) of one K4 and one K5 call on the plan ``ex`` (3
    components): K4 reads u [3, M_pad] and the plan's ``loc`` and writes the
    rows; K5 reads the rows and its node index and writes [3, M_pad], three
    additions per row entry."""
    rows = ex.B * 3 * ex.Rn * itemsize
    idx5 = (ex.node_ptr.numel() * ex.node_ptr.element_size()
            + ex.node_rows.numel() * ex.node_rows.element_size())
    return {"K4": (3 * ex.M_pad * itemsize + ex.loc.numel() * ex.loc.element_size() + rows,
                   0.0),
            "K5": (rows + idx5 + 3 * ex.M_pad * itemsize, 3.0 * ex.node_rows.numel())}


def k6_cost(w) -> tuple[float, float]:
    """(bytes, flops) of one K6 apply: the row layout (row_ptr, col, blk) and
    x read once, y written once; two operations per block entry."""
    size = w.blk.element_size()
    nnzb = w.col.numel()
    nbytes = ((w.NR_pad + 1 + nnzb) * 4
              + (nnzb * w.br * w.bc + w.bc * w.NC_pad + w.br * w.NR_pad) * size)
    return nbytes, 2.0 * nnzb * w.br * w.bc


def stencil_flops(geo) -> float:
    """Operations of one stencil apply at a node: 3^d neighbours of vs x vs
    blocks, a multiply and an add each (486 on a hex level, 72 on a quad)."""
    return 2.0 * 3**geo.gdim * geo.vs**2


def level_bytes(chain) -> int:
    """What a K3 kernel reads of a level: inv_d, the pattern ids and stencils."""
    return sum(t.numel() * t.element_size() for t in (chain.inv_d, chain.pid, chain.st))


def vcycle_costs(fc, itemsize: int, first: int) -> list:
    """(label, kind, (bytes, flops)) of every K3 entry of one fused V-cycle
    (``FusedVcycle``) whose one-block tail starts at level ``first``, in the
    cycle's order: pre_restrict down to ``first``, the tail, prolong_post up."""
    g0 = fc._chain(0).geo
    vs, apply_ops = g0.vs, stencil_flops(g0)
    n_nb, n_corner = 3**g0.gdim, 2**g0.gdim  # restriction and prolongation weights
    vec = itemsize * vs
    out = []
    for lvl in range(first):
        pre, M, Mc = fc.chains[lvl]["pre"], fc._chain(lvl).geo.M, fc._chain(lvl + 1).geo.M
        out.append((f"L{lvl} pre_restrict", "pre_restrict",
                    (level_bytes(pre) + vec * (2 * M + Mc),
                     pre.nu * M * apply_ops + (pre.nu - 1) * 3 * vs * M + n_nb * 2 * vs * Mc)))
    nbytes = vec * 2 * fc._chain(first).geo.M + sum(
        level_bytes(fc._chain(t)) for t in range(first, fc.n_levels))
    flops = 0.0
    for t in range(first, fc.n_levels - 1):
        c, M = fc._chain(t), fc._chain(t).geo.M
        flops += (2 * c.nu * M * apply_ops + 2 * c.nu * 3 * vs * M
                  + n_nb * 2 * vs * fc._chain(t + 1).geo.M + 2 * n_corner * vs * M)
    Nc = vs * fc._chain(fc.n_levels - 1).geo.M
    if fc.coarse_inv is not None:
        nbytes += fc.coarse_inv.numel() * fc.coarse_inv.element_size()
        flops += 2.0 * Nc * Nc
    else:
        flops += fc.chains[-1]["coarse"].nu * (Nc / vs) * apply_ops
    out.append((f"L{first}-{fc.n_levels - 1} tail", "tail", (nbytes, flops)))
    for lvl in reversed(range(first)):
        post, M = fc.chains[lvl]["post"], fc._chain(lvl).geo.M
        out.append((f"L{lvl} prolong_post", "prolong_post",
                    (level_bytes(post) + vec * (3 * M + fc._chain(lvl + 1).geo.M),
                     post.nu * M * apply_ops + post.nu * 3 * vs * M + 2 * n_corner * vs * M)))
    return out


def amg_vcycle_k6(amg) -> tuple[int, float, float]:
    """(K6 launches, bytes, flops) of one V(nu, nu) cycle of the windowed AMG
    (``WindowedAmgPreconditioner._cycle``): on every level above the
    coarsest, A applied nu - 1 times in the zero-start pre-smoothing, once
    for the residual and nu times in the post-smoothing, then R and P once."""
    launches, nbytes, flops = 0, 0.0, 0.0
    for lvl in range(amg.n_levels - 1):
        for w, times in ((amg.A_win[lvl], 2 * amg.nu), (amg.R_win[lvl], 1),
                         (amg.P_win[lvl], 1)):
            b, f = k6_cost(w)
            launches += times
            nbytes += times * b
            flops += times * f
    return launches, nbytes, flops


# -- reading a torch.profiler trace ----------------------------------------------------

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
                   "python_function")


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]
    return re.sub(r"<.*", "", name).split("::")[-1]


class Trace:
    """The events of one exported chrome trace between the start and the
    end of the user annotation ``window``: device intervals (kernels,
    copies, fills) and host events, in microseconds.

    CUPTI records no event from inside a CUDA graph's conditional (while)
    nodes, so a replayed step shows only its top-level nodes. A replayed
    graph keeps the device busy from its first recorded node (or its launch)
    to the start of the first operation issued after the launch, which
    waits for it: ``busy_intervals`` adds that span for each graph launch.
    """

    def __init__(self, path, window: str):
        events = json.loads(open(path).read())["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        marks = [e for e in spans if e.get("cat") == "user_annotation" and e["name"] == window]
        if not marks:
            msg = f"the trace holds no annotation {window!r}"
            raise ValueError(msg)
        self.t0 = min(e["ts"] for e in marks)
        self.t1 = max(e["ts"] + e["dur"] for e in marks)
        inside = [e for e in spans if self.t0 <= e["ts"] and e["ts"] + e["dur"] <= self.t1]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATEGORIES]
        self.host = [e for e in inside if e.get("cat") in HOST_CATEGORIES
                     and e["name"] != window]
        runtime = {e["args"]["correlation"]: e for e in inside
                   if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        self.graph_launches = [e for e in runtime.values() if e["name"] == "cudaGraphLaunch"]
        for e in self.device:
            call = runtime.get(e.get("args", {}).get("correlation"))
            e["issued"] = call["ts"] if call is not None else e["ts"]
            e["by_graph"] = call is not None and call["name"] == "cudaGraphLaunch"

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def kernels(self, names) -> list:
        """The kernel events whose short name is one of ``names``."""
        return [e for e in self.device if e.get("cat") == "kernel"
                and short_name(e["name"]) in names]

    def seconds(self, events) -> float:
        return sum(e["dur"] for e in events) * 1e-6

    def graph_spans(self) -> list:
        """(start, end) of each replayed graph on the device."""
        by_issue = sorted(self.device, key=lambda e: e["issued"])
        issued = [e["issued"] for e in by_issue]
        out = []
        for g in self.graph_launches:
            own = [e["ts"] for e in self.device if e["by_graph"]
                   and e["args"]["correlation"] == g["args"]["correlation"]]
            before = [e["ts"] + e["dur"] for e in by_issue[:bisect.bisect_left(issued, g["ts"])]]
            start = min(own) if own else max([g["ts"], *before[-1:]])
            after = by_issue[bisect.bisect_right(issued, g["ts"]):]
            later = [e["ts"] for e in after if not e["by_graph"]]
            end = min(later) if later else self.t1
            if end > start:
                out.append((start, end))
        return out

    def busy_intervals(self) -> list:
        """The union of the device intervals and the graphs' spans, merged."""
        merged = []
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in self.device] + self.graph_spans()
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def top_device_ops(self, k: int = 10) -> list:
        totals: dict = {}
        for e in self.device:
            key = short_name(e["name"]) if e.get("cat") == "kernel" else e["name"]
            totals[key] = totals.get(key, 0.0) + e["dur"] * 1e-6
        return sorted(([n, s] for n, s in totals.items()), key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time between device intervals (and at the window's ends),
        summed by the host event that was running at each gap's middle (the
        innermost: the latest to start); the largest ``k``."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [h["ts"] for h in host]
        totals: dict = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name = "python (no op or runtime call)"
            for h in reversed(host[max(0, bisect.bisect_right(starts, mid) - 512):
                                   bisect.bisect_right(starts, mid)]):
                if h["ts"] + h["dur"] >= mid:
                    name = h["name"]
                    break
            totals[name] = totals.get(name, 0.0) + (e - s) * 1e-6
        return sorted(([n, v] for n, v in totals.items()), key=lambda r: -r[1])[:k]
