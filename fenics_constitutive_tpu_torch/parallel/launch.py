"""Start ranks for a sharded run: ``run_ranks(fn, n_ranks, *args, workdir=...)``
spawns ``n_ranks`` processes, initialises a process group in each from a
file store under ``workdir`` (gloo by default: it runs on the CPU and, staged
through the host, on CUDA tensors, so several ranks may share one card;
``backend="nccl"`` for one rank per card), calls
``fn(*args)`` in every rank and returns what each rank's call returned
(saved with ``torch.save``), in rank order.

``fn`` must be importable by the spawned processes (a module-level function
of an installed module). The process group's timeout bounds every
collective, and the join has a deadline of its own, so a rank that
deadlocks or dies fails the call instead of hanging it; an exception in a
rank is raised in the caller.
"""

from __future__ import annotations

import datetime
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["run_ranks"]


def _rank_entry(rank, fn, n_ranks, args, workdir, timeout, backend) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=f"file://{Path(workdir) / 'store'}", rank=rank,
        world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        out = fn(*args)
        torch.save(out, Path(workdir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, *args, workdir, timeout: float = 180.0,
              backend: str = "gloo") -> list:
    """``fn(*args)`` in ``n_ranks`` spawned ranks of one process group;
    returns each rank's result. Raises the first rank's exception, or
    TimeoutError when the ranks have not all ended within ``timeout``
    seconds (they are killed then)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for old in [workdir / "store", *(workdir / f"rank{r}.pt" for r in range(n_ranks))]:
        old.unlink(missing_ok=True)
    ctx = mp.start_processes(
        _rank_entry, args=(fn, n_ranks, args, str(workdir), timeout, backend),
        nprocs=n_ranks, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=0.5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            msg = f"the {n_ranks} ranks did not end within {timeout:g} s"
            raise TimeoutError(msg)
    return [torch.load(workdir / f"rank{r}.pt") for r in range(n_ranks)]
