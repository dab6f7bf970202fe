"""The multi-rank dry run: ``dryrun_multichip(n_ranks, device=...)`` spawns
``n_ranks`` gloo ranks and runs, in each, one packed load step on tiny
shapes on the structured engine (a 4^3 hex box) and on the windowed engine
(a shuffled 4^3 Kuhn tet mesh), once in one process and once sharded through
``shard_packed_state``. Every rank checks that its state holds only its
cells and that the sharded step matches the one-process step; the call
raises if any rank fails.

    python -c "from fenics_constitutive_tpu_torch.parallel import dryrun_multichip; \\
               print(dryrun_multichip(4, device='cpu'))"
"""

from __future__ import annotations

import tempfile

import numpy as np

from .launch import run_ranks
from .runs import packed_step_run
from .sharding import make_device_mesh

__all__ = ["dryrun_multichip"]

#: the two engines' tiny problems
CASES = {
    "structured": {"mesh": ("box", (4, 4, 4), "hex"), "law": "mises", "q": 2,
                   "loads": [0.008], "steps": 1},
    "windowed": {"mesh": ("shuffled", 4, 0), "law": "mises", "q": 2, "engine": "windowed",
                 "loads": [0.008], "steps": 1},
}
#: the sharded step against the one-process step, relative L2 of u
TOL = 1e-12


def _rank(device) -> dict:
    mesh = make_device_mesh(device=device)
    out = {}
    for name, spec in CASES.items():
        one = packed_step_run(spec, mesh.device)
        sharded = packed_step_run(spec, mesh.device, mesh)
        rel = float(np.linalg.norm(sharded["u"] - one["u"]) / np.linalg.norm(one["u"]))
        share = sharded["qp_numel"] / sharded["whole_qp_numel"]
        if rel > TOL or not sharded["u_bitequal"] or share > 0.75:
            msg = (f"dry run, {name} on rank {mesh.rank}: rel {rel:.2e} (tol {TOL:g}), ranks "
                   f"bit-equal {sharded['u_bitequal']}, rank-local QP share {share:.3f}")
            raise AssertionError(msg)
        out[name] = {"rel_u": rel, "qp_share": share, "newton": sharded["newton"]}
    return out


def dryrun_multichip(n_ranks: int = 2, device=None, timeout: float = 300.0) -> list:
    """Run the dry run on ``n_ranks`` gloo ranks (``device`` None: each
    rank's card, ``"cpu"`` on the CPU); returns each rank's summary."""
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(_rank, n_ranks, device, workdir=tmp, timeout=timeout)
