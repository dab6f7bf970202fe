"""The reference's MPI problem (test_torch_sharding.py) on 4 gloo ranks: u
within 1e-14 of the port's one-process run and within 1e-12 of the JAX
package's unsharded run, equal Newton counts, ranks bit-equal, each rank
holding a quarter of the QP state. A file of its own: 10 steps of about 850
CG iterations, one 4-rank all-reduce each, take about a minute on the CPU.
"""

import pytest
from test_torch_sharding import AOS, aos_parity, run_with_references


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_with_references(4, {"aos": ("problem", AOS)}, tmp_path_factory.mktemp("ranks"))


def test_sharded_matches_one_process_and_jax(runs):
    aos_parity(*runs)


def test_sharded_state_stays_rank_local(runs):
    ranks, one, _ = runs
    sizes = [res["aos"]["qp_numel"] for res in ranks]
    assert sum(sizes) == one["qp_numel"]
    assert max(sizes) <= one["qp_numel"] / 4 * 1.1
