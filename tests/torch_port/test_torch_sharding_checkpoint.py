"""A sharded problem's checkpoint (utils/checkpoint.py) restores in one
process and on the same ranks: 2 gloo ranks on the CPU run the loads, write
the checkpoint after the first ``split`` of them (the one-process layout,
the same ``.npz`` format and engine marker), go on, and a second sharded
problem restores it and takes the remaining loads. A one-process problem
restores the same file. After the restore both match the uninterrupted
one-process run within 1e-14 (u), on the AoS engine (the reference's 4x6x7
tet problem) and on the packed structured engine (the 7^3 hex box with
linear hardening).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from test_torch_sharding import AOS, TIMEOUT, rel

from fenics_constitutive_tpu_torch.parallel import run_ranks
from fenics_constitutive_tpu_torch.parallel.runs import build_problem, cases_rank, problem_run
from fenics_constitutive_tpu_torch.utils import load_checkpoint, load_state_dict

CKPT = {
    "aos": {**AOS, "loads": [0.005, 0.01, 0.015], "split": 2, "observe": False},
    "packed": {"mesh": ("box", (7, 7, 7), "hex"), "law": "hardening", "q": 2,
               "loads": [0.01, 0.02, 0.03], "split": 2,
               "solve": {"rtol": 1e-14, "atol": 1e-13, "cg_rtol": 1e-15}},
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, the uninterrupted one-process runs)"""
    tmp = tmp_path_factory.mktemp("ranks")
    cases = {k: ("checkpoint", {**spec, "path": str(tmp / f"{k}.npz")})
             for k, spec in CKPT.items()}
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, cases_rank, 2, cases, "cpu", workdir=tmp,
                            timeout=TIMEOUT)
        refs = {k: problem_run(spec, "cpu") for k, spec in CKPT.items()}
        return ranks.result(), refs


@pytest.mark.parametrize("case", sorted(CKPT))
def test_restores_on_the_same_ranks(runs, case):
    ranks, refs = runs
    ref = refs[case]
    for res in ranks:
        r = res[case]
        assert rel(r["u"], ref["u"]) < 1e-14
        assert rel(r["u_restored"], ref["u"]) < 1e-14
        assert rel(r["stress_restored"], ref["stress"]) < 1e-13


@pytest.mark.parametrize("case", sorted(CKPT))
def test_restores_in_one_process(runs, case):
    ranks, refs = runs
    spec, ref = CKPT[case], refs[case]
    state = load_checkpoint(ranks[0][case]["path"])
    assert str(np.asarray(state["engine"])) == ("aos" if case == "aos" else "packed")
    restored, move = build_problem(spec, "cpu")
    load_state_dict(restored, state)
    for value in spec["loads"][spec["split"]:]:
        move.value = value
        assert restored.solve(**spec["solve"])[1]
        restored.update()
    assert rel(restored.u, ref["u"]) < 1e-14
    assert rel(restored.stress_0, ref["stress"]) < 1e-13
