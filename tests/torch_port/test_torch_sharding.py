"""The sharded IncrSmallStrainProblem (parallel/sharding.py) against the
one-process run, on gloo ranks spawned on the CPU: the counterparts of
tests/parallel/test_sharding.py's AoS cases, with the reference's MPI bar.

The reference runs its 4x6x7 plasticity problem partitioned and serial and
holds them to a relative L2 difference of 1e-14 (test_solver_mpi.py:92-121).
Here the same problem (10 steps, Newton rtol 1e-14, CG rtol 1e-15) runs on
2 ranks (4 ranks: test_torch_sharding_ranks4.py): u within 1e-14 of the
port's one-process run and within 1e-12 of the JAX package's unsharded run,
with the same Newton counts (CG's counts at rtol 1e-15 may differ by a few
iterations, as the sums round differently). The ranks also check that their
``u`` is bit-equal to every other rank's, and report how much QP state they
hold (their own cells only). The rank programs are
``fenics_constitutive_tpu_torch.parallel.runs.cases_rank``; every run
initialises its process group from a file store under the test's tmp dir,
with a timeout on the group and on the join. A gloo all-reduce costs about
1.3 ms on 2 CPU ranks (4-6.5 ms on 4; ``allreduce_run``), and this
problem's Jacobi CG takes about 850 iterations a step, one all-reduce each:
the files keep their runs apart so that each stays near a minute.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fenics_constitutive_tpu_torch.parallel import DeviceMesh, run_ranks, shard_problem
from fenics_constitutive_tpu_torch.parallel.runs import build_problem, cases_rank, problem_run

TIGHT = {"rtol": 1e-14, "atol": 1e-12, "cg_rtol": 1e-15}
#: the reference's MPI test problem: 4x6x7 tets (1008 cells), VonMises3D, q 1
AOS = {"mesh": ("box", (4, 6, 7), "tetra"), "law": "mises", "q": 1, "engine": "aos",
       "loads": [0.05 * k / 10 for k in range(1, 11)], "solve": TIGHT, "observe": True}
TIMEOUT = 300.0


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def aos_parity(runs, one, jax_u) -> None:
    """Every rank's run of the AoS problem against the one-process run and
    JAX's; the ranks bit-equal; plasticity happened."""
    for res in runs:
        r = res["aos"]
        assert rel(r["u"], one["u"]) < 1e-14
        assert rel(r["stress"], one["stress"]) < 1e-13
        assert [n for n, _ in r["iters"]] == [n for n, _ in one["iters"]]
        assert rel(r["u"], jax_u) <= 1e-12
        assert float(r["alpha"].max()) > 0.0
        assert r["u_bitequal"]
        assert torch.equal(r["u"], runs[0]["aos"]["u"])


def jax_aos_u():
    """The JAX package's unsharded run of the AoS problem (the reference of
    tests/parallel/test_sharding.py)."""
    from fenics_constitutive_tpu.fem import DirichletBC, FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu.models import VonMises3D
    from fenics_constitutive_tpu.solver import IncrSmallStrainProblem
    from fenics_constitutive_tpu_torch.parallel.runs import MAT

    V = FunctionSpace(unit_cube_mesh(4, 6, 7, "tetra"), 1, 3)

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    move = DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.0)
    bcs = [DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0), move,
           DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
           DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0)]
    problem = IncrSmallStrainProblem(VonMises3D(MAT), V, bcs, 1, engine="aos")
    for value in AOS["loads"]:
        move.value = value
        assert problem.solve(**TIGHT)[1]
        problem.update()
    return np.asarray(problem.u)


def run_with_references(n: int, cases: dict, workdir) -> tuple:
    """The ranks' results of ``cases`` on ``n`` ranks, the port's
    one-process AoS run and JAX's, the references computed while the ranks
    run."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, cases_rank, n, cases, "cpu", workdir=workdir,
                            timeout=TIMEOUT)
        one, ref = problem_run(AOS, "cpu"), jax_aos_u()
        return ranks.result(), one, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_with_references(2, {"aos": ("problem", AOS)}, tmp_path_factory.mktemp("ranks"))


def test_sharded_matches_one_process_and_jax(runs):
    aos_parity(*runs)


def test_sharded_state_stays_rank_local(runs):
    """After solve() and update() each rank's stress holds its own cells:
    half of the problem's, both ranks together exactly the whole."""
    ranks, one, _ = runs
    sizes = [res["aos"]["qp_numel"] for res in ranks]
    assert sum(sizes) == one["qp_numel"] == ranks[0]["aos"]["whole_qp_numel"]
    assert max(sizes) <= one["qp_numel"] / 2 * 1.1


def test_sharded_observations_are_whole(runs):
    """stress_1, histories, dxm, _del_grad_u, norm(comm=group) and the
    sensors give the one-process values on every rank."""
    ranks, one, _ = runs
    for res in ranks:
        r = res["aos"]
        assert r["dxm"].shape == one["dxm"].shape
        np.testing.assert_array_equal(r["dxm"], one["dxm"])
        assert rel(r["stress_1"], one["stress_1"]) < 1e-13
        for a, b in zip(r["del_grad_u"], one["del_grad_u"]):
            assert a.shape == b.shape and rel(a, b) < 1e-12
        for ha, hb in zip(r["history"], one["history"]):
            assert ha.keys() == hb.keys()
            for k in ha:
                assert ha[k].shape == hb[k].shape
                np.testing.assert_allclose(ha[k], hb[k], rtol=0, atol=1e-14)
        assert r["norm"] == pytest.approx(one["norm"], rel=1e-13)
        assert rel(r["u_sensor"], one["u_sensor"]) < 1e-13
        assert rel(r["qp_sensor"], one["qp_sensor"]) < 1e-13


def test_split_without_cells_raises():
    """A split that leaves a rank without cells of a law raises a clear
    ValueError (the check runs before any collective)."""
    mesh = DeviceMesh(rank=0, size=4, device=torch.device("cpu"))
    box = {"mesh": ("box", (3, 3, 3), "hex"), "law": "elastic", "q": 2, "loads": []}
    problem, _ = build_problem(box, "cpu")  # 3 cell layers for 4 ranks
    with pytest.raises(ValueError, match="cannot be split over 4 ranks"):
        shard_problem(problem, mesh)
    tiny = {"mesh": ("box", (1, 1, 1), "tetra"), "law": "mises", "q": 1, "engine": "aos",
            "loads": []}
    problem, _ = build_problem(tiny, "cpu")  # 6 tets for 8 ranks
    with pytest.raises(ValueError, match="cannot be split over 8 ranks"):
        shard_problem(problem, DeviceMesh(rank=0, size=8, device=torch.device("cpu")))
