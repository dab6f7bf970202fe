"""The sharded packed engines against the one-process run, on gloo ranks
spawned on the CPU: the counterparts of tests/parallel/test_sharding.py's
packed cases and of tests/parallel/test_packed_sharding.py, with their bars.

* IncrSmallStrainProblem on the structured engine (the 7^3 hex box, q 2):
  elastic (4 ranks) and linear hardening (2 ranks) within 1e-12 in u; the
  P2 lattice box (4^3, q 4) on JAX's bars; the gather engine (a shuffled 4^3 tet mesh) and two laws on a box
  (masked views of each slab) and on the windowed engine (a shuffled 9^3
  tet mesh, the AMG preconditioner on every rank) within 1e-12, with their
  observations whole.
* VonMises3D on 1-point hexes (the 7^3 box, q 1), whose tangent is
  singular: the one-process run's steps, and JAX's bars on the physical
  fields.
* The hardening box, the P2 lattice, the q 1 hexes and the windowed step
  also against the JAX package's unsharded run of the same inputs.
* ``make_packed_step`` through ``shard_packed_state`` on the structured 7^3
  box (< 1e-13) and the shuffled 6^3 windowed tets (< 1e-12).
* The ranks' ``u`` bit-equal; each rank's QP state about 1/n of the whole
  (plus one node plane on a slab, plus the plan's padding on a window).
* ``dryrun_multichip(4, device="cpu")``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_torch_sharding import TIMEOUT, rel

from fenics_constitutive_tpu_torch.parallel import dryrun_multichip, run_ranks
from fenics_constitutive_tpu_torch.parallel.runs import (
    HARDENING,
    MAT,
    cases_rank,
    packed_step_run,
    problem_run,
)

PACKED_TIGHT = {"rtol": 1e-14, "atol": 1e-13, "cg_rtol": 1e-15}
BOX7 = ("box", (7, 7, 7), "hex")
CASES = {
    2: {
        "hardening": ("problem", {"mesh": BOX7, "law": "hardening", "q": 2,
                                  "loads": [0.01, 0.02, 0.03], "solve": PACKED_TIGHT}),
        "lattice": ("problem", {"mesh": ("box", (4, 4, 4), "hex"), "degree": 2,
                                "law": "mises", "q": 4, "loads": [0.005, 0.01]}),
        "gather": ("problem", {"mesh": ("shuffled", 4, 0), "law": "mises", "q": 2,
                               "loads": [0.004, 0.008], "solve": PACKED_TIGHT,
                               "observe": True}),
        "two_box": ("problem", {"mesh": ("box", (4, 4, 4), "hex"), "law": "two", "q": 2,
                                "loads": [0.004, 0.008], "solve": PACKED_TIGHT,
                                "observe": True}),
        "q1": ("problem", {"mesh": BOX7, "law": "mises", "q": 1,
                           "loads": [0.02 * k / 3 for k in (1, 2, 3)]}),
        "step_structured": ("packed_step", {"mesh": BOX7, "law": "mises", "q": 2,
                                            "loads": [0.008], "steps": 3}),
        "step_windowed": ("packed_step", {"mesh": ("shuffled", 6, 0), "law": "mises", "q": 2,
                                          "engine": "windowed", "loads": [0.008],
                                          "steps": 3}),
    },
    4: {
        "elastic": ("problem", {"mesh": BOX7, "law": "elastic", "q": 2, "loads": [0.01, 0.02],
                                "solve": PACKED_TIGHT}),
        "two_windowed": ("problem", {"mesh": ("shuffled", 9, 0), "law": "two", "q": 2,
                                     "preconditioner": "amg", "loads": [0.004, 0.008],
                                     "solve": PACKED_TIGHT, "observe": True}),
    },
}
#: relative L2 bar on u against the one-process run
U_BAR = {"hardening": 1e-12, "gather": 1e-12, "two_box": 1e-12, "elastic": 1e-12,
         "two_windowed": 1e-12, "step_structured": 1e-13, "step_windowed": 1e-12}
#: the engine each problem must have resolved to
ENGINES = {"hardening": "structured", "lattice": "lattice", "gather": "gather",
           "two_box": "structured", "two_windowed": "windowed", "q1": "structured"}
#: the cases also held to the JAX package's unsharded run of the same inputs
JAX_CASES = ("hardening", "lattice", "q1", "step_windowed")
NAMES = [(n, name) for n, cases in CASES.items() for name in cases]


def one_process(kind, spec) -> dict:
    run = problem_run if kind == "problem" else packed_step_run
    return run(spec, "cpu")


def jax_run(kind, spec) -> dict:
    """The JAX package's unsharded run of ``spec`` (a box or the shuffled
    tets, "mises" or "hardening"), built as ``parallel/runs.py`` builds the
    port's: u, and for a problem the committed stress and alpha."""
    import jax

    from fenics_constitutive_tpu.fem import DirichletBC, FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu.fem.bcs import combine_bcs
    from fenics_constitutive_tpu.fem.mesh import Mesh
    from fenics_constitutive_tpu.models import MisesPlasticityLinearHardening3D, VonMises3D
    from fenics_constitutive_tpu.solver import IncrSmallStrainProblem
    from fenics_constitutive_tpu.solver.packed_step import build_packed_problem, make_packed_step

    kind_m, *args = spec["mesh"]
    if kind_m == "box":
        mesh = unit_cube_mesh(*args[0], args[1])
    else:  # ("shuffled", n, seed): the tet box with its nodes renumbered
        n, seed = args
        box = unit_cube_mesh(n, n, n, "tetra")
        pi = np.random.default_rng(seed).permutation(box.num_nodes)
        nodes = np.empty_like(box.nodes)
        nodes[pi] = box.nodes
        mesh = Mesh(nodes, pi[box.cells].astype(np.int32), "tetra")
    V = FunctionSpace(mesh, spec.get("degree", 1), 3)
    law = (VonMises3D(MAT) if spec["law"] == "mises"
           else MisesPlasticityLinearHardening3D(HARDENING))

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    move = DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), spec["loads"][0])
    bcs = [DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0), move,
           DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
           DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0)]
    if kind == "packed_step":
        geos, models, state = build_packed_problem(V, law, q_degree=spec["q"],
                                                   engine=spec.get("engine", "auto"))
        step = make_packed_step(geos, newton_rtol=1e-10, cg_rtol=1e-12, cg_maxiter=2000)
        bcd, bcv = combine_bcs(bcs)
        bcv = jax.numpy.asarray(bcv, state.u.dtype)
        fx = jax.numpy.zeros_like(state.u)  # internal on the windowed engine
        dt = jax.numpy.asarray(1.0, state.u.dtype)
        jitted = jax.jit(lambda st: step(models, st, jax.numpy.asarray(bcd), bcv, fx, dt))
        for _ in range(spec["steps"]):
            state, _ = jitted(state)
        return {"u": np.asarray(state.u)}
    problem = IncrSmallStrainProblem(law, V, bcs, spec["q"])
    for value in spec["loads"]:
        move.value = value
        assert problem.solve(**spec.get("solve", {}))[1]
        problem.update()
    return {"u": np.asarray(problem.u), "stress": np.asarray(problem.stress_0),
            "alpha": np.asarray(problem._history_0[0]["alpha"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """n -> (the ranks' results, the one-process results, the JAX package's
    results), the references computed while the ranks run."""
    out = {}
    for n, cases in CASES.items():
        with ThreadPoolExecutor(1) as pool:
            ranks = pool.submit(run_ranks, cases_rank, n, cases, "cpu",
                                workdir=tmp_path_factory.mktemp(f"ranks{n}"), timeout=TIMEOUT)
            refs = {name: one_process(*case) for name, case in cases.items()}
            jax_refs = {name: jax_run(*case) for name, case in cases.items()
                        if name in JAX_CASES}
            out[n] = (ranks.result(), refs, jax_refs)
    return out


@pytest.mark.parametrize(("n", "name"), [c for c in NAMES if c[1] in U_BAR])
def test_sharded_u_matches_one_process(runs, n, name):
    ranks, refs, _ = runs[n]
    for res in ranks:
        assert rel(res[name]["u"], refs[name]["u"]) < U_BAR[name]
        assert res[name]["u_bitequal"]
        assert torch.equal(res[name]["u"], ranks[0][name]["u"])
    if CASES[n][name][0] == "problem":
        assert [k for k, _ in ranks[0][name]["iters"]] == [k for k, _ in refs[name]["iters"]]


@pytest.mark.parametrize(("n", "name"), NAMES)
def test_sharded_state_is_rank_local(runs, n, name):
    """Every rank holds about 1/n of the QP state: its cells, plus one node
    plane on a slab (7^3 box: 5 of 8 planes on 2 ranks), plus the padding of
    its window plan on the windowed engine."""
    ranks, _, _ = runs[n]
    share = max(res[name]["qp_numel"] for res in ranks) / ranks[0][name]["whole_qp_numel"]
    assert share <= (0.65 if n == 2 else 0.45), share


def test_p2_lattice(runs):
    """The degree-2 lattice box: JAX's bars (test_sharding.py:283-285)."""
    ranks, refs, _ = runs[2]
    ref = refs["lattice"]
    assert float(ref["alpha"].max()) > 0
    for res in ranks:
        np.testing.assert_allclose(res["lattice"]["stress"], ref["stress"], rtol=1e-9, atol=1e-8)
        np.testing.assert_allclose(res["lattice"]["alpha"], ref["alpha"], rtol=0, atol=1e-13)


def test_q1_hexes(runs):
    """VonMises3D on 1-point hexes (test_sharding.py:88-150): the tangent is
    singular (hourglass modes), so the run converges only if the right-hand
    side stays in the operator's range to the CG tolerance. The box's
    element arrays are all-reduced before assembly, so the sharded run adds
    every node's terms in the one-process order and takes the one-process
    run's steps: u bit-equal to it, and JAX's bars on the physical fields
    (JAX's sharded q 1 run holds u only to 5e-3)."""
    ranks, refs, _ = runs[2]
    ref = refs["q1"]
    assert float(ref["alpha"].max()) > 0
    for res in ranks:
        r = res["q1"]
        assert r["iters"] == ref["iters"]
        assert torch.equal(r["u"], ref["u"])
        assert r["u_bitequal"]
        np.testing.assert_allclose(r["stress"], ref["stress"], rtol=1e-10, atol=1e-9)
        np.testing.assert_allclose(r["alpha"], ref["alpha"], rtol=0, atol=1e-14)
        assert r["r_norm"] <= 1e-9


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_matches_jax(runs, name):
    """Every rank against the JAX package's unsharded run of the same inputs,
    at the bars of tests/parallel/: u within 1e-12 (the hardening box, the
    windowed step), the physical fields at JAX's bars (the P2 lattice:
    test_sharding.py:283-285; the q 1 hexes: :135-146, whose u is non-unique
    and held to 5e-3)."""
    ranks, _, jax_refs = runs[2]
    ref = jax_refs[name]
    for res in ranks:
        r = res[name]
        assert r["u"].shape == ref["u"].shape
        if name in ("hardening", "step_windowed"):
            assert rel(r["u"], ref["u"]) <= 1e-12
            continue
        tight = name == "q1"
        np.testing.assert_allclose(r["stress"], ref["stress"], rtol=1e-10 if tight else 1e-9,
                                   atol=1e-9 if tight else 1e-8)
        np.testing.assert_allclose(r["alpha"].reshape(ref["alpha"].shape), ref["alpha"], rtol=0,
                                   atol=1e-14 if tight else 1e-13)
        if tight:
            assert rel(r["u"], ref["u"]) < 5e-3


@pytest.mark.parametrize(("n", "name"), [(2, "hardening"), (2, "step_structured"),
                                         (2, "step_windowed")])
def test_plasticity_happened(runs, n, name):
    ranks, refs, _ = runs[n]
    for res in (*ranks, refs[name]):
        r = res[name] if res is not refs[name] else res
        peak = r["alpha_max"] if "alpha_max" in r else float(r["alpha"].max())
        assert peak > 0.0


@pytest.mark.parametrize(("n", "name"), [(2, "gather"), (2, "two_box"), (4, "two_windowed")])
def test_observations_are_whole(runs, n, name):
    ranks, refs, _ = runs[n]
    ref = refs[name]
    for res in ranks:
        r = res[name]
        np.testing.assert_array_equal(r["dxm"], ref["dxm"])
        assert rel(r["stress"], ref["stress"]) < 1e-12
        assert rel(r["stress_1"], ref["stress_1"]) < 1e-12
        for a, b in zip(r["del_grad_u"], ref["del_grad_u"]):
            assert a.shape == b.shape and rel(a, b) < 1e-11
        for ha, hb in zip(r["history"], ref["history"]):
            assert (ha is None) == (hb is None)
            for k in ha or {}:
                assert ha[k].shape == hb[k].shape
                np.testing.assert_allclose(ha[k], hb[k], rtol=0, atol=1e-13)
        assert r["norm"] == pytest.approx(ref["norm"], rel=1e-12)
        assert rel(r["qp_sensor"], ref["qp_sensor"]) < 1e-12


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_resolved(name):
    from fenics_constitutive_tpu_torch.parallel.runs import build_problem

    n = next(k for k, cases in CASES.items() if name in cases)
    problem, _ = build_problem(CASES[n][name][1], "cpu")
    assert problem._pk_geos[0].engine == ENGINES[name]


def test_dryrun_multichip_on_cpu():
    out = dryrun_multichip(4, device="cpu")
    assert len(out) == 4
    for rank in out:
        assert set(rank) == {"structured", "windowed"}
        assert all(v["rel_u"] <= 1e-12 for v in rank.values())
