"""bench_torch.py, the twin of bench.py, against bench.py on the CPU (float64,
a 6^3 box), and the bound arithmetic scripts/torch_bench/roofline.py shares
with chip_smoke.py.

bench.py runs in this process (``main()`` with its environment and
``sys.argv`` patched; tests/conftest.py puts JAX on the CPU with x64), the
twin through its own entry point with ``--device cpu --dtype float64``.

What can be held, and why: the state after bench.py's three warm-up loads
is deterministic (the loads 0.5 and 1.0 stay elastic, and 1.5 starts from an
elastic state), so it is held to the same JAX calls within 1e-8, as
test_torch_slice.py holds it. A timed step starts from a plastic state,
where every point that yielded sits on the yield surface and round-off
decides whether it counts as plastic, so the one Newton iteration's residual
is a few percent apart between two programs: measured on this 6^3 box,
bench.py against the same JAX step compiled on its own 2.6% (one step), the
twin against bench.py 1.7% (one step) and 6.4% after six (where the two
verdicts differ; with two Newton iterations a step still 5.6%). So (a)
holds the settled and deep residuals within 2% and equal verdicts on the
one-step schedule; (b) the failing verdict and the settled residual where
the CG count, not round-off, sets it (fixed-1: 0.1% after one step, 1.4%
after six, where every probe of the window is held within 2% of the same
JAX calls); and on the 6-step schedule at the default fixed-9 CG with the
Newton step converged (4 iterations, so round-off no longer picks the
tangent) the state after the timed window within 1e-8 of the JAX calls.
The twin's deep re-run repeats the warm-up at the deep count, where bench.py
starts it from the timed run's warm state; at the default count the two
warm states agree, at fixed-1 they do not (bench_torch.py says why).
(c) A sharded run is bit-equal to one process (the box engines assemble
whole on every rank), so its probes are held equal.
"""

import contextlib
import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from fenics_constitutive_tpu.fem import DirichletBC, FunctionSpace, unit_cube_mesh
from fenics_constitutive_tpu.fem.bcs import combine_bcs
from fenics_constitutive_tpu.models import VonMises3D
from fenics_constitutive_tpu.solver.multigrid import build_multigrid
from fenics_constitutive_tpu.solver.packed_step import build_packed_problem, make_packed_step
from scripts.torch_bench import common, roofline

N = 6
TWIN = ["--device", "cpu", "--dtype", "float64"]
#: Newton iterations a step where the first tangent must not decide: the
#: state after 4 no longer depends on which points the first one counted
#: as plastic (at 3 the 6^3 box's residual is already ~1e-9 of its start)
NEWTON = 4


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(), err_msg=what)


def run_bench_py(env: dict) -> tuple[dict, int]:
    """bench.py's main() in this process: (its JSON line, its exit code)."""
    out = io.StringIO()
    code = 0
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(sys, "argv", ["bench.py"])
        with contextlib.redirect_stdout(out):
            try:
                bench.main()
            except SystemExit as e:
                code = e.code
    return json.loads(out.getvalue().strip().splitlines()[-1]), code


def twin_line(env: dict, argv=TWIN) -> tuple[dict, object]:
    """The twin's line and its run's objects (bench_torch.measure)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        return bench_torch.measure(argv)


def twin_main(env: dict, argv=TWIN) -> tuple[dict, int]:
    """The twin run as a user runs it: (its printed line, its exit code)."""
    out = io.StringIO()
    code = 0
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        with contextlib.redirect_stdout(out):
            try:
                bench_torch.main(argv)
            except SystemExit as e:
                code = e.code
    return json.loads(out.getvalue().strip().splitlines()[-1]), code


def jax_box_run(n: int, fixed: int, loads, max_newton: int = 1):
    """bench.py's calls in its order, one step a load (the warm-up loads
    first) with fixed-``fixed`` CG and ``max_newton`` Newton iterations:
    (the state after the last load, the r_norm of every step)."""
    V = FunctionSpace(unit_cube_mesh(n, n, n, "hex"), 1, 3)

    def at(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    bcs = [DirichletBC(V.locate_dofs_geometrical(at(0, 0.0), component=0), 0.0),
           DirichletBC(V.locate_dofs_geometrical(at(0, 1.0), component=0), 0.004),
           DirichletBC(V.locate_dofs_geometrical(at(1, 0.0), component=1), 0.0),
           DirichletBC(V.locate_dofs_geometrical(at(2, 0.0), component=2), 0.0)]
    geos, models, state = build_packed_problem(V, VonMises3D(common.MAT), q_degree=2)
    bc_dofs, bc_vals = combine_bcs(bcs)
    free = jnp.ones(V.ndofs, bool).at[jnp.asarray(bc_dofs)].set(False)
    mg = build_multigrid(geos[0], common.MU, common.KAPPA, free, nu=3, nu_coarse=2,
                         coarse_direct=True)
    step = jax.jit(make_packed_step(geos, max_newton=max_newton, newton_rtol=0.0,
                                    newton_atol=0.0, cg_rtol=1e-5, cg_maxiter=400,
                                    preconditioner=mg, cg_fixed_iters=fixed))
    st, probes = state, []
    for k in loads:
        st, stats = step(models, st, jnp.asarray(bc_dofs), jnp.asarray(bc_vals) * k,
                         jnp.zeros(V.ndofs), jnp.asarray(1.0))
        probes.append(float(stats["r_norm"]))
    return st, probes


def jax_warm_state(n: int):
    """bench.py's calls up to the end of its warm-up, in its order."""
    return jax_box_run(n, 9, common.WARM_LOADS)[0]


@contextlib.contextmanager
def converged_newton(max_newton: int = NEWTON):
    """The port's packed step with ``max_newton`` Newton iterations wherever
    a twin builds one (a twin builds its step when it runs)."""
    import fenics_constitutive_tpu_torch.solver as tsolver

    make = tsolver.make_packed_step

    def patched(*args, **kwargs):
        return make(*args, **{**kwargs, "max_newton": max_newton})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsolver, "make_packed_step", patched)
        yield


@pytest.fixture(scope="module")
def jax_one_step():
    return run_bench_py({"BENCH_N": str(N), "BENCH_STEPS": "1"})


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
def test_bench_twin_matches_bench_py(jax_one_step, fused, no_repo_writes):
    (ref, ref_code) = jax_one_step
    line, objs = twin_line({"BENCH_N": str(N), "BENCH_STEPS": "1", "BENCH_FUSED": fused})
    warm = objs["warm"]
    # the warm state, deterministic: within 1e-8 of bench.py's calls
    sj = jax_warm_state(N)
    close(warm.u, sj.u, 1e-8, "u")
    close(warm.stress[0], sj.stress[0], 1e-8, "stress")
    close(warm.histories[0]["alpha"], sj.histories[0]["alpha"], 1e-8, "alpha")
    assert float(warm.histories[0]["alpha"].max()) > 0.0  # past yield
    assert line["n_qp"] == N**3 * 8
    assert line["converged"] is ref["converged"] is True and ref_code == 0
    for key in ("r_norm", "r_norm_ref"):
        assert line[key] == pytest.approx(ref[key], rel=0.02), key
    # the line: bench.py's keys but vs_baseline, and the protocol's
    assert "vs_baseline" not in line
    assert line["metric"] == ref["metric"] == "mises_1MQP_newton_step_converged"
    assert len(line["windows_ms"]) == common.WINDOWS >= 5
    assert line["value"] == pytest.approx(float(np.median(line["windows_ms"])))
    assert line["spread"] >= 0.0 and line["clock"] == "host"
    assert line["fused"] is (fused == "1") and line["dtype"] == "float64"
    assert line["device"] == {"name": "cpu", "power_limit": None, "power_limit_w": None}
    assert set(line["launches"].values()) == {0}  # no kernel off the card


def test_bench_twin_six_steps_protocol(no_repo_writes):
    """The 6-step schedule: the line is whole, its probes finite and
    its verdict that of its own deep re-runs (the 2x-deep one off 50^3)."""
    line, code = twin_main({"BENCH_N": str(N), "BENCH_STEPS": "6"})
    assert len(line["probes"]) == 6 and np.isfinite(line["probes"]).all()
    assert line["r_norm"] == line["probes"][-1]
    assert line["r_norm_ref2"] is not None
    assert line["converged"] == common.verdict(line["r_norm"], line["r_norm_ref"],
                                               line["r_norm_ref2"])
    assert code == (0 if line["converged"] else 1)


def test_bench_twin_six_steps_fixed_one_matches_jax(no_repo_writes):
    """The 6-step schedule where the CG count sets the residual (fixed-1):
    every probe of the timed window within 2% of the same JAX calls, the
    settled residual within 2% of bench.py's, both verdicts failing."""
    env = {"BENCH_N": str(N), "BENCH_STEPS": "6", "BENCH_FIXED_ITERS": "1"}
    ref, ref_code = run_bench_py(env)
    line, code = twin_main(env)
    assert (ref["converged"], ref_code) == (line["converged"], code) == (False, 1)
    assert line["r_norm"] == pytest.approx(ref["r_norm"], rel=0.02)
    loads = [*common.WARM_LOADS, *common.scales(common.WINDOWS, 6)]
    close(line["probes"], jax_box_run(N, 1, loads)[1][-6:], 0.02, "probes")


@pytest.mark.parametrize("fused", ["1", "0"], ids=["fused", "eager"])
def test_bench_twin_six_steps_converged_newton_matches_jax(fused, no_repo_writes):
    """The 6-step schedule at the default fixed-9 CG with the Newton step
    converged, where round-off no longer picks the tangent: the state after
    the timed window within 1e-8 of the same JAX calls."""
    with converged_newton():
        line, objs = twin_line({"BENCH_N": str(N), "BENCH_STEPS": "6", "BENCH_FUSED": fused})
    loads = [*common.WARM_LOADS, *common.scales(common.WINDOWS, 6)]
    sj, probes = jax_box_run(N, 9, loads, max_newton=NEWTON)
    final = objs["final"]
    close(final.u, sj.u, 1e-8, "u")
    close(final.stress[0], sj.stress[0], 1e-8, "stress")
    close(final.histories[0]["alpha"], sj.histories[0]["alpha"], 1e-8, "alpha")
    assert float(final.histories[0]["alpha"].max()) > 0.0
    assert line["fixed_iters"] == 9 and len(line["probes"]) == 6
    assert max(line["probes"]) < 1e-6 and max(probes[-6:]) < 1e-6  # converged


def test_bench_twin_fails_where_bench_py_fails(no_repo_writes):
    env = {"BENCH_N": str(N), "BENCH_STEPS": "1", "BENCH_FIXED_ITERS": "1"}
    ref, ref_code = run_bench_py(env)
    line, code = twin_main(env)
    assert (ref["converged"], ref_code) == (line["converged"], code) == (False, 1)
    assert line["r_norm"] == pytest.approx(ref["r_norm"], rel=0.02)
    # the twin's deep re-run repeats the warm-up at fixed-40; bench.py's
    # starts from the fixed-1 warm state, so its reference sits higher
    assert line["r_norm_ref"] < ref["r_norm_ref"]


def test_bench_twin_sharded_equals_one_process(no_repo_writes):
    env = {"BENCH_N": str(N), "BENCH_STEPS": "3"}
    one, _ = twin_line(env)
    line, objs = twin_line(env, ["--sharded", "2", "--dtype", "float64"])
    assert objs is None
    assert line["metric"] == "mises_1MQP_newton_step_converged_sharded2cpu"
    assert line["probes"] == one["probes"]
    for key in ("r_norm", "r_norm_ref", "r_norm_ref2", "converged", "n_qp"):
        assert line[key] == one[key], key
    assert len(line["rank_values"]) == 2 and line["value"] == max(line["rank_values"])
    assert set(line["launches"].values()) == {0}


def test_twin_without_a_card_fails():
    """No fallback: the default device is the card."""
    assert bench_torch.parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench_torch.main([])


# -- (e) the bound arithmetic, moved from chip_smoke.py ---------------------------------


def old_chain_cost(chain):
    """chip_smoke.py's chain_cost before the move, verbatim."""
    geo = chain.geo
    M, vs, size = geo.M, geo.vs, chain.inv_d.element_size()
    vecs = 1 + (0 if chain.zero_start else 1) + 1 + int(chain.emit_residual)
    nbytes = vecs * vs * M * size + sum(
        t.numel() * t.element_size() for t in (chain.inv_d, chain.pid, chain.st))
    sweeps = max(chain.nu - 1, 0) if chain.zero_start else chain.nu
    applies = sweeps + int(chain.emit_residual)
    return nbytes, applies * M * 2.0 * 3**geo.gdim * geo.vs**2 + sweeps * 3 * M * vs


@pytest.fixture(scope="module")
def hierarchy():
    """The 50^3 fused hierarchy of phases 5/11/12 (float32, built on the CPU)."""
    from fenics_constitutive_tpu_torch.solver import build_multigrid as tbuild

    geos, _, _, mg, _ = common.bench_setup(50, torch.float32, "cpu", fused=True)
    mg_coarse = tbuild(geos[0], common.MU, common.KAPPA, device="cpu", dtype=torch.float32,
                       nu=3, nu_coarse=2, fused_smoothing=True)
    return geos[0], mg, mg_coarse


def test_bounds_k1_k2_unchanged(hierarchy):
    geo = hierarchy[0]
    M, cells = geo.M, float(geo.mask.sum())
    assert (M, cells) == (51**3, 50.0**3)
    assert roofline.k1_cost(geo) == (4 * (3 + 8 + 8 + 48 + 1 + 3) * M,
                                     cells * (4 * 1152 + 8 * 40) + 21 * M)
    assert roofline.k2_cost(geo) == (4 * 279 * M, cells * (4 * 576 + 8 * 100) + 21 * M)
    for cost in (roofline.k1_cost, roofline.k2_cost):  # float64 values: twice the bytes
        assert cost(geo, 8) == (2 * cost(geo)[0], cost(geo)[1])
    bound, by = roofline.bound_ms(*roofline.k2_cost(geo), torch.float32)
    assert (bound, by) == (4 * 279 * M / 3.35e12 * 1e3, "bytes")
    assert roofline.bound_ms(0.0, 67e9, torch.float32) == (1.0, "operations")
    assert roofline.bound_ms(0.0, 34e9, torch.float64) == (1.0, "operations")


def test_bounds_k3_unchanged(hierarchy):
    geo, mg, mg_coarse = hierarchy
    chains = [c for lvl in range(mg.n_levels - 1) for c in mg.fused[lvl].values()]
    chains.append(mg_coarse.fused[-1]["coarse"])
    for chain in chains:
        assert roofline.chain_cost(chain) == old_chain_cost(chain)
    assert roofline.stencil_flops(geo) == 486.0
    fc = mg.fused_cycle
    costs = roofline.vcycle_costs(fc, 4, 2)
    assert [kind for _, kind, _ in costs] == ["pre_restrict"] * 2 + ["tail"] + \
        ["prolong_post"] * 2
    # the first level's pre_restrict, as chip_smoke.py's k3_entries counted it
    pre = fc.chains[0]["pre"]
    M, Mc = fc._chain(0).geo.M, fc._chain(1).geo.M
    assert costs[0][2] == (roofline.level_bytes(pre) + 12 * (2 * M + Mc),
                           pre.nu * M * 486.0 + (pre.nu - 1) * 9 * M + 27 * 6 * Mc)


def test_bounds_window_kernels_unchanged(tets):
    from fenics_constitutive_tpu_torch.ops import build_windowed_exchange, build_windowed_bsr
    import scipy.sparse as sp

    V = tets(6)["torch"][0]
    ex = build_windowed_exchange(V.mesh.cells, V.mesh.num_nodes, device="cpu", tile=128)
    rows = ex.B * 3 * ex.Rn * 4
    idx5 = (ex.node_ptr.numel() * ex.node_ptr.element_size()
            + ex.node_rows.numel() * ex.node_rows.element_size())
    assert roofline.window_costs(ex) == {
        "K4": (3 * ex.M_pad * 4 + ex.loc.numel() * ex.loc.element_size() + rows, 0.0),
        "K5": (rows + idx5 + 3 * ex.M_pad * 4, 3.0 * ex.node_rows.numel())}
    A = sp.random(60, 60, density=0.1, random_state=np.random.default_rng(0)) + sp.eye(60)
    w = build_windowed_bsr(A.tocsr(), 3, 3, device="cpu", dtype=torch.float32)
    nnzb = w.col.numel()
    assert roofline.k6_cost(w) == ((w.NR_pad + 1 + nnzb) * 4
                                   + (nnzb * 9 + 3 * w.NC_pad + 3 * w.NR_pad) * 4,
                                   2.0 * nnzb * 9)
