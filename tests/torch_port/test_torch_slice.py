"""The port's main path as a whole against the JAX package (6^3 box, float64).

(a) The benchmark configuration of make_packed_step (one Newton iteration,
    fixed-9 CG, V(3,3) multigrid with a direct coarse solve) over the load
    scales 0.5, 1.0, 1.5 of the benchmark's stretch: u, stress, alpha and
    r_norm agree to rtol 1e-8 of each field's largest entry. The two
    packages take the same steps with sums in another order; the nine CG
    iterations and the local Newton amplify that by a few orders of
    magnitude, nowhere near 1e-8. (The first two loads stay elastic, so no
    point sits on the yield surface when a step starts, where round-off
    would decide which points count as plastic.)
(b) PackedSimulation with the V-cycle, three load steps of 0.004 k: both
    converge, with Newton counts equal or one apart, and u and stress agree
    to rtol 1e-7 (both Newton loops stop at 1e-8 of the first residual).
    The counts may differ because a step that starts from a plastic state
    has its first tangent decided by round-off: every point that yielded in
    the step before sits on the yield surface, its trial stress as far
    outside it as the last local Newton left it (about 1e-12). Either
    tangent converges to the same state; the residual history differs.
(c) A plastic JAX state carried over by utils.convert is bit-equal, and one
    converged step from it agrees as in (b).
Plus the kernel branch of make_packed_step (eval_impl/matvec_impl="kernel"),
driven on CPU tensors through the wrappers' plain versions, reproduces the
plain branch exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu.solver.multigrid import build_multigrid as jax_build_mg
from fenics_constitutive_tpu.solver.packed_step import (
    build_packed_problem as jax_build_problem,
)
from fenics_constitutive_tpu.solver.packed_step import make_packed_step as jax_make_step
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.solver import (
    PackedSimulation,
    build_multigrid,
    build_packed_problem,
    make_packed_step,
)
from fenics_constitutive_tpu_torch.utils import params_from_numpy, state_from_numpy

F64 = torch.float64
SCALES = (0.5, 1.0, 1.5)
BENCH = dict(max_newton=1, newton_rtol=0.0, newton_atol=0.0, cg_rtol=1e-5,
             cg_maxiter=400, cg_fixed_iters=9)
MG = dict(nu=3, nu_coarse=2, coarse_direct=True)
CONVERGED = dict(max_newton=25, newton_rtol=1e-8, newton_atol=1e-8, cg_rtol=1e-6,
                 cg_maxiter=1000)


def close(got, ref, rtol, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
                               err_msg=what)


def port_bench(pair, mat):
    V, bcs = pair["torch"]
    geos, models, state = build_packed_problem(V, VonMises3D(mat), 2, device="cpu", dtype=F64)
    bc_dofs, bc_vals = combine_bcs(bcs)
    free = torch.ones(V.ndofs, dtype=torch.bool)
    free[torch.as_tensor(bc_dofs, dtype=torch.int64)] = False
    mg = build_multigrid(geos[0], mat["p_mu"], mat["p_ka"], free, device="cpu",
                         dtype=F64, **MG)
    args = (torch.as_tensor(bc_dofs), torch.tensor(bc_vals), torch.zeros(V.ndofs), 1.0)
    return geos, models, state, mg, args


@pytest.fixture(scope="module")
def bench_runs(box, mat):
    pair = box(6)
    # JAX reference
    V, bcs = pair["jax"]
    geos, models, state = jax_build_problem(V, JVonMises3D(mat), 2)
    bc_dofs, bc_vals = jax_combine(bcs)
    free = jnp.ones(V.ndofs, bool).at[jnp.asarray(bc_dofs)].set(False)
    mg = jax_build_mg(geos[0], mat["p_mu"], mat["p_ka"], free, **MG)
    step = jax.jit(jax_make_step(geos, preconditioner=mg, **BENCH))
    ref, st = [], state
    for k in SCALES:
        st, stats = step(models, st, jnp.asarray(bc_dofs), jnp.asarray(bc_vals) * k,
                         jnp.zeros(V.ndofs), jnp.asarray(1.0))
        ref.append((st, stats))
    # port
    geos_t, models_t, state_t, mg_t, args = port_bench(pair, mat)
    step_t = make_packed_step(geos_t, preconditioner=mg_t, **BENCH)
    got, st = [], state_t
    for k in SCALES:
        st, stats = step_t(models_t, st, args[0], args[1] * k, *args[2:])
        got.append((st, stats))
    return ref, got


@pytest.mark.parametrize("i", range(len(SCALES)), ids=[f"scale{k}" for k in SCALES])
def test_bench_step_matches_jax(bench_runs, i):
    (sj, stj), (st, stt) = bench_runs[0][i], bench_runs[1][i]
    assert int(stt["newton_iters"]) == int(stj["newton_iters"]) == 1
    close(st.u, sj.u, 1e-8, "u")
    close(st.stress[0], sj.stress[0], 1e-8, "stress")
    close(st.histories[0]["alpha"], sj.histories[0]["alpha"], 1e-8, "alpha")
    close(stt["r_norm"], stj["r_norm"], 1e-8, "r_norm")


def test_bench_steps_reach_plasticity(bench_runs):
    st = bench_runs[1][-1][0]
    assert float(st.histories[0]["alpha"].max()) > 0.0


def test_kernel_branch_on_cpu_matches_plain(box, mat, monkeypatch):
    import fenics_constitutive_tpu_torch.solver.packed_step as ps

    monkeypatch.setattr(ps, "_require_cuda", lambda geo: None)
    geos, models, state, mg, args = port_bench(box(4), mat)
    out = {}
    for impl in ("kernel", "plain"):
        step = make_packed_step(geos, preconditioner=mg, matvec_impl=impl,
                                eval_impl=impl, **BENCH)
        st = state
        for k in SCALES:
            st, stats = step(models, st, args[0], args[1] * k, *args[2:])
        out[impl] = (st, stats)
    (sk, tk), (sp, tp) = out["kernel"], out["plain"]
    torch.testing.assert_close(sk.u, sp.u, rtol=0, atol=0)
    torch.testing.assert_close(sk.stress[0], sp.stress[0], rtol=0, atol=0)
    torch.testing.assert_close(tk["r_norm"], tp["r_norm"], rtol=0, atol=0)


@pytest.fixture(scope="module")
def simulations(box, mat):
    pair = box(6)
    runs = {}
    for key, make in (
        ("jax", lambda V, bcs: JPackedSimulation(JVonMises3D(mat), V, bcs, 2,
                                                 preconditioner="vcycle")),
        ("torch", lambda V, bcs: PackedSimulation(VonMises3D(mat), V, bcs, 2,
                                                  preconditioner="vcycle",
                                                  device="cpu", dtype=F64)),
    ):
        V, bcs = pair[key]
        sim = make(V, bcs)
        steps = []
        for k in (1, 2, 3):
            bcs[1].value = 0.004 * k
            niter, conv = sim.solve()
            steps.append((niter, conv, np.asarray(sim.u).copy(), np.asarray(sim.stress)))
        runs[key] = (sim, steps, bcs)
    return runs


@pytest.mark.parametrize("k", [0, 1, 2], ids=["step1", "step2", "step3"])
def test_simulation_matches_jax(simulations, k):
    nj, cj, uj, sj = simulations["jax"][1][k]
    nt, ct, ut, stt = simulations["torch"][1][k]
    assert ct and cj
    assert abs(nt - nj) <= 1
    close(ut, uj, 1e-7, "u")
    close(stt, sj, 1e-7, "stress")


def test_state_from_numpy_roundtrip_and_step(simulations, mat):
    sim_j, _, bcs_j = simulations["jax"]
    sim_t, _, bcs_t = simulations["torch"]
    sj = sim_j.state
    assert float(sj.histories[0]["alpha"].max()) > 0.0  # plastic
    st = state_from_numpy(
        np.asarray(sj.u), [np.asarray(s) for s in sj.stress],
        [{k: np.asarray(v) for k, v in h.items()} for h in sj.histories],
        np.asarray(sj.t), device="cpu", dtype=F64,
    )
    torch.testing.assert_close(st.u, torch.tensor(np.asarray(sj.u)), rtol=0, atol=0)
    torch.testing.assert_close(st.stress[0], torch.tensor(np.asarray(sj.stress[0])),
                               rtol=0, atol=0)
    for k, v in sj.histories[0].items():
        torch.testing.assert_close(st.histories[0][k], torch.tensor(np.asarray(v)),
                                   rtol=0, atol=0)
    assert float(st.t) == float(sj.t)

    # one more converged load step from the carried state, in both packages
    law_t = VonMises3D(params_from_numpy(JVonMises3D(mat).params))
    assert law_t.params == mat
    geos_t = sim_t._geos
    step_t = make_packed_step(geos_t, preconditioner=sim_t._mg, **CONVERGED)
    bcs_t[1].value = 0.016
    bc_dofs, bc_vals = combine_bcs(bcs_t)
    out_t, stats_t = step_t((law_t,), st, torch.as_tensor(bc_dofs), torch.tensor(bc_vals),
                            torch.zeros(st.u.shape[0]), 1.0)
    sim_j.bcs[1].value = 0.016
    niter, conv = sim_j.solve()
    assert conv and abs(int(stats_t["newton_iters"]) - niter) <= 1
    close(out_t.u, sim_j.u, 1e-7, "u")
    close(out_t.stress[0], sim_j.state.stress[0], 1e-7, "stress")
