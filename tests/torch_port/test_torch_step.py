"""The port's make_load_step against the JAX package's, float64 on the CPU:
the same load path from the same zero state through both, on a 2^3 hex box
(VonMises3D driven past yield) and on a 2^3 tet box with two laws
(SpringMaxwellModel and linear elasticity), a Neumann load and a time
increment. Newton stops at the same test, so converged states agree within
1e-8 of their largest entry (plastic steps may take one Newton iteration
more or fewer, ROADMAP.md Queue 3) and the stats carry the same keys.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jcombine
from fenics_constitutive_tpu.solver import IncrSmallStrainProblem as JProblem
from fenics_constitutive_tpu.solver.step import StepState as JStepState
from fenics_constitutive_tpu.solver.step import make_load_step as jmake
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem, StepState, make_load_step
from test_torch_problem import PKGS, bench_box

F64 = torch.float64
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}


def mises_box(fem, m):
    V, bcs = bench_box(fem, "hex", 2)
    return m.VonMises3D(MAT), V, bcs, 2


def two_law_tets(fem, m):
    V, bcs = bench_box(fem, "tetra", 2)
    z = V.mesh.cell_midpoints()[:, 2]
    laws = [(m.SpringMaxwellModel({"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3},
                                  m.Constraint.FULL), np.flatnonzero(z < 0.5)),
            (m.LinearElasticityModel({"E": 60000.0, "nu": 0.3}, m.Constraint.FULL),
             np.flatnonzero(z >= 0.5))]
    return laws, V, bcs, 1


CASES = {"mises_box": (mises_box, 0.01, False), "two_law_tets": (two_law_tets, 0.002, True)}


def drive(key, case):
    setup, stretch, neumann = CASES[case]
    fem, m = PKGS[key]
    laws, V, bcs, q = setup(fem, m)
    load = np.zeros(V.ndofs)
    if neumann:
        load[V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 1], 1.0), component=1)] = 0.5
    out = []
    if key == "jax":
        p = JProblem(laws, V, bcs, q, engine="aos")
        step = jmake(p, newton_rtol=1e-11)
        st = JStepState(u=p.u, stress=p._stress_prev, histories=p._histories,
                        t=jnp.asarray(0.0))
        for k in (1, 2, 3):
            bcs[1].value = stretch * k
            dofs, vals = jcombine(bcs)
            st, stats = step(p._models, st, jnp.asarray(dofs), jnp.asarray(vals),
                             jnp.asarray(load), 0.5)
            out.append((st, stats))
    else:
        p = IncrSmallStrainProblem(laws, V, bcs, q, device="cpu", dtype=F64)
        step = make_load_step(p, newton_rtol=1e-11)
        C, Q = V.mesh.num_cells, p._law_data[0][1].n_qp
        st = StepState(
            u=torch.zeros(V.ndofs, dtype=F64),
            stress=torch.zeros((C, Q, 6), dtype=F64),
            histories=tuple(mo.init_history(len(c) * Q, dtype=F64) for mo, c in
                            zip(p._models, p._law_cells)),
            t=torch.zeros((), dtype=F64))
        for k in (1, 2, 3):
            bcs[1].value = stretch * k
            dofs, vals = combine_bcs(bcs)
            st, stats = step(p._models, st, dofs, vals, load, 0.5)
            out.append((st, stats))
    return [(st_.u, st_.stress, st_.histories, float(st_.t),
             {k: float(np.asarray(v)) for k, v in stats.items()}) for st_, stats in out]


def leaves(h):
    return [] if h is None else [h[k] for k in sorted(h)]


@pytest.mark.parametrize("case", list(CASES))
def test_load_step_matches_jax(case):
    got, ref = drive("torch", case), drive("jax", case)
    plastic = case == "mises_box"
    for (u, s, h, t, st), (uj, sj, hj, tj, stj) in zip(got, ref):
        assert set(st) == set(stj) == {"newton_iters", "r_norm", "r0_norm"}
        assert abs(st["newton_iters"] - stj["newton_iters"]) <= (1 if plastic else 0)
        assert st["r0_norm"] == pytest.approx(stj["r0_norm"], rel=1e-10)
        assert t == tj
        pairs = [(u.numpy(), np.asarray(uj)), (s.numpy(), np.asarray(sj))]
        for ha, hb in zip(h, hj):
            pairs += zip([x.numpy() for x in leaves(ha)], map(np.asarray, leaves(hb)))
        for x, y in pairs:
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-8 * np.abs(y).max())
    assert got[-1][4]["r_norm"] <= max(1e-10, 1e-11 * got[-1][4]["r0_norm"])
    if plastic:
        assert float(got[-1][2][0]["alpha"].max()) > 0
