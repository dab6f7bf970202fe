"""The port's IncrSmallStrainProblem against the JAX package's, float64 on
the CPU: the elasticity BVPs of tests/solver/test_elasticity_bvp.py, the
two engines against each other (tests/solver/test_problem_engines.py), the
observation surface, the line search, and the AMG and callable
preconditioners. The plastic, viscoelastic and Drucker-Prager BVPs are in
test_torch_problem_inelastic.py.

Each case is one function of the package's modules, so the same seeded
numpy inputs run through JAX (once per case, cached) and through the port on
its "packed" and "aos" engines. Tolerances are those of the JAX tests:
Hooke's law stops at the Newton tolerance (rtol 1e-12), so u and stress
agree with JAX's within 1e-10 of their largest entry, and each case's
analytic check (1e-10 relative) holds on the port's run. Newton counts
are equal.
"""

from functools import cache

import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu.solver import IncrSmallStrainProblem as JProblem
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch.fem import assembly as tasm
from fenics_constitutive_tpu_torch.fem import combine_bcs
from fenics_constitutive_tpu_torch.postprocessing import qp_norm
from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem, build_amg

F64 = torch.float64
PKGS = {"jax": (jfem, jm), "torch": (tfem, tm)}
E, NU = 42.0, 0.3


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def left(x):
    return np.isclose(x[:, 0], 0.0)


def right(x):
    return np.isclose(x[:, 0], 1.0)


def make_problem(key, laws, V, bcs, q, engine="auto", **kw):
    if key == "jax":
        return JProblem(laws, V, bcs, q, engine=engine, **kw)
    return IncrSmallStrainProblem(laws, V, bcs, q, engine=engine, device="cpu", dtype=F64, **kw)


def run_case(key, setup, steps, engine="auto"):
    """Build the case's problem for ``key`` and drive its load steps;
    returns one observation dict (numpy) per step."""
    fem, m = PKGS[key]
    laws, V, bcs, q, opts = setup(fem, m)
    p = make_problem(key, laws, V, bcs, q, engine=engine, **opts)
    out = []
    for step in steps:
        step(p, bcs)
        niter, conv = p.solve()
        obs = {"niter": niter, "converged": conv, "stress_1": np_(p.stress_1),
               "grad": [np_(g) for g in p._del_grad_u],
               "hist_1": [None if h is None else {k: np_(v) for k, v in h.items()}
                          for h in p._history_1]}
        p.update()
        obs.update(u=np_(p.u), u0=np_(p._u0), stress_0=np_(p.stress_0), dxm=np_(p.dxm),
                   time=p._time)
        out.append(obs)
    return out


def compare(got, ref, tol, keys=("u", "stress_0", "stress_1", "grad", "hist_1")):
    """Every step's observations within tol of the largest entry, equal
    Newton counts and convergence. The increment's gradient is a difference
    of two displacements, so it carries their round-off too: its floor is
    1e-14 of max|u|."""
    assert len(got) == len(ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert (a["niter"], a["converged"]) == (b["niter"], b["converged"]), k
        assert a["time"] == pytest.approx(b["time"], abs=0)
        np.testing.assert_allclose(a["dxm"], b["dxm"], rtol=1e-14, atol=0)
        for key in keys:
            floor = 1e-14 * np.abs(b["u"]).max() if key == "grad" else 0.0
            for x, y in zip(*(flat_leaves(o[key]) for o in (a, b))):
                assert x.shape == y.shape, (k, key)
                atol = max(tol * np.abs(y).max(), floor, 1e-300)
                np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=f"step {k} {key}")


def flat_leaves(x):
    if x is None:
        return []
    if isinstance(x, dict):
        return [l for k in sorted(x) for l in flat_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in flat_leaves(v)]
    return [np.asarray(x)]


def set_bc(i, value):
    def step(p, bcs):
        bcs[i].value = value
    return step


def noop(p, bcs):
    return None


# -- the elasticity BVPs ---------------------------------------------------------


def bar(fem, n):
    V = fem.FunctionSpace(fem.unit_interval_mesh(n), 1, 1)
    return V, [fem.DirichletBC(V.locate_dofs_geometrical(left), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(right), 0.0)]


def uniaxial_stress(fem, m):
    V, bcs = bar(fem, 10)
    return m.LinearElasticityModel({"E": E, "nu": NU}, m.Constraint.UNIAXIAL_STRESS), V, bcs, 1, {}


def two_laws(factor):
    def setup(fem, m):
        V, bcs = bar(fem, 2)
        c = m.Constraint.UNIAXIAL_STRESS
        laws = [(m.LinearElasticityModel({"E": E, "nu": NU}, c), np.array([0], np.int32)),
                (m.LinearElasticityModel({"E": factor * E, "nu": NU}, c), np.array([1], np.int32))]
        return laws, V, bcs, 1, {}
    return setup


def uniaxial_strain(wrapped):
    def setup(fem, m):
        V, bcs = bar(fem, 2)
        law = (m.UniaxialStrainFrom3D(m.LinearElasticityModel({"E": E, "nu": NU}, m.Constraint.FULL))
               if wrapped else m.LinearElasticityModel({"E": E, "nu": NU},
                                                       m.Constraint.UNIAXIAL_STRAIN))
        return law, V, bcs, 1, {}
    return setup


def plane(cell, q, constraint, wrapped=False):
    def setup(fem, m):
        V = fem.FunctionSpace(fem.unit_square_mesh(2, 2, cell), 1, 2)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(left), np.array([0.0, 0.0])),
               fem.DirichletBC(V.locate_dofs_geometrical(right), np.array([0.01, 0.0]))]
        law = (m.PlaneStrainFrom3D(m.LinearElasticityModel({"E": E, "nu": NU}, m.Constraint.FULL))
               if wrapped else m.LinearElasticityModel({"E": E, "nu": NU}, m.Constraint[constraint]))
        return law, V, bcs, q, {}
    return setup


def cube3d(cell, q):
    def setup(fem, m):
        V = fem.FunctionSpace(fem.unit_cube_mesh(2, 2, 2, cell), 1, 3)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(left), np.zeros(3)),
               fem.DirichletBC(V.locate_dofs_geometrical(right), np.array([0.01, 0.0, 0.0]))]
        return m.LinearElasticityModel({"E": E, "nu": NU}, m.Constraint.FULL), V, bcs, q, {}
    return setup


ELASTIC = {
    "uniaxial_stress": (uniaxial_stress, [set_bc(1, 0.01), set_bc(1, 0.02)]),
    **{f"two_laws_{f}": (two_laws(f), [set_bc(1, 0.01)]) for f in (0.5, 2.0, 3.0, 4.0)},
    "uniaxial_strain": (uniaxial_strain(False), [set_bc(1, 0.01)]),
    "uniaxial_strain_from_3d": (uniaxial_strain(True), [set_bc(1, 0.01)]),
    **{f"plane_{c}_{cell}{'_from_3d' if w else ''}": (plane(cell, q, c.upper(), w), [noop])
       for c, cell, q, w in (("plane_strain", "triangle", 1, False),
                             ("plane_strain", "quad", 2, False),
                             ("plane_strain", "triangle", 1, True),
                             ("plane_strain", "quad", 2, True),
                             ("plane_stress", "triangle", 1, False),
                             ("plane_stress", "quad", 2, False))},
    "cube_tetra": (cube3d("tetra", 1), [noop]),
    "cube_hex": (cube3d("hex", 2), [noop]),
}


@cache
def jax_run(name):
    setup, steps = ELASTIC[name]
    return run_case("jax", setup, steps)


@cache
def port_run(name, engine):
    setup, steps = ELASTIC[name]
    return run_case("torch", setup, steps, engine)


@pytest.mark.parametrize("engine", ["packed", "aos"])
@pytest.mark.parametrize("name", list(ELASTIC))
def test_elastic_bvp_matches_jax(name, engine):
    compare(port_run(name, engine), jax_run(name), 1e-10)


@pytest.mark.parametrize("engine", ["packed", "aos"])
def test_uniaxial_stress_analytic(engine):
    """Two load steps of the bar: sigma = E eps at every QP, and the second
    step solves only the increment."""
    runs = port_run("uniaxial_stress", engine)
    for obs, strain in zip(runs, (0.01, 0.02)):
        w = torch.as_tensor(obs["dxm"])
        for key in ("stress_1", "stress_0"):
            diff = torch.as_tensor(obs[key][..., 0]) - E * strain
            assert float(qp_norm(diff, w)) < 1e-10 / (E * strain)
    assert runs[0]["u0"].max() == 0.01


@pytest.mark.parametrize("factor", [0.5, 2.0, 3.0, 4.0])
def test_two_laws_stress_homogeneous(factor):
    obs = port_run(f"two_laws_{factor}", "packed")[0]
    s = obs["stress_0"].ravel()
    g = [x.ravel() for x in obs["grad"]]
    assert abs(s[0] - s[1]) < 1e-10 / abs(s[0])
    assert g[0][0] != 0.0 and abs(g[0][0] - factor * g[1][0]) < 1e-10 / abs(g[0][0])


def test_uniaxial_strain_and_its_3d_wrapper():
    analytic = E * (1 - NU) / ((1 + NU) * (1 - 2 * NU)) * 0.01
    a = port_run("uniaxial_strain", "packed")[0]
    b = port_run("uniaxial_strain_from_3d", "aos")[0]
    w = torch.as_tensor(a["dxm"])
    for obs in (a, b):
        assert float(qp_norm(torch.as_tensor(obs["stress_0"][..., 0]) - analytic, w)) < \
            1e-10 / analytic
    s3d = b["hist_1"][0]["stress_3d"]
    assert np.linalg.norm(s3d[:, 3:6]) < 1e-14
    assert np.linalg.norm(a["u"] - b["u"]) < 1e-14


@pytest.mark.parametrize("cell", ["triangle", "quad"])
def test_plane_constraints(cell):
    """Plane strain keeps sigma_zz != 0 and equals its 3D wrapper; plane
    stress ends with sigma_zz = 0."""
    ps = port_run(f"plane_plane_strain_{cell}", "packed")[0]
    wr = port_run(f"plane_plane_strain_{cell}_from_3d", "aos")[0]
    pst = port_run(f"plane_plane_stress_{cell}", "packed")[0]
    w = torch.as_tensor(ps["dxm"])

    def n(x):
        return float(qp_norm(torch.as_tensor(x), w))

    assert n(ps["stress_0"][..., 2]) > 1e-2 and n(wr["stress_0"][..., 2]) > 1e-2
    assert np.linalg.norm(wr["u"] - ps["u"]) / np.linalg.norm(ps["u"]) < 1e-14
    assert n(wr["stress_0"] - ps["stress_0"]) / n(ps["stress_0"]) < 1e-10
    assert n(pst["stress_0"][..., 2]) < 1e-10


@pytest.mark.parametrize(("cell", "q"), [("tetra", 1), ("hex", 2)])
def test_3d_against_a_direct_solve(cell, q):
    """The AoS engine's solution against a dense solve of the matrix that
    tangent_matvec applies (the problem's own tangents), and the packed
    engine's against the AoS engine's."""
    fem, m = PKGS["torch"]
    laws, V, bcs, qd, _ = cube3d(cell, q)(fem, m)
    p = make_problem("torch", laws, V, bcs, qd, engine="aos")
    assert p.solve()[1]
    dofmap, geo, _ = p._law_data[0]
    n = p.ndofs
    eye = torch.eye(n, dtype=F64)
    A = torch.stack([tasm.tangent_matvec(eye[i], p._tangents[0], dofmap, geo, p.constraint, n)
                     for i in range(n)], dim=1).numpy()
    bc_dofs, bc_vals = combine_bcs(bcs)
    free = np.ones(n, bool)
    free[bc_dofs] = False
    u = np.zeros(n)
    u[bc_dofs] = bc_vals
    u[free] = np.linalg.solve(A[np.ix_(free, free)], -A[np.ix_(free, ~free)] @ bc_vals)
    assert np.linalg.norm(p.u.numpy() - u) < 1e-8 * np.linalg.norm(u)
    packed = port_run(f"cube_{cell}", "packed")[0]
    np.testing.assert_allclose(packed["u"], p.u.numpy(), rtol=0, atol=1e-12 * np.abs(u).max())


# -- the engines against each other, observations -----------------------------------

MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}


def bench_bcs(V, fem=tfem):
    """The benchmark's Dirichlet set, x = 1 pulled (value 0 until set)."""
    def close(a, v):
        return lambda x: np.isclose(x[:, a], v)

    return [fem.DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
            fem.DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.0),
            fem.DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
            fem.DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0)]


def bench_box(fem, cell, n):
    V = fem.FunctionSpace(fem.unit_cube_mesh(n, n, n, cell), 1, 3)
    return V, bench_bcs(V, fem)


@pytest.mark.parametrize("cell", ["hex", "tetra"])
def test_packed_engine_matches_aos_plasticity(cell):
    """Three plastic steps (VonMises3D) agree between the port's engines,
    with the histories through the observation surface."""
    runs = {}
    for engine in ("packed", "aos"):
        def setup(fem, m):
            V, bcs = bench_box(fem, cell, 2)
            return m.VonMises3D(MAT), V, bcs, 2, {}
        runs[engine] = run_case("torch", setup, [set_bc(1, 0.01 * k) for k in (1, 2, 3)], engine)
    for a, b in zip(runs["packed"], runs["aos"]):
        np.testing.assert_allclose(a["u"], b["u"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(a["stress_0"], b["stress_0"], rtol=1e-8, atol=1e-7)
        np.testing.assert_allclose(a["grad"][0], b["grad"][0], rtol=1e-9, atol=1e-13)
        for k in ("alpha", "eps_n"):
            np.testing.assert_allclose(a["hist_1"][0][k], b["hist_1"][0][k], rtol=1e-7, atol=1e-12)
    assert runs["packed"][-1]["hist_1"][0]["alpha"].max() > 0


def test_packed_engine_multimaterial_on_the_structured_views():
    """Two laws on cell subsets of a box: masked structured views on the
    packed engine, equal to the AoS engine."""
    from fenics_constitutive_tpu_torch.ops.structured import StructuredGeometry

    def setup(fem, m):
        V, bcs = bench_box(fem, "hex", 3)
        mid = V.mesh.cell_midpoints()
        laws = [(m.LinearElasticityModel({"E": 50000.0, "nu": 0.3}, m.Constraint.FULL),
                 np.flatnonzero(mid[:, 0] < 0.5)),
                (m.LinearElasticityModel({"E": 200000.0, "nu": 0.3}, m.Constraint.FULL),
                 np.flatnonzero(mid[:, 0] >= 0.5))]
        return laws, V, bcs, 2, {}

    steps = [set_bc(1, 0.01), set_bc(1, 0.02)]
    a = run_case("torch", setup, steps, "packed")
    b = run_case("torch", setup, steps, "aos")
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["u"], y["u"], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(x["stress_0"], y["stress_0"], rtol=1e-8, atol=1e-7)
    laws, V, bcs, q, _ = setup(tfem, tm)
    p = make_problem("torch", laws, V, bcs, q)
    masks = [g.mask for g in p._pk_geos]
    assert all(isinstance(g, StructuredGeometry) for g in p._pk_geos)
    assert [int(mk.sum()) for mk in masks] == [len(c) for _, c in laws]
    assert float((masks[0] + masks[1]).max()) == 1.0


def test_observation_surface_and_time():
    """_u/_u0, stress_0/stress_1 around update(), _time and _del_t."""
    fem, m = PKGS["torch"]
    laws, V, bcs, q, _ = uniaxial_stress(fem, m)
    p = make_problem("torch", laws, V, bcs, q, del_t=0.5)
    assert p.del_t == p._del_t == 0.5
    bcs[1].value = 0.01
    p.solve()
    assert p._u is p.u and float(p._u0.abs().max()) == 0.0
    assert float(p.stress_0.abs().max()) == 0.0 and float(p.stress_1.abs().max()) > 0
    p.update()
    assert torch.equal(p.stress_0, p.stress_1) and p._time == 0.5
    p._del_t = 2.0
    p._time = 3.0
    assert p.sim_time.dt == 2.0 and p.sim_time.current == 3.0
    with pytest.raises(ValueError, match="partition"):
        IncrSmallStrainProblem([(laws, np.array([0, 1]))], V, bcs, 1, device="cpu", dtype=F64)


# -- the line search -------------------------------------------------------------------


def soft_tangent_models():
    """Linear elasticity whose tangent is 0.4 D: the full Newton step
    overshoots (r -> -1.5 r), the half step lands at -0.25 r."""
    from fenics_constitutive_tpu.models.interfaces import register_model

    @register_model
    class JSoft(jm.LinearElasticityModel):
        def evaluate(self, t, del_t, grad_del_u, stress, history):
            s, tg, h = super().evaluate(t, del_t, grad_del_u, stress, history)
            return s, 0.4 * tg, h

    class TSoft(tm.LinearElasticityModel):
        def evaluate(self, t, del_t, grad_del_u, stress, history):
            s, tg, h = super().evaluate(t, del_t, grad_del_u, stress, history)
            return s, 0.4 * tg, h

    c = {"E": 100.0, "nu": 0.3}
    return JSoft(c, jm.Constraint.FULL), TSoft(c, tm.Constraint.FULL)


@pytest.mark.parametrize("engine", ["packed", "aos"])
def test_line_search_halves_an_overshooting_step(engine):
    jlaw, tlaw = soft_tangent_models()
    res = {}
    for key, law in (("jax", jlaw), ("torch", tlaw)):
        fem, _ = PKGS[key]
        V, bcs = bench_box(fem, "hex", 2)
        bcs[1].value = 0.01
        p = make_problem(key, law, V, bcs, 2, engine=engine)
        niter, conv = p.solve(rtol=1e-10)
        res[key] = (niter, conv, np_(p.u), p.last_stats)
    (nt, ct, ut, st), (nj, cj, uj, sj) = res["torch"], res["jax"]
    assert ct and cj and nt == nj
    # the residual falls by 4x per iteration (the 1/2 step), not 1.5x up
    assert st["r_norm"] <= st["r0_norm"] * 0.26 ** nt
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-10 * np.abs(uj).max())


# -- preconditioners --------------------------------------------------------------------


def shuffled_tets(n, seed=0):
    mesh = tfem.unit_cube_mesh(n, n, n, "tetra")
    pi = np.random.default_rng(seed).permutation(mesh.num_nodes)
    nodes = np.empty_like(mesh.nodes)
    nodes[pi] = mesh.nodes
    return tfem.Mesh(nodes, pi[mesh.cells].astype(np.int32), "tetra")


def solve_two_steps(p, bcs):
    out = []
    for k in (1, 2):
        bcs[1].value = 0.002 * k
        niter, conv = p.solve(rtol=1e-11, cg_rtol=1e-12)
        assert conv
        p.update()
        out.append((p.u.clone(), p.stress_0.clone()))
    return out


def assert_same_states(a, b, tol):
    for (ua, sa), (ub, sb) in zip(a, b):
        assert float((ua - ub).abs().max()) <= tol * float(ub.abs().max())
        assert float((sa - sb).abs().max()) <= tol * float(sb.abs().max())


@pytest.mark.parametrize("mesh", ["box", "tets"])
def test_amg_and_callable_preconditioners(mesh):
    """"amg" (ELL levels off the card; grid-major on a box, node-major on
    the gather engine) and the same hierarchy passed as a node-major
    callable converge to the Jacobi run's states, on both engines."""
    V = (tfem.FunctionSpace(tfem.unit_cube_mesh(4, 4, 4, "hex"), 1, 3) if mesh == "box"
         else tfem.FunctionSpace(shuffled_tets(5), 1, 3))

    def problem(engine, pc=None, **kw):
        bcs = bench_bcs(V)
        return make_problem("torch", tm.VonMises3D(MAT), V, bcs, 2, engine=engine,
                            preconditioner=pc, **kw), bcs

    ref = solve_two_steps(*problem("aos"))
    p_amg, bcs = problem("packed", "amg")
    assert p_amg._pk_geos[0].engine == ("structured" if mesh == "box" else "gather")
    assert_same_states(solve_two_steps(p_amg, bcs), ref, 1e-8)
    free = np.ones(V.ndofs, bool)
    free[combine_bcs(bench_bcs(V))[0]] = False
    amg = build_amg(V, MAT["p_mu"], MAT["p_ka"], free, q_degree=2, device="cpu", dtype=F64)
    p_call, bcs = problem("aos", amg)
    assert_same_states(solve_two_steps(p_call, bcs), ref, 1e-8)


def test_windowed_engine_routes():
    """A 9^3 shuffled tet mesh (4,374 cells) resolves to the windowed
    engine: Jacobi, the node-major AMG (ELL) and the AMG on the engine's
    internal layout (windowed levels, ``internal_layout``) all converge to
    the AoS engine's states."""
    V = tfem.FunctionSpace(shuffled_tets(9), 1, 3)

    def problem(engine, pc=None, **kw):
        bcs = bench_bcs(V)
        return make_problem("torch", tm.VonMises3D(MAT), V, bcs, 2, engine=engine,
                            preconditioner=pc, **kw), bcs

    ref = solve_two_steps(*problem("aos", "amg"))
    p, bcs = problem("packed")
    assert p._pk_geos[0].engine == "windowed"
    assert_same_states(solve_two_steps(p, bcs), ref, 1e-8)
    g = p._del_grad_u[0]
    assert g.shape == (V.mesh.num_cells, 4, 3, 3)
    p, bcs = problem("packed", "amg", pc_options={"spmv": "windowed"})
    assert getattr(p._pc, "internal_layout", False)
    assert_same_states(solve_two_steps(p, bcs), ref, 1e-8)


def test_unknown_options_raise():
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(1, 1, 1, "hex"), 1, 3)
    law = tm.VonMises3D(MAT)
    with pytest.raises(ValueError, match="engine"):
        IncrSmallStrainProblem(law, V, [], 2, engine="gather", device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="preconditioner"):
        IncrSmallStrainProblem(law, V, [], 2, preconditioner="vcycle", device="cpu", dtype=F64)
    with pytest.warns(UserWarning, match="hourglass"):
        IncrSmallStrainProblem(law, V, [], 1, device="cpu", dtype=F64)
