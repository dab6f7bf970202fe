"""The port's IncrSmallStrainProblem against the JAX package's on the
path-dependent BVPs, float64 on the CPU: Mises plasticity (monotonic and
cyclic, tests/solver/test_plasticity_bvp.py), the viscoelastic BVPs
(tests/solver/test_viscoelasticity_bvp.py: relaxation, creep, Kelvin
against Maxwell, plane strain against 3D with u_z = 0) and a Drucker-Prager bar in
tension (tests/solver/test_drucker_prager_bvp.py).

Each load path runs once in JAX (cached) and on both of the port's engines.
Plastic paths are compared as converged states (from a plastic pre-state
round-off decides the first tangent, so Newton counts may differ by one:
ROADMAP.md, Queue 3): u and stress within 1e-8 of their largest entry. The
viscoelastic paths stay smooth and keep equal Newton counts. The JAX tests'
own analytic checks (1e-8 on stress and strain, 1e-7 on the elastic slope)
hold on the port's runs. Load paths of more than 40 steps are cut to fewer,
larger steps (the same for both packages); the checks that need the full
relaxation are then made where they still hold.
"""

from functools import cache

import numpy as np
import pytest

from fenics_constitutive_tpu.fem import facets as jfacets
from fenics_constitutive_tpu_torch.fem import facets as tfacets
from test_torch_problem import PKGS, compare, noop, run_case, set_bc

MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}
E0, E1, TAU, NU = 42.0, 10.0, 10.0, 0.2
N_MONO, N_CYCLIC = 25, 40  # load steps (the JAX tests take 100 each)


def close(axis, v):
    return lambda x: np.isclose(x[:, axis], v)


def one_tet_cube(law_fn):
    def setup(fem, m):
        V = fem.FunctionSpace(fem.unit_cube_mesh(1, 1, 1, "tetra"), 1, 3)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0)]
        return law_fn(m), V, bcs, 1, {}
    return setup


def mises(m):
    return m.VonMises3D(MAT)


def mises_linear(m):
    return m.MisesPlasticityLinearHardening3D(
        {"mu": MAT["p_mu"], "kappa": MAT["p_ka"], "y_0": MAT["p_y0"], "h": MAT["p_w"]})


def visco_bar(mat, constraint="UNIAXIAL_STRESS", disp=0.01, q=1, nu=False):
    def setup(fem, m):
        V = fem.FunctionSpace(fem.unit_interval_mesh(2), 1, 1)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(close(0, 0.0)), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(close(0, 1.0)), disp)]
        p = {"E0": E0, "E1": E1, "tau": TAU, **({"nu": NU} if nu else {})}
        return getattr(m, mat)(p, m.Constraint[constraint]), V, bcs, q, {"del_t": 2.0}
    return setup


def visco_box(mat, dim, creep):
    """Symmetry planes, then a pulled x = 1 face (relaxation) or a traction
    on it (creep)."""
    def setup(fem, m):
        mesh = fem.unit_square_mesh(2, 2, "triangle") if dim == 2 else \
            fem.unit_cube_mesh(2, 2, 2, "tetra")
        V = fem.FunctionSpace(mesh, 1, dim)
        c = m.Constraint.PLANE_STRESS if dim == 2 else m.Constraint.FULL
        law = getattr(m, mat)({"E0": E0, "E1": E1, "tau": TAU, "nu": NU}, c)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(close(a, 0.0), component=a), 0.0)
               for a in range(dim)]
        if not creep:
            bcs.append(fem.DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0),
                                       0.01))
        return law, V, bcs, 1, {"del_t": 2.0}
    return setup


def creep_load(dim):
    def step(p, bcs):
        torch_side = type(p).__module__.startswith("fenics_constitutive_tpu_torch.")
        fac = tfacets if torch_side else jfacets
        load = np.zeros(dim)
        load[0] = 0.1
        facets = fac.locate_boundary_facets(p.space.mesh, close(0, 1.0))
        p.f_ext = fac.assemble_facet_traction(p.space, facets, load)
        p._del_t = 1e-8
    return step


def set_dt(dt):
    def step(p, bcs):
        p._del_t = dt
    return step


def plane_vs_fixed_z(mat, dim):
    """Plane strain in 2D, or 3D with u_z = 0 at every node, pulled on x = 1."""
    def setup(fem, m):
        mesh = fem.unit_square_mesh(2, 2, "triangle") if dim == 2 else \
            fem.unit_cube_mesh(2, 2, 2, "tetra")
        V = fem.FunctionSpace(mesh, 1, dim)
        c = m.Constraint.PLANE_STRAIN if dim == 2 else m.Constraint.FULL
        law = getattr(m, mat)({"E0": E0, "E1": E1, "tau": TAU, "nu": NU}, c)
        bcs = [fem.DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
               fem.DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.01),
               fem.DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0)]
        if dim == 3:
            bcs.append(fem.DirichletBC(V.locate_dofs_geometrical(
                lambda x: np.ones(len(x), bool), component=2), 0.0))
        return law, V, bcs, 1, {"del_t": 1e-8}
    return setup


def dp_bar(fem, m):
    V = fem.FunctionSpace(fem.unit_cube_mesh(2, 2, 2, "hex"), 1, 3)
    bcs = [fem.DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
           fem.DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), 0.0),
           fem.DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
           fem.DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0)]
    law = m.DruckerPrager3D({"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15,
                             "b_flow": 0.15})
    return law, V, bcs, 2, {}


MONO = [set_bc(1, t * 0.05) for t in np.linspace(0, 1, N_MONO + 1)[1:]]
CYCLIC = [set_bc(1, float(np.sin(t) * 0.05))
          for t in np.linspace(np.pi, -np.pi, N_CYCLIC + 1)]
RELAX = [set_dt(1e-8)] + [set_dt(10.0)] * 20  # t = 200 = 20 tau (JAX: dt 2)

CASES = {
    # name: (setup, steps, tolerance, same Newton counts)
    "mises_uniaxial": (one_tet_cube(mises), MONO, 1e-8, False),
    "mises_linear_uniaxial": (one_tet_cube(mises_linear), MONO, 1e-8, False),
    "mises_cyclic": (one_tet_cube(mises), CYCLIC, 1e-8, False),
    **{f"relaxation_bar_{mat}": (visco_bar(mat), [set_dt(1e-8)] + [set_dt(2.0)] * 100,
                                 1e-10, True)
       for mat in ("SpringKelvinModel", "SpringMaxwellModel")},
    **{f"relaxation_{dim}d_{mat}": (visco_box(mat, dim, False), RELAX, 1e-10, True)
       for dim in (2, 3) for mat in ("SpringKelvinModel", "SpringMaxwellModel")},
    **{f"creep_{dim}d_{mat}": (visco_box(mat, dim, True), [creep_load(dim)] + RELAX[1:], 1e-10,
                               True)
       for dim in (2, 3) for mat in ("SpringKelvinModel", "SpringMaxwellModel")},
    **{f"plane_{dim}d_{mat}": (plane_vs_fixed_z(mat, dim), [set_dt(1e-8)] + [set_dt(2.0)] * 10,
                               1e-10, True)
       for dim in (2, 3) for mat in ("SpringKelvinModel", "SpringMaxwellModel")},
    "drucker_prager_tension": (dp_bar, [set_bc(1, 0.008 * k / 4) for k in (1, 2, 3, 4)],
                               1e-8, False),
}


@cache
def jax_run(name):
    setup, steps, _, _ = CASES[name]
    return run_case("jax", setup, steps)


@cache
def port_run(name, engine):
    setup, steps, _, _ = CASES[name]
    return run_case("torch", setup, steps, engine)


@pytest.mark.parametrize("engine", ["packed", "aos"])
@pytest.mark.parametrize("name", list(CASES))
def test_inelastic_bvp_matches_jax(name, engine):
    _, _, tol, same_iters = CASES[name]
    got, ref = port_run(name, engine), jax_run(name)
    assert all(o["converged"] for o in got)
    if not same_iters:  # converged plastic states; counts may differ by one
        for a, b in zip(got, ref):
            assert abs(a["niter"] - b["niter"]) <= 1
            a["niter"] = b["niter"]
    compare(got, ref, tol)


def elastic_slope():
    ka, mu = MAT["p_ka"], MAT["p_mu"]
    v = (3 * ka - 2 * mu) / (2 * (3 * ka + mu))
    trace = 1.0 - 2 * v
    return ka * trace + 2 * mu * (1.0 - trace / 3)


def load_curve(name, engine):
    runs = port_run(name, engine)
    return np.array([0.0] + [o["stress_0"].reshape(-1, 6)[0, 0] for o in runs])


@pytest.mark.parametrize("name", ["mises_uniaxial", "mises_linear_uniaxial"])
def test_mises_uniaxial_analytic(name):
    load = load_curve(name, "packed")
    disp = np.concatenate([[0.0], np.linspace(0, 1, N_MONO + 1)[1:] * 0.05])
    tol = 1e-8
    if name == "mises_uniaxial":
        assert load.max() - MAT["p_y00"] <= tol
    idx = load + tol < MAT["p_y0"]
    assert idx.sum() >= 3
    assert np.all(np.abs(np.ediff1d(load[idx]) / np.ediff1d(disp[idx]) - elastic_slope()) < 1e-7)


def test_mises_cyclic_analytic():
    """The elastic range stretches with isotropic hardening; the slope in it
    stays elastic."""
    load = load_curve("mises_cyclic", "aos")
    disp = np.concatenate([[0.0], np.sin(np.linspace(np.pi, -np.pi, N_CYCLIC + 1)) * 0.05])
    tol, slope, n = 1e-8, elastic_slope(), N_CYCLIC
    assert load.max() - MAT["p_y00"] <= tol and abs(load.min()) - MAT["p_y00"] <= tol
    a, b = int(n / 4 + 2), int(3 * n / 4 + 1)
    parts = [(load[:a], disp[:a], MAT["p_y0"], 1)]
    parts.append((load[a:b], disp[a:b], max(load[:a].max(), MAT["p_y0"]), 0))
    parts.append((load[b:], disp[b:], max(load[:a].max(), abs(load[a:b].min()), MAT["p_y0"]), 0))
    for ld, dp, bound, skip in parts:
        idx = np.abs(ld) + tol < bound
        assert idx.sum() >= 2
        s = np.ediff1d(ld[idx][skip:]) / np.ediff1d(dp[idx][skip:])
        assert np.all(np.abs(s - slope) < 1e-7)


@pytest.mark.parametrize("mat", ["SpringKelvinModel", "SpringMaxwellModel"])
def test_relaxation_bar_analytic(mat):
    runs = port_run(f"relaxation_bar_{mat}", "packed")
    stress = [o["stress_1"].ravel()[-1] for o in runs]
    strain = [o["hist_1"][0]["strain"].ravel()[-1] for o in runs]
    visco = [o["hist_1"][0]["strain_visco"].ravel()[-1] for o in runs]
    s0, s_end = ((E0, E0 * E1 / (E0 + E1)) if mat == "SpringKelvinModel" else (E0 + E1, E0))
    assert abs(stress[0] - s0 * 0.01) < 1e-8 and abs(stress[-1] - s_end * 0.01) < 1e-8
    assert abs(strain[0] - 0.01) < 1e-8 and np.sum(np.diff(strain)) < 1e-8
    assert abs(visco[0]) < 1e-8 and visco[-1] > 0


@pytest.mark.parametrize("kind", ["relaxation", "creep"])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mat", ["SpringKelvinModel", "SpringMaxwellModel"])
def test_relaxation_and_creep_instant_response(kind, dim, mat):
    """The instant (dt = 1e-8) response, then a monotone approach; the
    final values are JAX's (the larger steps leave them short of the
    analytic limit)."""
    runs = port_run(f"{kind}_{dim}d_{mat}", "packed")
    stress = [o["stress_1"].max() for o in runs]
    strain = [o["hist_1"][0]["strain"].max() for o in runs]
    visco = [o["hist_1"][0]["strain_visco"].max() for o in runs]
    kelvin = mat == "SpringKelvinModel"
    if kind == "relaxation":
        assert abs(stress[0] - (E0 if kelvin else E0 + E1) * 0.01) < 1e-8
        assert abs(strain[0] - 0.01) < 1e-8 and np.sum(np.diff(strain)) < 1e-8
        assert np.all(np.diff(stress) < 1e-12)
    else:
        assert abs(strain[0] - 0.1 / (E0 if kelvin else E0 + E1)) < 1e-8
        assert abs(stress[0] - 0.1) < 1e-8 and np.sum(np.diff(stress)) < 1e-8
        assert np.all(np.diff(strain) > -1e-12)
    assert abs(visco[0]) < 1e-8 and visco[-1] > 0


def run_kelvin_vs_maxwell(key):
    """Parameter-equivalent Kelvin and Maxwell bars (q 4, dt 0.1, 10 steps):
    the stress histories of both laws."""
    fem, m = PKGS[key]
    E0_M, E1_M, tau_M = E0 * E1 / (E0 + E1), E0**2 / (E0 + E1), E1 / (E0 + E1) * TAU
    laws = [m.SpringKelvinModel({"E0": E0, "E1": E1, "tau": TAU, "nu": NU},
                                m.Constraint.UNIAXIAL_STRESS),
            m.SpringMaxwellModel({"E0": E0_M, "E1": E1_M, "tau": tau_M, "nu": NU},
                                 m.Constraint.UNIAXIAL_STRESS)]
    out = []
    for law in laws:
        setup = visco_bar("SpringKelvinModel", disp=0.001, q=4)

        def with_law(fem_, m_, law=law):
            _, V, bcs, q, _ = setup(fem_, m_)
            return law, V, bcs, q, {"del_t": 0.1}

        runs = run_case(key, with_law, [noop] * 10)
        out.append(np.array([o["stress_1"].ravel()[-1] for o in runs]))
    return out


def test_kelvin_vs_maxwell():
    tk, tmx = run_kelvin_vs_maxwell("torch")
    jk, jmx = run_kelvin_vs_maxwell("jax")
    assert np.linalg.norm(tk - tmx) < 1e-8
    np.testing.assert_allclose(tk, jk, rtol=0, atol=1e-10 * np.abs(jk).max())
    np.testing.assert_allclose(tmx, jmx, rtol=0, atol=1e-10 * np.abs(jmx).max())


@pytest.mark.parametrize("mat", ["SpringKelvinModel", "SpringMaxwellModel"])
def test_plane_strain_matches_3d_fixed_z(mat):
    """2D plane strain equals 3D with u_z = 0 everywhere at every step: the
    same homogeneous xx, yy and zz stresses, sigma_zz nonzero."""
    for o2, o3 in zip(port_run(f"plane_2d_{mat}", "packed"), port_run(f"plane_3d_{mat}", "aos")):
        s2, s3 = o2["stress_0"].reshape(-1, 4), o3["stress_0"].reshape(-1, 6)
        for i in range(3):
            np.testing.assert_allclose(s2[:, i], s2[0, i], rtol=0, atol=1e-8)
            np.testing.assert_allclose(s3[:, i], s3[0, i], rtol=0, atol=1e-8)
            assert abs(s2[0, i] - s3[0, i]) < 1e-8
    assert abs(s2[0, 2]) > 1e-3


def test_drucker_prager_yields_in_tension():
    runs = port_run("drucker_prager_tension", "packed")
    assert runs[-1]["hist_1"][0]["alpha"].max() > 0
