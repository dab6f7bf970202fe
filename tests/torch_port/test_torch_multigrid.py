"""The port's geometric multigrid against the JAX package's on a 10^3 box,
whose node grids 11 -> 6 -> 3 include a non-nested level (6 <- 3, where
prolongation extrapolates one row), with nu=3, nu_coarse=2 and the direct
coarse solve. The transfers are computed as separable slices here and as
convolutions in JAX, so the sums differ in order: rtol 1e-12 of the largest
entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu.solver.multigrid import build_multigrid as jax_build_mg
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
from fenics_constitutive_tpu_torch.solver.multigrid import build_multigrid

RTOL = 1e-12
OPTS = dict(nu=3, nu_coarse=2, coarse_direct=True)


def close(got, ref, rtol=RTOL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def setup(box, mat):
    pair = box(10)
    (Vj, bcs_j), (Vt, _) = pair["jax"], pair["torch"]
    gj = jax_build_geometry(Vj, 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(Vt, 2, Constraint.FULL, device="cpu", dtype=torch.float64)
    bc_dofs, _ = jax_combine(bcs_j)
    free = np.ones(Vj.ndofs, bool)
    free[bc_dofs] = False
    mu, ka = mat["p_mu"], mat["p_ka"]
    mg_j = jax_build_mg(gj, mu, ka, jnp.asarray(free), **OPTS)
    mg_t = build_multigrid(gt, mu, ka, torch.tensor(free), device="cpu",
                           dtype=torch.float64, **OPTS)
    r = np.random.default_rng(1).normal(size=Vj.ndofs)
    return mg_j, mg_t, r


def test_hierarchy_shapes(setup):
    mg_j, mg_t, _ = setup
    assert mg_t.node_grids == mg_j.node_grids == ((11,) * 3, (6,) * 3, (3,) * 3)
    for lvl in range(mg_t.n_levels):
        np.testing.assert_array_equal(mg_t.free(lvl).numpy(), np.asarray(mg_j.frees[lvl]))
        close(mg_t._diag(lvl), mg_j._diag(lvl, jnp.float64))
    close(mg_t.coarse_inv, mg_j.coarse_inv, rtol=1e-10)


@pytest.mark.parametrize("lvl", [0, 1], ids=["nested", "non-nested"])
def test_transfers(setup, lvl):
    mg_j, mg_t, _ = setup
    rng = np.random.default_rng(lvl)
    xf = rng.normal(size=3 * int(np.prod(mg_t.node_grids[lvl])))
    xc = rng.normal(size=3 * int(np.prod(mg_t.node_grids[lvl + 1])))
    close(mg_t.restrict(torch.tensor(xf), lvl), mg_j.restrict(jnp.asarray(xf), lvl))
    close(mg_t.prolong(torch.tensor(xc), lvl), mg_j.prolong(jnp.asarray(xc), lvl))


def test_vcycle_apply(setup):
    mg_j, mg_t, r = setup
    close(mg_t(torch.tensor(r)), mg_j(jnp.asarray(r)))


def test_bpx_apply(setup):
    mg_j, mg_t, r = setup
    close(mg_t.bpx(torch.tensor(r)), mg_j.bpx(jnp.asarray(r)))


# -- with_moduli, prepared, Chebyshev and the build's guards ----------------------


@pytest.mark.parametrize("as_tensor", [False, True], ids=["floats", "tensors"])
def test_with_moduli_matches_jax(setup, mat, as_tensor):
    """A common rescale of the moduli: the V-cycle, whose direct coarse solve
    is rescaled by kappa0/kappa, equals JAX's; the fused chains are dropped."""
    mg_j, mg_t, r = setup
    s = 1.7
    mu, ka = s * mat["p_mu"], s * mat["p_ka"]
    if as_tensor:
        mu_t, ka_t = torch.tensor(mu, dtype=torch.float64), torch.tensor(ka, dtype=torch.float64)
    else:
        mu_t, ka_t = mu, ka
    mg2 = mg_t.with_moduli(mu_t, ka_t)
    assert mg2.fused is None and mg2.mu is mu_t and mg_t.mu == mat["p_mu"]
    z = mg2(torch.tensor(r))
    close(z, mg_j.with_moduli(mu, ka)(jnp.asarray(r)))
    # a common scale of A scales M^-1 by 1/s: the coarse solve follows
    close(z, mg_t(torch.tensor(r)).numpy() / s)


def test_with_moduli_drops_fused(box, mat):
    (V, bcs) = box(4)["torch"]
    geo = build_structured_geometry(V, 2, Constraint.FULL, device="cpu", dtype=torch.float64)
    mg = build_multigrid(geo, mat["p_mu"], mat["p_ka"], device="cpu", dtype=torch.float64,
                         fused_smoothing=True)
    assert mg.fused is not None
    assert mg.with_moduli(mat["p_mu"], mat["p_ka"]).fused is None


@pytest.fixture(scope="module")
def chebyshev(box, mat):
    pair = box(10)
    (Vj, bcs_j), (Vt, _) = pair["jax"], pair["torch"]
    gj = jax_build_geometry(Vj, 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(Vt, 2, Constraint.FULL, device="cpu", dtype=torch.float64)
    bc_dofs, _ = jax_combine(bcs_j)
    free = np.ones(Vj.ndofs, bool)
    free[bc_dofs] = False
    mu, ka = mat["p_mu"], mat["p_ka"]
    opts = dict(OPTS, smoother="chebyshev")
    mg_j = jax_build_mg(gj, mu, ka, jnp.asarray(free), **opts)
    mg_t = build_multigrid(gt, mu, ka, torch.tensor(free), device="cpu", dtype=torch.float64,
                           **opts)
    return mg_j, mg_t


def test_chebyshev_lmax_matches_jax(chebyshev):
    mg_j, mg_t = chebyshev
    assert len(mg_t.lmax) == mg_t.n_levels == len(mg_j.lmax)
    np.testing.assert_allclose(mg_t.lmax, mg_j.lmax, rtol=1e-10)


def test_chebyshev_vcycle_matches_jax(chebyshev):
    mg_j, mg_t = chebyshev
    r = np.random.default_rng(4).normal(size=3 * 11**3)
    close(mg_t(torch.tensor(r)), mg_j(jnp.asarray(r)))


def test_prepared_with_plastic_tangent_matches_jax(box, mat):
    """Level 0 smoothed with a plastic consistent tangent and its diagonal."""
    from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
    from fenics_constitutive_tpu_torch.models import VonMises3D

    pair = box(6)
    (Vj, bcs_j), (Vt, _) = pair["jax"], pair["torch"]
    gj = jax_build_geometry(Vj, 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(Vt, 2, Constraint.FULL, device="cpu", dtype=torch.float64)
    bc_dofs, _ = jax_combine(bcs_j)
    free = np.ones(Vj.ndofs, bool)
    free[bc_dofs] = False
    rng = np.random.default_rng(9)
    u = rng.normal(size=Vj.ndofs) * 2e-3  # strains of a few percent: plastic
    r = rng.normal(size=Vj.ndofs)

    def jax_side():
        eps = gj.strain_gm(gj.to_grid_major(jnp.asarray(u)))
        z = jnp.zeros(gj.qp_shape(6))
        hist = {"eps_n": z, "alpha": jnp.zeros(gj.qp_shape(1))}
        _, tg, _ = JVonMises3D(mat).evaluate_packed(0.0, 1.0, eps, z, hist)
        mg = jax_build_mg(gj, mat["p_mu"], mat["p_ka"], jnp.asarray(free), **OPTS)
        return mg.prepared(tg, gj.jacobi_diag_gm(tg))(gj.to_grid_major(jnp.asarray(r))), tg

    def port_side():
        eps = gt.strain_gm(gt.to_grid_major(torch.tensor(u)))
        z = torch.zeros(gt.qp_shape(6), dtype=torch.float64)
        hist = {"eps_n": z, "alpha": torch.zeros(gt.qp_shape(1), dtype=torch.float64)}
        _, tg, _ = VonMises3D(mat).evaluate_packed(0.0, 1.0, eps, z, hist)
        mg = build_multigrid(gt, mat["p_mu"], mat["p_ka"], torch.tensor(free), device="cpu",
                             dtype=torch.float64, **OPTS)
        return mg.prepared(tg, gt.jacobi_diag_gm(tg))(gt.to_grid_major(torch.tensor(r))), tg

    (z_j, tg_j), (z_t, tg_t) = jax_side(), port_side()
    assert float(tg_t.gamma.abs().max()) > 0  # plastic points
    # the local Newton's stopping rule leaves the tangents a few ulps apart
    close(z_t, z_j, rtol=1e-10)


@pytest.mark.parametrize("bad", ["chebyshev", "fine_matvec"])
def test_fused_smoothing_guards(box, mat, bad):
    (V, _) = box(4)["torch"]
    geo = build_structured_geometry(V, 2, Constraint.FULL, device="cpu", dtype=torch.float64)
    kw = {"smoother": "chebyshev"} if bad == "chebyshev" else {"fine_matvec": lambda v, t: v}
    with pytest.raises(ValueError, match="fused smoothing"):
        build_multigrid(geo, mat["p_mu"], mat["p_ka"], device="cpu", dtype=torch.float64,
                        fused_smoothing=True, **kw)


SPACES = {"1d": ("unit_interval_mesh", (4,), 1), "2d": ("unit_square_mesh", (3, 3, "quad"), 2),
          "3d": ("unit_cube_mesh", (2, 2, 2, "hex"), 3)}


@pytest.mark.parametrize("dim", SPACES)
def test_space_constraint_matches_jax(dim):
    """The port's multigrid.space_constraint (JAX solver/multigrid.py) and
    amg.space_constraint (JAX solver/amg.py) give JAX's constraint on a 1D,
    a 2D and a 3D space (the two functions differ in 1D, in both packages)."""
    from fenics_constitutive_tpu import fem as jfem
    from fenics_constitutive_tpu.solver import amg as jamg
    from fenics_constitutive_tpu.solver import multigrid as jmg
    from fenics_constitutive_tpu_torch import fem as tfem
    from fenics_constitutive_tpu_torch.solver import amg as tamg
    from fenics_constitutive_tpu_torch.solver import multigrid as tmg

    maker, args, vs = SPACES[dim]
    Vj = jfem.FunctionSpace(getattr(jfem, maker)(*args), 1, vs)
    Vt = tfem.FunctionSpace(getattr(tfem, maker)(*args), 1, vs)
    assert tmg.space_constraint(Vt).name == jmg.space_constraint(Vj).name
    assert tamg.space_constraint(Vt).name == jamg.space_constraint(Vj).name


def test_sqrt2_matches_jax():
    from fenics_constitutive_tpu.ops import mandel as jmandel
    from fenics_constitutive_tpu_torch.ops import mandel

    assert mandel.SQRT2 == jmandel.SQRT2 and "SQRT2" in mandel.__all__
