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
