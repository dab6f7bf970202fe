"""K3, the fused multigrid smoothing chain, against the JAX package on a 6^3
box (float64). The port's chains run their plain PyTorch version here (CPU
tensors); the JAX chains run the Pallas kernel in interpret mode, as the JAX
package's own tests do.

* One level, each kind of chain (pre: zero start and residual; post; coarse:
  zero start, sweeps only), on the same b, x, inv_d and mask: normwise rtol
  1e-12 (the element product sums in another order).
* The fused V-cycle (nu=3, nu_coarse=1, direct or iterative coarse solve)
  against JAX's fused V-cycle and against the port's unfused one: rtol
  1e-10, the bar of the JAX package's test.
* The host rule that puts a level's stencil phases on bricks on the card
  (``brick_plan``), and the shared memory each chain asks for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.fem.bcs import combine_bcs as jax_combine
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.pallas_smoother import (
    build_fused_smoother as jax_build_fused_smoother,
)
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu.solver.multigrid import build_multigrid as jax_build_mg
from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_square_mesh
from fenics_constitutive_tpu_torch.ops import cuda_smoother
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
from fenics_constitutive_tpu_torch.solver.multigrid import build_multigrid

F64 = torch.float64


def close(got, ref, rtol):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def level(box, mat):
    pair = box(6)
    (Vj, bcs_j), (Vt, _) = pair["jax"], pair["torch"]
    gj = jax_build_geometry(Vj, 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(Vt, 2, Constraint.FULL, device="cpu", dtype=F64)
    bc_dofs, _ = jax_combine(bcs_j)
    free = np.ones(Vj.ndofs, bool)
    free[bc_dofs] = False
    beta0, ka = 2.0 * mat["p_mu"], mat["p_ka"]
    ke = beta0 * np.asarray(gj.KE_I) + (ka - beta0 / 3.0) * np.asarray(gj.KE_V)
    rng = np.random.default_rng(5)
    free_gm = free.reshape(-1, 3).T.reshape(-1)
    inv_d = np.where(free_gm, 0.6 / (1e5 * (1.0 + rng.random(Vj.ndofs))), 0.0)
    b = np.where(free_gm, rng.normal(size=Vj.ndofs), 0.0)
    x = np.where(free_gm, rng.normal(size=Vj.ndofs) * 1e-5, 0.0)
    return gj, gt, ke, inv_d, b, x, free


CHAINS = {
    "pre": dict(nu=3, zero_start=True, emit_residual=True),
    "pre_nu1": dict(nu=1, zero_start=True, emit_residual=True),
    "post": dict(nu=3, zero_start=False, emit_residual=False),
    "coarse": dict(nu=5, zero_start=True, emit_residual=False),
}


@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_matches_jax(level, chain):
    gj, gt, ke, inv_d, b, x, _ = level
    opts = CHAINS[chain]
    fn_j = jax_build_fused_smoother(gj, ke, jnp.asarray(inv_d), np.asarray(gj.mask), **opts)
    fn_t = cuda_smoother.build_fused_smoother(gt, ke, torch.tensor(inv_d), gt.mask, **opts)
    before = cuda_smoother.launches
    if opts["zero_start"]:
        out_j, out_t = fn_j(jnp.asarray(b)), fn_t(torch.tensor(b))
    else:
        out_j, out_t = fn_j(jnp.asarray(x), jnp.asarray(b)), fn_t(torch.tensor(x), torch.tensor(b))
    assert cuda_smoother.launches == before  # CPU tensors: the plain version
    if not opts["emit_residual"]:
        out_j, out_t = (out_j,), (out_t,)
    assert len(out_t) == len(out_j)
    for got, ref in zip(out_t, out_j):
        close(got, ref, 1e-12)
    # x stays zero where inv_d is zero
    assert not out_t[0][torch.tensor(inv_d) == 0].any()


def test_plain_is_the_unfused_jacobi_chain(level):
    """smoother_plain's pre chain equals nu damped-Jacobi sweeps written out
    with the geometry's own elastic operator."""
    _, gt, ke, inv_d, b, _, _ = level
    inv_d, b = torch.tensor(inv_d), torch.tensor(b)
    ke_t = torch.tensor(ke)
    x, r = cuda_smoother.smoother_plain(gt, ke_t, inv_d, gt.mask, None, b, nu=2,
                                        zero_start=True, emit_residual=True)

    def A(v):
        U = gt._corner_dofs(v.reshape(3, gt.M)) * gt.mask
        return gt._scatter_corners(ke_t @ U).reshape(-1)

    x_ref = inv_d * b
    x_ref = x_ref + inv_d * (b - A(x_ref))
    torch.testing.assert_close(x, x_ref, rtol=0, atol=0)
    torch.testing.assert_close(r, torch.where(inv_d != 0, b - A(x_ref), 0.0), rtol=0, atol=0)


@pytest.fixture(scope="module")
def hierarchies(box, mat):
    pair = box(6)
    (Vj, bcs_j), (Vt, _) = pair["jax"], pair["torch"]
    gj = jax_build_geometry(Vj, 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(Vt, 2, Constraint.FULL, device="cpu", dtype=F64)
    bc_dofs, _ = jax_combine(bcs_j)
    free = np.ones(Vj.ndofs, bool)
    free[bc_dofs] = False
    mu, ka = mat["p_mu"], mat["p_ka"]
    r = np.random.default_rng(7).normal(size=Vj.ndofs)
    out = {}
    for direct in (True, False):
        kw = dict(nu=3, nu_coarse=1, coarse_direct=direct)
        mg_j = jax_build_mg(gj, mu, ka, jnp.asarray(free), fused_smoothing=True, **kw)
        mg_t = build_multigrid(gt, mu, ka, torch.tensor(free), device="cpu", dtype=F64,
                               fused_smoothing=True, **kw)
        mg_u = build_multigrid(gt, mu, ka, torch.tensor(free), device="cpu", dtype=F64, **kw)
        r_gm = gt.to_grid_major(torch.tensor(r))
        out[direct] = (mg_t, mg_t(r_gm), mg_u(r_gm), mg_j(gj.to_grid_major(jnp.asarray(r))))
    return out


@pytest.mark.parametrize("direct", [True, False], ids=["coarse_direct", "coarse_chain"])
def test_fused_vcycle_matches_jax_and_unfused(hierarchies, direct):
    mg_t, z_fused, z_unfused, z_jax = hierarchies[direct]
    assert mg_t.fused is not None and mg_t.n_levels == 2
    assert set(mg_t.fused[-1]) == {"coarse"} and set(mg_t.fused[0]) == {"pre", "post"}
    close(z_fused, z_jax, 1e-10)
    close(z_fused, z_unfused.numpy(), 1e-10)


def test_quad_level_on_the_card_is_not_ported():
    """A 2D quad level is a level of the K3 kernels (its 9-point stencils are
    built on the host); a level of neither the hex nor the quad corner
    layout is refused with ValueError before touching the card."""
    import copy

    V = FunctionSpace(unit_square_mesh(4, 4, "quad"), 1, 2)
    g = build_structured_geometry(V, 2, Constraint.PLANE_STRAIN, device="cpu", dtype=F64)
    ke = np.eye(8)
    z = torch.zeros(V.ndofs, dtype=F64)
    chain = cuda_smoother.build_fused_smoother(g, ke, z, g.mask, nu=2, zero_start=True,
                                               emit_residual=False)
    assert cuda_smoother.smoother_geometry_ok(g)
    assert cuda_smoother.quad_corner_layout(g)
    cuda_smoother._check_card_level(chain)
    assert chain.n_patterns == 9 and chain.pid.numel() == g.M
    odd = copy.copy(g)
    odd.offsets = tuple(reversed(g.offsets))
    assert not cuda_smoother.smoother_geometry_ok(odd)
    chain.geo = odd
    with pytest.raises(ValueError, match="corner layouts"):
        chain._kernel(None, z)


#: the H100's SMs and the shared memory one block may hold there
H100_SMS, H100_SMEM = 132, 232_448
#: node grids of the 50^3 box's hierarchy, the 65^3 P2 lattice's refined-P1
#: hierarchy and a 512^2 quad hierarchy, with their levels' pattern counts
HIERARCHIES = {
    "box50": (((51,) * 3, (26,) * 3, (13,) * 3, (7,) * 3, (4,) * 3), 27),
    "p2_lattice65": (((65,) * 3, (33,) * 3, (17,) * 3, (9,) * 3, (5,) * 3), 27),
    "quad512": (((513, 513), (257, 257), (129, 129), (65, 65), (33, 33)), 9),
}


@pytest.mark.parametrize(("hierarchy", "itemsize", "smem", "bricks"), [
    ("box50", 8, H100_SMEM, (True, False, False, False, False)),
    ("box50", 4, H100_SMEM, (True, False, False, False, False)),
    ("p2_lattice65", 8, H100_SMEM, (True, False, False, False, False)),
    ("p2_lattice65", 4, H100_SMEM, (True, False, False, False, False)),
    ("quad512", 8, H100_SMEM, (False,) * 5),
    ("quad512", 4, H100_SMEM, (False,) * 5),
    # a card with less shared memory a block takes smaller bricks
    ("box50", 8, 64 * 1024, (True, False, False, False, False)),
    ("p2_lattice65", 8, 64 * 1024, (True, False, False, False, False)),
])
def test_brick_plan(hierarchy, itemsize, smem, bricks):
    """Which levels run their chains' stencil phases on bricks on the H100:
    those whose runs give every SM at least BRICK_MIN_WARPS warps (the fine
    level of both 3D hierarchies, no 2D level); the shared memory each
    level's chain asks for, on bricks or with its stencils, fits in a block;
    a brick's tile holds more than a warp and at most BRICK_TILE columns."""
    grids, n_patterns = HIERARCHIES[hierarchy]
    for grid, want in zip(grids, bricks):
        plan = cuda_smoother.brick_plan(grid, itemsize, H100_SMS, smem)
        assert (plan is not None) == want, grid
        assert cuda_smoother.chain_bytes(grid, None, n_patterns, itemsize) <= H100_SMEM
        if plan is None:
            continue
        run, p1, p2 = plan
        assert run == cuda_smoother.BRICK_RUN
        tile = -(-grid[1] // p1) * -(-grid[2] // p2)
        assert 33 <= tile <= cuda_smoother.BRICK_TILE
        runs = (2 + -(-(grid[0] - 2) // run)) * grid[1] * grid[2]
        assert runs >= cuda_smoother.BRICK_MIN_WARPS * 32 * H100_SMS
        assert cuda_smoother.chain_bytes(grid, plan, n_patterns, itemsize) <= smem
