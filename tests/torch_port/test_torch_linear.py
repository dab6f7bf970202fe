"""The port's cg_solve against the JAX package's on the same SPD system
(dense, 80 unknowns, condition number ~40, Jacobi or explicit
preconditioner). float64 runs agree to rtol 1e-10 (same iteration, other
summation order, amplified by the condition number) with equal iteration
counts; the float32 run with float64 reductions to rtol 1e-4 (float32
rounding of the matrix products, differently ordered)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.solver.linear import cg_solve as jax_cg
from fenics_constitutive_tpu_torch.solver.linear import cg_solve


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(3)
    n = 80
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = Q @ np.diag(np.logspace(0, 1.5, n)) @ Q.T
    A = 0.5 * (A + A.T) + np.diag(rng.uniform(1.0, 5.0, n))
    b = rng.normal(size=n)
    return A, b


CASES = {
    "adaptive": dict(rtol=1e-10),
    "fixed_iters": dict(fixed_iters=12),
    "flexible": dict(rtol=1e-10, flexible=True),
    "precond": dict(rtol=1e-10, precond=True),
    "maxiter": dict(rtol=1e-14, maxiter=7),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cg_matches_jax(system, case):
    A, b = system
    opts = dict(CASES[case])
    diag = np.diag(A).copy()
    use_pc = opts.pop("precond", False)
    Aj, At = jnp.asarray(A), torch.tensor(A)
    jax_kw, torch_kw = dict(opts), dict(opts)
    if use_pc:
        # a fixed SPD preconditioner: two damped Jacobi sweeps from zero
        def pc(r, mv, d):
            x = 0.5 * r / d
            return x + 0.5 * (r - mv(x)) / d

        dj, dt = jnp.asarray(diag), torch.tensor(diag)
        jax_kw["precond"] = lambda r: pc(r, lambda x: Aj @ x, dj)
        torch_kw["precond"] = lambda r: pc(r, lambda x: At @ x, dt)
        args_j, args_t = (), ()
    else:
        args_j, args_t = (jnp.asarray(diag),), (torch.tensor(diag),)
    xj, kj = jax_cg(lambda x: Aj @ x, jnp.asarray(b), *args_j, **jax_kw)
    xt, kt = cg_solve(lambda x: At @ x, torch.tensor(b), *args_t, **torch_kw)
    assert int(kt) == int(kj)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10, atol=1e-10 * np.abs(xj).max())


def test_cg_reduce_dtype_float32(system):
    A, b = system
    Aj, At = jnp.asarray(A, jnp.float32), torch.tensor(A, dtype=torch.float32)
    d = np.diag(A).astype(np.float32)
    xj, _ = jax_cg(lambda x: Aj @ x, jnp.asarray(b, jnp.float32), jnp.asarray(d),
                   fixed_iters=30, flexible=True, reduce_dtype=jnp.float64)
    xt, _ = cg_solve(lambda x: At @ x, torch.tensor(b, dtype=torch.float32),
                     torch.tensor(d), fixed_iters=30, flexible=True,
                     reduce_dtype=torch.float64)
    assert xt.dtype == torch.float32
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-4, atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("case", ["adaptive", "fixed_iters"])
def test_cg_custom_dot_matches_jax(system, case):
    """``dot=`` (JAX's argument, the hook of a sharded solve): every
    reduction through the caller's inner product, here the sum of two
    halves' dots as two ranks would add theirs."""
    A, b = system
    opts = dict(CASES[case])
    h = len(b) // 2
    Aj, At = jnp.asarray(A), torch.tensor(A)
    d = np.diag(A).copy()
    xj, kj = jax_cg(lambda x: Aj @ x, jnp.asarray(b), jnp.asarray(d),
                    dot=lambda a, c: jnp.vdot(a[:h], c[:h]) + jnp.vdot(a[h:], c[h:]), **opts)
    xt, kt = cg_solve(lambda x: At @ x, torch.tensor(b), torch.tensor(d),
                      dot=lambda a, c: torch.dot(a[:h], c[:h]) + torch.dot(a[h:], c[h:]),
                      **opts)
    assert int(kt) == int(kj)
    xj = np.asarray(xj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10, atol=1e-10 * np.abs(xj).max())
