"""Structured-engine operators of the port against the JAX package (6^3 box,
float64, a genuinely plastic tangent). Both sides compute the same sums in
a different order, so they agree to a few ulps: rtol 1e-12 of the largest
entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.models import packed_models  # noqa: F401
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.packed import IsotropicTangent as JTangent
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu_torch.ops import IsotropicTangent
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry

RTOL = 1e-12


def close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def setup(box, mat):
    pair = box(6)
    gj = jax_build_geometry(pair["jax"][0], 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(
        pair["torch"][0], 2, Constraint.FULL, device="cpu", dtype=torch.float64
    )
    rng = np.random.default_rng(0)
    u = rng.normal(size=gt.ndofs) * 5e-3
    v = rng.normal(size=gt.ndofs)
    u_j, u_t = gj.to_grid_major(jnp.asarray(u)), gt.to_grid_major(torch.tensor(u))
    v_j, v_t = gj.to_grid_major(jnp.asarray(v)), gt.to_grid_major(torch.tensor(v))
    # plastic tangent: JAX's own radial return, carried into the port's layout
    eps = gj.strain_gm(u_j)
    hist = {"eps_n": jnp.zeros(gj.qp_shape(6)), "alpha": jnp.zeros(gj.qp_shape(1))}
    sig, tg_j, _ = JVonMises3D(mat).evaluate_packed(
        0.0, 1.0, eps, jnp.zeros(gj.qp_shape(6)), hist
    )
    assert float(jnp.abs(tg_j.gamma).max()) > 0
    tg_t = IsotropicTangent(
        kappa=mat["p_ka"], beta=torch.tensor(np.asarray(tg_j.beta)),
        gamma=torch.tensor(np.asarray(tg_j.gamma)), n=torch.tensor(np.asarray(tg_j.n)),
    )
    return dict(gj=gj, gt=gt, u=(u_j, u_t), v=(v_j, v_t), sig=sig, tg=(tg_j, tg_t))


def test_grid_major_roundtrip(setup):
    gj, gt = setup["gj"], setup["gt"]
    x = np.arange(gt.ndofs, dtype=np.float64)
    np.testing.assert_array_equal(gt.to_grid_major(torch.tensor(x)).numpy(),
                                  np.asarray(gj.to_grid_major(jnp.asarray(x))))
    np.testing.assert_array_equal(
        gt.to_node_major(gt.to_grid_major(torch.tensor(x))).numpy(), x
    )


def test_strain_gm(setup):
    close(setup["gt"].strain_gm(setup["u"][1]), setup["gj"].strain_gm(setup["u"][0]))


def test_residual_gm(setup):
    sig = setup["sig"]
    close(setup["gt"].residual_gm(torch.tensor(np.asarray(sig))),
          setup["gj"].residual_gm(sig))


def test_matvec_gm_plastic_tangent(setup):
    (vj, vt), (tj, tt) = setup["v"], setup["tg"]
    close(setup["gt"].matvec_gm(vt, tt), setup["gj"].matvec_gm(vj, tj))


def test_elastic_matvec_gm(setup, mat):
    vj, vt = setup["v"]
    ka, beta = mat["p_ka"], 2.0 * mat["p_mu"]
    close(setup["gt"].elastic_matvec_gm(vt, ka, beta),
          setup["gj"].elastic_matvec_gm(vj, ka, beta))


@pytest.mark.parametrize("uniform", [False, True], ids=["plastic", "uniform"])
def test_jacobi_diag_gm(setup, mat, uniform):
    tj, tt = setup["tg"]
    if uniform:
        ka, beta = mat["p_ka"], 2.0 * mat["p_mu"]
        tj = JTangent(kappa=jnp.asarray(ka), beta=jnp.asarray(beta),
                      gamma=jnp.asarray(0.0), n=jnp.zeros((6, 1, 1)))
        tt = IsotropicTangent(kappa=ka, beta=beta, gamma=0.0,
                              n=torch.zeros((6, 1, 1), dtype=torch.float64))
    close(setup["gt"].jacobi_diag_gm(tt), setup["gj"].jacobi_diag_gm(tj))


def test_extract_cells(setup):
    sig = setup["sig"]
    close(setup["gt"].extract_cells(torch.tensor(np.asarray(sig))),
          setup["gj"].extract_cells(sig), rtol=0)
