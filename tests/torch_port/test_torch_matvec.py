"""The port's fused-operator entry point (ops/cuda_matvec.py) on CPU tensors.

On the CPU the entry point runs its plain PyTorch version; the CUDA kernel
itself is held to that version on the card by chip_smoke.py. Here the entry
point is compared with

  * the JAX package's Pallas kernel in interpret mode (patched exactly as
    tests/solver/test_pallas_matvec.py does): rtol 1e-9 of the largest
    entry, the tolerance of that test, since the kernel's MXU-shaped
    contractions sum in another order;
  * JAX's ``matvec_gm``: rtol 1e-12 (same sums, different order);
  * for a uniform elastic tangent (the V-cycle's fine-level use), JAX's
    ``elastic_matvec_gm``: rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import fenics_constitutive_tpu.ops.pallas_matvec as pm
from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.models import packed_models  # noqa: F401
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu_torch.ops import IsotropicTangent
from fenics_constitutive_tpu_torch.ops.cuda_matvec import (
    build_cuda_matvec,
    hot_path_geometry,
)
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry


def close(got, ref, rtol):
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def setup(box, mat):
    pair = box(6)
    gj = jax_build_geometry(pair["jax"][0], 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(
        pair["torch"][0], 2, Constraint.FULL, device="cpu", dtype=torch.float64
    )
    rng = np.random.default_rng(0)
    u = jnp.asarray(rng.normal(size=gt.ndofs) * 5e-3)
    hist = {"eps_n": jnp.zeros(gj.qp_shape(6)), "alpha": jnp.zeros(gj.qp_shape(1))}
    _, tg_j, _ = JVonMises3D(mat).evaluate_packed(
        0.0, 1.0, gj.strain_gm(gj.to_grid_major(u)), jnp.zeros(gj.qp_shape(6)), hist
    )
    assert float(jnp.abs(tg_j.gamma).max()) > 0  # plastic somewhere
    tg_t = IsotropicTangent(
        kappa=mat["p_ka"], beta=torch.tensor(np.asarray(tg_j.beta)),
        gamma=torch.tensor(np.asarray(tg_j.gamma)), n=torch.tensor(np.asarray(tg_j.n)),
    )
    v = rng.normal(size=gt.ndofs)
    v_j, v_t = gj.to_grid_major(jnp.asarray(v)), gt.to_grid_major(torch.tensor(v))
    r_port = build_cuda_matvec(gt)(v_t, tg_t)
    return dict(gj=gj, gt=gt, tg=(tg_j, tg_t), v=(v_j, v_t), r_port=r_port)


def test_hot_path_geometry(setup):
    assert hot_path_geometry(setup["gt"])


def test_entry_point_matches_pallas_interpret(setup, monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pm.pl, "pallas_call", lambda *a, **k: orig(*a, interpret=True, **k)
    )
    r_pallas = pm.build_pallas_matvec(setup["gj"])(setup["v"][0], setup["tg"][0])
    close(setup["r_port"], r_pallas, rtol=1e-9)


def test_entry_point_matches_jax_matvec_gm(setup):
    ref = setup["gj"].matvec_gm(setup["v"][0], setup["tg"][0])
    close(setup["r_port"], ref, rtol=1e-12)


def test_entry_point_uniform_tangent(setup, mat):
    ka, beta = mat["p_ka"], 2.0 * mat["p_mu"]
    tg = IsotropicTangent(kappa=ka, beta=beta, gamma=0.0,
                          n=torch.zeros((6, 1, 1), dtype=torch.float64))
    got = build_cuda_matvec(setup["gt"])(setup["v"][1], tg)
    ref = setup["gj"].elastic_matvec_gm(setup["v"][0], ka, beta)
    close(got, ref, rtol=1e-12)
