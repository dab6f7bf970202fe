"""The port's fused-eval entry point (ops/cuda_eval.py) on CPU tensors.

On the CPU the entry point runs its plain PyTorch version (strain_gm -> the
SoA radial return -> masked divergence); the CUDA kernel is held to it on the
card by chip_smoke.py. From a plastic pre-state on a 6^3 box (made as
tests/solver/test_pallas_eval.py makes it) every output is compared with
JAX's strain_gm -> evaluate_packed -> residual_gm, the path JAX's own fused
kernel is pinned to, at rtol 1e-9 of each field's largest entry: the local
Newton stops at a relative step of 1e-8, and two implementations whose exp
and sums round differently may stop one iterate apart. The same parity holds
on a 5 x 4 x 3 box, with a different extent in every direction (chip_smoke.py
phase 4 holds the kernel on non-cubic boxes on the card).
The first output is the assembled residual r [3*M]; the plain twin computes
it with the plain step's own residual_gm, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.models import VonMises3D as JVonMises3D
from fenics_constitutive_tpu.models import packed_models  # noqa: F401
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.ops.cuda_eval import build_cuda_eval
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry

FIELDS = ("residual", "stress", "beta", "gamma", "n", "eps_n", "alpha")


def t(x):
    return torch.tensor(np.asarray(x))


def close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale, err_msg=what)


def hex_pair(cells):
    """The same P1 vector space on a box of ``cells`` hexes in both packages."""
    from fenics_constitutive_tpu import fem as jfem
    from fenics_constitutive_tpu_torch import fem as tfem

    return {key: (fem.FunctionSpace(fem.unit_cube_mesh(*cells, "hex"), 1, 3),)
            for key, fem in (("jax", jfem), ("torch", tfem))}


def plastic_prestate(pair, mat):
    gj = jax_build_geometry(pair["jax"][0], 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(
        pair["torch"][0], 2, Constraint.FULL, device="cpu", dtype=torch.float64
    )
    law_j = JVonMises3D(mat)
    rng = np.random.default_rng(0)
    # one eval from zero with a large strain; its outputs are the base state
    u1 = jnp.asarray(rng.normal(size=gt.ndofs) * 6e-3)
    hist0 = {"eps_n": jnp.zeros(gj.qp_shape(6)), "alpha": jnp.zeros(gj.qp_shape(1))}
    sig1, _, hist1 = law_j.evaluate_packed(
        0.0, 1.0, gj.strain_gm(gj.to_grid_major(u1)), jnp.zeros(gj.qp_shape(6)), hist0
    )
    assert float(hist1["alpha"].max()) > 0.0  # genuinely plastic
    du_gm = gj.to_grid_major(jnp.asarray(rng.normal(size=gt.ndofs) * 2e-3))
    return gj, gt, law_j, du_gm, sig1, hist1


def parity_outputs(pair, mat):
    """(port, JAX) outputs of one eval from a plastic pre-state."""
    gj, gt, law_j, du_gm, sig1, hist1 = plastic_prestate(pair, mat)
    s_ref, tg_ref, h_ref = law_j.evaluate_packed(0.0, 1.0, gj.strain_gm(du_gm), sig1, hist1)
    Q, M = gt.n_qp, gt.M
    ref = {
        "residual": gj.residual_gm(s_ref),
        "stress": s_ref,
        "beta": jnp.broadcast_to(tg_ref.beta, (Q, M)),
        "gamma": jnp.broadcast_to(tg_ref.gamma, (Q, M)),
        "n": tg_ref.n,
        "eps_n": h_ref["eps_n"],
        "alpha": h_ref["alpha"],
    }
    fused = build_cuda_eval(gt, VonMises3D(mat))
    r, s, (beta, gmm, nf), h = fused(t(du_gm), t(sig1), {k: t(v) for k, v in hist1.items()})
    got = {
        "residual": r,
        "stress": s, "beta": beta, "gamma": gmm, "n": nf,
        "eps_n": h["eps_n"], "alpha": h["alpha"],
    }
    return got, ref


@pytest.fixture(scope="module")
def outputs(box, mat):
    return parity_outputs(box(6), mat)


@pytest.fixture(scope="module")
def outputs_5x4x3(mat):
    return parity_outputs(hex_pair((5, 4, 3)), mat)


@pytest.mark.parametrize("field", FIELDS)
def test_entry_point_matches_jax(outputs, field):
    got, ref = outputs
    close(got[field], ref[field], 1e-9, field)


@pytest.mark.parametrize("field", FIELDS)
def test_entry_point_matches_jax_on_a_non_cubic_box(outputs_5x4x3, field):
    got, ref = outputs_5x4x3
    assert got["residual"].shape == (3 * 6 * 5 * 4,)
    close(got[field], ref[field], 1e-9, field)


def test_plain_twin_residual_is_the_plain_steps_residual(box, mat):
    """The first output on the CPU is residual_gm of the new stress, the very
    computation of the step's plain path: equal bit for bit."""
    gj, gt, _, du_gm, sig1, hist1 = plastic_prestate(box(3), mat)
    law = VonMises3D(mat)
    r, s_new, _, _ = build_cuda_eval(gt, law)(
        t(du_gm), t(sig1), {k: t(v) for k, v in hist1.items()}
    )
    assert r.shape == (gt.ndofs,)
    assert torch.equal(r, gt.residual_gm(s_new))


def test_kernel_eval_step_on_a_cpu_geometry_raises(box, mat):
    from fenics_constitutive_tpu_torch.ops import cuda_eval
    from fenics_constitutive_tpu_torch.solver import build_packed_problem, make_packed_step

    geos, _, _ = build_packed_problem(box(2)["torch"][0], VonMises3D(mat), 2, device="cpu",
                                      dtype=torch.float64)
    before = cuda_eval.launches
    with pytest.raises(ValueError, match="CUDA"):
        make_packed_step(geos, eval_impl="kernel")
    assert cuda_eval.launches == before


@pytest.mark.slow
def test_entry_point_matches_pallas_eval_interpret(box, mat):
    """Against JAX's fused Pallas eval itself (interpret mode, 3^3 box)."""
    from fenics_constitutive_tpu.ops.pallas_eval import build_pallas_eval

    gj, gt, law_j, du_gm, sig1, hist1 = plastic_prestate(box(3), mat)
    Fj, sj, tgj, hj = build_pallas_eval(gj, law_j)(du_gm, sig1, hist1)
    rt, st, tgt, ht = build_cuda_eval(gt, VonMises3D(mat))(
        t(du_gm), t(sig1), {k: t(v) for k, v in hist1.items()}
    )
    close(rt, gj._scatter_corners(Fj).reshape(-1), 1e-9, "r")
    close(st, sj, 1e-9, "stress")
    for name, a, b in zip(("beta", "gamma", "n"), tgt, tgj):
        close(a, b, 1e-9, name)
    for k in ("eps_n", "alpha"):
        close(ht[k], hj[k], 1e-9, k)
