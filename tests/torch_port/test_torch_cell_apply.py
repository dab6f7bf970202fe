"""The tet CG operator's cell part (``WindowedGeometry.matvec``): the
dispatch between the CUDA kernel K7 (``ops/cuda_window.py::
windowed_cell_apply``) and its plain twin ``cell_apply_plain``, on the CPU.

* Dispatch: ``cell_apply_form`` takes every IsotropicTangent on affine P1
  tets (the Mises and elastic laws' fields of the QPs, a uniform tangent,
  fields of another dtype); it refuses a DenseTangent and P2 tets (one
  gradient per QP); ``WindowedGeometry.matvec`` takes K7 on CUDA tensors
  only, so the CPU path launches nothing.
* K7's reading of a tangent entry: a field of any dtype or layout becomes
  [k, N] contiguous of the working dtype, a uniform one (k values, or a view
  repeating them along the QPs) k values read with a zero stride.
* The plain twin followed by the scatter is the operator as the windowed
  geometry composes it from its strain, tangent and residual, bit for bit,
  in float64 and float32, for the plastic, elastic and uniform tangents.

K7's own guards are in test_torch_guards.py; K7 against its twin on the
card is phase 7b of chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from fenics_constitutive_tpu_torch import fem
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.models.packed_models import _uniform_tangent
from fenics_constitutive_tpu_torch.ops import (
    Constraint,
    DenseTangent,
    build_windowed_geometry,
    cuda_window,
)


def geometry(tets, n, degree, q, dtype, tile=32):
    """The windowed geometry of the shuffled n^3 tet box (several blocks)."""
    mesh = tets(n)["torch"][0].mesh
    V = fem.FunctionSpace(mesh, degree, 3)
    return build_windowed_geometry(V, q, Constraint.FULL, device="cpu", dtype=dtype, tile=tile)


def law_tangent(geo, mat, amp, seed=3):
    """The tangent VonMises3D returns from the zero state for a random
    displacement of amplitude ``amp`` (plastic at 1e-2, elastic at 1e-6)."""
    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.normal(size=geo.ndofs_int) * amp, dtype=geo.dtype)
    zeros = torch.zeros(6, geo.N, dtype=geo.dtype)
    hist = {"eps_n": zeros.clone(), "alpha": torch.zeros(1, geo.N, dtype=geo.dtype)}
    return VonMises3D(mat).evaluate_packed(0.0, 1.0, geo.strain(u), zeros, hist)[1]


def tangent(geo, mat, form):
    if form == "plastic":
        tg = law_tangent(geo, mat, 1e-2)
        assert (tg.gamma != 0).any() and tg.n.shape == (6, geo.N)
        return tg
    if form == "elastic":
        tg = law_tangent(geo, mat, 1e-6)
        assert not tg.gamma.any() and tg.beta.shape == (geo.N,)
        return tg
    if form == "uniform":
        return _uniform_tangent(mat["p_ka"], 2.0 * mat["p_mu"], torch.zeros(6, geo.N,
                                                                            dtype=geo.dtype))
    C = torch.as_tensor(np.random.default_rng(4).normal(size=(6, 6, geo.N)), dtype=geo.dtype)
    return DenseTangent(C)


@pytest.mark.parametrize(("form", "takes"), [
    ("plastic", True), ("elastic", True), ("uniform", True), ("dense", False), ("p2", False),
    ("float32_fields_on_float64", True),
])
def test_dispatch_picks_k7_or_the_plain_operator(tets, mat, form, takes):
    """cell_apply_form decides K7 by the geometry and the tangent's type
    alone; on the CPU matvec launches nothing whatever the form."""
    if form == "p2":
        geo = geometry(tets, 3, 2, 4, torch.float64, tile=128)
        tg = tangent(geo, mat, "plastic")
    else:
        geo = geometry(tets, 4, 1, 2, torch.float64)
        tg = tangent(geo, mat, form.replace("float32_fields_on_float64", "plastic"))
        if form.startswith("float32"):
            tg = type(tg)(tg.kappa, tg.beta.float(), tg.gamma.float(), tg.n.float())
    assert geo.compact == (form != "p2")
    assert cuda_window.cell_apply_form(geo, tg) is takes
    v = torch.as_tensor(np.random.default_rng(5).normal(size=geo.ndofs_int))
    before = dict(cuda_window.launches)
    assert torch.isfinite(geo.matvec(v, tg)).all()
    assert cuda_window.launches == before


@pytest.mark.parametrize("form", ["plastic", "elastic", "uniform"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_twin_then_scatter_is_the_operator(tets, mat, dtype, form):
    """cell_apply_plain then the scatter equals the geometry's strain,
    tangent and residual composed (the operator before K7), bit for bit, and
    matvec on the CPU returns the same."""
    geo = geometry(tets, 4, 1, 2, dtype)
    assert geo.ex.B > 1
    tg = tangent(geo, mat, form)
    ui = torch.as_tensor(np.random.default_rng(6).normal(size=geo.ndofs_int), dtype=dtype)
    u2 = ui.reshape(3, geo.ex.M_pad)
    rows = cuda_window.cell_apply_plain(geo, u2, tg)
    assert rows.shape == (geo.ex.B, 3, geo.ex.Rn) and rows.dtype == dtype
    composed = geo.residual(tg.apply(geo.strain(ui)))
    assert torch.equal(geo.ex.scatter(rows).reshape(-1), composed)
    assert torch.equal(geo.matvec(ui, tg), composed)


@pytest.mark.parametrize(("entry", "k", "qp_stride"), [
    ("field", 1, 1), ("float32_field", 1, 1), ("strided_field", 6, 1), ("field_shaped", 6, 1),
    ("number_tensor", 1, 0), ("expanded", 1, 0), ("expanded_n", 6, 0), ("uniform_n", 6, 0),
])
def test_k7_reads_each_tangent_entry_as_given(entry, k, qp_stride):
    """_tangent_entry hands K7 contiguous values of the working dtype and the
    QP stride it reads them with; read back as the kernel reads QP p
    (component c at c * (N if the QP stride is 1 else 1) + p * QP stride),
    they are the entry's values at every QP."""
    N, dtype = 12, torch.float64
    rng = np.random.default_rng(8)
    base = torch.as_tensor(rng.normal(size=(k, N)), dtype=dtype)
    x = {
        "field": base[0],
        "float32_field": base[0].float(),
        "strided_field": base.T.contiguous().T,
        "field_shaped": base.reshape(k, 3, 4),
        "number_tensor": base[0, 0],
        "expanded": base[0, :1].expand(N),
        "expanded_n": base[:, :1].expand(k, N),
        "uniform_n": base[:, :1].reshape(k, 1, 1),
    }[entry]
    values, stride = cuda_window._tangent_entry("K7", "x", x, k, N, dtype, x.device)
    assert stride == qp_stride and values.dtype == dtype and values.is_contiguous()
    assert values.numel() == (k * N if stride else k)
    comp = N if stride else 1
    read = values.reshape(-1)[torch.arange(k)[:, None] * comp + torch.arange(N)[None] * stride]
    assert torch.equal(read, torch.broadcast_to(x.reshape(k, -1).to(dtype), (k, N)))
