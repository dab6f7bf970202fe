"""K8, the lattice operator's CUDA kernel (``ops/cuda_lattice.py``), on the
CPU: when it is chosen, its plain twin against the plain operator, and the
pieces of its launch that run on the host.

* ``lattice_apply_form`` holds for an IsotropicTangent on the 27-node hex
  box (float32, float64) and for nothing else;
* CPU tensors run the plain ``matvec_gm`` and count no launch, and the
  wrapper refuses them;
* ``lattice_apply_plain`` (K8's sum-factorised contractions) equals the
  plain operator normwise at 1e-13 in float64 on a 3 x 4 x 5 box, for a
  field tangent, a uniform one and one with gamma 0;
* the 1-D tables reproduce the geometry's gradients and weights, and a box
  whose gradients do not factor is refused;
* the kernel's brick partition (a node no other brick holds goes to r, the
  others to the face buffer and are summed in brick order), written out in
  numpy, assembles the twin's cell forces as the plain slice adds do;
* the tangent-entry reader takes a field, a uniform value and a stride-0
  view, and raises on a wrong size.

The kernel itself runs on the card (``chip_smoke.py``, phase 19).
"""

import numpy as np
import pytest
import torch

from fenics_constitutive_tpu_torch import fem
from fenics_constitutive_tpu_torch.ops import (
    DenseTangent,
    IsotropicTangent,
    build_lattice_geometry,
)
from fenics_constitutive_tpu_torch.ops import cuda_lattice
from fenics_constitutive_tpu_torch.ops.cuda_lattice import (
    lattice_apply,
    lattice_apply_form,
    lattice_apply_plain,
    lattice_brick,
    lattice_tables,
)
from fenics_constitutive_tpu_torch.ops.cuda_window import _tangent_entry
from fenics_constitutive_tpu_torch.ops.mandel import Constraint

F64 = torch.float64
CELLS = (3, 4, 5)


def lattice(cells=CELLS, q_degree=4, constraint=Constraint.FULL, dtype=F64):
    if len(cells) == 3:
        V = fem.FunctionSpace(fem.unit_cube_mesh(*cells, "hex"), 2, 3)
    else:
        V = fem.FunctionSpace(fem.unit_square_mesh(*cells, "quad"), 2, 2)
    return build_lattice_geometry(V, q_degree, constraint, device="cpu", dtype=dtype)


@pytest.fixture(scope="module")
def geo():
    return lattice()


def field_tangent(geo, rng, gamma=True):
    Q, C = geo.n_qp, geo.n_cells
    g = rng.uniform(0.0, 1.0, (Q, C)) if gamma else np.zeros((Q, C))
    return IsotropicTangent(kappa=3.0, beta=torch.tensor(rng.uniform(1.0, 2.0, (Q, C))),
                            gamma=torch.tensor(g), n=torch.tensor(rng.normal(size=(6, Q, C))))


def uniform_tangent(rng):
    n = rng.normal(size=6)
    return IsotropicTangent(kappa=3.0, beta=1.5, gamma=0.25,
                            n=torch.tensor(n / np.linalg.norm(n)).reshape(6, 1, 1))


def plain(geo, v, tangent):
    return geo.residual_gm(tangent.apply(geo.strain_gm(v)))


def _with_constraint(geo, constraint):
    geo.constraint = constraint
    return geo


def rel(got, ref):
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


FORMS = {
    "hex27 f64": (lambda: lattice(), "iso", True),
    "hex27 f32": (lambda: lattice(dtype=torch.float32), "iso", True),
    "dense tangent": (lambda: lattice(), "dense", False),
    "quad P2 box": (lambda: lattice((4, 3), constraint=Constraint.PLANE_STRAIN), "iso", False),
    "hex27 at q 2": (lambda: lattice(q_degree=2), "iso", False),
    "not FULL": (lambda: _with_constraint(lattice(), Constraint.UNIAXIAL_STRAIN), "iso", False),
}


@pytest.mark.parametrize("case", list(FORMS))
def test_lattice_apply_form(case):
    build, kind, expected = FORMS[case]
    g = build()
    s, Q, C = g.sdim, g.n_qp, g.n_cells
    if kind == "iso":
        t = IsotropicTangent(kappa=1.0, beta=1.0, gamma=0.0,
                             n=torch.zeros((s, 1, 1), dtype=g.dtype))
    else:
        t = DenseTangent(C=torch.zeros((s, s, Q, C), dtype=g.dtype))
    assert lattice_apply_form(g, t) is expected


def test_cpu_tensors_run_the_plain_operator(geo):
    rng = np.random.default_rng(1)
    t = field_tangent(geo, rng)
    v = torch.tensor(rng.normal(size=3 * geo.M))
    before = dict(cuda_lattice.launches)
    assert lattice_apply_form(geo, t)
    assert torch.equal(geo.matvec_gm(v, t), plain(geo, v, t))
    assert cuda_lattice.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        lattice_apply(geo, v, t)
    with pytest.raises(ValueError, match="IsotropicTangent"):
        lattice_apply(geo, v, DenseTangent(C=torch.zeros((6, 6, geo.n_qp, geo.n_cells),
                                                         dtype=F64)))


@pytest.mark.parametrize("kind", ["field", "uniform", "zero gamma"])
def test_plain_twin_matches_the_operator(geo, kind):
    rng = np.random.default_rng(2)
    t = {"field": lambda: field_tangent(geo, rng), "uniform": lambda: uniform_tangent(rng),
         "zero gamma": lambda: field_tangent(geo, rng, gamma=False)}[kind]()
    v = torch.tensor(rng.normal(size=3 * geo.M))
    got, ref = lattice_apply_plain(geo, v, t), geo.matvec_gm(v, t)
    assert got.shape == ref.shape == (3 * geo.M,)
    assert rel(got, ref) <= 1e-13


def test_tables_reproduce_the_geometry():
    g = lattice((2, 3, 4))
    t = lattice_tables(g)
    assert lattice_tables(g) is t
    B, D = t["B"], t["D"]
    dN = np.stack([np.einsum("ax,by,cz->zyxabc", D[0], B, B),
                   np.einsum("ax,by,cz->zyxabc", B, D[1], B),
                   np.einsum("ax,by,cz->zyxabc", B, B, D[2])], axis=3).reshape(27, 3, 27)
    np.testing.assert_allclose(dN, g.dN_host, rtol=1e-13, atol=1e-13 * np.abs(dN).max())
    np.testing.assert_allclose(t["w"], g.w.numpy(), rtol=1e-14)
    assert len(t["host"]) == 64 and t["host"][63] == pytest.approx(2**-0.5, rel=1e-15)
    bad = lattice((2, 3, 4))
    bad.dN_host = bad.dN_host.copy()
    bad.dN_host[3, 1, 5] += 1e-3
    with pytest.raises(ValueError, match="factor"):
        lattice_tables(bad)


def brick_sums(f: np.ndarray, grid, brick) -> np.ndarray:
    """K8's node sums in numpy: cell forces f [o2, o1, o0, j, C] -> grid-major
    [3 M], as csrc/lattice.cu takes them (each brick's lattice, then r or the
    face buffer, then the shared nodes summed in brick order)."""
    g, b = np.array(grid), np.array(brick)
    nb = -(-g // b)
    L = 2 * g + 1
    FL = 2 * b + 1
    r = np.full((3, *L), np.nan)
    face = np.full((*nb, 3, *FL), np.nan)
    fc = f.reshape(3, 3, 3, 3, *g)  # [o2, o1, o0, j, c0, c1, c2]
    for bi in np.ndindex(*nb):
        lo = np.array(bi) * b
        n = np.minimum(b, g - lo)
        F = np.zeros((3, *FL))
        for c in np.ndindex(*n):
            cell = tuple(lo + c)
            for o in np.ndindex(3, 3, 3):
                l_ = tuple(2 * np.array(c) + o)
                F[(slice(None), *l_)] += fc[(o[2], o[1], o[0], slice(None), *cell)]
        for l_ in np.ndindex(*(2 * n + 1)):
            shared = any((l_[k] == 0 and bi[k] > 0) or (l_[k] == 2 * n[k] and bi[k] < nb[k] - 1)
                         for k in range(3))
            node = tuple(2 * lo + l_)
            if shared:
                face[(*bi, slice(None), *l_)] = F[(slice(None), *l_)]
            else:
                assert np.isnan(r[(slice(None), *node)]).all()
                r[(slice(None), *node)] = F[(slice(None), *l_)]
    for node in np.ndindex(*L):
        per_axis = []
        for k in range(3):
            kk = min(node[k] // (2 * b[k]), nb[k] - 1)
            lk = node[k] - 2 * b[k] * kk
            per_axis.append([(kk - 1, 2 * b[k]), (kk, 0)] if lk == 0 and kk > 0 else [(kk, lk)])
        if all(len(p) == 1 for p in per_axis):
            continue
        assert np.isnan(r[(slice(None), *node)]).all()
        acc = np.zeros(3)
        for (b0, l0) in per_axis[0]:
            for (b1, l1) in per_axis[1]:
                for (b2, l2) in per_axis[2]:
                    acc = acc + face[b0, b1, b2, :, l0, l1, l2]
        r[(slice(None), *node)] = acc
    assert not np.isnan(r).any()
    return r.reshape(-1)


@pytest.mark.parametrize("brick", [torch.float64, torch.float32, (2, 2, 2), (1, 3, 2)])
def test_brick_partition_assembles_the_cell_forces(geo, brick):
    rng = np.random.default_rng(3)
    C = geo.n_cells
    brick = lattice_brick(geo.grid, brick) if isinstance(brick, torch.dtype) else brick
    f = torch.tensor(rng.normal(size=(81, C)))
    got = brick_sums(f.numpy(), geo.grid, brick)
    np.testing.assert_allclose(got, geo.assemble_gm(f).numpy(), rtol=1e-14, atol=1e-14)


def test_lattice_brick_rule():
    assert lattice_brick((32, 32, 32), torch.float64) == (4, 2, 32)
    assert lattice_brick((32, 32, 32), torch.float32) == (2, 2, 32)
    assert lattice_brick((3, 4, 5), torch.float64) == (3, 2, 5)
    assert lattice_brick((1, 40, 70), torch.float32) == (1, 2, 32)


def test_tangent_entry_reader():
    N, dev = 27 * 4, torch.device("cpu")
    field = torch.arange(6 * N, dtype=torch.float32).reshape(6, 27, 4)
    vals, stride = _tangent_entry("t", "n", field, 6, N, F64, dev)
    assert stride == 1 and vals.dtype == F64 and vals.shape == (6, N) and vals.is_contiguous()
    assert torch.equal(vals, field.reshape(6, N).double())
    uniform = torch.tensor([1.0, 2, 3, 4, 5, 6]).reshape(6, 1, 1)
    vals, stride = _tangent_entry("t", "n", uniform, 6, N, F64, dev)
    assert stride == 0 and vals.shape == (6,)
    view = uniform.expand(6, 27, 4)
    vals, stride = _tangent_entry("t", "n", view, 6, N, F64, dev)
    assert stride == 0 and torch.equal(vals, uniform.reshape(6).double())
    vals, stride = _tangent_entry("t", "beta", torch.tensor(2.0).expand(27, 4), 1, N, F64, dev)
    assert stride == 0 and vals.shape == (1,)
    with pytest.raises(ValueError, match="must hold"):
        _tangent_entry("t", "n", torch.zeros(6, 27, 5), 6, N, F64, dev)
