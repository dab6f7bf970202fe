"""The AoS assembly of the port (fem/assembly.py) against the JAX package's
fem/assembly.py, float64 on the CPU.

On a 2^3 hex box, a 2 x 2 triangle box, a 2 x 2 quad box and a 2^3 tet box
(P1, the 2D boxes in plane strain), the same seeded numpy inputs (a
displacement, a Mandel stress, a nonsymmetric tangent) go through every
function of both modules; they agree within 1e-12 of each output's largest
entry. The port assembles as a gather and a sum in a fixed order through
the plan its ``CellDofmap`` keeps, so a residual is bit-equal across two
calls.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu.fem import assembly as jasm
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.fem import assembly as tasm
from fenics_constitutive_tpu_torch.ops.mandel import Constraint

F64 = torch.float64
TOL = 1e-12

#: name -> (mesh maker args, value size, q_degree, constraint name)
MESHES = {
    "hex": (("cube", 2, "hex"), 3, 2, "FULL"),
    "triangle": (("square", 2, "triangle"), 2, 2, "PLANE_STRAIN"),
    "quad": (("square", 2, "quad"), 2, 2, "PLANE_STRAIN"),
    "tetra": (("cube", 2, "tetra"), 3, 2, "FULL"),
}


def make(name):
    (kind, n, cell), vs, q, cname = MESHES[name]
    out = {}
    for key, fem in (("jax", jfem), ("torch", tfem)):
        mesh = fem.unit_cube_mesh(n, n, n, cell) if kind == "cube" else \
            fem.unit_square_mesh(n, n, cell)
        out[key] = fem.FunctionSpace(mesh, 1, vs)
    Vj, Vt = out["jax"], out["torch"]
    gj = jfem.precompute_geometry(Vj, q)
    gt = tasm.device_geometry(tfem.precompute_geometry(Vt, q), dtype=F64, device="cpu")
    dm = tasm.build_cell_dofmap(Vt.dofmap, Vt.ndofs, device="cpu")
    rng = np.random.default_rng(7)
    C, Q = gt.dN_dx.shape[:2]
    s = Constraint[cname].stress_strain_dim
    data = {
        "u": rng.normal(size=Vt.ndofs),
        "sigma": rng.normal(size=(C, Q, s)),
        "tangent": rng.normal(size=(C, Q, s, s)),
    }
    return {"jax": (jnp.asarray(Vj.dofmap), gj, JConstraint[cname]),
            "torch": (dm, gt, Constraint[cname]), "ndofs": Vt.ndofs, "data": data,
            "bare": np.asarray(Vt.dofmap)}


@pytest.fixture(scope="module", params=list(MESHES))
def case(request):
    return make(request.param)


def close(got, ref):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * max(np.abs(ref).max(), 1e-300))


def t(x):
    return torch.as_tensor(x, dtype=F64)


def test_gather_element_dofs(case):
    (dj, _, _), (dt, _, _), d = case["jax"], case["torch"], case["data"]
    got = tasm.gather_element_dofs(t(d["u"]), dt)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jasm.gather_element_dofs(
        jnp.asarray(d["u"]), dj)))


def test_grad_at_qp(case):
    (dj, gj, _), (dt, gt, _), d = case["jax"], case["torch"], case["data"]
    close(tasm.grad_at_qp(t(d["u"]), dt, gt), jasm.grad_at_qp(jnp.asarray(d["u"]), dj, gj))


def test_assemble_residual(case):
    (dj, gj, cj), (dt, gt, ct), d = case["jax"], case["torch"], case["data"]
    n = case["ndofs"]
    close(tasm.assemble_residual(t(d["sigma"]), dt, gt, ct, n),
          jasm.assemble_residual(jnp.asarray(d["sigma"]), dj, gj, cj, n))


def test_tangent_matvec(case):
    (dj, gj, cj), (dt, gt, ct), d = case["jax"], case["torch"], case["data"]
    n = case["ndofs"]
    close(tasm.tangent_matvec(t(d["u"]), t(d["tangent"]), dt, gt, ct, n),
          jasm.tangent_matvec(jnp.asarray(d["u"]), jnp.asarray(d["tangent"]), dj, gj, cj, n))


def test_assemble_jacobi_diag(case):
    (dj, gj, cj), (dt, gt, ct), d = case["jax"], case["torch"], case["data"]
    n = case["ndofs"]
    close(tasm.assemble_jacobi_diag(t(d["tangent"]), dt, gt, ct, n),
          jasm.assemble_jacobi_diag(jnp.asarray(d["tangent"]), dj, gj, cj, n))


def test_assembly_bit_equal_across_calls(case):
    """The gather-and-sum assembly repeats bit for bit, also through a plan
    built again from the same dofmap."""
    (dt, gt, ct), d, n = case["torch"], case["data"], case["ndofs"]
    sig = t(d["sigma"])
    a = tasm.assemble_residual(sig, dt, gt, ct, n)
    b = tasm.assemble_residual(sig, dt, gt, ct, n)
    c = tasm.assemble_residual(sig, tasm.build_cell_dofmap(case["bare"], n, device="cpu"), gt,
                               ct, n)
    assert torch.equal(a, b) and torch.equal(a, c)
    tg = t(d["tangent"])
    assert torch.equal(tasm.assemble_jacobi_diag(tg, dt, gt, ct, n),
                       tasm.assemble_jacobi_diag(tg, dt, gt, ct, n))


def test_plan_lists_every_slot_of_each_dof(case):
    dt, n = case["torch"][0], case["ndofs"]
    plan = dt.plan.numpy()
    flat = dt.idx.numpy().reshape(-1)
    pad = len(flat)
    for dof in (0, n // 2, n - 1):
        row = plan[dof][plan[dof] != pad]
        np.testing.assert_array_equal(row, np.flatnonzero(flat == dof))


def test_no_float_atomics_in_the_new_modules():
    """No index_add_/scatter_add_/index_put_(accumulate=True) on the
    assembly, problem, step or postprocessing paths, nor in any module of
    the sharding package (parallel/)."""
    pkg = pathlib.Path(tasm.__file__).resolve().parents[1]
    files = ["fem/assembly.py", "solver/problem.py", "solver/step.py", "solver/maps.py",
             "postprocessing/norms.py", "postprocessing/sensors.py", "native/__init__.py",
             *(str(f.relative_to(pkg)) for f in sorted((pkg / "parallel").glob("*.py")))]
    assert "parallel/sharding.py" in files
    for rel in files:
        tree = ast.parse((pkg / rel).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("index_add_", "index_add", "scatter_add_",
                                         "scatter_add", "index_put_", "index_put"), (rel,
                                                                                      node.attr)
            if isinstance(node, ast.keyword):
                assert node.arg != "accumulate", rel
