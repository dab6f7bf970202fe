"""Rules of the port that hold whatever the numbers are.

* No module of the port imports jax: a static AST scan (jax may be loaded
  in the test process anyway, so ``sys.modules`` proves nothing).
* The CUDA kernel paths refuse CPU tensors at the step level instead of
  quietly running the plain path.
* Importing the kernel modules and building the wrappers compiles nothing:
  nvcc runs only at a kernel's first launch on the card.
"""

import ast
import importlib
import pathlib
import subprocess

import pytest
import torch

import fenics_constitutive_tpu_torch

PKG = pathlib.Path(fenics_constitutive_tpu_torch.__file__).parent


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    bad = {
        str(f.relative_to(PKG)): name
        for f in files
        for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "fenics_constitutive_tpu")
    }
    assert not bad, bad


def test_kernel_sources_present():
    csrc = PKG / "csrc"
    assert {p.name for p in csrc.glob("*.cu")} == {"matvec.cu", "eval.cu"}
    for p in csrc.glob("*.cu"):
        assert "Replaces" in p.read_text()[:2000], p.name


@pytest.mark.parametrize("impl", ["matvec_impl", "eval_impl"])
def test_kernel_impl_with_cpu_tensors_raises(box, mat, impl):
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_packed_problem, make_packed_step

    geos, _, _ = build_packed_problem(box(2)["torch"][0], VonMises3D(mat), 2,
                                      device="cpu", dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        make_packed_step(geos, **{impl: "kernel"})


def test_simulation_auto_is_plain_off_the_card(box, mat):
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V, bcs = box(2)["torch"]
    PackedSimulation(VonMises3D(mat), V, bcs, 2, preconditioner="vcycle",
                     device="cpu", dtype=torch.float64)  # matvec_impl="auto"
    with pytest.raises(ValueError, match="CUDA"):
        PackedSimulation(VonMises3D(mat), V, bcs, 2, matvec_impl="kernel",
                         device="cpu", dtype=torch.float64)


def test_import_and_build_never_call_nvcc(box, mat, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a subprocess was started: {args!r}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    from fenics_constitutive_tpu_torch.ops import _cuda_build, cuda_eval, cuda_matvec

    for mod in (_cuda_build, cuda_matvec, cuda_eval):
        importlib.reload(mod)
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_packed_problem

    geos, models, state = build_packed_problem(box(2)["torch"][0], VonMises3D(mat), 2,
                                               device="cpu", dtype=torch.float64)
    mv = cuda_matvec.build_cuda_matvec(geos[0])
    ev = cuda_eval.build_cuda_eval(geos[0], models[0])
    u = torch.zeros(geos[0].ndofs, dtype=torch.float64)
    F, s, (beta, gamma, n), h = ev(u, state.stress[0], state.histories[0])
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent

    mv(u, IsotropicTangent(mat["p_ka"], beta, gamma, n))
    assert cuda_matvec.launches == 0 and cuda_eval.launches == 0
    assert not _cuda_build.build_log
