"""Rules of the port that hold whatever the numbers are.

* No module of the port imports jax, nor do chip_smoke.py, the examples on
  the port (examples/torch/), the bench twins (bench_torch.py,
  scripts/torch_bench/), the script that executes the port's notebook or
  that notebook's code cells: a static AST scan (jax may be loaded in the
  test process anyway, so ``sys.modules`` proves nothing).
* The examples on the port and the bench twins run on the card unless asked
  for the CPU; the twins write no file (their runs in
  test_torch_bench_*.py also refuse any write into the repository).
* The CUDA kernel paths refuse CPU tensors (at the step level for the
  structured kernels, in the wrappers for the windowed ones) instead of
  quietly running the plain path.
* Importing the kernel modules, building a problem on either engine (with
  several laws, and with the fused K3 smoothing chains) and stepping it on
  the CPU compile nothing: nvcc runs only at a kernel's first launch on the
  card.
"""

import ast
import importlib
import importlib.util
import inspect
import json
import pathlib
import subprocess

import numpy as np
import pytest
import torch

import fenics_constitutive_tpu_torch

PKG = pathlib.Path(fenics_constitutive_tpu_torch.__file__).parent
REPO = PKG.parent
TWINS = ("creep_neumann", "custom_torch_model", "elasticity_cpp", "mises_c",
         "plasticity_demo")
BENCH_TWINS = (REPO / "bench_torch.py",
               *(REPO / "scripts" / "torch_bench" / f"{name}.py"
                 for name in ("common", "unstructured", "tet", "p2", "amg", "roofline")))


def _imports(path, source=None):
    tree = ast.parse(path.read_text() if source is None else source, filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_never_imports_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 15
    scanned = {str(f.relative_to(PKG)) for f in files}
    for module in ("fem/io.py", "fem/kinematics.py", "ops/windowed.py", "ops/windowed_bsr.py",
                   "ops/cuda_window.py", "solver/amg.py", "ops/cuda_smoother.py",
                   "fem/facets.py", "models/linear_elasticity.py", "utils/checkpoint.py",
                   "models/drucker_prager.py", "models/plasticity_general.py",
                   "models/viscoelasticity.py", "models/conversions.py", "utils/convert.py",
                   "solver/problem.py", "solver/step.py", "solver/maps.py", "fem/assembly.py",
                   "postprocessing/norms.py", "postprocessing/sensors.py", "utils/timers.py",
                   "native/__init__.py", "models/interfaces.py"):
        assert module in scanned, module
    # beside the package: the chip script, the examples on the port, the
    # notebook's executor and the notebook's code cells
    nb = REPO / "docs" / "torch" / "basic_usage.ipynb"
    cells = [c for c in json.loads(nb.read_text())["cells"] if c["cell_type"] == "code"]
    others = [REPO / "chip_smoke.py", REPO / "scripts" / "execute_torch_notebook.py",
              *sorted((REPO / "examples" / "torch").rglob("*.py")),
              *sorted((REPO / "scripts" / "torch_bench").glob("*.py")), REPO / "bench_torch.py"]
    assert set(BENCH_TWINS) <= set(others)
    assert len(others) == 2 + len(TWINS) + len(BENCH_TWINS) + 1 and len(cells) >= 5
    sources = [(f, f.read_text()) for f in files + others]
    sources += [(nb, "".join(c["source"])) for c in cells]
    bad = {
        str(f.relative_to(REPO)): name
        for f, src in sources
        for name in _imports(f, src)
        if name.split(".")[0] in ("jax", "jaxlib", "fenics_constitutive_tpu")
    }
    assert not bad, bad


@pytest.mark.parametrize("name", TWINS)
def test_example_twins_default_to_the_card(name):
    """No fallback: a twin runs on the card unless asked for the CPU
    (``--device cpu`` or ``main(device="cpu")``)."""
    path = REPO / "examples" / "torch" / name / "run_example.py"
    spec = importlib.util.spec_from_file_location(f"twin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert inspect.signature(mod.main).parameters["device"].default == "cuda"
    assert mod.parse_args([]).device == "cuda"
    assert mod.parse_args(["out", "--device", "cpu"]).device == "cpu"


@pytest.mark.parametrize("path", BENCH_TWINS[:1] + BENCH_TWINS[2:], ids=lambda p: p.stem)
def test_bench_twins_default_to_the_card(path):
    """No fallback: a bench twin runs on the card unless given --device cpu,
    and without a card its default run fails."""
    spec = importlib.util.spec_from_file_location(f"bench_twin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.parse_args([]).device == "cuda"
    assert mod.parse_args(["--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            mod.main([])


@pytest.mark.parametrize("path", BENCH_TWINS, ids=lambda p: p.stem)
def test_bench_twins_write_no_file(path):
    """A twin prints its line and writes nothing: no open(), save or dump
    call in its source (the Gmsh round trip of unstructured.py goes through
    a temporary directory)."""
    tree = ast.parse(path.read_text())
    calls = {(n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", None))
             for n in ast.walk(tree) if isinstance(n, ast.Call)}
    assert not calls & {"open", "write_text", "write_bytes", "dump", "save", "savez",
                        "savetxt", "to_csv"}, path.name


def test_kernel_sources_present():
    csrc = PKG / "csrc"
    names = {p.name for p in csrc.glob("*.cu")}
    # K1-K9, and the while nodes' set-conditional kernel (no TPU kernel's)
    assert names == {"matvec.cu", "eval.cu", "window.cu", "smoother.cu", "lattice.cu",
                     "return_map.cu", "graph_loop.cu"}
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


@pytest.mark.parametrize("kernel", ["gather", "scatter", "bsr_matvec", "bsr_matvec_bare"])
def test_window_kernels_refuse_cpu_tensors(tets, kernel):
    """Each wrapper raises instead of running its plain version; K6 also
    refuses a plan without the row layout it reads ("bsr_matvec_bare")."""
    from fenics_constitutive_tpu_torch.ops import (
        WindowedBsr,
        build_windowed_bsr,
        build_windowed_exchange,
        cuda_window,
    )

    V = tets(4)["torch"][0]
    ex = build_windowed_exchange(V.mesh.cells, V.mesh.num_nodes, device="cpu", tile=128)
    if kernel == "gather":
        call = lambda: cuda_window.windowed_gather(ex, torch.zeros(3, ex.M_pad))
    elif kernel == "scatter":
        call = lambda: cuda_window.windowed_scatter(ex, torch.zeros(ex.B, 3, ex.Rn))
    else:
        import scipy.sparse as sp

        w = build_windowed_bsr(sp.eye(6), 3, 3, device="cpu", dtype=torch.float64)
        if kernel == "bsr_matvec_bare":
            w = WindowedBsr(loc=w.loc, vals=w.vals, jb=w.jb, br=3, bc=3, k=w.k, T_r=w.T_r,
                            P=w.P, B=w.B, n_rnodes=w.n_rnodes, n_cnodes=w.n_cnodes,
                            NR_pad=w.NR_pad, NC_pad=w.NC_pad)
        call = lambda: cuda_window.windowed_bsr_matvec(w, torch.zeros(3 * w.NC_pad,
                                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert cuda_window.launches[kernel.removesuffix("_bare")] == 0


@pytest.mark.parametrize(("case", "error", "match"), [
    ("cpu", ValueError, "CUDA"),
    ("dtype", TypeError, "float32 or float64"),
    ("geometry_dtype", TypeError, "geometry of"),
    ("shape", ValueError, "expected shape"),
    ("plan", ValueError, "affine P1"),
    ("tangent", TypeError, "IsotropicTangent"),
    ("field", ValueError, "beta must hold 1 or 1 x N"),
    ("n_field", ValueError, "n must hold 6 or 6 x N"),
    ("kappa", ValueError, "kappa must be one value"),
    ("field_device", ValueError, "beta is on meta"),
])
def test_cell_apply_guards(tets, mat, case, error, match):
    """K7's wrapper checks the plan, the node rows' dtype and shape and the
    tangent's layout before the device, and raises for each, as K4/K5 do; a
    call it takes on CPU tensors still raises instead of running its plain
    twin. Nothing is launched."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace
    from fenics_constitutive_tpu_torch.models.packed_models import _uniform_tangent
    from fenics_constitutive_tpu_torch.ops import (
        Constraint,
        DenseTangent,
        IsotropicTangent,
        build_windowed_geometry,
        cuda_window,
    )

    mesh = tets(4 if case != "plan" else 3)["torch"][0].mesh
    degree, q = (2, 4) if case == "plan" else (1, 2)
    geo = build_windowed_geometry(FunctionSpace(mesh, degree, 3), q, Constraint.FULL,
                                  device="cpu", dtype=torch.float64, tile=128)
    u2 = torch.zeros(3, geo.ex.M_pad, dtype=torch.float64)
    tg = _uniform_tangent(mat["p_ka"], 2.0 * mat["p_mu"], torch.zeros(6, geo.N,
                                                                       dtype=torch.float64))
    if case == "dtype":
        u2 = u2.to(torch.int32)
    elif case == "geometry_dtype":
        u2 = u2.float()
    elif case == "shape":
        u2 = u2[:, :-1]
    elif case == "tangent":
        tg = DenseTangent(torch.zeros(6, 6, geo.N, dtype=torch.float64))
    elif case == "field":
        tg = IsotropicTangent(mat["p_ka"], torch.ones(geo.N - 1, dtype=torch.float64),
                              tg.gamma, tg.n)
    elif case == "n_field":
        tg = IsotropicTangent(mat["p_ka"], tg.beta, tg.gamma,
                              torch.zeros(3, geo.N, dtype=torch.float64))
    elif case == "kappa":
        tg = IsotropicTangent(torch.ones(geo.N, dtype=torch.float64), tg.beta, tg.gamma, tg.n)
    elif case == "field_device":
        tg = IsotropicTangent(mat["p_ka"], torch.ones(geo.N, device="meta"), tg.gamma, tg.n)
    before = cuda_window.launches["cell_apply"]
    with pytest.raises(error, match=match):
        cuda_window.windowed_cell_apply(geo, u2, tg)
    assert cuda_window.launches["cell_apply"] == before


@pytest.mark.parametrize("entry", ["PackedSimulation", "build_packed_problem", "build_amg",
                                   "build_multigrid", "build_structured_geometry",
                                   "IncrSmallStrainProblem"])
def test_entry_points_default_to_the_card(entry):
    """The entry points run on the card unless the caller asks for the CPU
    (no fallback: without a card the default fails at the first allocation)."""
    import inspect

    from fenics_constitutive_tpu_torch import solver
    from fenics_constitutive_tpu_torch.ops import structured

    fn = getattr(solver, entry, None) or getattr(structured, entry)
    param = inspect.signature(fn).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default == "cuda"


def test_import_and_build_never_call_nvcc(box, tets, mat, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError(f"a subprocess was started: {args!r}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    from fenics_constitutive_tpu_torch.ops import (
        _cuda_build,
        cuda_eval,
        cuda_matvec,
        cuda_smoother,
        cuda_window,
    )

    for mod in (_cuda_build, cuda_matvec, cuda_eval, cuda_window, cuda_smoother):
        importlib.reload(mod)
    from fenics_constitutive_tpu_torch.models import VonMises3D
    from fenics_constitutive_tpu_torch.solver import build_packed_problem

    geos, models, state = build_packed_problem(box(2)["torch"][0], VonMises3D(mat), 2,
                                               device="cpu", dtype=torch.float64)
    mv = cuda_matvec.build_cuda_matvec(geos[0])
    ev = cuda_eval.build_cuda_eval(geos[0], models[0])
    u = torch.zeros(geos[0].ndofs, dtype=torch.float64)
    r, s, (beta, gamma, n), h = ev(u, state.stress[0], state.histories[0])
    from fenics_constitutive_tpu_torch.ops import IsotropicTangent

    mv(u, IsotropicTangent(mat["p_ka"], beta, gamma, n))

    # the general-mesh path: windowed problem, AMG and one step on the CPU
    from fenics_constitutive_tpu_torch.solver import PackedSimulation

    V, bcs = tets(4)["torch"]
    sim = PackedSimulation(VonMises3D(mat), V, bcs, 2, engine="windowed", device="cpu",
                           dtype=torch.float64)
    assert sim.solve()[1]
    assert cuda_matvec.launches == 0 and cuda_eval.launches == 0
    assert set(cuda_window.launches.values()) == {0}
    assert not _cuda_build.build_log


@pytest.mark.parametrize("case", ["fused_hierarchy", "multi_law_simulation"])
def test_fused_and_multi_law_builds_never_call_nvcc(box, mat, monkeypatch, case):
    """A hierarchy with the K3 chains, and a two-law simulation with them,
    build and run on the CPU without starting a compiler."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"a subprocess was started: {args!r}")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    from fenics_constitutive_tpu_torch.models import (
        Constraint,
        LinearElasticityModel,
        VonMises3D,
    )
    from fenics_constitutive_tpu_torch.ops import _cuda_build, cuda_smoother
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
    from fenics_constitutive_tpu_torch.solver import PackedSimulation, build_multigrid

    importlib.reload(_cuda_build)
    importlib.reload(cuda_smoother)
    V, bcs = box(6)["torch"]
    if case == "fused_hierarchy":
        geo = build_structured_geometry(V, 2, Constraint.FULL, device="cpu",
                                        dtype=torch.float64)
        mg = build_multigrid(geo, mat["p_mu"], mat["p_ka"], device="cpu",
                             dtype=torch.float64, fused_smoothing=True)
        assert mg.fused is not None
        mg(torch.ones(geo.ndofs, dtype=torch.float64))
    else:
        mid = V.mesh.cell_midpoints()
        laws = [(LinearElasticityModel({"E": 150000.0, "nu": 0.3}, Constraint.FULL),
                 np.flatnonzero(mid[:, 2] < 0.5)),
                (VonMises3D(mat), np.flatnonzero(mid[:, 2] >= 0.5))]
        bcs[1].value = 0.002
        sim = PackedSimulation(laws, V, bcs, 2, preconditioner="vcycle",
                               mg_options={"fused_smoothing": True}, device="cpu",
                               dtype=torch.float64)
        assert sim.solve()[1]
    assert cuda_smoother.launches == 0
    assert not _cuda_build.build_log


@pytest.mark.parametrize("module", ["", ".ops"], ids=["top", "ops"])
def test_package_re_exports_match_jax(module):
    """Every name the JAX package's top level and ``ops`` export (their
    ``__all__``) is exported by the port's, and resolves there."""
    jax_mod = importlib.import_module(f"fenics_constitutive_tpu{module}")
    port = importlib.import_module(f"fenics_constitutive_tpu_torch{module}")
    assert set(jax_mod.__all__) <= set(port.__all__)
    for name in jax_mod.__all__:
        assert getattr(port, name) is not None, name
    if module:
        from fenics_constitutive_tpu_torch.ops import get_identity, mandel

        assert get_identity is mandel.get_identity
    else:
        from fenics_constitutive_tpu_torch import VonMises3D, models

        assert VonMises3D is models.VonMises3D
