"""Shared fixtures of the port's parity tests: the same problem (a box of
hexes, or a shuffled tet box that arrives like an imported mesh) built by the
JAX package (the reference) and by the PyTorch port.

The tests run on the CPU in float64 (tests/conftest.py puts JAX on the CPU
with x64); data move between the packages as numpy arrays.
"""

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (a CUDA kernel, which has no CPU mode; skips here)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided when the test runs, never
    at import). On the card: ``python -m pytest tests/torch_port -m card``."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the CUDA kernel runs on the card only")
    return torch.device("cuda")


@pytest.fixture(scope="session", autouse=True)
def _one_torch_thread():
    """One intra-op thread for the port's CPU tests: the problems are small,
    and the suite runs in several worker processes beside JAX's own thread
    pools, where torch's default of one thread per core oversubscribes the
    machine and small ops wait on descheduled threads."""
    import torch

    torch.set_num_threads(1)


#: the benchmark's material (VonMises3D, exponential hardening)
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}


def _bench_bcs(V, DirichletBC, stretch):
    """The benchmark's Dirichlet set: x=0 fixed in x, x=1 pulled in x, y=0 and
    z=0 fixed in y and z."""

    def close(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    return [
        DirichletBC(V.locate_dofs_geometrical(close(0, 0.0), component=0), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(0, 1.0), component=0), stretch),
        DirichletBC(V.locate_dofs_geometrical(close(1, 0.0), component=1), 0.0),
        DirichletBC(V.locate_dofs_geometrical(close(2, 0.0), component=2), 0.0),
    ]


@pytest.fixture(scope="session")
def mat():
    return dict(MAT)


@pytest.fixture(scope="session")
def box():
    """box(n, stretch) -> {"jax": (V, bcs), "torch": (V, bcs)} on an n^3 hex mesh."""

    def make(n, stretch=0.004):
        from fenics_constitutive_tpu import fem as jfem
        from fenics_constitutive_tpu_torch import fem as tfem

        out = {}
        for key, fem in (("jax", jfem), ("torch", tfem)):
            V = fem.FunctionSpace(fem.unit_cube_mesh(n, n, n, "hex"), 1, 3)
            out[key] = (V, _bench_bcs(V, fem.DirichletBC, stretch))
        return out

    return make


def _shuffle(mesh, Mesh, seed):
    """The mesh with its node numbering shuffled and no structured metadata:
    it arrives like an imported mesh."""
    pi = np.random.default_rng(seed).permutation(mesh.num_nodes)  # old -> new
    nodes = np.empty_like(mesh.nodes)
    nodes[pi] = mesh.nodes
    return Mesh(nodes, pi[mesh.cells].astype(np.int32), mesh.cell_type)


@pytest.fixture(scope="session")
def tets():
    """tets(n, stretch, seed) -> {"jax": (V, bcs), "torch": (V, bcs)} on the same
    shuffled n^3 Kuhn tet box (P1, vector-valued), with the benchmark's BCs."""

    def make(n, stretch=0.004, seed=0):
        from fenics_constitutive_tpu import fem as jfem
        from fenics_constitutive_tpu.fem.mesh import Mesh as JMesh
        from fenics_constitutive_tpu_torch import fem as tfem

        out = {}
        for key, fem, Mesh in (("jax", jfem, JMesh), ("torch", tfem, tfem.Mesh)):
            mesh = _shuffle(fem.unit_cube_mesh(n, n, n, "tetra"), Mesh, seed)
            V = fem.FunctionSpace(mesh, 1, 3)
            out[key] = (V, _bench_bcs(V, fem.DirichletBC, stretch))
        return out

    return make


@pytest.fixture
def no_repo_writes(monkeypatch):
    """While active, opening a file for writing inside the repository
    raises: the bench twins write no file there."""
    import builtins
    import os
    from pathlib import Path

    repo = Path(__file__).resolve().parents[2]
    real_open = builtins.open

    def guarded(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, os.PathLike)) and any(c in mode for c in "wax+"):
            path = Path(file).resolve()
            if path == repo or repo in path.parents:
                msg = f"a write into the repository: {path}"
                raise AssertionError(msg)
        return real_open(file, mode, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", guarded)
