"""Shared fixtures of the port's parity tests: the same box problem built by
the JAX package (the reference) and by the PyTorch port.

The tests run on the CPU in float64 (tests/conftest.py puts JAX on the CPU
with x64); data move between the packages as numpy arrays.
"""

import numpy as np
import pytest

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
