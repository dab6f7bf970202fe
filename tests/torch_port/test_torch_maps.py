"""CellSubsetMap of the port against the JAX package's (the same seeded
numpy blocks, exact), its identity fast path, and a two-material problem
whose per-law stress blocks land in their parent rows, against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.solver.maps import build_cell_subset_map as jbuild
from fenics_constitutive_tpu_torch.solver.maps import build_cell_subset_map
from test_torch_problem import compare, run_case


@pytest.mark.parametrize("shape_tail", [(), (6,), (6, 6)])
def test_random_subset_roundtrip(shape_tail):
    rng = np.random.default_rng(42)
    n_parent, Q = 64, 4
    for _ in range(10):
        k = rng.integers(1, n_parent + 1)
        cells = np.sort(rng.choice(n_parent, size=k, replace=False))
        m, mj = build_cell_subset_map(cells, n_parent), jbuild(cells, n_parent)
        assert m.identity == mj.identity
        parent_np = rng.normal(size=(n_parent, Q, *shape_tail))
        parent = torch.as_tensor(parent_np)
        sub = m.map_to_sub(parent)
        np.testing.assert_array_equal(sub.numpy(), np.asarray(mj.map_to_sub(jnp.asarray(parent_np))))
        assert torch.equal(m.map_to_parent(sub, parent), parent)
        back = m.map_to_parent(sub + 1.0, parent)
        ref = mj.map_to_parent(jnp.asarray(sub.numpy() + 1.0), jnp.asarray(parent_np))
        np.testing.assert_array_equal(back.numpy(), np.asarray(ref))
        assert torch.equal(parent, torch.as_tensor(parent_np))  # the parent is not written


def test_identity_fast_path():
    m = build_cell_subset_map(np.arange(10), 10)
    assert m.identity
    x = torch.arange(10.0)
    assert m.map_to_sub(x) is x and m.map_to_parent(x, torch.zeros(10)) is x
    assert not build_cell_subset_map(np.arange(1, 10), 10).identity
    assert not build_cell_subset_map(np.arange(10)[::-1], 10).identity


def two_materials(fem, m):
    mesh = fem.unit_cube_mesh(2, 2, 2, "tetra")
    V = fem.FunctionSpace(mesh, 1, 3)
    half = mesh.num_cells // 2
    laws = [(m.LinearElasticityModel({"E": 42.0, "nu": 0.3}, m.Constraint.FULL),
             np.arange(half)),
            (m.LinearElasticityModel({"E": 84.0, "nu": 0.3}, m.Constraint.FULL),
             np.arange(half, mesh.num_cells))]
    bcs = [fem.DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 0.0)),
                           np.zeros(3)),
           fem.DirichletBC(V.locate_dofs_geometrical(lambda x: np.isclose(x[:, 0], 1.0)),
                           np.array([0.01, 0.0, 0.0]))]
    return laws, V, bcs, 1, {}


@pytest.mark.parametrize("engine", ["packed", "aos"])
def test_multimaterial_stress_blocks_land_in_parent_rows(engine):
    got = run_case("torch", two_materials, [lambda p, b: None], engine)
    compare(got, run_case("jax", two_materials, [lambda p, b: None]), 1e-10)
    s = got[0]["stress_0"]
    half = s.shape[0] // 2
    a, b = s[:half], s[half:]
    assert np.abs(a).max() > 0 and np.abs(b).max() > 0
    assert abs(a[:, :, 0].mean() - b[:, :, 0].mean()) / abs(a[:, :, 0].mean()) < 0.2
