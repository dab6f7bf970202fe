"""The port's host FEM core and structured geometry against the JAX package.

Meshes, dofs and BCs are integer or exactly computed host data: they must be
identical. The geometry matrices are built by the same float64 host
arithmetic, so they agree to 1e-14 (they are in fact bit-equal today).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry


@pytest.mark.parametrize(
    "make",
    [
        lambda fem: fem.unit_cube_mesh(3, 2, 4, "hex"),
        lambda fem: fem.unit_cube_mesh(2, 2, 2, "tetra"),
        lambda fem: fem.unit_square_mesh(3, 4, "quad"),
        lambda fem: fem.unit_square_mesh(2, 3, "triangle"),
    ],
    ids=["hex", "tetra", "quad", "triangle"],
)
def test_mesh_identical(make):
    a, b = make(jfem), make(tfem)
    np.testing.assert_array_equal(a.nodes, b.nodes)
    np.testing.assert_array_equal(a.cells, b.cells)
    assert (a.cell_type, a.structured_shape) == (b.cell_type, b.structured_shape)


def test_bench_bc_dofs_and_combine_identical(box):
    pair = box(4)
    (Vj, bcs_j), (Vt, bcs_t) = pair["jax"], pair["torch"]
    assert Vj.ndofs == Vt.ndofs
    for bj, bt in zip(bcs_j, bcs_t):
        np.testing.assert_array_equal(bj.dofs, bt.dofs)
        np.testing.assert_array_equal(bj.dof_values(), bt.dof_values())
    dj, vj = jfem.bcs.combine_bcs(bcs_j)
    dt, vt = tfem.combine_bcs(bcs_t)
    np.testing.assert_array_equal(dj, dt)
    np.testing.assert_array_equal(vj, vt)


@pytest.mark.parametrize("n", [4, 6])
def test_structured_geometry_matches(box, n):
    pair = box(n)
    gj = jax_build_geometry(pair["jax"][0], 2, JConstraint.FULL, jnp.float64)
    gt = build_structured_geometry(
        pair["torch"][0], 2, Constraint.FULL, device="cpu", dtype=torch.float64
    )
    for name in ("KEPS_c", "KDIV_c", "KE_I", "KE_V", "mask"):
        ref = np.asarray(getattr(gj, name))
        got = getattr(gt, name).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-14, atol=1e-14 * np.abs(ref).max(),
                                   err_msg=name)
    np.testing.assert_array_equal(gt.cell_index.numpy(), np.asarray(gj.cell_index))
    assert gt.offsets == gj.offsets
    assert (gt.M, gt.N, gt.grid, gt.ndofs) == (gj.M, gj.N, gj.grid, gj.ndofs)
    np.testing.assert_allclose(gt.dN_host, np.asarray(gj.dN_host), rtol=1e-14)
    np.testing.assert_allclose(gt.w_host, np.asarray(gj.w_host), rtol=1e-14)
