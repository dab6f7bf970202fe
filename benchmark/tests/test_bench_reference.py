"""The reference's elements on small boxes: the 27-node hex (exact strains,
weights, equilibrium of a uniform stress), the coordinate map that matches a
degree-2 space's dof nodes to the reference's, and the P1 elements pinned
as they were."""

import numpy as np
import pytest
import torch

from benchmark.harness import RunError
from benchmark.meshes import mesh_module
from benchmark.reference import check, fem

CPU = torch.device("cpu")
LAW = {"name": "VonMises3D",
       "params": {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0,
                  "p_w": 200.0}}
EVERY_CELL = [(LAW, None)]


def q2_box(n):
    return mesh_module("box_hex_q2").inputs({"n": n})


def q2_geometry(n):
    inp = q2_box(n)
    return inp, fem.Geometry(inp["nodes"], inp["cells"], inp["cell_type"], CPU)


def mandel(A):
    """The Mandel vector of the symmetric part of A."""
    e = 0.5 * (A + A.T)
    r = np.sqrt(2.0)
    return np.array([e[0, 0], e[1, 1], e[2, 2], r * e[0, 1], r * e[0, 2], r * e[1, 2]])


@pytest.mark.parametrize("n", [2, 3])
def test_q2_linear_field_has_its_exact_strain(n):
    inp, geo = q2_geometry(n)
    assert geo.Q == 27 and geo.cells.shape == (n**3, 27)
    A = np.random.default_rng(n).standard_normal((3, 3))
    u = torch.as_tensor(inp["nodes"] @ A.T).reshape(-1)
    eps = geo.strain(u)
    exact = torch.as_tensor(mandel(A)).expand_as(eps)
    assert torch.allclose(eps, exact, rtol=0, atol=1e-12)


@pytest.mark.parametrize("n", [2, 3])
def test_q2_weights_sum_to_the_volume(n):
    _, geo = q2_geometry(n)
    assert float(geo.w.sum()) == pytest.approx(1.0, abs=1e-14)
    assert torch.allclose(geo.w, geo.w[0].expand_as(geo.w), rtol=1e-14, atol=0)


@pytest.mark.parametrize("n", [2, 3])
def test_q2_uniform_stress_loads_no_interior_node(n):
    inp, geo = q2_geometry(n)
    s = torch.as_tensor(np.random.default_rng(7).standard_normal(6))
    f = geo.internal_force(s.expand(geo.cells.shape[0], geo.Q, 6)).reshape(-1, 3)
    x = inp["nodes"]
    interior = torch.as_tensor(((x > 1e-12) & (x < 1.0 - 1e-12)).all(axis=1))
    assert int(interior.sum()) == (2 * n - 1) ** 3
    assert float(f[interior].abs().max()) < 1e-13
    assert float(f[~interior].abs().max()) > 1e-3


def uniaxial(inp, load):
    """The exact answer of the stretch on an elastic box (uniaxial stress):
    u node-major and the last state, per cell and point."""
    p = LAW["params"]
    K, mu = p["p_ka"], p["p_mu"]
    nu = (3 * K - 2 * mu) / (2 * (3 * K + mu))
    x = inp["nodes"]
    u = np.stack([load * x[:, 0], -nu * load * x[:, 1], -nu * load * x[:, 2]], axis=1)
    C, Q = len(inp["cells"]), 27
    stress = np.zeros((C, Q, 6))
    stress[..., 0] = 9 * K * mu / (3 * K + mu) * load
    last = {"stress": torch.as_tensor(stress),
            "histories": [{"eps_n": torch.zeros(C, Q, 6), "alpha": torch.zeros(C, Q, 1)}]}
    return torch.as_tensor(u.reshape(-1)), last


def test_a_permuted_numbering_judges_through_the_coordinates():
    inp = q2_box(2)
    u, last = uniaxial(inp, 1e-3)
    plain = check.judge(inp, EVERY_CELL, "stretch_x", [(1e-3, u)], last, CPU)
    assert all(plain[k] <= lim for k, lim in
               {"bc_gap": 1e-15, "newton_residual": 1e-10, "state_gap": 1e-12}.items()), plain
    pi = np.random.default_rng(3).permutation(len(inp["nodes"]))
    coords = np.empty_like(inp["nodes"])
    coords[pi] = inp["nodes"]
    u_prog = torch.empty(len(pi), 3, dtype=u.dtype)
    u_prog[pi] = u.reshape(-1, 3)
    permuted = check.judge(inp, EVERY_CELL, "stretch_x", [(1e-3, u_prog.reshape(-1))], last, CPU,
                           dof_coords=coords)
    assert permuted == plain
    # taken in the program's order, the same answers are wrong
    blind = check.judge(inp, EVERY_CELL, "stretch_x", [(1e-3, u_prog.reshape(-1))], last, CPU)
    assert blind["bc_gap"] > 0.1 and blind["state_gap"] > 0.1


def test_node_map_refuses_what_lies_off_the_lattice():
    inp = q2_box(2)
    h = inp["spacing"]
    assert (check.node_map(inp, inp["nodes"]) == np.arange(len(inp["nodes"]))).all()
    off = inp["nodes"].copy()
    off[5, 1] += 0.3 * h
    with pytest.raises(RunError, match="no node of the"):
        check.node_map(inp, off)
    outside = inp["nodes"].copy()
    outside[5, 2] = 1.0 + h
    with pytest.raises(RunError, match="no node of the mesh"):
        check.node_map(inp, outside)
    twice = inp["nodes"].copy()
    twice[5] = twice[6]
    with pytest.raises(RunError, match="one lattice node"):
        check.node_map(inp, twice)
    with pytest.raises(RunError, match="dof nodes, the mesh"):
        check.node_map(inp, inp["nodes"][:-1])


@pytest.mark.parametrize("kind", ["box_hex", "kuhn_tet_gmsh"])
def test_p1_geometry_is_as_it_was(kind):
    """The P1 hex and tet geometries, bit for bit, against their element
    functions put together as the reference always has."""
    inp = mesh_module(kind).inputs({"n": 3, "shuffle_seed": 0})
    geo = fem.Geometry(inp["nodes"], inp["cells"], inp["cell_type"], CPU)
    dN_ref, wq = {"hex": fem._hex_reference, "tetra": fem._tet_reference}[inp["cell_type"]]()
    dN_ref = torch.as_tensor(dN_ref, dtype=torch.float64)
    xc = torch.as_tensor(inp["nodes"], dtype=torch.float64)[torch.as_tensor(inp["cells"])]
    J = torch.einsum("cai,qaj->cqij", xc, dN_ref)
    assert torch.equal(geo.dNdx, torch.einsum("qai,cqij->cqaj", dN_ref, torch.linalg.inv(J)))
    assert torch.equal(geo.w, torch.as_tensor(wq) * torch.linalg.det(J).abs())

