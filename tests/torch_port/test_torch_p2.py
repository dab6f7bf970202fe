"""Degree-2 spaces through PackedSimulation against the JAX package (float64,
CPU): the lattice engine with every preconditioner, a P2 law on a cell
subset of a box with the refined-P1 node preconditioner, the 2D quad
lattice, a 2D quad box's fused V-cycle, and P2 on a shuffled tet mesh with
the AMG on the windowed and the gather engines.

Every load path starts elastic and every step converges (Newton rtol 1e-10),
so the states agree to rtol 1e-7 of each field's largest entry (ROADMAP
"Properties of the shared algorithm"); the preconditioner applies agree to
1e-12 (the sums differ in order only) and the fused V-cycle to 1e-10, the
bar of the JAX package's own fused V-cycle test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu.ops.mandel import Constraint as JConstraint
from fenics_constitutive_tpu.ops.pallas_smoother import (
    build_fused_smoother as jax_build_fused_smoother,
)
from fenics_constitutive_tpu.ops.structured import (
    build_structured_geometry as jax_build_geometry,
)
from fenics_constitutive_tpu.solver import PackedSimulation as JPackedSimulation
from fenics_constitutive_tpu.solver.multigrid import (
    build_p2_node_preconditioner as jax_p2_precond,
)
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch.ops.mandel import Constraint
from fenics_constitutive_tpu_torch.ops.structured import build_structured_geometry
from fenics_constitutive_tpu_torch.solver import PackedSimulation, build_multigrid
from fenics_constitutive_tpu_torch.solver.multigrid import build_p2_node_preconditioner

F64 = torch.float64
STEPS = (0.004, 0.008, 0.012)
CONVERGED = dict(newton_rtol=1e-10, newton_atol=1e-10, cg_rtol=1e-10)
MU, KAPPA = 80769.0, 175000.0


def close(got, ref, rtol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


def bcs_of(V, fem):
    """x=0 fixed in x, x=1 pulled in x (bcs[1]), symmetry planes y=0 (and z=0)."""

    def at(axis, v):
        return lambda x: np.isclose(x[:, axis], v)

    out = [fem.DirichletBC(V.locate_dofs_geometrical(at(0, 0.0), component=0), 0.0),
           fem.DirichletBC(V.locate_dofs_geometrical(at(0, 1.0), component=0), 0.0)]
    return out + [fem.DirichletBC(V.locate_dofs_geometrical(at(a, 0.0), component=a), 0.0)
                  for a in range(1, V.mesh.gdim)]


def shuffled(mesh, Mesh, seed=0):
    pi = np.random.default_rng(seed).permutation(mesh.num_nodes)
    nodes = np.empty_like(mesh.nodes)
    nodes[pi] = mesh.nodes
    return Mesh(nodes, pi[mesh.cells].astype(np.int32), mesh.cell_type)


def spaces(kind, n):
    out = {}
    for key, fem in (("jax", jfem), ("torch", tfem)):
        if kind == "hex":
            V = fem.FunctionSpace(fem.unit_cube_mesh(n, n, n, "hex"), 2, 3)
        elif kind == "quad":
            V = fem.FunctionSpace(fem.unit_square_mesh(n, n - 1, "quad"), 2, 2)
        else:
            Mesh = fem.Mesh if key == "torch" else __import__(
                "fenics_constitutive_tpu.fem.mesh", fromlist=["Mesh"]).Mesh
            V = fem.FunctionSpace(shuffled(fem.unit_cube_mesh(n, n, n, "tetra"), Mesh), 2, 3)
        out[key] = V
    return out


def law_of(kind, pkg, mat, subset=None):
    m = jm if pkg == "jax" else tm
    law = m.VonMises3D(mat)
    if kind == "quad":
        law = m.PlaneStrainFrom3D(law)
    return law if subset is None else [(law, subset)]


def run_both(kind, n, mat, q_degree, subset=None, jax_kw=None, **kw):
    """The same converged load path in both packages: (port sim, JAX sim).
    ``jax_kw`` replaces ``kw`` on the JAX side."""
    pair = spaces(kind, n)
    sims = {}
    for pkg, Sim, fem, extra in (("jax", JPackedSimulation, jfem, jax_kw),
                                 ("torch", PackedSimulation, tfem, None)):
        V = pair[pkg]
        bcs = bcs_of(V, fem)
        opts = dict(kw if extra is None else extra)
        if pkg == "torch":
            opts.update(device="cpu", dtype=F64)
        sim = Sim(law_of(kind, pkg, mat, subset), V, bcs, q_degree, **CONVERGED, **opts)
        its = []
        for load in STEPS:
            bcs[1].value = load
            its.append(sim.solve())
        assert all(ok for _, ok in its), (pkg, its)
        sims[pkg] = (sim, [k for k, _ in its])
    (st, it_t), (sj, it_j) = sims["torch"], sims["jax"]
    assert it_t == it_j
    close(st.u, np.asarray(sj.u), 1e-7)
    close(st.stress, np.asarray(sj.stress), 1e-7)
    return st, sj


@pytest.mark.parametrize(("preconditioner", "mg_options"), [
    (None, None), ("bpx", None), ("vcycle", None), ("vcycle", {"fused_smoothing": True}),
    ("amg", None),
], ids=["jacobi", "bpx", "vcycle", "vcycle-fused", "amg"])
def test_p2_box_simulation_matches_jax(mat, preconditioner, mg_options):
    st, _ = run_both("hex", 4, mat, 4, preconditioner=preconditioner, mg_options=mg_options)
    assert (st.engine, st.preconditioner) == ("lattice", preconditioner)
    if mg_options:
        assert st._mg.fused_cycle is not None and st._mg.node_grids[0] == (9, 9, 9)


def test_p2_quad_lattice_with_the_fused_vcycle_matches_jax(mat):
    """The 2D P2 lattice with the fused refined-P1 V-cycle. The JAX package's
    build_multigrid cannot build a 2D hierarchy (its unit tangents carry 6
    Mandel components, PLANE_STRAIN has 4), so its side runs Jacobi: the
    converged states do not depend on the preconditioner."""
    moduli = (MU, KAPPA)
    st, _ = run_both("quad", 4, mat, 4, preconditioner="vcycle",
                     mg_options={"fused_smoothing": True}, elastic_moduli=moduli,
                     jax_kw=dict(preconditioner=None, elastic_moduli=moduli))
    assert st.engine == "lattice" and st._mg.fused_cycle is not None
    assert st._mg.node_grids[0] == (9, 7)


@pytest.mark.parametrize("preconditioner", ["vcycle", "bpx"])
def test_p2_law_on_a_box_subset_matches_jax(mat, preconditioner):
    """One law on the cells x < 0.75 of a P2 box: the gather engine (the
    lattice engine takes the whole box only) with the refined-P1 node
    preconditioner."""
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(3, 3, 3, "hex"), 2, 3)
    cells = np.flatnonzero(V.mesh.cell_midpoints()[:, 0] < 0.75).astype(np.int32)
    st, _ = run_both("hex", 3, mat, 4, subset=cells, preconditioner=preconditioner)
    assert (st.engine, st.preconditioner) == ("gather", preconditioner)


def test_p2_law_on_a_box_subset_on_the_windowed_engine(mat):
    """The same on the windowed engine: the node preconditioner runs between
    the engine's internal layout and the node-major one."""
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(3, 3, 3, "hex"), 2, 3)
    cells = np.flatnonzero(V.mesh.cell_midpoints()[:, 0] < 0.75).astype(np.int32)
    st, _ = run_both("hex", 3, mat, 4, subset=cells, preconditioner="vcycle",
                     engine="windowed")
    assert st.engine == "windowed"


def test_several_p2_laws_with_vcycle_raise(mat):
    V = tfem.FunctionSpace(tfem.unit_cube_mesh(2, 2, 2, "hex"), 2, 3)
    x = V.mesh.cell_midpoints()[:, 0]
    laws = [(tm.VonMises3D(mat), np.flatnonzero(x < 0.5)),
            (tm.VonMises3D(mat), np.flatnonzero(x >= 0.5))]
    with pytest.raises(ValueError, match="vcycle"):
        PackedSimulation(laws, V, bcs_of(V, tfem), 4, preconditioner="vcycle", device="cpu",
                         dtype=F64)


def test_p2_node_preconditioner_matches_jax(mat):
    pair = spaces("hex", 3)
    Vj, Vt = pair["jax"], pair["torch"]
    free = np.ones(Vt.ndofs, bool)
    free[np.concatenate([b.dofs for b in bcs_of(Vt, tfem)])] = False
    r = np.random.default_rng(4).normal(size=Vt.ndofs)
    for use_bpx in (False, True):
        pj = jax_p2_precond(Vj, MU, KAPPA, jnp.asarray(free), use_bpx=use_bpx, nu=3)
        pt = build_p2_node_preconditioner(Vt, MU, KAPPA, free, device="cpu", dtype=F64,
                                          use_bpx=use_bpx, nu=3)
        close(pt(torch.tensor(r)), pj(jnp.asarray(r)), 1e-12)


def test_quad_box_fused_vcycle_matches_jax_and_unfused():
    """A 2D P1 quad box's fused V-cycle (the plain twins of the K3 entries on
    the CPU): every level's chains against the JAX package's fused chains
    (Pallas in interpret mode) on that level's geometry, and the whole cycle
    against the port's unfused V-cycle. (JAX's build_multigrid cannot build
    the 2D hierarchy itself: see the test above.)"""
    Vt = tfem.FunctionSpace(tfem.unit_square_mesh(9, 7, "quad"), 1, 2)
    free = np.ones(Vt.ndofs, bool)
    free[np.concatenate([b.dofs for b in bcs_of(Vt, tfem)])] = False
    gt = build_structured_geometry(Vt, 2, Constraint.PLANE_STRAIN, device="cpu", dtype=F64)
    kw = dict(nu=3, nu_coarse=2, coarse_direct=True, min_size=2)
    mg_t = build_multigrid(gt, MU, KAPPA, torch.tensor(free), device="cpu", dtype=F64,
                           fused_smoothing=True, **kw)
    mg_u = build_multigrid(gt, MU, KAPPA, torch.tensor(free), device="cpu", dtype=F64, **kw)
    assert mg_t.n_levels == 3 and mg_t.fused_cycle.patterns() == [9, 9, 6]
    rng = np.random.default_rng(7)
    for lvl, chains in enumerate(mg_t.fused):
        cells = tuple(L - 1 for L in mg_t.node_grids[lvl])
        Vj = jfem.FunctionSpace(jfem.unit_square_mesh(*cells, "quad"), 1, 2)
        gj = jax_build_geometry(Vj, 2, JConstraint.PLANE_STRAIN, jnp.float64)
        for chain in chains.values():
            fn_j = jax_build_fused_smoother(
                gj, chain.ke.numpy(), jnp.asarray(chain.inv_d.numpy()), np.asarray(gj.mask),
                nu=chain.nu, zero_start=chain.zero_start, emit_residual=chain.emit_residual)
            b = rng.normal(size=chain.inv_d.numel())
            x = rng.normal(size=b.size) * 1e-3
            args = (b,) if chain.zero_start else (x, b)
            got = chain(*(torch.tensor(a) for a in args))
            ref = fn_j(*(jnp.asarray(a) for a in args))
            for g, r in zip(got if chain.emit_residual else (got,),
                            ref if chain.emit_residual else (ref,)):
                close(g, r, 1e-12)
    r = np.random.default_rng(8).normal(size=Vt.ndofs)
    z = mg_t(gt.to_grid_major(torch.tensor(r)))
    close(z, mg_u(gt.to_grid_major(torch.tensor(r))), 1e-10)


@pytest.mark.parametrize("engine", ["windowed", "gather"])
def test_p2_tets_with_the_amg_match_jax(mat, engine):
    st, _ = run_both("tets", 3, mat, 2, preconditioner="amg", engine=engine)
    assert (st.engine, st.preconditioner) == (engine, "amg")
    assert st._geos[0].n_nodes == 10


@pytest.mark.parametrize("cell", ["quad", "triangle"])
def test_2d_pattern_stencils_equal_the_gather(cell):
    """The 9-point stencils of 2 x 2 blocks the K3 kernels read on a 2D level
    (one per pattern of valid cells around a node, built from Ke on the
    host) apply the same operator as the 4-corner gather at every node of
    every level: the quad box's and the Kuhn triangle box's (whose corner
    channels sit on the quad layout)."""
    from fenics_constitutive_tpu_torch.ops import cuda_smoother
    from fenics_constitutive_tpu_torch.ops.structured import build_structured_tet_geometry

    V = tfem.FunctionSpace(tfem.unit_square_mesh(9, 7, cell), 1, 2)
    build = build_structured_geometry if cell == "quad" else build_structured_tet_geometry
    g = build(V, 2, Constraint.PLANE_STRAIN, device="cpu", dtype=F64)
    free = np.ones(V.ndofs, bool)
    free[np.concatenate([b.dofs for b in bcs_of(V, tfem)])] = False
    mg = build_multigrid(g, MU, KAPPA, torch.tensor(free), device="cpu", dtype=F64,
                         fused_smoothing=True, coarse_direct=True, min_size=2)
    rng = np.random.default_rng(5)
    for lvl in range(mg.n_levels):
        chain = mg.fused_cycle._chain(lvl)
        assert cuda_smoother.smoother_geometry_ok(chain.geo)
        n0, n1 = chain.grid
        n_pat = chain.n_patterns
        pid = chain.pid.numpy().astype(np.int64).reshape(n0, n1)
        assert pid.max() < n_pat <= 9
        x = torch.tensor(rng.normal(size=2 * n0 * n1))
        ref = cuda_smoother._apply_plain(chain.geo, chain.ke, chain.mask, x).reshape(2, n0, n1)
        st = chain.st.numpy().reshape(n_pat, 2, cuda_smoother.stencil_k(2))[:, :, :18]
        st = st.reshape(n_pat, 2, 9, 2)[pid]  # [n0, n1, k, d, j]
        xp = np.pad(x.numpy().reshape(2, n0, n1), ((0, 0), (1, 1), (1, 1)))
        got = np.zeros((2, n0, n1))
        for d in range(9):
            nb = xp[:, d // 3 : d // 3 + n0, d % 3 : d % 3 + n1]  # [k, n0, n1]
            got += np.einsum("abkj,kab->jab", st[:, :, :, d, :], nb)
        close(got, ref.numpy(), 1e-12)


@pytest.mark.parametrize(("itemsize", "first"), [(4, 3), (8, 4)])
def test_2d_tail_start_rule(itemsize, first):
    """The tail's first level on the 512^2 quad hierarchy at 227 KB a block
    (the H100's opt-in): 2 components and 40-value stencils per pattern."""
    from fenics_constitutive_tpu_torch.ops import cuda_smoother

    grids = tuple((n, n) for n in (513, 257, 129, 65, 33, 17, 9, 5))
    patterns = (9,) * len(grids)
    smem = 232_448
    assert cuda_smoother.stencil_values(2) == 40
    assert cuda_smoother.tail_start(grids, patterns, itemsize, smem, vs=2) == first
    assert cuda_smoother.tail_bytes(grids, patterns, itemsize, first, vs=2) <= smem
    assert cuda_smoother.tail_bytes(grids, patterns, itemsize, first - 1, vs=2) > smem
