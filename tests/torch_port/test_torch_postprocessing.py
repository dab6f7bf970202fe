"""Norms, sensors, timers and the problem's checkpoint helpers of the port,
against the JAX package's where it has them (float64, CPU).

Norms and sensors read the same seeded numpy fields in both packages and
agree within 1e-12; the sensors also locate points in a graded interval
mesh (a huge cell beyond the 30 nearest midpoints) and in distorted quads
(the Newton inverse map), where a linear field is interpolated exactly. A
checkpoint of either engine's problem, saved and loaded into a new problem,
continues bit-equal.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import fem as jfem
from fenics_constitutive_tpu import postprocessing as jpost
from fenics_constitutive_tpu_torch import fem as tfem
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.postprocessing import (
    DisplacementSensor,
    QPSensor,
    dof_norm,
    norm,
    qp_norm,
)
from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem
from fenics_constitutive_tpu_torch.utils import (
    get_timings,
    load_checkpoint,
    load_state_dict,
    reset_timings,
    save_checkpoint,
    scope,
    state_dict,
    timed,
    timing,
)
from test_torch_problem import bench_box

F64 = torch.float64
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}


@pytest.mark.parametrize("norm_type", ["l2", "inf"])
@pytest.mark.parametrize("shape", [(5, 4), (5, 4, 6)])
def test_norms_match_jax(norm_type, shape):
    rng = np.random.default_rng(3)
    f, w, v = rng.normal(size=shape), rng.random(size=shape[:2]), rng.normal(size=17)
    pairs = [
        (qp_norm(torch.as_tensor(f), torch.as_tensor(w), norm_type),
         jpost.qp_norm(jnp.asarray(f), jnp.asarray(w), norm_type)),
        (norm(torch.as_tensor(f), torch.as_tensor(w), None, norm_type),
         jpost.norm(jnp.asarray(f), jnp.asarray(w), None, norm_type)),
        (dof_norm(torch.as_tensor(v), norm_type), jpost.dof_norm(jnp.asarray(v), norm_type)),
    ]
    for got, ref in pairs:
        assert float(got) == pytest.approx(float(ref), rel=1e-12, abs=0)


def test_norm_options_raise():
    """Unknown norm types raise; a communicator is accepted and ignored, as
    the JAX package ignores it (a sharded problem's fields are whole on
    every rank, so the norm is already global)."""
    f = torch.ones(2, 2)
    with pytest.raises(ValueError, match="unknown norm"):
        qp_norm(f, f, "h1")
    with pytest.raises(ValueError, match="unknown norm"):
        dof_norm(f, "h1")
    rng = np.random.default_rng(4)
    g, w = rng.normal(size=(5, 4, 6)), rng.random(size=(5, 4))
    comm = object()
    for norm_type in ("l2", "inf"):
        got = norm(torch.as_tensor(g), torch.as_tensor(w), comm, norm_type)
        ref = jpost.norm(jnp.asarray(g), jnp.asarray(w), comm, norm_type)
        assert float(got) == pytest.approx(float(ref), rel=1e-12, abs=0)


def tet_problem(engine="auto"):
    V, bcs = bench_box(tfem, "tetra", 3)
    return IncrSmallStrainProblem(VonMises3D(MAT), V, bcs, 1, device="cpu", dtype=F64,
                                  engine=engine), bcs, V


def test_sensors_read_the_solution():
    """ux is affine in x for this BVP; the stress is homogeneous."""
    problem, bcs, V = tet_problem()
    bcs[1].value = 0.02
    problem.solve()
    problem.update()
    vals = DisplacementSensor(V, [[0.5, 0.25, 0.25], [1.0, 0.0, 0.0]])(problem.u)
    assert float(vals[0, 0]) == pytest.approx(0.01, rel=1e-8)
    assert float(vals[1, 0]) == pytest.approx(0.02, rel=1e-12)
    s = QPSensor(V, 1, [[0.4, 0.4, 0.4]])(problem.stress_0)
    assert s.shape == (1, 6)
    np.testing.assert_allclose(s[0].numpy(), problem.stress_0.reshape(-1, 6)[0].numpy(),
                               rtol=1e-9, atol=1e-9)
    n = norm(problem.stress_0, problem.dxm)
    assert float(n) == pytest.approx(float(s.norm()), rel=1e-8)  # unit volume, homogeneous


@pytest.mark.parametrize("cell", ["tetra", "hex", "triangle", "quad"])
def test_sensors_match_jax(cell):
    rng = np.random.default_rng(11)
    dim = 3 if cell in ("tetra", "hex") else 2
    pts = rng.random(size=(5, dim))
    out = {}
    for key, fem, post in (("jax", jfem, jpost), ("torch", tfem, None)):
        mesh = fem.unit_cube_mesh(3, 3, 3, cell) if dim == 3 else fem.unit_square_mesh(3, 3, cell)
        V = fem.FunctionSpace(mesh, 1, dim)
        u = np.random.default_rng(5).normal(size=V.ndofs)
        field = np.random.default_rng(6).normal(size=(mesh.num_cells, 4 if cell != "hex" else 8, 6))
        q = 2
        if key == "jax":
            out[key] = (np.asarray(post.DisplacementSensor(V, pts)(jnp.asarray(u))),
                        np.asarray(post.QPSensor(V, q, pts)(jnp.asarray(field[:, :, :]))))
        else:
            out[key] = (DisplacementSensor(V, pts)(torch.as_tensor(u)).numpy(),
                        QPSensor(V, q, pts)(torch.as_tensor(field)).numpy())
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12 * np.abs(b).max())


def test_sensor_graded_mesh_beyond_candidate_window():
    xs = np.concatenate([np.linspace(0.0, 0.5, 41), [10.0]])
    cells = np.stack([np.arange(len(xs) - 1), np.arange(1, len(xs))], axis=1).astype(np.int32)
    V = tfem.FunctionSpace(tfem.Mesh(xs[:, None], cells, "interval"), 1, 1)
    u = torch.as_tensor(3.0 * V.dof_coords[:, 0] + 1.0)
    np.testing.assert_allclose(DisplacementSensor(V, [[0.55]])(u).numpy(), [[3.0 * 0.55 + 1.0]],
                               rtol=1e-12)


def test_sensor_distorted_quad():
    from dataclasses import replace

    mesh = tfem.unit_square_mesh(4, 4, "quad")
    nodes = mesh.nodes.copy()
    nodes[:, 0] = nodes[:, 0] + 0.2 * nodes[:, 0] * (1 - nodes[:, 0]) * nodes[:, 1]
    V = tfem.FunctionSpace(replace(mesh, nodes=nodes, structured_shape=None), 1, 2)
    x, y = V.dof_coords[:, 0], V.dof_coords[:, 1]
    u = torch.as_tensor(np.stack([2.0 * x - y, y], axis=1).reshape(-1))
    pts = [[0.52, 0.37], [0.13, 0.81], [0.97, 0.55]]
    np.testing.assert_allclose(DisplacementSensor(V, pts)(u).numpy(),
                               [[2.0 * a - b, b] for a, b in pts], rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="not found"):
        DisplacementSensor(V, [[1.5, 0.5]])


def test_timers(monkeypatch):
    """The registry counts and clocks ``timing``/``timed``; without a
    profiler neither they nor ``scope`` enter ``record_function``."""

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    reset_timings()

    @timed("unit-test-scope")
    def f(x):
        return x + 1

    @timed("blocking-scope", block=True)
    def g(x):
        return {"a": (x * 2,)}

    for _ in range(3):
        f(1)
    g(torch.ones(3))
    with timing("manual"):
        time.sleep(0.01)
    with scope("no-registry"):
        pass
    t = get_timings()
    assert t["unit-test-scope"][0] == 3 and t["blocking-scope"][0] == 1
    assert t["manual"][1] >= 0.01
    assert "no-registry" not in t
    reset_timings()
    assert get_timings() == {}


def test_scopes_under_a_profiler():
    """Under torch.profiler ``scope`` and ``timing`` open named scopes,
    nested as written; ``scope`` adds nothing to the registry."""
    from torch.profiler import ProfilerActivity, profile

    reset_timings()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing("outer"):
            for _ in range(2):
                with scope("inner"):
                    torch.ones(4).sum()
    events = [e for e in prof.events() if e.name in ("outer", "inner")]
    assert sorted(e.name for e in events) == ["inner", "inner", "outer"]
    assert all(e.cpu_parent.name == "outer" for e in events if e.name == "inner")
    assert set(get_timings()) == {"outer"}
    reset_timings()


@pytest.mark.parametrize("engine", ["packed", "aos"])
def test_checkpoint_roundtrip(tmp_path, engine):
    """A restored problem continues bit-identically; another engine's
    checkpoint is refused."""
    problem, bcs, _ = tet_problem(engine)
    for k in (1, 2):
        bcs[1].value = 0.01 * k
        problem.solve()
        problem.update()
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, state_dict(problem))
    bcs[1].value = 0.03
    problem.solve()
    problem.update()

    problem2, bcs2, _ = tet_problem(engine)
    load_state_dict(problem2, load_checkpoint(path))
    bcs2[1].value = 0.03
    problem2.solve()
    problem2.update()
    assert torch.equal(problem2.u, problem.u)
    assert torch.equal(problem2.stress_0, problem.stress_0)
    for h1, h2 in zip(problem._history_0, problem2._history_0):
        assert all(torch.equal(h1[k], h2[k]) for k in h1)
    assert problem2.sim_time.current == problem.sim_time.current
    other, _, _ = tet_problem("aos" if engine == "packed" else "packed")
    with pytest.raises(ValueError, match="engine"):
        load_state_dict(other, load_checkpoint(path))
