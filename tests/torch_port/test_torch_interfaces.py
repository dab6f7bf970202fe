"""The AoS half of the port's model interface against the JAX package's:
rotate_history (the cases of tests/models/test_rotatable_history.py, the
same seeded numpy histories through both, within 1e-12), as_param_dict
(0-d tensors, so a float32 evaluate stays float32), and matrix-valued
history entries (tests/models/test_matrix_history.py's cases) through the
problem on both engines and through PackedSimulation."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu.models import interfaces as jint
from fenics_constitutive_tpu.ops import mandel as jmandel
from fenics_constitutive_tpu_torch.models import VonMises3D
from fenics_constitutive_tpu_torch.models.interfaces import (
    Constraint,
    IncrSmallStrainModel,
    as_param_dict,
    rotate_history,
)
from fenics_constitutive_tpu_torch.ops import mandel
from fenics_constitutive_tpu_torch.solver import IncrSmallStrainProblem, PackedSimulation
from test_torch_problem import run_case

F64 = torch.float64
HD = {"plastic_strain": 6, "fiber": 3, "fabric": (3, 3), "alpha": 1}
ROT = frozenset({"plastic_strain", "fiber", "fabric"})


def rot_model(base, hd=HD, rot=ROT):
    class RotModel(base):
        @property
        def constraint(self):
            return Constraint.FULL if base is IncrSmallStrainModel else jint.Constraint.FULL

        @property
        def history_dim(self):
            return hd

        @property
        def rotatable_history(self):
            return rot

        def evaluate(self, t, del_t, grad_del_u, stress, history):
            raise NotImplementedError

    return RotModel()


def rot_z(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rand_history(n, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(n, *((d,) if isinstance(d, int) else d))) for k, d in HD.items()}


def both(h_np, R):
    got = rotate_history(rot_model(IncrSmallStrainModel), {k: torch.as_tensor(v) for k, v in
                                                          h_np.items()}, R)
    ref = jint.rotate_history(rot_model(jint.IncrSmallStrainModel),
                              {k: jnp.asarray(v) for k, v in h_np.items()}, R)
    for k in h_np:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-12)
    return got


def test_identity_rotation_is_noop():
    h = rand_history(7)
    out = both(h, np.eye(3))
    for k in h:
        np.testing.assert_allclose(out[k].numpy(), h[k], atol=1e-14)


def test_mandel_vector_rotates_as_tensor_conjugation():
    h = rand_history(5, seed=1)
    R = rot_z(0.7)
    out = both(h, R)
    A = mandel.mandel_to_matrix(torch.as_tensor(h["plastic_strain"]), Constraint.FULL).numpy()
    got = mandel.mandel_to_matrix(out["plastic_strain"], Constraint.FULL).numpy()
    np.testing.assert_allclose(got, np.einsum("ij,qjk,lk->qil", R, A, R), atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(out["plastic_strain"].numpy(), axis=1),
                               np.linalg.norm(h["plastic_strain"], axis=1), rtol=1e-12)
    ref = np.asarray(jmandel.mandel_to_matrix(jnp.asarray(h["plastic_strain"]), jint.Constraint.FULL))
    np.testing.assert_allclose(A, ref, atol=0)


def test_matrix_vector_and_scalar_rules():
    h = rand_history(4, seed=2)
    R = rot_z(-1.2)
    out = both(h, R)
    np.testing.assert_allclose(out["fabric"].numpy(), np.einsum("ij,qjk,lk->qil", R, h["fabric"], R),
                               atol=1e-12)
    np.testing.assert_allclose(out["fiber"].numpy(), np.einsum("ij,qj->qi", R, h["fiber"]),
                               atol=1e-12)
    np.testing.assert_array_equal(out["alpha"].numpy(), h["alpha"])


def test_per_qp_rotations_and_inverse_roundtrip():
    n = 6
    h = rand_history(n, seed=3)
    R = np.stack([rot_z(t) for t in np.linspace(0.1, 2.0, n)])
    out = both(h, R)
    back = rotate_history(rot_model(IncrSmallStrainModel), out, np.transpose(R, (0, 2, 1)))
    for k in h:
        np.testing.assert_allclose(back[k].numpy(), h[k], atol=1e-12)


@pytest.mark.parametrize(("hd", "match"), [({"m": (2, 3)}, "must be"), ({"v": 4}, "has dim")])
def test_bad_rotatable_entries_raise(hd, match):
    for base, rot in ((IncrSmallStrainModel, rotate_history), (jint.IncrSmallStrainModel,
                                                               jint.rotate_history)):
        m = rot_model(base, hd, frozenset(hd))
        h = {k: np.zeros((2, *((d,) if isinstance(d, int) else d))) for k, d in hd.items()}
        with pytest.raises(ValueError, match=match):
            rot(m, {k: torch.as_tensor(v) if base is IncrSmallStrainModel else jnp.asarray(v)
                    for k, v in h.items()}, np.eye(3))


def test_default_models_declare_nothing_rotatable():
    m = VonMises3D({"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0,
                    "p_w": 200.0})
    assert m.rotatable_history == frozenset()
    h = m.init_history(3)
    assert rotate_history(m, h, np.eye(3)) is h


# -- as_param_dict ------------------------------------------------------------------


class ParamElasticity(IncrSmallStrainModel):
    """Linear elasticity whose parameters are as_param_dict's 0-d tensors."""

    def __init__(self, parameters):
        self.params = as_param_dict(parameters)

    @property
    def constraint(self):
        return Constraint.FULL

    @property
    def history_dim(self):
        return None

    def evaluate(self, t, del_t, grad_del_u, stress, history):
        E, nu = self.params["E"], self.params["nu"]
        mu, lam = E / (2 * (1 + nu)), E * nu / ((1 + nu) * (1 - 2 * nu))
        eps = mandel.strain_from_grad_u(grad_del_u, Constraint.FULL)
        I2 = torch.as_tensor(mandel.get_identity(Constraint.FULL), dtype=eps.dtype)
        D = 2 * mu * torch.eye(6, dtype=eps.dtype) + lam * I2[:, None] * I2[None, :]
        return stress + (eps[:, None, :] * D).sum(-1), D.expand(eps.shape[0], 6, 6), history


def test_as_param_dict_keeps_float32():
    p = as_param_dict({"E": np.float64(100.0), "nu": 0.3})
    assert all(v.dim() == 0 and v.dtype == F64 for v in p.values())
    law = ParamElasticity({"E": 100.0, "nu": 0.3})
    grad = torch.full((4, 3, 3), 1e-3, dtype=torch.float32)
    s, tg, _ = law.evaluate(0.0, 1.0, grad, torch.zeros(4, 6, dtype=torch.float32), None)
    assert s.dtype == tg.dtype == torch.float32
    s64, _, _ = law.evaluate(0.0, 1.0, grad.double(), torch.zeros(4, 6, dtype=F64), None)
    assert s64.dtype == F64
    np.testing.assert_allclose(s.numpy(), s64.numpy(), rtol=1e-6)


def test_as_param_dict_model_in_a_float32_problem():
    from test_torch_problem import bench_box
    from fenics_constitutive_tpu_torch import fem

    V, bcs = bench_box(fem, "hex", 2)
    bcs[1].value = 0.01
    p = IncrSmallStrainProblem(ParamElasticity({"E": 100.0, "nu": 0.3}), V, bcs, 2,
                               device="cpu", dtype=torch.float32, engine="aos")
    niter, conv = p.solve(rtol=1e-5, atol=1e-9, cg_rtol=1e-7)
    assert conv and p.u.dtype == p.stress_1.dtype == torch.float32


# -- matrix-valued history -------------------------------------------------------------


def strain_tensor_models():
    from fenics_constitutive_tpu.models.interfaces import register_model

    class Port(ParamElasticity):
        @property
        def history_dim(self):
            return {"eps_total": (3, 3), "steps": 1}

        def evaluate(self, t, del_t, grad_del_u, stress, history):
            s, tg, _ = super().evaluate(t, del_t, grad_del_u, stress, None)
            inc = 0.5 * (grad_del_u + grad_del_u.transpose(-1, -2))
            return s, tg, {"eps_total": history["eps_total"] + inc,
                           "steps": history["steps"] + 1.0}

    @register_model
    class Jax(jint.IncrSmallStrainModel):
        def __init__(self, parameters):
            self.params = {k: jnp.asarray(v) for k, v in parameters.items()}

        @property
        def constraint(self):
            return jint.Constraint.FULL

        @property
        def history_dim(self):
            return {"eps_total": (3, 3), "steps": 1}

        def evaluate(self, t, del_t, grad_del_u, stress, history):
            E, nu = self.params["E"], self.params["nu"]
            mu, kappa = E / (2.0 * (1.0 + nu)), E / (3.0 * (1.0 - 2.0 * nu))
            D = jmandel.isotropic_elastic_tangent(mu, kappa, 6)
            eps = jmandel.strain_from_grad_u(grad_del_u, jint.Constraint.FULL)
            inc = 0.5 * (grad_del_u + jnp.swapaxes(grad_del_u, -1, -2))
            return stress + eps @ D.T, jnp.broadcast_to(D, (stress.shape[0], 6, 6)), {
                "eps_total": history["eps_total"] + inc, "steps": history["steps"] + 1.0}

    p = {"E": 100.0, "nu": 0.3}
    return Jax(p), Port(p)


def matrix_setup(fem, m):
    from test_torch_problem import bench_box

    V, bcs = bench_box(fem, "hex", 2)
    law = strain_tensor_models()[0 if m.__name__.startswith("fenics_constitutive_tpu.") else 1]
    return law, V, bcs, 2, {}


def test_init_history_shapes():
    h = strain_tensor_models()[1].init_history(17)
    assert h["eps_total"].shape == (17, 3, 3) and h["steps"].shape == (17, 1)


@pytest.mark.parametrize("engine", ["packed", "aos"])
def test_matrix_history_problem_matches_jax(engine):
    from test_torch_problem import compare, set_bc

    steps = [set_bc(1, 0.01), set_bc(1, 0.02)]
    got = run_case("torch", matrix_setup, steps, engine)
    compare(got, run_case("jax", matrix_setup, steps, engine), 1e-10)
    for k, (obs, disp) in enumerate(zip(got, (0.01, 0.02)), start=1):
        h = obs["hist_1"][0]
        assert h["eps_total"].shape[-2:] == (3, 3)
        np.testing.assert_allclose(h["eps_total"][:, 0, 0], disp, rtol=1e-8)
        np.testing.assert_allclose(h["steps"], k, rtol=0)
        np.testing.assert_allclose(h["eps_total"], np.swapaxes(h["eps_total"], -1, -2),
                                   atol=1e-14)


def test_matrix_history_through_packed_simulation():
    """The generic evaluate_packed adapter stores the [3, 3] entry as [9, *qp];
    PackedSimulation's step gives the problem's state."""
    from test_torch_problem import bench_box
    from fenics_constitutive_tpu_torch import fem

    law = strain_tensor_models()[1]
    V, bcs = bench_box(fem, "hex", 2)
    bcs[1].value = 0.01
    sim = PackedSimulation(law, V, bcs, 2, device="cpu", dtype=F64)
    assert sim.solve()[1]
    h = sim.histories[0]["eps_total"]
    assert h.shape[0] == 9
    h_pk = sim._geos[0].extract_cells(h).reshape(9, -1).numpy()
    p = IncrSmallStrainProblem(law, V, bcs, 2, device="cpu", dtype=F64, engine="aos")
    p.solve()
    h_aos = p._history_1[0]["eps_total"].numpy()
    np.testing.assert_allclose(h_pk.mean(axis=1), h_aos.reshape(-1, 9).mean(axis=0), rtol=1e-8,
                               atol=1e-12)
