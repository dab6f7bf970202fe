"""The port's native bridge (ctypes over native/include/comfe.h, built with
the system's C and C++ compilers) against the JAX package's native models
(whose bindings load the port's build of the same library here) and
against the port's own models, float64 on the CPU: the same seeded
gradients through both, each native law within 1e-14 of the JAX package's
binding and within the JAX test's tolerance of its Python twin, and a
problem solve with a native law within 1e-10 of the same solve with the
port's model. Operands are never written, and a point whose return map
diverges comes back NaN at that point only. Skipped only where the machine
has no C++ compiler.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import native as jnative
from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch import native
from fenics_constitutive_tpu_torch.ops import mandel
from test_torch_problem import bench_box, make_problem

F64 = torch.float64
MU, KAPPA = 80769.0, 175000.0
E = 9.0 * KAPPA * MU / (3.0 * KAPPA + MU)
NU = (3.0 * KAPPA - 2.0 * MU) / (2.0 * (3.0 * KAPPA + MU))
MISES = {"mu": MU, "kappa": KAPPA, "y_0": 1200.0, "h": 200.0}
DP = {"mu": MU, "kappa": KAPPA, "a": 1000.0, "b": 0.2, "b_flow": 0.2}
DPH = {**DP, "d": 50.0}


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's build of the library, which the JAX package's bindings
    load too: both wrappers then call the same binary, and no cmake build
    of the JAX package's runs beside its own tests."""
    if shutil.which("c++") is None or shutil.which("cc") is None:
        pytest.skip("no C/C++ compiler on this machine")
    lib = native.ensure_built()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "ensure_built", lambda force=False: lib)
        mp.setattr(jnative, "_BUILD_DIR", lib.parent)
        mp.setattr(jnative, "_LIB", None)
        yield


def rand_grad(q, seed=0, scale=2e-3):
    return np.random.default_rng(seed).normal(size=(q, 3, 3)) * scale


def run(model, grad, stress=None, history=None):
    q = grad.shape[0]
    s0 = np.zeros((q, 6)) if stress is None else stress
    if isinstance(model, tm.IncrSmallStrainModel):
        h = model.init_history(q) if history is None else history
        return model.evaluate(0.0, 1.0, torch.as_tensor(grad), torch.as_tensor(s0), h)
    h = model.init_history(q) if history is None else history
    out = model.evaluate(0.0, 1.0, jnp.asarray(grad), jnp.asarray(s0), h)
    return tuple(out)


def close(a, b, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["linear_elasticity3d", "mises_linear_hardening3d",
                                  "drucker_prager3d", "drucker_prager_hyperbolic3d"])
def test_native_matches_the_jax_package_native(name):
    params = {"linear_elasticity3d": {"mu": MU, "kappa": KAPPA}, "mises_linear_hardening3d":
              MISES, "drucker_prager3d": DP, "drucker_prager_hyperbolic3d": DPH}[name]
    grad = rand_grad(8, scale=5e-3)
    s_t, t_t, h_t = run(native.NativeModel(name, params), grad)
    s_j, t_j, h_j = run(jnative.NativeModel(name, params), grad)
    close(s_t, s_j, 1e-14)
    close(t_t, t_j, 1e-14)
    if h_t is not None:
        close(h_t["history"], h_j["history"], 1e-14)


def test_native_linear_elasticity_matches_the_port_model():
    ref = tm.LinearElasticityModel({"E": E, "nu": NU}, tm.Constraint.FULL)
    grad = rand_grad(16)
    s_n, t_n, h_n = run(native.LinearElasticity3D({"mu": MU, "kappa": KAPPA}), grad)
    s_r, t_r, _ = run(ref, grad)
    close(s_n, s_r, 1e-10)
    close(t_n, t_r, 1e-10)
    assert h_n is None


def test_native_mises_matches_the_port_model():
    native_m = native.NativeModel("mises_linear_hardening3d", MISES)
    ref = tm.MisesPlasticityLinearHardening3D(MISES)
    grad = rand_grad(8, scale=5e-3)
    s_n, t_n, h_n = run(native_m, grad)
    s_r, t_r, h_r = run(ref, grad)
    close(s_n, s_r, 1e-10)
    close(t_n, t_r, 1e-9, 1e-6)
    close(h_n["history"][:, 0:1], h_r["alpha"], 1e-10)
    close(h_n["history"][:, 1:7], h_r["plastic_strain"], 1e-9, 1e-12)


@pytest.mark.parametrize(("name", "cls", "params"), [
    ("drucker_prager3d", "DruckerPrager3D", DP),
    ("drucker_prager_hyperbolic3d", "DruckerPragerHyperbolic3D", DPH)])
def test_native_drucker_prager_matches_the_port_model(name, cls, params):
    grad = np.zeros((3, 3, 3))
    grad[:, 0, 0], grad[:, 0, 1] = 0.005, 0.006
    s_n, t_n, h_n = run(native.NativeModel(name, params), grad)
    s_r, t_r, h_r = run(getattr(tm, cls)(params), grad)
    close(s_n, s_r, 1e-6)
    close(t_n, t_r, 1e-4, 1.0)
    close(h_n["history"][:, 0:1], h_r["alpha"], 1e-6)


def test_umat_linear_elastic_matches_the_port_model():
    law = native.UmatModel(native.umat_demo_path(), [E, NU], n_statev=1)
    ref = tm.LinearElasticityModel({"E": E, "nu": NU}, tm.Constraint.FULL)
    grad = rand_grad(5, seed=3)
    s_u, t_u, h_u = run(law, grad)
    s_r, t_r, _ = run(ref, grad)
    close(s_u, s_r, 1e-10)
    close(t_u, t_r, 1e-10)
    eps = mandel.strain_from_grad_u(torch.as_tensor(grad), tm.Constraint.FULL)
    close(h_u["strain"], eps, 1e-12)
    s_u2, _, h_u2 = law.evaluate(1.0, 1.0, torch.as_tensor(grad), s_u, h_u)
    close(s_u2, 2 * s_r, 1e-10)
    close(h_u2["strain"], 2 * eps, 1e-12)
    s_j, t_j, h_j = run(jnative.UmatModel(str(jnative.umat_demo_path()), [E, NU], n_statev=1),
                        grad)
    close(s_u, s_j, 1e-14)
    close(h_u["statev"], h_j["statev"], 0)


def test_umat_real_fortran_payload():
    path = native.umat_fortran_path()
    if path is None:
        pytest.skip("no Fortran compiler on this machine")
    law = native.UmatModel(path, [E, NU], n_statev=1)
    grad = rand_grad(5, seed=7)
    s_f, t_f, h_f = run(law, grad)
    s_r, t_r, _ = run(tm.LinearElasticityModel({"E": E, "nu": NU}, tm.Constraint.FULL), grad)
    close(s_f, s_r, 1e-10)
    close(t_f, t_r, 1e-10)
    close(h_f["statev"][:, 0], 1.0, 0)


@pytest.mark.parametrize(("native_law", "port_law"), [
    (lambda: native.LinearElasticity3D({"mu": MU, "kappa": KAPPA}),
     lambda: tm.LinearElasticityModel({"E": E, "nu": NU}, tm.Constraint.FULL)),
    (lambda: native.NativeModel("mises_linear_hardening3d", MISES),
     lambda: tm.MisesPlasticityLinearHardening3D(MISES)),
    (lambda: native.UmatModel(native.umat_demo_path(), [E, NU], n_statev=1),
     lambda: tm.LinearElasticityModel({"E": E, "nu": NU}, tm.Constraint.FULL)),
], ids=["linear_elasticity3d", "mises", "umat"])
@pytest.mark.parametrize("engine", ["packed", "aos"])
def test_native_law_in_a_problem(native_law, port_law, engine):
    """Two load steps into the plastic range: the native law's solution is
    the port model's."""
    out = []
    for law in (native_law(), port_law()):
        V, bcs = bench_box(__import__("fenics_constitutive_tpu_torch").fem, "tetra", 1)
        p = make_problem("torch", law, V, bcs, 1, engine=engine)
        for k in (1, 2):
            bcs[1].value = 0.01 * k
            assert p.solve()[1]
            p.update()
        out.append((p.u, p.stress_0))
    (u_n, s_n), (u_r, s_r) = out
    close(u_n, u_r, 0, 1e-10 * float(u_r.abs().max()))
    close(s_n, s_r, 0, 1e-10 * float(s_r.abs().max()))


def test_native_divergence_poisons_per_point():
    m = native.NativeModel("drucker_prager3d", {"mu": 80.0, "kappa": 175.0, "a": 0.1, "b": 0.9,
                                                "b_flow": 0.9})
    grad = np.zeros((4, 3, 3))
    grad[0, 0, 0] = grad[0, 1, 1] = grad[0, 2, 2] = 50.0
    grad[1, 0, 0] = 1e-5
    s, _, _ = run(m, grad, history={"history": torch.zeros(4, 7, dtype=F64)})
    assert torch.isnan(s[0]).all() and torch.isfinite(s[1:]).all()


def test_native_evaluate_never_writes_its_operands():
    m = native.NativeModel("mises_linear_hardening3d", MISES)
    grad = torch.as_tensor(rand_grad(8, seed=3, scale=5e-3))
    s0 = torch.as_tensor(np.random.default_rng(4).normal(size=(8, 6)))
    h0 = m.init_history(8)
    copies = [x.clone() for x in (grad, s0, h0["history"])]
    a = m.evaluate(0.0, 1.0, grad, s0, h0)
    b = m.evaluate(0.0, 1.0, grad, s0, h0)
    assert all(torch.equal(x, y) for x, y in zip((grad, s0, h0["history"]), copies))
    assert torch.equal(a[0], b[0]) and torch.equal(a[2]["history"], b[2]["history"])
    assert a[0].dtype == F64 and a[0].device == s0.device


def test_native_float32_stays_float32():
    m = native.LinearElasticity3D({"mu": MU, "kappa": KAPPA})
    g = torch.as_tensor(rand_grad(3), dtype=torch.float32)
    s, t, _ = m.evaluate(0.0, 1.0, g, torch.zeros(3, 6), None)
    assert s.dtype == t.dtype == torch.float32


def test_unknown_native_model_raises():
    with pytest.raises(ValueError, match="unknown native model"):
        native.NativeModel("nope", {})
