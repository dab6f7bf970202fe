"""The general implicit return map (``models/plasticity_general.py``) of the
two Drucker-Prager laws on the CPU, on seeded points that mix the zero state,
elastic increments, plastic ones and returns that end near the cone's apex,
in float64 and float32: against the JAX package's laws (float64), against
the benchmark's plain closed-form cone return (``benchmark/reference/
druckerprager3d.py``, associated flow), finite everywhere, and the same
under the stand-in of a captured step (``HostRecorder``).

Tolerances, normwise (max |port - ref| <= tol * max |ref| per output):
float64 1e-9 (the JAX comparison's bar in test_torch_models.py; the
local Newton stops at 1e-10 increments). Float32 against a float64
reference: 5e-6 on stress and histories (measured <= 9.0e-7 over five
seeds), 2e-4 on the consistent tangent (measured <= 6.0e-5: near the apex
its deviatoric part grows as 1/sqrt(J2), and the Jacobian it is solved
from loses digits there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark.reference import druckerprager3d as reference
from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch.models import plasticity_general
from fenics_constitutive_tpu_torch.ops import mandel
from fenics_constitutive_tpu_torch.solver import compiled
from test_torch_compiled import HostRecorder

F64, F32 = torch.float64, torch.float32
DP = {"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15, "b_flow": 0.15}
DPH = {**DP, "d": 0.1}
LAWS = {"dp": (tm.DruckerPrager3D, jm.DruckerPrager3D, DP),
        "dp-hyp": (tm.DruckerPragerHyperbolic3D, jm.DruckerPragerHyperbolic3D, DPH)}
#: (stress and histories, tangent)
TOL = {F64: (1e-9, 1e-9), F32: (5e-6, 2e-4)}
#: points of each kind
P = 12


def _dev_mandel(rng, n):
    """n random unit deviators in Mandel notation [n, 6]."""
    m = rng.normal(size=(n, 6))
    m[:, :3] -= m[:, :3].mean(axis=1, keepdims=True)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def first_increments(seed: int) -> np.ndarray:
    """Mandel strain increments [4 P, 6] from the zero state: none (the zero
    state), elastic (1e-4), plastic (mostly deviatoric), and near the apex: a trial I1 of 95-99% of a/b with a deviator
    of 1.5-3 times what yields there, so the return ends on the cone's
    smooth part close to its tip (the closed form holds)."""
    rng = np.random.default_rng(seed)
    mu, ka, a, b = DP["mu"], DP["kappa"], DP["a"], DP["b"]
    zero = np.zeros((P, 6))
    elastic = rng.normal(size=(P, 6)) * 1e-4
    # a trial sqrt(J2) of 1.2-4 a and |b I1| under 0.08 a: past the cone
    plastic = _dev_mandel(rng, P) * (rng.uniform(1.2, 4.0, P) * a / (np.sqrt(2.0) * mu))[:, None]
    plastic[:, :3] += rng.uniform(-1e-3, 1e-3, (P, 1)) / 3.0
    delta = rng.uniform(0.01, 0.05, P)
    i1_tr = (a / b) * (1.0 - delta)
    sq_tr = rng.uniform(1.5, 3.0, P) * delta * a
    # trial from zero: I1 = 3 kappa tr(eps), sqrt(J2) = sqrt(2) mu |dev eps|
    near = _dev_mandel(rng, P) * (sq_tr / (np.sqrt(2.0) * mu))[:, None]
    near[:, :3] += (i1_tr / (9.0 * ka))[:, None]
    return np.concatenate([zero, elastic, plastic, near])


def second_increments(seed: int) -> np.ndarray:
    """Small increments [4 P, 6] (2e-4) from the first's state: unloading,
    reloading and further flow from a plastic pre-state."""
    return np.random.default_rng(seed + 1).normal(size=(4 * P, 6)) * 2e-4


def grad_of(eps: np.ndarray) -> torch.Tensor:
    """The symmetric gradient [n, 3, 3] of Mandel strains [n, 6]."""
    return mandel.mandel_to_matrix(torch.as_tensor(eps, dtype=F64), mandel.Constraint.FULL)


def close(got, ref, tol, what):
    got = np.asarray(torch.as_tensor(got).to(F64))
    ref = np.asarray(ref, np.float64)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def port_path(name, dtype, seed):
    """The port's law through both increments: [(stress, tangent, history)]."""
    law = LAWS[name][0](LAWS[name][2])
    n = 4 * P
    s, h = torch.zeros((n, 6), dtype=dtype), law.init_history(n, dtype=dtype)
    out = []
    for eps in (first_increments(seed), second_increments(seed)):
        s, t, h = law.evaluate(0.0, 0.5, grad_of(eps).to(dtype), s, h)
        out.append((s, t, h))
    return out


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(LAWS))
def test_return_map_matches_jax(name, dtype):
    jl = LAWS[name][1](LAWS[name][2])
    n, (tol, tol_t) = 4 * P, TOL[dtype]
    sj, hj = jnp.zeros((n, 6)), jl.init_history(n)
    for k, ((st, tt, ht), eps) in enumerate(zip(port_path(name, dtype, 7),
                                                (first_increments(7), second_increments(7)))):
        sj, tj, hj = jl.evaluate(0.0, 0.5, jnp.asarray(grad_of(eps).numpy()), sj, hj)
        assert st.dtype == tt.dtype == ht["alpha"].dtype == dtype
        close(st, sj, tol, f"stress, increment {k}")
        close(tt, tj, tol_t, f"tangent, increment {k}")
        for key in hj:
            close(ht[key], hj[key], tol, f"history {key}, increment {k}")
        if k == 0:  # every kind of point is there: two elastic kinds, two plastic
            alpha = np.asarray(hj["alpha"])[:, 0]
            assert (alpha[: 2 * P] == 0).all() and (alpha[2 * P:] > 0).all()


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_return_map_matches_the_closed_form_cone(dtype):
    """DruckerPrager3D against the benchmark's plain reference, which returns
    in closed form along the trial deviator (associated flow)."""
    tol = TOL[dtype][0]
    ref = reference.zero_state(4 * P, "cpu")
    for k, ((st, _, ht), eps) in enumerate(zip(port_path("dp", dtype, 11),
                                               (first_increments(11), second_increments(11)))):
        ref = reference.update(DP, torch.as_tensor(eps, dtype=F64), ref, 0.5)
        close(st, ref["stress"], tol, f"stress, increment {k}")
        close(ht["alpha"][:, 0], ref["alpha"], tol, f"alpha, increment {k}")
        close(ht["plastic_strain"], ref["plastic_strain"], tol, f"plastic strain, increment {k}")
    # the near-apex returns end close to the tip: sqrt(J2) under a tenth of a
    _, j2, _ = mandel.i1_j2_dev(ref["stress"][3 * P:])
    assert (j2.sqrt() < 0.1 * DP["a"]).all() and (ref["alpha"][3 * P:] > 0).all()


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(LAWS))
def test_return_map_is_finite_at_every_point(name, dtype):
    """Elastic and zero-state points meet singular or unconverged lanes only
    through torch.where: their stress, tangent and histories are finite and
    elastic (C, the trial stress, unchanged histories)."""
    (s, t, h), _ = port_path(name, dtype, 3)
    for v in (s, t, h["alpha"], h["plastic_strain"]):
        assert torch.isfinite(v).all()
    C = mandel.isotropic_elastic_tangent(DP["mu"], DP["kappa"], dtype=dtype)
    assert torch.equal(t[: 2 * P], C.expand(2 * P, 6, 6))
    assert (s[:P] == 0).all() and (h["alpha"][: 2 * P] == 0).all()
    assert (h["plastic_strain"][: 2 * P] == 0).all()


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_return_map_replays_bit_equal(dtype, monkeypatch):
    """Captured by the stand-in recorder under the sync guard, the return map
    reads nothing back to the host, records its trips as one while node and
    replays to the eager result bit for bit; the eager loop runs the same
    number of trips."""
    law = tm.DruckerPrager3D(DP)
    n = 4 * P
    grad = grad_of(first_increments(5)).to(dtype)
    s0, h0 = torch.zeros((n, 6), dtype=dtype), law.init_history(n, dtype=dtype)
    trips = []
    real = plasticity_general.device_while

    def counted(cond, body, carry, **kw):
        def trip(c):
            trips.append(kw["name"])
            return body(c)

        return real(cond, trip, carry, **kw)

    monkeypatch.setattr(plasticity_general, "device_while", counted)
    eager = law.evaluate(0.0, 0.5, grad, s0, h0)
    n_eager = len(trips)
    rec = HostRecorder("cpu")
    with compiled.no_host_sync():
        rec.capture(lambda: law.evaluate(0.0, 0.5, grad, s0, h0))
    rec.replay()
    assert len(rec.loops) == 1 and rec.trips == [n_eager] and 1 < n_eager <= law.newton_maxit
    assert set(trips) == {"law.trip"}
    s, t, h = rec.out
    assert torch.equal(s, eager[0]) and torch.equal(t, eager[1])
    assert all(torch.equal(h[k], eager[2][k]) for k in h)


def test_adapter_returns_a_contiguous_state():
    """The generic adapter hands back stress and history laid out as the
    engines build the state (contiguous), so a compiled step, whose static
    buffers take the first call's layout, reduces them in the same order as
    the eager step."""
    law = tm.DruckerPrager3D(DP)
    eps = torch.as_tensor(first_increments(9).T.reshape(6, 4, P).copy(), dtype=F64)
    hist = {k: torch.zeros((d, 4, P), dtype=F64) for k, d in law.history_dim.items()}
    s, _, h = law.evaluate_packed(0.0, 0.5, eps, torch.zeros((6, 4, P), dtype=F64), hist)
    assert s.shape == (6, 4, P) and s.is_contiguous()
    assert all(v.is_contiguous() and v.shape[1:] == (4, P) for v in h.values())
