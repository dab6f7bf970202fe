"""K9, Drucker-Prager's return map as one CUDA kernel
(``ops/cuda_return_map.py``, ``csrc/return_map.cu``).

On the CPU:

* ``dp_return_map_form`` holds for a DruckerPrager3D or
  DruckerPragerHyperbolic3D on a CUDA stress of float32 or float64, and for
  nothing else (a CPU tensor, half precision, a subclass, another law);
* a CPU evaluation runs the plain ``implicit_return_map`` and launches
  nothing;
* the wrapper checks the law, the shapes, the dtypes and the devices before
  it asks for CUDA tensors, and raises for each without a launch.

On the card (marked ``card``; ``python -m pytest tests/torch_port -m card``):
K9 against the plain map run on the CPU, over the cone and the hyperbolic
apex, associated and non-associated flow, float64 and float32, on points
that are at the zero state, elastic, past yield, near the apex, and then
unloading, reloading or flowing on from that state; two launches bit-equal;
a CUDA graph of the law's evaluation replayed under
``set_sync_debug_mode("error")`` bit-equal to the eager call; the launch
counter.

Tolerances of the card comparison, normwise (max |K9 - plain| <= tol *
max |plain| per output). Float64: 1e-12 on stress, alpha and the plastic
strain increment (both stop their Newton at increments of 1e-10 relative,
after which a quadratic step moves the iterate by round-off alone; the two
differ in the order of their sums and the pivot order of their solves);
1e-10 on the tangent (solved from the final Jacobian, whose condition grows
near the apex as 1/sqrt(J2)). Float32: 1e-5 on stress, alpha and the
plastic strain increment (a few float32 roundings, amplified by the local
Newton that stops at its trip cap in float32), 2e-4 on the tangent (the
bar of float32 against float64 in ``test_torch_return_map.py``, set by the
same near-apex points).
"""

import types

import numpy as np
import pytest
import torch

from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch.models import drucker_prager
from fenics_constitutive_tpu_torch.ops import cuda_return_map, mandel
from fenics_constitutive_tpu_torch.ops.cuda_return_map import dp_return_map, dp_return_map_form
from fenics_constitutive_tpu_torch.solver import compiled

F64, F32 = torch.float64, torch.float32
DP = {"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15, "b_flow": 0.15}
LAWS = {
    "cone": (tm.DruckerPrager3D, DP),
    "cone non-associated": (tm.DruckerPrager3D, {**DP, "b_flow": 0.05}),
    "hyperbolic": (tm.DruckerPragerHyperbolic3D, {**DP, "d": 0.1}),
    "hyperbolic non-associated": (tm.DruckerPragerHyperbolic3D, {**DP, "d": 0.1, "b_flow": 0.0}),
}
#: (stress, alpha and plastic strain; tangent)
TOL = {F64: (1e-12, 1e-10), F32: (1e-5, 2e-4)}
#: points of each kind: 4 P points fill three blocks of 128 and part of a fourth
P = 100


class _Subclass(tm.DruckerPrager3D):
    pass


def law(name):
    cls, params = LAWS[name]
    return cls(params)


def _dev_mandel(rng, n):
    m = rng.normal(size=(n, 6))
    m[:, :3] -= m[:, :3].mean(axis=1, keepdims=True)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def increments(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two Mandel strain increments [4 P, 6]. The first from the zero state:
    none, elastic (1e-4), past yield (a trial sqrt(J2) of 1.2-4 a, mostly
    deviatoric), and near the apex (a trial I1 of 95-99% of a/b with 1.5-3
    times the deviator that yields there). The second (2e-4) unloads,
    reloads or flows on from the first's state; at the points near the apex
    it is deviatoric. A volumetric 2e-4 there would carry some trial I1 past
    a/b, where the local Newton of both maps stops at its trip cap, and
    the two unconverged iterates agree in nothing but that."""
    rng = np.random.default_rng(seed)
    mu, ka, a, b = DP["mu"], DP["kappa"], DP["a"], DP["b"]
    elastic = rng.normal(size=(P, 6)) * 1e-4
    plastic = _dev_mandel(rng, P) * (rng.uniform(1.2, 4.0, P) * a / (np.sqrt(2.0) * mu))[:, None]
    plastic[:, :3] += rng.uniform(-1e-3, 1e-3, (P, 1)) / 3.0
    delta = rng.uniform(0.01, 0.05, P)
    near = _dev_mandel(rng, P) * (rng.uniform(1.5, 3.0, P) * delta * a / (np.sqrt(2.0) * mu))[:, None]
    near[:, :3] += ((a / b) * (1.0 - delta) / (9.0 * ka))[:, None]
    first = np.concatenate([np.zeros((P, 6)), elastic, plastic, near])
    second = rng.normal(size=(4 * P, 6)) * 2e-4
    second[3 * P:, :3] -= second[3 * P:, :3].mean(axis=1, keepdims=True)
    return first, second


def grad_of(eps: np.ndarray, dtype, device) -> torch.Tensor:
    g = mandel.mandel_to_matrix(torch.as_tensor(eps, dtype=F64), mandel.Constraint.FULL)
    return g.to(device, dtype)


def path(m, dtype, device, seed):
    """The law through both increments from the zero state on ``device``:
    [(stress, tangent, history)] of each."""
    n = 4 * P
    s, h = torch.zeros((n, 6), dtype=dtype, device=device), m.init_history(n, dtype=dtype,
                                                                           device=device)
    out = []
    for eps in increments(seed):
        s, t, h = m.evaluate(0.0, 0.5, grad_of(eps, dtype, device), s, h)
        out.append((s, t, h))
    return out


def close(got, ref, tol, what):
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    assert torch.isfinite(got).all(), what
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    assert err <= tol * scale, f"{what}: max |K9 - plain| {err:.3e} > {tol:g} x {scale:.3e}"


def stand_in(dtype):
    """What the form reads of a CUDA stress, without a card."""
    return types.SimpleNamespace(is_cuda=True, dtype=dtype)


FORMS = {
    "cone f64": (lambda: law("cone"), lambda: stand_in(F64), True),
    "cone f32": (lambda: law("cone"), lambda: stand_in(F32), True),
    "hyperbolic f64": (lambda: law("hyperbolic"), lambda: stand_in(F64), True),
    "hyperbolic f32": (lambda: law("hyperbolic"), lambda: stand_in(F32), True),
    "half precision": (lambda: law("cone"), lambda: stand_in(torch.float16), False),
    "CPU tensor": (lambda: law("cone"), lambda: torch.zeros((4, 6), dtype=F64), False),
    "a subclass": (lambda: _Subclass(DP), lambda: stand_in(F64), False),
    "von Mises": (lambda: tm.VonMises3D({"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0,
                                         "p_y00": 2500.0, "p_w": 200.0}),
                  lambda: stand_in(F64), False),
}


@pytest.mark.parametrize("case", list(FORMS))
def test_dp_return_map_form(case):
    make_law, make_stress, expected = FORMS[case]
    assert dp_return_map_form(make_law(), make_stress()) is expected


@pytest.mark.parametrize("name", ["cone", "hyperbolic"])
def test_cpu_evaluate_takes_the_plain_map(name, monkeypatch):
    calls = []
    plain = drucker_prager.implicit_return_map

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(drucker_prager, "implicit_return_map", counted)
    before = dict(cuda_return_map.launches)
    (s, t, h), _ = path(law(name), F64, "cpu", 4)
    assert len(calls) == 2 and cuda_return_map.launches == before
    assert s.shape == (4 * P, 6) and t.shape == (4 * P, 6, 6) and h["alpha"].shape == (4 * P, 1)
    assert (h["alpha"][2 * P:] > 0).all()  # past yield and near the apex: plastic


@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_elastic_entries_match_the_plain_c(dtype):
    """The three entries of C that K9 takes are the plain map's C rounded
    alike (its elastic points write them as the tangent), and computing them
    reads no tensor back to the host, as a first call inside a captured step
    must not."""
    cuda_return_map._elastic.cache_clear()
    with compiled.no_host_sync():
        c_d, c_o, c_s = cuda_return_map._elastic(DP["mu"], DP["kappa"], dtype)
    C = mandel.isotropic_elastic_tangent(DP["mu"], DP["kappa"], dtype=dtype)
    ref = torch.tensor([[c_d if i == k else c_o for k in range(3)] for i in range(3)], dtype=dtype)
    assert torch.equal(C[:3, :3], ref) and torch.equal(C[3:, 3:], c_s * torch.eye(3, dtype=dtype))
    assert (C[:3, 3:] == 0).all() and (C[3:, :3] == 0).all()


GUARDS = {
    "not a Drucker-Prager law": (ValueError, "DruckerPrager3D"),
    "stress shape": (ValueError, "stress of shape"),
    "del_eps shape": (ValueError, "del_eps of shape"),
    "alpha shape": (ValueError, "alpha of shape"),
    "integer dtype": (TypeError, "float32 or float64"),
    "mixed dtypes": (TypeError, "all alike"),
    "mixed devices": (ValueError, "mixed devices"),
    "CPU tensors": (ValueError, "CUDA tensors"),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_dp_return_map_guards(case):
    """The wrapper checks its law, shapes, dtypes and devices before it asks
    for CUDA tensors, so each guard raises here on CPU tensors; a call on
    CPU tensors that passes them all still raises instead of running the
    plain map. Nothing is launched."""
    error, match = GUARDS[case]
    m, Q = law("cone"), 5
    s, e, a = torch.zeros((Q, 6), dtype=F64), torch.zeros((Q, 6), dtype=F64), torch.zeros(
        (Q, 1), dtype=F64)
    if case == "not a Drucker-Prager law":
        m = _Subclass(DP)
    elif case == "stress shape":
        s = s[None]
    elif case == "del_eps shape":
        e = e[:, :3]
    elif case == "alpha shape":
        a = a[:, 0]
    elif case == "integer dtype":
        s, e, a = s.int(), e.int(), a.int()
    elif case == "mixed dtypes":
        e = e.float()
    elif case == "mixed devices":
        a = a.to("meta")
    before = dict(cuda_return_map.launches)
    with pytest.raises(error, match=match):
        dp_return_map(m, s, e, a)
    assert cuda_return_map.launches == before


# -- on the card ------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", list(LAWS))
def test_k9_matches_the_plain_map(card, name, dtype):
    tol, tol_t = TOL[dtype]
    before = cuda_return_map.launches["dp_return_map"]
    ours = path(law(name), dtype, card, 7)
    assert cuda_return_map.launches["dp_return_map"] - before == 2
    ref = path(law(name), dtype, "cpu", 7)
    for k, ((s, t, h), (sr, tr, hr)) in enumerate(zip(ours, ref)):
        assert s.dtype == t.dtype == h["alpha"].dtype == dtype and s.is_cuda
        # the plain map's memory order of the tangent, which the dense operator reads
        assert t.stride() == tr.stride() == (36, 1, 6)
        close(s, sr, tol, f"stress, increment {k}")
        close(h["alpha"], hr["alpha"], tol, f"alpha, increment {k}")
        close(h["plastic_strain"], hr["plastic_strain"], tol, f"plastic strain, increment {k}")
        close(t, tr, tol_t, f"tangent, increment {k}")
    # every kind of point is there: the zero state and elastic, then plastic
    alpha = ref[0][2]["alpha"][:, 0]
    assert (alpha[: 2 * P] == 0).all() and (alpha[2 * P:] > 0).all()
    C = mandel.isotropic_elastic_tangent(DP["mu"], DP["kappa"], dtype=dtype)
    assert torch.equal(ours[0][1][: 2 * P].cpu(), C.expand(2 * P, 6, 6))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_k9_launches_bit_equal(card, dtype):
    m = law("hyperbolic non-associated")
    first, _ = increments(5)
    n = 4 * P
    s = torch.zeros((n, 6), dtype=dtype, device=card)
    e = mandel.strain_from_grad_u(grad_of(first, dtype, card), mandel.Constraint.FULL)
    a = torch.zeros((n, 1), dtype=dtype, device=card)
    one, two = dp_return_map(m, s, e, a), dp_return_map(m, s, e, a)
    assert all(torch.equal(x, y) for x, y in zip(one, two))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [F64, F32], ids=["f64", "f32"])
def test_k9_replays_bit_equal_from_a_cuda_graph(card, dtype):
    """The law's packed evaluation (the generic adapter, as the engines call
    it) captured in a CUDA graph: no host read under the sync guard, the
    capture and the replays count no launch, and each replay equals the
    eager call bit for bit."""
    m = law("cone")
    first, _ = increments(6)
    n = 4 * P
    eps = torch.as_tensor(first.T.copy(), dtype=dtype, device=card)  # [6, Q]
    s0 = torch.zeros((6, n), dtype=dtype, device=card)
    h0 = {k: torch.zeros((d, n), dtype=dtype, device=card) for k, d in m.history_dim.items()}
    eager = m.evaluate_packed(0.0, 0.5, eps, s0, h0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        m.evaluate_packed(0.0, 0.5, eps, s0, h0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = cuda_return_map.launches["dp_return_map"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = m.evaluate_packed(0.0, 0.5, eps, s0, h0)
        for _ in range(2):
            graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert cuda_return_map.launches["dp_return_map"] == before
    s, t, h = out
    assert torch.equal(s, eager[0]) and torch.equal(t.C, eager[1].C)
    assert all(torch.equal(h[k], eager[2][k]) for k in h)


@pytest.mark.card
def test_k9_counts_each_cuda_evaluation(card):
    """One launch a CUDA evaluation, through evaluate and through the
    adapter; none for a CPU one or an empty batch."""
    m = law("cone")
    first, _ = increments(8)
    n = 4 * P
    grad = grad_of(first, F64, card)
    s, h = torch.zeros((n, 6), dtype=F64, device=card), m.init_history(n, device=card)
    before = cuda_return_map.launches["dp_return_map"]
    m.evaluate(0.0, 0.5, grad, s, h)
    m.evaluate_packed(0.0, 0.5, torch.zeros((6, n), dtype=F64, device=card),
                      torch.zeros((6, n), dtype=F64, device=card),
                      {k: torch.zeros((d, n), dtype=F64, device=card)
                       for k, d in m.history_dim.items()})
    m.evaluate(0.0, 0.5, grad.cpu(), s.cpu(), {k: v.cpu() for k, v in h.items()})
    empty = dp_return_map(m, s[:0], s[:0], h["alpha"][:0])
    assert [x.shape[0] for x in empty] == [0, 0, 0, 0]
    assert cuda_return_map.launches["dp_return_map"] - before == 2
