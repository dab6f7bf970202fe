"""Every model of the library against the JAX package (float64, CPU).

Each law is carried across with ``utils.model_from_jax`` and driven through
two increments from the zero state, the second from the first's output (a
plastic pre-state for the plastic laws), in both packages on the same
numpy-seeded inputs: the AoS ``evaluate`` on [Q, g, g] gradients, and
``evaluate_packed`` on [s, 3, 5] strain fields (the SoA twin of a hot law,
or the generic adapter with a dense tangent).

Tolerances, normwise (max |port - jax| <= tol * max |jax| per output):
1e-12 for stress, tangent and history (the ROADMAP's single-op bar;
measured <= 1.5e-15 over every law and output). Drucker-Prager: 1e-9 on
every output. Its local Newton stops when an increment falls under atol +
rtol |sol| (1e-10 each), so a round-off may let one package stop one
iterate before the other, which can move the state by up to that
increment; measured <= 3.2e-16 (stress) and <= 5.7e-16 (tangent): both
packages stopped at the same iterate at every point. The DP inputs keep
I1 below the cone's tip a/b, past which both packages' Newton stops at its
trip cap with different non-converged values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenics_constitutive_tpu import models as jm
from fenics_constitutive_tpu.models import packed_models as _jax_packed  # noqa: F401
from fenics_constitutive_tpu_torch import models as tm
from fenics_constitutive_tpu_torch.models import plasticity_general
from fenics_constitutive_tpu_torch.ops import DenseTangent, IsotropicTangent, mandel
from fenics_constitutive_tpu_torch.utils import model_from_jax

F64 = torch.float64
MAT = {"p_ka": 175000.0, "p_mu": 80769.0, "p_y0": 1200.0, "p_y00": 2500.0, "p_w": 200.0}
LIN = {"mu": 80769.0, "kappa": 175000.0, "y_0": 1200.0, "h": 5000.0}
DP = {"mu": 80769.0, "kappa": 175000.0, "a": 1000.0, "b": 0.15, "b_flow": 0.15}
DPH = {**DP, "d": 0.1}
SLS = {"E0": 42000.0, "E1": 10000.0, "tau": 2.0, "nu": 0.3}
ELASTIC = {"E": 42000.0, "nu": 0.3}
C = jm.Constraint

#: the 7 FULL laws of the JAX package's production-path test
#: (tests/solver/test_simulation.py), same parameters
FULL_LAWS = {
    "elastic": lambda: jm.LinearElasticityModel(ELASTIC, C.FULL),
    "mises-exp": lambda: jm.VonMises3D(MAT),
    "mises-lin": lambda: jm.MisesPlasticityLinearHardening3D(LIN),
    "kelvin": lambda: jm.SpringKelvinModel(SLS, C.FULL),
    "maxwell": lambda: jm.SpringMaxwellModel(SLS, C.FULL),
    "dp": lambda: jm.DruckerPrager3D(DP),
    "dp-hyp": lambda: jm.DruckerPragerHyperbolic3D(DPH),
}
OTHER_LAWS = {
    **{f"elastic-{c.name.lower()}": (lambda c=c: jm.LinearElasticityModel(ELASTIC, c))
       for c in (C.UNIAXIAL_STRAIN, C.UNIAXIAL_STRESS, C.PLANE_STRAIN, C.PLANE_STRESS)},
    **{f"{name}-{c.name.lower()}": (lambda cls=cls, c=c: cls(SLS, c))
       for name, cls in (("kelvin", jm.SpringKelvinModel), ("maxwell", jm.SpringMaxwellModel))
       for c in (C.PLANE_STRAIN, C.PLANE_STRESS)},
    "uniaxial-mises-exp": lambda: jm.UniaxialStrainFrom3D(jm.VonMises3D(MAT)),
    "plane-mises-exp": lambda: jm.PlaneStrainFrom3D(jm.VonMises3D(MAT)),
    "uniaxial-mises-lin": lambda: jm.UniaxialStrainFrom3D(
        jm.MisesPlasticityLinearHardening3D(LIN)),
    "plane-mises-lin": lambda: jm.PlaneStrainFrom3D(jm.MisesPlasticityLinearHardening3D(LIN)),
}
ALL_LAWS = {**FULL_LAWS, **OTHER_LAWS}
#: laws whose engines' tangent is factored (the others return a DenseTangent)
FACTORED = ("elastic", "mises-exp", "mises-lin", "kelvin", "maxwell")


def tol_of(name):
    return 1e-9 if name.startswith("dp") else 1e-12


def close(got, ref, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    ref = np.asarray(ref)
    got = np.broadcast_to(got, np.broadcast_shapes(got.shape, ref.shape))
    ref = np.broadcast_to(ref, got.shape)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


def increments(name, law, shape, seed):
    """Two strain-increment fields: Mandel [*shape, s] (AoS) from random
    gradients [*shape, g, g] of amplitude 0.006, past yield for the plastic
    laws; for DP the volumetric part is cut to a tenth, which keeps I1
    below the cone's tip."""
    g = law.constraint.geometric_dim
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        grad = rng.normal(size=(*shape, g, g)) * 0.006
        if name.startswith("dp"):
            tr = np.trace(grad, axis1=-2, axis2=-1)[..., None, None]
            grad = grad - 0.9 * tr / 3.0 * np.eye(g)
        out.append(grad)
    return out


@pytest.mark.parametrize("name", list(ALL_LAWS))
def test_aos_evaluate_matches_jax(name):
    jl = ALL_LAWS[name]()
    tl = model_from_jax(jl)
    assert type(tl).__name__ == type(jl).__name__
    assert tl.constraint.name == jl.constraint.name and tl.history_dim == jl.history_dim
    Q, s, tol = 48, jl.constraint.stress_strain_dim, tol_of(name)
    sj, hj = jnp.zeros((Q, s)), jl.init_history(Q)
    st, ht = torch.zeros((Q, s), dtype=F64), tl.init_history(Q, dtype=F64)
    for k, grad in enumerate(increments(name, jl, (Q,), seed=0)):
        sj, tj, hj = jl.evaluate(0.0, 0.5, jnp.asarray(grad), sj, hj)
        st, tt, ht = tl.evaluate(0.0, 0.5, torch.tensor(grad), st, ht)
        assert tt.shape == (Q, s, s)
        close(st, sj, tol, f"stress, increment {k}")
        close(tt, tj, tol, f"tangent, increment {k}")
        assert (ht is None) == (hj is None)
        for key in hj or {}:
            close(ht[key], hj[key], tol, f"history {key}, increment {k}")
    if "alpha" in (hj or {}):
        assert float(ht["alpha"].max()) > 0  # the pre-state of the second increment was plastic


@pytest.mark.parametrize("name", list(ALL_LAWS))
def test_evaluate_packed_matches_jax(name):
    jl = ALL_LAWS[name]()
    tl = model_from_jax(jl)
    s, tol, shape = jl.constraint.stress_strain_dim, tol_of(name), (3, 5)
    hd = jl.history_dim or {}
    sj, st = jnp.zeros((s, *shape)), torch.zeros((s, *shape), dtype=F64)
    hj = {k: jnp.zeros((d, *shape)) for k, d in hd.items()} or None
    ht = {k: torch.zeros((d, *shape), dtype=F64) for k, d in hd.items()} or None
    for k, grad in enumerate(increments(name, jl, shape, seed=1)):
        eps = np.moveaxis(np.asarray(mandel.strain_from_grad_u(torch.tensor(grad),
                                                               tl.constraint)), -1, 0)
        sj, tj, hj = jl.evaluate_packed(0.0, 0.5, jnp.asarray(eps), sj, hj)
        st, tt, ht = tl.evaluate_packed(0.0, 0.5, torch.tensor(eps), st, ht)
        close(st, sj, tol, f"stress, increment {k}")
        if name in FACTORED:
            assert isinstance(tt, IsotropicTangent)
            for f in ("kappa", "beta", "gamma", "n"):
                close(torch.as_tensor(getattr(tt, f), dtype=F64), getattr(tj, f), tol,
                      f"tangent {f}, increment {k}")
        else:
            assert isinstance(tt, DenseTangent) and tt.C.shape == (s, s, *shape)
            close(tt.C, tj.C, tol, f"dense tangent, increment {k}")
        for key in hj or {}:
            close(ht[key], hj[key], tol, f"history {key}, increment {k}")


@pytest.mark.parametrize("name", ["dp", "dp-hyp"])
def test_drucker_prager_tangent_matches_finite_difference(name, monkeypatch):
    """The consistent tangent against central differences of the port's own
    return map (h = 1e-7 on a strain of 0.005 tension + 0.006 shear, the
    local Newton at 1e-12), as the JAX package's DP test does."""
    law = model_from_jax(FULL_LAWS[name]())
    grad = torch.zeros((1, 3, 3), dtype=F64)
    grad[0, 0, 0], grad[0, 0, 1] = 0.005, 0.006
    trips = []
    loop = plasticity_general.device_while

    def counted(cond, body, carry, **kw):
        return loop(cond, lambda c: trips.append(kw["name"]) or body(c), carry, **kw)

    monkeypatch.setattr(plasticity_general, "device_while", counted)
    _, tangent, hist = law.evaluate(0.0, 1.0, grad, torch.zeros((1, 6), dtype=F64),
                                    law.init_history(1, dtype=F64))
    monkeypatch.undo()
    # the point yielded, and its local Newton converged in a few law.trip trips
    assert float(hist["alpha"][0, 0]) > 0
    assert 1 <= len(trips) < law.newton_maxit and set(trips) == {"law.trip"}
    C_el = mandel.isotropic_elastic_tangent(DP["mu"], DP["kappa"], dtype=F64)
    i2 = torch.as_tensor(mandel.sym_identity(6), dtype=F64)

    def stress_of(eps):
        s, _, _, _ = plasticity_general.implicit_return_map(
            law._f, lambda sig, k: law._g(sig, k, i2), C_el, torch.zeros((1, 6), dtype=F64),
            eps[None], torch.zeros((1, 1), dtype=F64), atol=1e-12, rtol=1e-12, maxit=50)
        return s[0]

    eps0 = mandel.strain_from_grad_u(grad, law.constraint)[0]
    h = 1e-7
    fd = torch.stack([(stress_of(eps0 + h * e) - stress_of(eps0 - h * e)) / (2 * h)
                      for e in torch.eye(6, dtype=F64)], dim=1)
    np.testing.assert_allclose(tangent[0].numpy(), fd.numpy(), rtol=5e-5, atol=1e-2)


def test_generic_adapter_with_matrix_history():
    """A user law with a (3, 3) history entry: the adapter flattens it to 9
    packed components and gives ``evaluate`` [n, 3, 3]; init_history and
    build_packed_problem follow the same shapes."""
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.solver import build_packed_problem

    class Accumulate(tm.LinearElasticityModel):
        """Hooke's law that also sums the gradient increments it saw."""

        @property
        def history_dim(self):
            return {"G": (3, 3), "count": 1}

        def evaluate(self, t, del_t, grad_del_u, stress, history):
            s, tg, _ = super().evaluate(t, del_t, grad_del_u, stress, None)
            return s, tg, {"G": history["G"] + grad_del_u, "count": history["count"] + 1}

        evaluate_packed = tm.IncrSmallStrainModel.evaluate_packed

    law = Accumulate(ELASTIC, tm.Constraint.FULL)
    assert law.init_history(4, dtype=F64)["G"].shape == (4, 3, 3)
    rng = np.random.default_rng(3)
    eps = torch.tensor(rng.normal(size=(6, 2, 5)) * 1e-3)
    hist = {"G": torch.zeros((9, 2, 5), dtype=F64), "count": torch.zeros((1, 2, 5), dtype=F64)}
    s, tg, h = law.evaluate_packed(0.0, 1.0, eps, torch.zeros((6, 2, 5), dtype=F64), hist)
    assert isinstance(tg, DenseTangent) and h["G"].shape == (9, 2, 5)
    G = mandel.mandel_to_matrix(eps.reshape(6, -1).T, tm.Constraint.FULL)
    torch.testing.assert_close(h["G"], G.reshape(-1, 9).T.reshape(9, 2, 5), rtol=0, atol=0)
    assert torch.equal(h["count"], torch.ones((1, 2, 5), dtype=F64))
    # the symmetric gradient rebuilt from the Mandel strain gives the strain back
    torch.testing.assert_close(mandel.matrix_to_mandel(G, tm.Constraint.FULL),
                               eps.reshape(6, -1).T, rtol=1e-15, atol=0)
    V = FunctionSpace(unit_cube_mesh(2, 2, 2, "hex"), 1, 3)
    _, _, state = build_packed_problem(V, law, 2, device="cpu", dtype=F64)
    assert state.histories[0]["G"].shape[0] == 9


def test_dense_tangent_matches_full_matrix_and_ignores_tf32():
    """DenseTangent.apply/quad_diag against the dense products, in float64,
    and in float32 bit-equal with the reduced-precision matmul settings on
    (TF32 on the card, bf16 passes on CPUs that have them): they are
    broadcast multiplies and sums, never a matmul."""
    rng = np.random.default_rng(5)
    Cm = rng.normal(size=(6, 6, 4, 7))
    eps = rng.normal(size=(6, 4, 7))
    B = rng.normal(size=(6, 3, 4, 1))
    tg = DenseTangent(torch.tensor(Cm))
    np.testing.assert_allclose(tg.apply(torch.tensor(eps)).numpy(),
                               np.einsum("st...,t...->s...", Cm, eps), rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(tg.quad_diag(torch.tensor(B)).numpy(),
                               np.einsum("sv...,st...,tv...->v...", B, Cm, B), rtol=1e-12,
                               atol=1e-12)
    tg32 = DenseTangent(torch.tensor(Cm, dtype=torch.float32))
    e32, B32 = torch.tensor(eps, dtype=torch.float32), torch.tensor(B, dtype=torch.float32)
    ref = tg32.apply(e32), tg32.quad_diag(B32)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        got = tg32.apply(e32), tg32.quad_diag(B32)
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("kind", ["isotropic", "dense"])
def test_jacobi_diag_gm_ignores_tf32(kind):
    """StructuredGeometry.jacobi_diag_gm with a factored or a dense tangent:
    float32 bit-equal with the reduced-precision matmul settings on, within
    1e-6 of the float64 diagonal, and the float64 diagonal equal to JAX's
    within 1e-12."""
    from fenics_constitutive_tpu.ops.packed import DenseTangent as JDense
    from fenics_constitutive_tpu.ops.packed import IsotropicTangent as JIso
    from fenics_constitutive_tpu.ops.structured import build_structured_geometry as jax_geo
    from fenics_constitutive_tpu_torch.fem import FunctionSpace, unit_cube_mesh
    from fenics_constitutive_tpu_torch.ops import build_structured_geometry

    V = FunctionSpace(unit_cube_mesh(3, 2, 2, "hex"), 1, 3)
    rng = np.random.default_rng(6)
    M = V.n_dof_nodes
    if kind == "dense":
        A = rng.normal(size=(6, 6, 8, M))
        fields = {"C": np.einsum("st...,ut...->su...", A, A)}  # SPD at every point
        make_t, make_j = (lambda f, cast: DenseTangent(cast(f["C"]))), (
            lambda f: JDense(jnp.asarray(f["C"])))
    else:
        n = rng.normal(size=(6, 8, M))
        fields = {"beta": rng.uniform(1, 2, size=(8, M)), "gamma": rng.uniform(0, 1, size=(8, M)),
                  "n": n / np.linalg.norm(n, axis=0)}
        make_t = lambda f, cast: IsotropicTangent(3.0, *(cast(f[k]) for k in  # noqa: E731
                                                         ("beta", "gamma", "n")))
        make_j = lambda f: JIso(3.0, *(jnp.asarray(f[k]) for k in  # noqa: E731
                                       ("beta", "gamma", "n")))
    diag = {}
    for dtype in (torch.float64, torch.float32):
        geo = build_structured_geometry(V, 2, tm.Constraint.FULL, device="cpu", dtype=dtype)
        diag[dtype] = geo.jacobi_diag_gm(make_t(fields, lambda a: torch.tensor(a, dtype=dtype)))
    geo32 = build_structured_geometry(V, 2, tm.Constraint.FULL, device="cpu",
                                      dtype=torch.float32)
    saved = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cuda.matmul.allow_tf32 = True
        d_tf32 = geo32.jacobi_diag_gm(make_t(fields, lambda a: torch.tensor(a,
                                                                             dtype=torch.float32)))
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
    assert torch.equal(d_tf32, diag[torch.float32])
    close(diag[torch.float32].double(), diag[torch.float64].numpy(), 1e-6, "float32")
    from fenics_constitutive_tpu import fem as jfem

    Vj = jfem.FunctionSpace(jfem.unit_cube_mesh(3, 2, 2, "hex"), 1, 3)
    ref = jax_geo(Vj, 2, C.FULL).jacobi_diag_gm(make_j(fields))
    close(diag[torch.float64], ref, 1e-12, "against JAX")


@pytest.mark.parametrize("c", list(C), ids=lambda c: c.name)
def test_mandel_maps_match_jax(c):
    from fenics_constitutive_tpu.ops import mandel as jmandel

    g, s = c.geometric_dim, c.stress_strain_dim
    grad = np.random.default_rng(2).normal(size=(5, g, g))
    tc = tm.Constraint[c.name]
    close(mandel.strain_from_grad_u(torch.tensor(grad), tc),
          jmandel.strain_from_grad_u(jnp.asarray(grad), c), 1e-15, "strain_from_grad_u")
    m = np.random.default_rng(3).normal(size=(5, s))
    close(mandel.mandel_to_matrix(torch.tensor(m), tc),
          jmandel.mandel_to_matrix(jnp.asarray(m), c), 1e-15, "mandel_to_matrix")
    np.testing.assert_array_equal(mandel.get_identity(tc), jmandel.get_identity(c))
    for fn in ("trace", "deviatoric", "mises_norm"):
        close(getattr(mandel, fn)(torch.tensor(m)), getattr(jmandel, fn)(jnp.asarray(m)), 1e-14,
              fn)
    close(mandel.isotropic_elastic_tangent_inv(80769.0, 175000.0, dtype=F64),
          jmandel.isotropic_elastic_tangent_inv(80769.0, 175000.0), 1e-15, "C^-1")
