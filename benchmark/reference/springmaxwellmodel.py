"""Plain PyTorch standard-linear-solid viscoelasticity in the Maxwell form
(the law of BAMresearch/fenics-constitutive's ``SpringMaxwellModel``,
``models/spring_maxwell_model.py``, under the FULL constraint), written from
its equations, on Mandel vectors [P, 6].

A spring ``E0`` beside a Maxwell branch, a spring ``E1`` in series with a
damper of relaxation time ``tau``, both isotropic with Poisson ratio ``nu``:
``D(E) v = 2 mu(E) v + lambda(E) tr(v) 1``. With the total strain ``eps =
eps_n + d eps``, the viscous strain follows ``d eps_v / dt = (D(E1) eps /
(2 mu1) - eps_v) / tau``, taken by backward Euler over the step ``dt``:
``d eps_v = (D(E1) eps / (2 mu1 tau) - eps_v,n / tau) / (1 / dt + 1 / tau)``.
Then ``sigma = sigma_n + D(E0) d eps + D(E1) d eps - 2 mu1 d eps_v``.
History: ``strain_visco`` (``eps_v``) and ``strain`` (``eps``).
"""

from __future__ import annotations

import torch

HISTORY = ("strain_visco", "strain")


def zero_state(P: int, device, dtype=torch.float64) -> dict:
    z = torch.zeros((P, 6), dtype=dtype, device=device)
    return {"stress": z, "strain_visco": z.clone(), "strain": z.clone()}


def _lame(E: float, nu: float) -> tuple[float, float]:
    return E / (2.0 * (1.0 + nu)), E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


def _elastic(E: float, nu: float, v: torch.Tensor) -> torch.Tensor:
    """``D(E) v`` of Mandel vectors v [P, 6]."""
    mu, lam = _lame(E, nu)
    out = 2.0 * mu * v
    out[:, :3] += (lam * v[:, :3].sum(dim=1))[:, None]
    return out


def update(params: dict, d_eps: torch.Tensor, state: dict, dt: float) -> dict:
    """The state after the strain increment ``d_eps`` [P, 6] over the time
    step ``dt`` from ``state``."""
    E0, E1, tau, nu = params["E0"], params["E1"], params["tau"], params["nu"]
    mu1 = _lame(E1, nu)[0]
    strain = state["strain"] + d_eps
    d_visco = (_elastic(E1, nu, strain) / (2.0 * mu1 * tau)
               - state["strain_visco"] / tau) / (1.0 / dt + 1.0 / tau)
    stress = (state["stress"] + _elastic(E0, nu, d_eps) + _elastic(E1, nu, d_eps)
              - 2.0 * mu1 * d_visco)
    return {"stress": stress, "strain_visco": state["strain_visco"] + d_visco,
            "strain": strain}


def strain_scale(params: dict) -> float:
    """1e-6, a microstrain, the least strain a gauge reads. The law has no
    yield or other strain of its own, and its history fields, the total and
    the viscous strain, are non-zero from the first loaded step wherever the
    load reaches, so the floor only keeps the measure finite on cells that
    the load leaves at rest."""
    del params
    return 1e-6
