"""Plain PyTorch Drucker-Prager plasticity, the classic cone with associated
flow and no hardening (the law of BAMresearch/fenics-constitutive's
``DruckerPrager3D``, comfe-rs ``src/plasticity/drucker_prager_classic.rs``),
written from its equations, on Mandel vectors [P, 6].

Yield function ``f = sqrt(J2) + b I1 - a``; flow ``g = df/dsigma = b 1 +
s / (2 sqrt(J2))``. The trial stress ``sigma_tr = sigma_n + kappa tr(d eps)
1 + 2 mu dev(d eps)`` yields where ``f_tr > 0``. The return keeps the
deviator's direction, so it is closed form: ``d gamma = f_tr / (mu + 9
kappa b^2)``, ``sqrt(J2) = sqrt(J2_tr) - mu d gamma``, ``I1 = I1_tr - 9 kappa
b d gamma``. History: ``alpha += d gamma sqrt(2/3) |g|`` (the upstream's
hardening measure) and ``plastic_strain += d gamma g``.

The closed form holds only on the cone's smooth part and under associated
flow: ``update`` raises ``RunError`` where a return would cross the apex
(``mu d gamma > sqrt(J2_tr)``) and where ``b_flow`` differs from ``b``.
"""

from __future__ import annotations

import math

import torch

from ..harness import RunError

SQ23 = math.sqrt(2.0 / 3.0)
HISTORY = ("alpha", "plastic_strain")


def zero_state(P: int, device, dtype=torch.float64) -> dict:
    z = torch.zeros((P, 6), dtype=dtype, device=device)
    return {"stress": z, "alpha": torch.zeros(P, dtype=dtype, device=device),
            "plastic_strain": z.clone()}


def _dev(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    tr = v[:, :3].sum(dim=1)
    dev = v.clone()
    dev[:, :3] -= tr[:, None] / 3.0
    return tr, dev


def update(params: dict, d_eps: torch.Tensor, state: dict, dt: float) -> dict:
    """The state after the strain increment ``d_eps`` [P, 6] from ``state``
    (rate-independent: the time step ``dt`` plays no part)."""
    del dt
    mu, ka, a, b = params["mu"], params["kappa"], params["a"], params["b"]
    if params["b_flow"] != b:
        raise RunError(f"the Drucker-Prager reference is associated only: b_flow "
                       f"{params['b_flow']} != b {b}")
    tr, de = _dev(d_eps)
    sigma_tr = state["stress"] + 2.0 * mu * de
    sigma_tr[:, :3] += (ka * tr)[:, None]
    i1_tr, s_tr = _dev(sigma_tr)
    sq_tr = torch.sqrt(0.5 * (s_tr * s_tr).sum(dim=1))  # sqrt(J2); Mandel: J2 = s.s / 2
    f_tr = sq_tr + b * i1_tr - a
    plastic = f_tr > 0.0
    dgamma = torch.where(plastic, f_tr / (mu + 9.0 * ka * b * b), torch.zeros_like(f_tr))
    sq = sq_tr - mu * dgamma
    if bool((sq < 0.0).any()):
        i = int(torch.argmax((sq < 0.0).to(torch.int8)))
        raise RunError(f"point {i}'s Drucker-Prager return crosses the apex (sqrt(J2) trial "
                       f"{float(sq_tr[i]):.6g}, mu d gamma {float(mu * dgamma[i]):.6g})")
    # the flow's deviatoric part s / (2 sqrt(J2)): the return keeps it as it is
    half_n = torch.where(plastic[:, None], s_tr / (2.0 * torch.where(plastic, sq_tr, 1.0))[:, None],
                         torch.zeros_like(s_tr))
    i1 = i1_tr - 9.0 * ka * b * dgamma
    returned = 2.0 * sq[:, None] * half_n
    returned[:, :3] += (i1 / 3.0)[:, None]
    stress = torch.where(plastic[:, None], returned, sigma_tr)
    g = half_n.clone()
    g[:, :3] += b
    g_norm = torch.linalg.vector_norm(g, dim=1)
    return {"stress": stress, "alpha": state["alpha"] + dgamma * SQ23 * g_norm,
            "plastic_strain": state["plastic_strain"] + dgamma[:, None] * g}


def strain_scale(params: dict) -> float:
    """The shear strain at first yield in pure shear without pressure,
    ``a / (2 mu)`` (there ``sqrt(J2)`` is the shear stress, ``2 mu`` times
    the shear strain): the floor of the scale a history field's gap is
    measured against, as it is zero where the load stays elastic."""
    return params["a"] / (2.0 * params["mu"])
