"""Plain PyTorch von Mises plasticity with exponential isotropic hardening
(the law of BAMresearch/fenics-constitutive's ``VonMises3D``), written from
its equations, on Mandel vectors [P, 6].

Trial state: ``s_tr = dev(sigma_n) + 2 mu dev(d eps)``. Yield when
``|s_tr| > sqrt(2/3) h(alpha)``, ``h(a) = y0 + (y00 - y0)(1 - exp(-w a))``.
The plastic multiplier ``g`` solves ``|s_tr| - 2 mu g - sqrt(2/3) h(alpha +
sqrt(2/3) g) = 0`` (Newton to round-off); then ``sigma = sigma_n + kappa
tr(d eps) I + 2 mu dev(d eps) - 2 mu g n``, ``eps_n += g n`` and ``alpha +=
sqrt(2/3) g``, with ``n = s_tr / |s_tr|``.
"""

from __future__ import annotations

import math

import torch

SQ23 = math.sqrt(2.0 / 3.0)
HISTORY = ("eps_n", "alpha")
MAX_TRIPS = 60


def zero_state(P: int, device, dtype=torch.float64) -> dict:
    z = torch.zeros((P, 6), dtype=dtype, device=device)
    return {"stress": z, "eps_n": z.clone(), "alpha": torch.zeros(P, dtype=dtype, device=device)}


def _dev(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    tr = v[:, :3].sum(dim=1)
    dev = v.clone()
    dev[:, :3] -= tr[:, None] / 3.0
    return tr, dev


def update(params: dict, d_eps: torch.Tensor, state: dict, dt: float) -> dict:
    """The state after the strain increment ``d_eps`` [P, 6] from ``state``
    (rate-independent: the time step ``dt`` plays no part)."""
    del dt
    ka, mu = params["p_ka"], params["p_mu"]
    y0, y00, w = params["p_y0"], params["p_y00"], params["p_w"]
    tr, de = _dev(d_eps)
    _, s_n = _dev(state["stress"])
    s_tr = s_n + 2.0 * mu * de
    norm = torch.linalg.vector_norm(s_tr, dim=1)
    alpha = state["alpha"]

    def f(g):
        e = torch.exp(-w * (alpha + SQ23 * g))
        return (norm - 2.0 * mu * g - SQ23 * (y0 + (y00 - y0) * (1.0 - e)),
                -2.0 * mu - (2.0 / 3.0) * (y00 - y0) * w * e)

    plastic = f(torch.zeros_like(norm))[0] > 0.0
    g = torch.zeros_like(norm)
    for _ in range(MAX_TRIPS):
        fx, dfx = f(g)
        step = torch.where(plastic, fx / dfx, torch.zeros_like(g))
        g = g - step
        if not bool((step.abs() > 1e-15 * (g.abs() + 1e-300)).any()):
            break
    n = torch.where(plastic[:, None], s_tr / torch.where(norm > 0, norm, 1.0)[:, None],
                    torch.zeros_like(s_tr))
    stress = state["stress"] + 2.0 * mu * de - 2.0 * mu * g[:, None] * n
    stress[:, :3] += (ka * tr)[:, None]
    return {"stress": stress, "eps_n": state["eps_n"] + g[:, None] * n,
            "alpha": alpha + SQ23 * g}


def strain_scale(params: dict) -> float:
    """The strain at first yield in shear, y0 / (2 mu): the floor of the
    scale a history field's gap is measured against (it is zero where the
    load stays elastic)."""
    return params["p_y0"] / (2.0 * params["p_mu"])
