"""Plain reference of the Hodgkin-Huxley model family.

Twelve models in the paper example: the Hodgkin-Huxley neuron integrated
by RK4 (kind 0) or forward Euler (kind 1), and the FitzHugh-Nagumo
reduction by RK4 (kind 2), each at time steps 0.01 ... 0.08 ms to
T = 10 ms.  A sample's inputs are the applied current (8 ... 12 uA/cm^2)
and the sodium and potassium conductances (120 and 36 mS/cm^2, each with
a 10% normal spread).  A model's five outputs are the means over the
steps of V, sigmoid(V / 2) and the n-gate, the final V and the largest V
(FitzHugh-Nagumo's v and w mapped to -65 + 40 (v + 1) mV and
0.3177 + 0.1 w).

Written from the model's equations (arXiv 2301.07831's example); it
shares no code with the program.  Plain PyTorch, one elementwise
operation after another, vectorised over samples, in the dtype asked
for.
"""

from __future__ import annotations

import numpy as np
import torch

T_END = 10.0
G_L, E_NA, E_K, E_L, C_M = 0.3, 50.0, -77.0, -54.387, 1.0
HH_REST = (-65.0, 0.0529, 0.5961, 0.3177)
FHN_REST = (-1.0, 1.0)
FHN_A, FHN_B, FHN_TAU = 0.7, 0.8, 12.5


def steps(dt: float) -> int:
    return int(round(T_END / dt))


def _hh(V, m, h, n, I, gNa, gK):
    a_m = 0.1 * (V + 40.0) / (1.0 - torch.exp(-(V + 40.0) / 10.0) + 1e-12)
    b_m = 4.0 * torch.exp(-(V + 65.0) / 18.0)
    a_h = 0.07 * torch.exp(-(V + 65.0) / 20.0)
    b_h = 1.0 / (1.0 + torch.exp(-(V + 35.0) / 10.0))
    a_n = 0.01 * (V + 55.0) / (1.0 - torch.exp(-(V + 55.0) / 10.0) + 1e-12)
    b_n = 0.125 * torch.exp(-(V + 65.0) / 80.0)
    dV = (I - gNa * m ** 3 * h * (V - E_NA) - gK * n ** 4 * (V - E_K)
          - G_L * (V - E_L)) / C_M
    return (dV, a_m * (1.0 - m) - b_m * m, a_h * (1.0 - h) - b_h * h,
            a_n * (1.0 - n) - b_n * n)


def _fhn(v, w, I):
    return (v - v ** 3 / 3.0 - w + I / 10.0, (v + FHN_A - FHN_B * w) / FHN_TAU)


def model_outputs(kind: int, dt: float, params: torch.Tensor,
                  dtype=torch.float64) -> torch.Tensor:
    """(n, 5) outputs of one model on (n, 3) parameters, in ``dtype``."""
    p = params.to(dtype)
    I, gNa, gK = p[:, 0], p[:, 1], p[:, 2]
    nb = p.shape[0]
    rest = FHN_REST if kind == 2 else HH_REST
    s = [torch.full((nb,), r, dtype=dtype, device=p.device) for r in rest]
    if kind == 2:
        f = lambda st: _fhn(st[0], st[1], I)
    else:
        f = lambda st: _hh(st[0], st[1], st[2], st[3], I, gNa, gK)
    k = steps(dt)
    sum_v = torch.zeros(nb, dtype=dtype, device=p.device)
    sum_sig = torch.zeros_like(sum_v)
    sum_n = torch.zeros_like(sum_v)
    v_max = torch.full_like(sum_v, -np.inf)
    for _ in range(k):
        if kind == 1:
            d = f(s)
            s = [x + dt * dx for x, dx in zip(s, d)]
        else:
            k1 = f(s)
            k2 = f([x + 0.5 * dt * d for x, d in zip(s, k1)])
            k3 = f([x + 0.5 * dt * d for x, d in zip(s, k2)])
            k4 = f([x + dt * d for x, d in zip(s, k3)])
            s = [x + dt / 6.0 * (a + 2.0 * b + 2.0 * c + d)
                 for x, a, b, c, d in zip(s, k1, k2, k3, k4)]
        if kind == 2:
            v = -65.0 + 40.0 * (s[0] + 1.0)
            ng = 0.3177 + 0.1 * s[1]
        else:
            v, ng = s[0], s[3]
        sum_v = sum_v + v
        v_max = torch.maximum(v_max, v)
        sum_sig = sum_sig + torch.sigmoid(v / 2.0)
        sum_n = sum_n + ng
    return torch.stack([sum_v / k, v, v_max, sum_sig / k, sum_n / k], dim=1)


def draw_inputs(gen: torch.Generator, n: int, device):
    """One chunk's parameters, (n, 3) float64: the applied current
    uniform on [8, 12), then the two conductances' normal factors, drawn
    from ``gen`` in that order (the family's input distribution)."""
    kw = dict(generator=gen, dtype=torch.float64, device=device)
    I_app = 8.0 + 4.0 * torch.rand(n, **kw)
    z = torch.randn((n, 2), **kw)
    return torch.stack([I_app, 120.0 * (1.0 + 0.1 * z[:, 0]),
                        36.0 * (1.0 + 0.1 * z[:, 1])], dim=1)


def group_outputs(cfg: dict, ls, inputs, dtype=torch.float64
                  ) -> torch.Tensor:
    """(n, 5, len(ls)) outputs of the models ``ls`` of ``cfg`` on one
    chunk's parameters."""
    models = cfg["models"]
    return torch.stack([model_outputs(models[l][0], models[l][1], inputs,
                                      dtype) for l in ls], dim=2)


def costs(cfg: dict) -> np.ndarray:
    """The family's model costs: steps times right-hand sides a step (4
    for RK4, 1 for Euler, 0.8 for the reduced model), over the least."""
    work = {0: 4.0, 1: 1.0, 2: 0.8}
    c = np.array([T_END / dt * work[kind] for kind, dt in cfg["models"]])
    return c / c.min()


# a coupled-group model: rows that are not finite are redrawn (the
# problem's default max_resample)
MAX_RESAMPLE = 64


def sampler(cfg: dict, device):
    """draw(gen, n): one chunk's parameters, as the family's problem
    draws them."""
    del cfg
    return lambda gen, n: draw_inputs(gen, n, device)
