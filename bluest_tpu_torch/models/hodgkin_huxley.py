"""Multi-fidelity, multi-output Hodgkin-Huxley neuron family.

Port of ``bluest_tpu/models/hodgkin_huxley.py`` (the reference's
12-model, 5-output paper example,
examples/paper_examples/hodgkin-huxley/blue_hodgkin-huxley.py): the model
set mixes integrator fidelity (time step), integrator order (RK4 vs
Euler) and model form (full HH vs FitzHugh-Nagumo reduction); randomness
enters through the applied current and channel conductances.

Outputs (5, as in the reference): mean membrane potential, final V,
max V, a smooth spike-count proxy, and mean potassium activation.

It is a coupled-group model (``sample_group`` / ``evaluate_group``): the
JAX package's ``lax.scan`` over time steps becomes a Python loop of
elementwise torch ops on the batch's (n, 4) f64 states, in the JAX
package's operation order.  Each step is a few dozen small kernels, so on
the card the integration is bound by launches, not arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import BLUEProblem

# (kind, dt): kind 0 = HH RK4, 1 = HH Euler, 2 = FitzHugh-Nagumo RK4
DEFAULT_MODELS = (
    (0, 0.01), (0, 0.02), (0, 0.04), (0, 0.08),
    (1, 0.01), (1, 0.02), (1, 0.04), (1, 0.08),
    (2, 0.01), (2, 0.02), (2, 0.04), (2, 0.08),
)
T_END = 10.0
N_OUTPUTS = 5


def _hh_rhs(state, params):
    V, m, h, n = state.unbind(1)
    I_app, gNa, gK = params.unbind(1)
    gL, ENa, EK, EL, Cm = 0.3, 50.0, -77.0, -54.387, 1.0

    a_m = 0.1 * (V + 40.0) / (1.0 - torch.exp(-(V + 40.0) / 10.0) + 1e-12)
    b_m = 4.0 * torch.exp(-(V + 65.0) / 18.0)
    a_h = 0.07 * torch.exp(-(V + 65.0) / 20.0)
    b_h = 1.0 / (1.0 + torch.exp(-(V + 35.0) / 10.0))
    a_n = 0.01 * (V + 55.0) / (1.0 - torch.exp(-(V + 55.0) / 10.0) + 1e-12)
    b_n = 0.125 * torch.exp(-(V + 65.0) / 80.0)

    INa = gNa * m ** 3 * h * (V - ENa)
    IK = gK * n ** 4 * (V - EK)
    IL = gL * (V - EL)
    dV = (I_app - INa - IK - IL) / Cm
    dm = a_m * (1 - m) - b_m * m
    dh = a_h * (1 - h) - b_h * h
    dn = a_n * (1 - n) - b_n * n
    return torch.stack([dV, dm, dh, dn], dim=1)


def _fhn_rhs(state, params):
    v, w = state[:, 0], state[:, 1]
    I_app = params[:, 0]
    a, b, tau = 0.7, 0.8, 12.5
    dv = v - v ** 3 / 3 - w + I_app / 10.0
    dw = (v + a - b * w) / tau
    zero = torch.zeros_like(v)
    return torch.stack([dv, dw, zero, zero], dim=1)


def _integrate(kind: int, dt: float, params: torch.Tensor) -> torch.Tensor:
    """(n, 3) parameters -> the (n, n_steps, 4) trajectory (the states
    after each step)."""
    n_steps = int(round(T_END / dt))
    if kind == 2:
        state0, rhs = (-1.0, 1.0, 0.0, 0.0), _fhn_rhs
    else:
        state0, rhs = (-65.0, 0.0529, 0.5961, 0.3177), _hh_rhs
    s = torch.tensor(state0, dtype=params.dtype,
                     device=params.device).expand(params.shape[0], 4)
    traj = []
    for _ in range(n_steps):
        if kind == 1:
            s = s + dt * rhs(s, params)
        else:
            k1 = rhs(s, params)
            k2 = rhs(s + 0.5 * dt * k1, params)
            k3 = rhs(s + 0.5 * dt * k2, params)
            k4 = rhs(s + dt * k3, params)
            s = s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        traj.append(s)
    return torch.stack(traj, dim=1)


def _outputs(kind: int, traj: torch.Tensor) -> torch.Tensor:
    """(n, n_steps, 4) trajectory -> (n, 5) outputs."""
    V = traj[:, :, 0]
    n_gate = traj[:, :, 3]
    if kind == 2:
        # rescale FHN to HH-like voltage units so outputs correlate
        V = -65.0 + 40.0 * (V + 1.0)
        n_gate = 0.3177 + 0.1 * traj[:, :, 1]
    spikes = torch.mean(torch.sigmoid((V - 0.0) / 2.0), dim=1)
    return torch.stack([torch.mean(V, dim=1), V[:, -1],
                        torch.amax(V, dim=1), spikes,
                        torch.mean(n_gate, dim=1)], dim=1)


def hh_outputs(kind: int, dt: float, params: torch.Tensor) -> torch.Tensor:
    """One model's (n, 5) outputs for (n, 3) parameters."""
    return _outputs(kind, _integrate(kind, dt, params))


class HodgkinHuxleyProblem(BLUEProblem):
    """12-model, 5-output neuron hierarchy (reference paper example)."""

    def __init__(self, models=DEFAULT_MODELS, **params):
        self.models = tuple(models)
        if "costs" not in params:
            # cost ~ steps * (4 rhs evals for RK4, 1 for Euler; FHN ~ 1/5)
            c = []
            for kind, dt in self.models:
                steps = T_END / dt
                work = {0: 4.0, 1: 1.0, 2: 0.8}[kind]
                c.append(steps * work)
            c = np.array(c)
            params["costs"] = c / c.min()
        super().__init__(len(self.models), n_outputs=N_OUTPUTS, **params)

    def sample_group(self, generator, ls, n):
        """(n, 3) parameters: applied current (8..12 uA/cm^2), gNa, gK."""
        kw = dict(generator=generator, dtype=torch.float64,
                  device=self.device)
        I_app = 8.0 + 4.0 * torch.rand(n, **kw)
        z = torch.randn((n, 2), **kw)
        gNa = 120.0 * (1.0 + 0.1 * z[:, 0])
        gK = 36.0 * (1.0 + 0.1 * z[:, 1])
        return torch.stack([I_app, gNa, gK], dim=1)

    def evaluate_group(self, ls, params):
        return torch.stack([hh_outputs(*self.models[l], params) for l in ls],
                           dim=2)                          # (n, 5, L)
