"""Multi-fidelity, multi-output Hodgkin-Huxley neuron family.

Port of ``bluest_tpu/models/hodgkin_huxley.py`` (the reference's
12-model, 5-output paper example,
examples/paper_examples/hodgkin-huxley/blue_hodgkin-huxley.py): the model
set mixes integrator fidelity (time step), integrator order (RK4 vs
Euler) and model form (full HH vs FitzHugh-Nagumo reduction); randomness
enters through the applied current and channel conductances.

Outputs (5, as in the reference): mean membrane potential, final V,
max V, a smooth spike-count proxy, and mean potassium activation.

It is a coupled-group model (``sample_group`` / ``evaluate_group``).  The
JAX package's ``lax.scan`` over time steps, with the outputs reduced from
the trajectory, is K2 (``ops.hodgkin_huxley.hh_group_outputs``): on the
card one kernel launch integrates every model of a group and reduces the
five outputs in registers; on the CPU its plain version, a Python loop
of elementwise torch ops in the JAX package's operation order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hodgkin_huxley import N_OUTPUTS, T_END, hh_group_outputs
from ..problem import BLUEProblem

# (kind, dt): kind 0 = HH RK4, 1 = HH Euler, 2 = FitzHugh-Nagumo RK4
DEFAULT_MODELS = (
    (0, 0.01), (0, 0.02), (0, 0.04), (0, 0.08),
    (1, 0.01), (1, 0.02), (1, 0.04), (1, 0.08),
    (2, 0.01), (2, 0.02), (2, 0.04), (2, 0.08),
)


def hh_outputs(kind: int, dt: float, params: torch.Tensor) -> torch.Tensor:
    """One model's (n, 5) outputs for (n, 3) float64 parameters."""
    return hh_group_outputs(((kind, dt),), params.contiguous())[:, :, 0]


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
        """(n, 5, L): one K2 launch for the group on the card."""
        return hh_group_outputs(tuple(self.models[l] for l in ls),
                                params.contiguous())
