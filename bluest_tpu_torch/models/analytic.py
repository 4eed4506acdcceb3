"""Analytic multi-fidelity hierarchy from the reference tutorial
(tutorials/01_tutorial.py:10-35): estimate E[e^Z] for Z ~ N(0,1), model i
truncating the exponential series after n_models - i terms; model 0 exact.

Port of ``bluest_tpu/models/analytic.py``: the factored problems, batched
and in float64 (``torch.lgamma`` for the factorials), plus
``ExpSeriesHostProblem``, the same hierarchy as a black-box numpy model
(the tutorial's ``MyHostProblem`` shape), which samples on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problem import BLUEProblem

TRUE_MEAN = float(np.exp(0.5))


def default_costs(n_models: int) -> np.ndarray:
    return np.array([2.0 ** (n_models - i) for i in range(n_models)])


def _series(x: torch.Tensor, n_terms: int) -> torch.Tensor:
    """sum_{i <= n_terms} x^i / i! per entry of x (n,)."""
    ii = torch.arange(n_terms + 1, dtype=torch.float64, device=x.device)
    fact = torch.exp(torch.lgamma(ii + 1.0))
    return (x[:, None] ** ii / fact).sum(dim=1)


def _value(l: int, z: torch.Tensor, n_models: int) -> torch.Tensor:
    return torch.exp(z) if l == 0 else _series(z, n_models - l)


class ExpSeriesProblem(BLUEProblem):
    """Single-output tutorial hierarchy (factored, on the device)."""

    def __init__(self, n_models: int = 5, **params):
        self.n_models = n_models
        params.setdefault("costs", default_costs(n_models))
        super().__init__(n_models, **params)

    def sample_inputs(self, generator, n):
        return torch.randn(n, generator=generator, dtype=torch.float64,
                           device=self.device)

    def evaluate_model(self, l, z):
        return _value(l, z, self.n_models)[:, None]


class ExpSeriesMultiProblem(BLUEProblem):
    """Two outputs: e^Z and e^{2Z} (tutorial part 4)."""

    def __init__(self, n_models: int = 5, **params):
        self.n_models = n_models
        params.setdefault("costs", default_costs(n_models))
        super().__init__(n_models, n_outputs=2, **params)

    def sample_inputs(self, generator, n):
        return torch.randn(n, generator=generator, dtype=torch.float64,
                           device=self.device)

    def evaluate_model(self, l, z):
        v = _value(l, z, self.n_models)
        return torch.stack([v, v * v], dim=1)


class ExpSeriesHostProblem(BLUEProblem):
    """The single-output hierarchy as a black-box model: a numpy
    ``sampler``/``evaluate`` pair that takes batches (``sample_batch_size``)
    and ``set_worker_id`` for ``host_workers > 1``.  Each worker reseeds
    its generator from (seed, worker id), so workers draw independent
    streams."""

    def __init__(self, n_models: int = 5, **params):
        self.n_models = n_models
        self._rng = np.random.default_rng(int(params.get("seed", 0)))
        params.setdefault("costs", default_costs(n_models))
        super().__init__(n_models, **params)

    def set_worker_id(self, wid):
        self._rng = np.random.default_rng([int(self.params["seed"]),
                                           int(wid) + 1])

    def sampler(self, ls, N=1):
        z = self._rng.standard_normal(N)
        return [z for _ in ls]

    def evaluate(self, ls, samples, N=1):
        out = []
        for i, l in enumerate(ls):
            z = np.asarray(samples[i], dtype=float)
            if l == 0:
                v = np.exp(z)
            else:
                ii = np.arange(self.n_models - l + 1)[:, None]
                v = np.sum(z[None, :] ** ii
                           / np.cumprod(np.maximum(ii, 1), axis=0), axis=0)
            out.append(v)
        return [out]
