"""Nonmonotone spectral projected gradient on torch f64 tensors.

Port of ``bluest_tpu/linalg/spg.py`` (the Birgin/Martinez/Raydan SPG the
reference uses for the masked SPD covariance projection, spg.py:39-132):
Barzilai-Borwein step, Grippo-style nonmonotone line search with
quadratic-interpolation backtracking.  The JAX package's two
``lax.while_loop``s become Python loops over tensors on the caller's
device (the covariance projection runs it on
``config.allocation_device()``); the scalars the loops test are Python
floats.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class SPGResult(NamedTuple):
    x: torch.Tensor
    f: float
    gpmax: float
    it: int
    count: int
    solver_info: int  # 0 converged, 1 maxit, 2 max feval


_SIGMA_MIN = 0.1
_SIGMA_MAX = 0.9
_GAMMA = 1.0e-4


def spg(feval: Callable, geval: Callable, proj: Callable, x0,
        eps: float = 1.0e-4, maxit: int = 200, max_fevals: int = 10 ** 5,
        lmbda_min: float = 1e-30, lmbda_max: float = 1e30,
        history: int = 10) -> SPGResult:
    """Minimize ``feval`` over the convex set defined by projector ``proj``.

    ``feval`` returns a Python float (or a 0-d tensor), ``geval`` and
    ``proj`` tensors shaped like ``x0``.  Stops when the projected
    gradient sup-norm <= eps, or on the iteration / evaluation budgets
    (reference spg.py semantics)."""
    x = proj(torch.as_tensor(x0))
    f = float(feval(x))
    g = geval(x)
    gpmax = float((proj(x - g) - x).abs().max())
    lmbda = (min(max(1.0 / max(gpmax, 1e-300), lmbda_min), lmbda_max)
             if gpmax > 1e-15 else 0.0)
    hist = [-float("inf")] * history
    hist[0] = f
    it, count, failed = 0, 1, False

    while gpmax > eps and it < maxit and count < max_fevals and not failed:
        d = proj(x - lmbda * g) - x
        fmax = max(hist)
        # nonmonotone line search with quadratic-interpolation backtracking
        gdotd = float(g @ d)
        alpha = 1.0
        xnew = x + alpha * d
        fnew = float(feval(xnew))
        count += 1
        while fnew > fmax + _GAMMA * alpha * gdotd and count < max_fevals:
            alpha_t = -0.5 * (alpha ** 2) * gdotd / (fnew - f - alpha * gdotd)
            if alpha_t < _SIGMA_MIN or alpha_t > _SIGMA_MAX * alpha:
                alpha_t = 0.5 * alpha
            alpha = 0.5 * alpha if alpha <= _SIGMA_MIN else alpha_t
            xnew = x + alpha * d
            fnew = float(feval(xnew))
            count += 1
        if not fnew <= fmax + _GAMMA * alpha * gdotd:
            # line-search failure: keep the old iterate and stop
            failed = True
            break

        gnew = geval(xnew)
        s = xnew - x
        y = gnew - g
        sdots = float(s @ s)
        sdoty = float(s @ y)
        lmbda = (lmbda_max if sdoty <= 0
                 else min(max(sdots / sdoty, lmbda_min), lmbda_max))
        it += 1
        hist[it % history] = fnew
        gpmax = float((proj(xnew - gnew) - xnew).abs().max())
        x, f, g = xnew, fnew, gnew

    info = 0 if gpmax <= eps else (2 if failed or count >= max_fevals else 1)
    return SPGResult(x=x, f=f, gpmax=gpmax, it=it, count=count,
                     solver_info=info)
