"""Least work of the Hodgkin-Huxley family's model evaluations (K2
computes a group's models in one launch on the card).

``k2_work`` is a copy of ``chip_smoke.py:958-968``: per sample and model
its steps times the operations of one step (``STEP_OPS``, frozen from
``bluest_tpu_torch/ops/hodgkin_huxley.py``: each add, subtract,
multiply, divide, exp and compare one); the (n, 3) parameters read once
and the (n, 5, L) outputs written once, in float64."""

from __future__ import annotations

from perfbench.work import peaks

STEP_OPS = {0: 288, 1: 73, 2: 79}
T_END = 10.0


def n_steps(dt):
    return int(round(T_END / dt))


def k2_work(models, n):
    ops = n * sum(n_steps(dt) * STEP_OPS[kind] for kind, dt in models)
    nbytes = 8 * (3 * n + 5 * n * len(models))
    return ops, nbytes


def least_seconds(cfg, active):
    """(seconds, "operations" or "bytes") for the evaluations of
    ``active``, a list of (group, samples)."""
    ops = nbytes = 0.0
    for g, N in active:
        o, b = k2_work([cfg["models"][l] for l in g], N)
        ops += o
        nbytes += b
    t_ops = ops / peaks()["fp64_flops"]
    t_bytes = nbytes / peaks()["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
