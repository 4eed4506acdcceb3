"""K2, the Hodgkin-Huxley kernel's wrapper and plain version
(``bluest_tpu_torch.ops.hodgkin_huxley``), on the CPU.

The same parameters, made with numpy from a seed, go through the JAX
package (``jax.vmap`` of ``_outputs(kind, _integrate(kind, dt, p))``, the
``lax.scan`` that K2 replaces) and the port's plain version, which a CPU
tensor runs.  Tolerances and why:

  * plain version against the JAX package, each of the 12 default models
    alone and the 12-model group in one call: the same rows non-finite,
    normwise <= 1e-8 on the rest (the port's tolerance against JAX: the
    CPU's exp differs from XLA's, and a spiking trajectory amplifies it);
  * plain version against the trajectory formula it replaced (kept below
    as a helper: the whole trajectory stacked, then mean, last and max
    taken over it): <= 1e-13 normwise, because only the order of the
    means' sums changed (now running sums in step order); the final and
    the max V, which are no sums, bit for bit.

The kernel itself runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it against this plain version there).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from bluest_tpu_torch.ops import hodgkin_huxley as k2
from bluest_tpu_torch.models.hodgkin_huxley import (DEFAULT_MODELS,
                                                    HodgkinHuxleyProblem,
                                                    hh_outputs)

torch.set_num_threads(1)

N = 64


def _normwise(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape
    return (np.abs(got - ref).max(axis=0)
            / np.maximum(np.abs(ref).max(axis=0), 1e-300)).max()


@functools.lru_cache(maxsize=None)
def _params(n=N, seed=11):
    rng = np.random.default_rng(seed)
    return np.stack([8 + 4 * rng.random(n),
                     120 * (1 + 0.1 * rng.standard_normal(n)),
                     36 * (1 + 0.1 * rng.standard_normal(n))], axis=1)


@functools.lru_cache(maxsize=None)
def _jax_outputs(kind, dt):
    from bluest_tpu.models import hodgkin_huxley as hj
    return np.asarray(jax.jit(jax.vmap(
        lambda p: hj._outputs(kind, hj._integrate(kind, dt, p))))(
            jnp.asarray(_params())))


@functools.lru_cache(maxsize=None)
def _plain(kind, dt):
    return k2.hh_group_outputs(((kind, dt),),
                               torch.as_tensor(_params()))[:, :, 0].numpy()


def _agrees(got, ref, tol):
    fin = np.isfinite(ref).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), fin)
    assert fin.sum() > 0
    err = _normwise(got[fin], ref[fin])
    assert err <= tol, err


@pytest.mark.parametrize("kind,dt", DEFAULT_MODELS)
def test_plain_matches_jax(kind, dt):
    got = _plain(kind, dt)
    assert got.shape == (N, 5)
    _agrees(got, _jax_outputs(kind, dt), 1e-8)


def test_group_matches_jax_and_each_model():
    """The 12-model group in one call: column l is model l's outputs, bit
    for bit as the model alone, and within 1e-8 of the JAX package."""
    out = k2.hh_group_outputs(DEFAULT_MODELS, torch.as_tensor(_params()))
    assert out.shape == (N, 5, 12) and out.dtype == torch.float64
    out = out.numpy()
    for l, (kind, dt) in enumerate(DEFAULT_MODELS):
        np.testing.assert_array_equal(out[:, :, l], _plain(kind, dt))
        _agrees(out[:, :, l], _jax_outputs(kind, dt), 1e-8)


def _trajectory_outputs(kind, dt, params):
    """The formula the running sums replaced: the (n, n_steps, 4)
    trajectory of the stacked state, then the outputs reduced over it."""
    steps = k2.n_steps(dt)
    n = params.shape[0]
    I_app, gNa, gK = params.unbind(1)

    def rhs(s):
        if kind == 2:
            dv, dw = k2._fhn_rhs(s[:, 0], s[:, 1], I_app)
            zero = torch.zeros_like(dv)
            return torch.stack([dv, dw, zero, zero], dim=1)
        return torch.stack(k2._hh_rhs(*s.unbind(1), I_app, gNa, gK), dim=1)

    state0 = ((-1.0, 1.0, 0.0, 0.0) if kind == 2
              else (-65.0, 0.0529, 0.5961, 0.3177))
    s = torch.tensor(state0, dtype=params.dtype).expand(n, 4)
    traj = []
    for _ in range(steps):
        if kind == 1:
            s = s + dt * rhs(s)
        else:
            k1 = rhs(s)
            k2_ = rhs(s + 0.5 * dt * k1)
            k3 = rhs(s + 0.5 * dt * k2_)
            k4 = rhs(s + dt * k3)
            s = s + dt / 6.0 * (k1 + 2 * k2_ + 2 * k3 + k4)
        traj.append(s)
    traj = torch.stack(traj, dim=1)
    V, n_gate = traj[:, :, 0], traj[:, :, 3]
    if kind == 2:
        V = -65.0 + 40.0 * (V + 1.0)
        n_gate = 0.3177 + 0.1 * traj[:, :, 1]
    spikes = torch.mean(torch.sigmoid((V - 0.0) / 2.0), dim=1)
    return torch.stack([torch.mean(V, dim=1), V[:, -1],
                        torch.amax(V, dim=1), spikes,
                        torch.mean(n_gate, dim=1)], dim=1)


@pytest.mark.parametrize("kind,dt", [(0, 0.02), (1, 0.08), (2, 0.04)])
def test_running_sums_match_trajectory_formula(kind, dt):
    got = _plain(kind, dt)
    ref = _trajectory_outputs(kind, dt, torch.as_tensor(_params())).numpy()
    _agrees(got, ref, 1e-13)
    # the last and the max V are no sums: the same states give them bit
    # for bit (NaN where the formula's is)
    np.testing.assert_array_equal(got[:, 1:3], ref[:, 1:3])


def test_model_entry_points_run_the_wrapper():
    """hh_outputs and evaluate_group go through hh_group_outputs; a
    strided parameter view is made contiguous by the model."""
    P = torch.as_tensor(_params())
    p = HodgkinHuxleyProblem(C=[np.eye(12) + 0.5] * 5, verbose=False,
                             device="cpu")
    ls = (11, 3, 8)
    out = p.evaluate_group(ls, P[:9])
    assert out.shape == (9, 5, 3)
    ref = k2.hh_group_outputs([DEFAULT_MODELS[l] for l in ls], P[:9])
    assert torch.equal(out.nan_to_num(), ref.nan_to_num())
    wide = torch.cat([P[:4], torch.zeros(4, 1, dtype=P.dtype)], dim=1)
    got = hh_outputs(2, 0.08, wide[:, :3])
    assert torch.equal(got,
                       k2.hh_group_outputs(((2, 0.08),), P[:4])[:, :, 0])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    P = torch.as_tensor(_params())
    with pytest.raises(TypeError):
        k2.hh_group_outputs(DEFAULT_MODELS, P.float())
    with pytest.raises(TypeError):
        k2.hh_group_outputs(DEFAULT_MODELS, P.numpy())
    for bad in (P[:, :2], P.reshape(-1), P.reshape(N, 3, 1)):
        with pytest.raises(ValueError):
            k2.hh_group_outputs(DEFAULT_MODELS, bad)
    with pytest.raises(ValueError, match="contiguous"):
        k2.hh_group_outputs(DEFAULT_MODELS, P.t().contiguous().t())
    for models in ((), ((3, 0.01),), ((0, 0.0),), ((0, -0.1),),
                   ((0, float("nan")),), ((1, 25.0),)):
        with pytest.raises(ValueError):
            k2.hh_group_outputs(models, P)


def test_launch_plan_splits_long_groups_longest_first():
    """Up to MAX_MODELS models a launch; longer tuples take more launches,
    every column once, each table longest model first."""
    assert len(k2.launch_plan(DEFAULT_MODELS, 16384)) == 1
    ((_, table),) = k2.launch_plan(DEFAULT_MODELS, 16384)
    assert [e[0] for e in table[:5]] == [0, 1, 8, 4, 2]  # HH RK4 0.01 first
    models = [DEFAULT_MODELS[i % 12] for i in range(40)]
    plan = [launch.entries for launch in k2.launch_plan(models, 16384)]
    assert [len(t) for t in plan] == [k2.MAX_MODELS, 40 - k2.MAX_MODELS]
    cols = [e[0] for t in plan for e in t]
    assert sorted(cols) == list(range(40))
    cost = [e[2] * k2.STEP_OPS[e[1]] for t in plan for e in t]
    assert cost == sorted(cost, reverse=True)
    for col, kind, steps, dt in (e for t in plan for e in t):
        assert (kind, dt) == models[col] and steps == k2.n_steps(dt)


def _fill_boundary(models, sm_count):
    """The largest n at which launch_plan's rule still takes eight lanes:
    a one-lane launch has ceil(n / 32) warps per model, each model's
    weighted by its steps x STEP_OPS over the longest's, spread over 4
    sub-partitions an SM."""
    cost = [k2.n_steps(dt) * k2.STEP_OPS[kind] for kind, dt in models]
    w = sum(cost) / max(cost)
    return 32 * int(k2.LANES8_MAX_FILL * 4 * sm_count / w)


@pytest.mark.parametrize("sm_count", [132, 66])
@pytest.mark.parametrize("name,models", [("model0", DEFAULT_MODELS[:1]),
                                         ("group", DEFAULT_MODELS)])
def test_launch_plan_variant_rule(name, models, sm_count):
    """Eight lanes a sample while the launch leaves the card emptier than
    LANES8_MAX_FILL, one lane past it: at the boundary n and at 1, 256,
    16384 and 65536 samples (the H100's 132 SMs, and half of them)."""
    def variant(n):
        (launch,) = k2.launch_plan(models, n, sm_count)
        return launch.variant

    nb = _fill_boundary(models, sm_count)
    assert variant(nb) == "lanes8" and variant(nb + 1) == "thread"
    want = {1: "lanes8", 256: "lanes8", 16384: "thread", 65536: "thread"}
    for n, v in want.items():
        assert variant(n) == v, (name, n, nb)
    if sm_count == 132:
        assert nb == {"model0": 11808, "group": 4128}[name]
    # every table of a split group takes its own variant
    plan = k2.launch_plan(list(models) * 40, 2048, sm_count)
    assert {launch.variant for launch in plan} <= set(k2.VARIANTS)
    with pytest.raises(ValueError):
        k2.launch_plan(models, -1, sm_count)


def test_integer_powers_match_jax_integer_pow():
    """The plain version's n ** 4 (IK) and m ** 3 (INa, FHN's v ** 3) are
    the products jax.lax.integer_pow takes, bit for bit, on 10^4 seeded
    f64 gate values in [-0.1, 1.1]; the kernel computes the same
    products."""
    import bluest_tpu.config  # noqa: F401  (float64 on, as the package runs)
    x = np.random.default_rng(12).uniform(-0.1, 1.1, 10_000)
    xj = jnp.asarray(x)
    assert xj.dtype == jnp.float64
    for y, fn in ((4, k2._pow4), (3, k2._cube)):
        ref = np.asarray(jax.jit(lambda v: jax.lax.integer_pow(v, y))(xj))
        np.testing.assert_array_equal(fn(torch.as_tensor(x)).numpy(), ref)
    # and on the gate's own range, whose squares JAX also takes
    g = np.random.default_rng(13).random(10_000)
    np.testing.assert_array_equal(
        k2._pow4(torch.as_tensor(g)).numpy(),
        np.asarray(jax.jit(lambda v: v ** 4)(jnp.asarray(g))))


def test_more_models_than_one_table_on_the_cpu():
    """A group longer than one launch's table: each column is its model."""
    P = torch.as_tensor(_params(5, 3))
    models = [(2, 0.08), (2, 0.04)] * 20
    out = k2.hh_group_outputs(models, P)
    assert out.shape == (5, 5, 40)
    for l, m in enumerate(models[:2]):
        assert torch.equal(out[:, :, l::2],
                           k2.hh_group_outputs((m,), P).expand(5, 5, 20))


def test_cpu_refuses_an_unknown_variant():
    """A forced variant must name one of VARIANTS on the CPU too (where
    the plain version runs whatever the variant)."""
    P = torch.as_tensor(_params(3, 5))
    for v in k2.VARIANTS:
        assert torch.equal(k2.hh_group_outputs(((2, 0.08),), P, variant=v),
                           k2.hh_group_outputs(((2, 0.08),), P))
    for bad in ("lanes4", "warp", 8):
        with pytest.raises(ValueError, match="variant"):
            k2.hh_group_outputs(((2, 0.08),), P, variant=bad)


def test_cpu_tensors_never_touch_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path built or loaded K2")

    monkeypatch.setattr(k2, "build_library", refuse)
    monkeypatch.setattr(k2._build, "build", lambda *a: refuse())
    before = k2.hh_group_outputs.launches
    out = k2.hh_group_outputs(((2, 0.08), (0, 0.08)),
                              torch.as_tensor(_params(3, 5)))
    assert out.shape == (3, 5, 2)
    assert k2.hh_group_outputs.launches == before
    n0 = k2.hh_group_outputs(((2, 0.08),), torch.zeros((0, 3),
                                                        dtype=torch.float64))
    assert n0.shape == (0, 5, 1)
    assert k2.hh_group_outputs.launches == before
