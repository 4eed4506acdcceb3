"""The plain reference against hand-worked cases, and its frozen copy of
the sampling recipe against the program's engines (this test, not the
reference, imports the program)."""

import json
import os

import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from perfbench import harness
from perfbench.reference import blue, hodgkin_huxley, streams


def test_fitzhugh_nagumo_against_an_ode_solver():
    I = 10.0
    p = torch.tensor([[I, 120.0, 36.0]], dtype=torch.float64)
    got = hodgkin_huxley.model_outputs(2, 0.01, p)[0, 1].item()

    def f(t, s):
        v, w = s
        return [v - v ** 3 / 3 - w + I / 10, (v + 0.7 - 0.8 * w) / 12.5]
    sol = solve_ivp(f, (0, 10), [-1.0, 1.0], rtol=1e-12, atol=1e-12)
    assert got == pytest.approx(-65 + 40 * (sol.y[0, -1] + 1), rel=1e-8)


def test_hodgkin_huxley_rk4_converges():
    p = torch.tensor([[10.0, 120.0, 36.0]], dtype=torch.float64)
    a = hodgkin_huxley.model_outputs(0, 0.01, p)
    b = hodgkin_huxley.model_outputs(0, 0.005, p)
    # the means over steps differ by the sampling of the trajectory
    assert torch.allclose(a[:, [1, 2]], b[:, [1, 2]], rtol=1e-4)


def test_blue_single_group_is_monte_carlo():
    C = [np.array([[4.0, 1.0], [1.0, 2.0]])]
    ref = blue.Groups(C, [(0,), (1,), (0, 1)])
    m = np.array([10.0, 0.0, 0.0])
    mus, var = ref.estimate(m, [[np.array([25.0]), np.zeros(1), np.zeros(2)]])
    assert mus[0] == pytest.approx(2.5) and var[0] == pytest.approx(0.4)


def test_blue_two_models_by_hand():
    """Groups {0, 1} x n and {1} x k: the BLUE is the control-variate
    estimator with the optimal weight C01 / C11, whose variance is
    known."""
    s0, s1, r = 2.0, 1.0, 0.9
    C = [np.array([[s0 ** 2, r * s0 * s1], [r * s0 * s1, s1 ** 2]])]
    ref = blue.Groups(C, [(0,), (1,), (0, 1)])
    n, k = 10.0, 90.0
    S0, S1, T1 = 31.0, 12.0, 99.0
    mus, var = ref.estimate(np.array([0.0, k, n]),
                            [[np.zeros(1), np.array([T1]),
                              np.array([S0, S1])]])
    beta = r * s0 / s1
    want = S0 / n - beta * (S1 / n - (S1 + T1) / (n + k))
    assert mus[0] == pytest.approx(want, rel=1e-12)
    assert var[0] == pytest.approx(s0 ** 2 / n * (1 - r ** 2 * k / (n + k)),
                                   rel=1e-12)


def test_generator_seed_is_the_programs():
    from bluest_tpu_torch.sampling.engine import generator_seed
    for args in [(0, 0, 0), (2 ** 32 + 5, 7, 3), (123456789012, 1, 0)]:
        assert streams.generator_seed(*args) == generator_seed(*args)


def _toy(ls, x, nan=True):
    """(n, 2, len(ls)) outputs, not finite where x[:, 0] > 1.2 for model
    1: a model whose redraws the recipe has to follow."""
    cols = []
    for l in ls:
        v = torch.stack([x[:, 0] * (l + 1), x[:, 1] ** 2], dim=1)
        if l == 1 and nan:
            v = torch.where((x[:, :1] > 1.2), torch.full_like(v, np.nan), v)
        cols.append(v)
    return torch.stack(cols, dim=2)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("resample", [0, 64])
def test_group_sums_follow_the_programs_engines(resample, batched):
    from bluest_tpu_torch.sampling.engine import SamplingEngine
    from bluest_tpu_torch.sampling.group_engine import GroupEngine
    draw = lambda gen, n: torch.randn((n, 2), generator=gen,
                                      dtype=torch.float64)
    ls, N, batch = (0, 1), 1000, 256
    if resample:
        model = _toy
        eng = GroupEngine(lambda g, ls_, n: draw(g, n), _toy, 2, batch,
                          "cpu", max_resample=resample)
    else:
        model = lambda ls_, x: _toy(ls_, x, nan=False)
        eng = SamplingEngine(draw, lambda l, x: model((l,), x)[..., 0], 2,
                             batch, "cpu")
    got = eng.sample_sums(ls, 99, 4, N)
    calls, want = streams.follow(ls, N, 99, 4, batch, "cpu", draw, model,
                                 resample, batched)
    assert int(got.n_failed) == 0
    assert torch.allclose(got.sumse[..., 0], want, rtol=1e-13)
    assert len(calls) >= -(-N // batch) and all(
        o.shape == (x.shape[0], 2, 2) for x, o in calls)


def test_group_sums_top_up_like_the_problem():
    """A factored model's failing rows are drawn again from the call's
    next chunks, as BLUEProblem's fetch rounds do."""
    from bluest_tpu_torch import BLUEProblem
    draw = lambda gen, n: torch.randn((n, 2), generator=gen,
                                      dtype=torch.float64)

    class Toy(BLUEProblem):
        def sample_inputs(self, gen, n):
            return draw(gen, n)

        def evaluate_model(self, l, x):
            return _toy((l,), x)[..., 0]

    C = np.array([[1.0, 0.5], [0.5, 1.0]])
    p = Toy(2, C=[C, C], costs=np.array([1.0, 0.5]), n_outputs=2,
            device="cpu", device_batch_size=256, seed=99, verbose=False)
    host = p._sample_groups([(0, 1)], [1000])[0]
    _calls, want = streams.follow((0, 1), 1000, 99, 0, 256, "cpu", draw,
                                  _toy, 0)
    assert host[-1] == 0
    assert np.allclose(host[0][..., 0], want.numpy(), rtol=1e-13)


def test_pilot_inputs_are_as_recorded():
    for c in harness.manifest()["configs"]:
        cfg = harness.load_json(harness.ROOT, c["file"])
        data = np.load(os.path.join(harness.ROOT, cfg["inputs"]))
        fam = {"hodgkin_huxley": hodgkin_huxley}[cfg["family"]]
        assert np.allclose(data["costs"], fam.costs(cfg))
        for k in range(cfg["n_outputs"]):
            C = data["C%d" % k]
            w = np.linalg.eigvalsh(C)
            # positive semidefinite to round-off: the clip at 5e-14 of
            # covariances whose condition reaches 1e16
            assert np.allclose(C, C.T) and w.min() > -1e-12 * w.max()
        assert json.dumps(cfg["pilot"])
