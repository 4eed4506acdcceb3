"""Models: the port's analytic, Matern 2D and Hodgkin-Huxley families
against the JAX package's, on the same inputs.

Relative errors are normwise per output: max |port - jax| over the batch
divided by max |jax| over the batch (an output that crosses zero, like
the Matern field's center value, has no elementwise relative error).

  * analytic: <= 1e-13;
  * Matern 2D, the same white noise w_hat: <= 1e-12 in f64;
  * Hodgkin-Huxley, the same parameters, on the three dt=0.08 models
    (RK4, Euler, FitzHugh-Nagumo) and the dt=0.01 RK4 model: <= 1e-8,
    with the same rows non-finite in both.  Measured on the CPU on these
    inputs: 8.2e-14 normwise at most (HH RK4 at dt=0.08), 8.1e-14 for HH
    Euler at dt=0.08 (whose rows blow up to NaN in 45 of 64 draws in both
    packages), 3.1e-15 for RK4 at dt=0.01.

Each problem's pilot covariance agrees with the JAX package's within the
sampling error of two independent pilots (the random streams differ):
6 standard deviations of the difference, the standard deviation of each
entry's estimate taken from the fourth moments of a separate draw of the
port's model.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

torch.set_num_threads(1)


def _normwise(got, ref):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape
    return (np.abs(got - ref).max(axis=0)
            / np.maximum(np.abs(ref).max(axis=0), 1e-300)).max()


@pytest.mark.parametrize("cls_name", ["ExpSeriesProblem",
                                      "ExpSeriesMultiProblem"])
@pytest.mark.parametrize("n_models", [3, 5])
def test_analytic_outputs_match_jax(cls_name, n_models):
    from bluest_tpu.models import analytic as aj
    from bluest_tpu_torch.models import analytic as at
    z = np.random.default_rng(n_models).standard_normal(300) * 1.5
    pj = object.__new__(getattr(aj, cls_name))
    pt = object.__new__(getattr(at, cls_name))
    pj.n_models = pt.n_models = n_models
    for l in range(n_models):
        ref = jax.vmap(lambda x: pj.evaluate_model_jax(l, x))(jnp.asarray(z))
        got = pt.evaluate_model(l, torch.as_tensor(z))
        assert _normwise(got.numpy(), np.asarray(ref)) <= 1e-13


def test_analytic_host_model_matches_factored():
    """The black-box variant evaluates the same series (numpy)."""
    from bluest_tpu_torch.models import analytic as at
    z = np.random.default_rng(1).standard_normal(200)
    h = object.__new__(at.ExpSeriesHostProblem)
    f = object.__new__(at.ExpSeriesProblem)
    h.n_models = f.n_models = 5
    out = h.evaluate(list(range(5)), [z] * 5)[0]
    for l in range(5):
        ref = f.evaluate_model(l, torch.as_tensor(z))[:, 0].numpy()
        assert _normwise(out[l], ref) <= 1e-13


@pytest.mark.parametrize("grids", [(16, 8, 4), (32, 16, 8, 4)])
@pytest.mark.parametrize("kappa,alpha", [(8.0, 1.0), (4.0, 1.5)])
def test_matern2d_outputs_match_jax(grids, kappa, alpha):
    from bluest_tpu.models import matern2d as mj
    from bluest_tpu_torch.models import matern2d as mt
    n0 = grids[0]
    w = np.random.default_rng(n0).standard_normal((40, n0, n0))
    for n in grids:
        ref = jax.vmap(lambda x: mj.matern2d_outputs(x, n, kappa, alpha))(
            jnp.asarray(w))
        got = mt.matern2d_outputs(torch.as_tensor(w), n, kappa, alpha)
        assert got.shape == (40, 3) and got.dtype == torch.float64
        assert _normwise(got.numpy(), np.asarray(ref)) <= 1e-12
    np.testing.assert_allclose(
        mt._sine_basis(n0, torch.float64).numpy(),
        np.asarray(mj._sine_basis(n0, jnp.float64)), rtol=0, atol=0)


def test_matern2d_problem_model_path():
    """The problem's cached spectra give the module function's outputs,
    and the default dtype is f64."""
    from bluest_tpu_torch.models.matern2d import (Matern2DProblem,
                                                  matern2d_outputs)
    p = Matern2DProblem(grids=(16, 8), C=[np.eye(2) + 0.5] * 3,
                        verbose=False, device="cpu")
    w = p.sample_inputs(torch.Generator().manual_seed(0), 7)
    assert w.shape == (7, 16, 16) and w.dtype == torch.float64
    for l, n in enumerate(p.grids):
        assert torch.equal(p.evaluate_model(l, w),
                           matern2d_outputs(w, n, p.kappa, p.alpha))
    # one process, no process group: "auto" is no mesh, the synthesis is
    # the unsharded one
    q = Matern2DProblem(grids=(16, 8), C=[np.eye(2) + 0.5] * 3, mesh="auto",
                        verbose=False, device="cpu")
    assert q.mesh is None and q._model_mesh is None
    assert torch.equal(q.evaluate_model(0, w), p.evaluate_model(0, w))


@pytest.mark.parametrize("kind,dt", [(0, 0.08), (1, 0.08), (2, 0.08),
                                     (0, 0.01)])
def test_hodgkin_huxley_outputs_match_jax(kind, dt):
    from bluest_tpu.models import hodgkin_huxley as hj
    from bluest_tpu_torch.models import hodgkin_huxley as ht
    rng = np.random.default_rng(int(dt * 100) + kind)
    n = 64
    P = np.stack([8 + 4 * rng.random(n),
                  120 * (1 + 0.1 * rng.standard_normal(n)),
                  36 * (1 + 0.1 * rng.standard_normal(n))], axis=1)
    ref = np.asarray(jax.jit(jax.vmap(
        lambda p: hj._outputs(kind, hj._integrate(kind, dt, p))))(
            jnp.asarray(P)))
    got = ht.hh_outputs(kind, dt, torch.as_tensor(P)).numpy()
    assert got.shape == (n, 5)
    fin = np.isfinite(ref).all(axis=1)
    np.testing.assert_array_equal(np.isfinite(got).all(axis=1), fin)
    assert fin.sum() > 0
    assert _normwise(got[fin], ref[fin]) <= 1e-8


def test_hodgkin_huxley_group_shapes_and_costs():
    from bluest_tpu.models.hodgkin_huxley import HodgkinHuxleyProblem as HJ
    from bluest_tpu_torch.models.hodgkin_huxley import (
        DEFAULT_MODELS, HodgkinHuxleyProblem)
    C = np.eye(12) + 0.5
    p = HodgkinHuxleyProblem(C=[C] * 5, verbose=False, device="cpu")
    pj = HJ(C=[C] * 5, verbose=False)
    np.testing.assert_array_equal(p.get_costs(), pj.get_costs())
    assert p.models == DEFAULT_MODELS and p.n_outputs == 5
    x = p.sample_group(torch.Generator().manual_seed(3), (0, 11), 9)
    assert x.shape == (9, 3) and x.dtype == torch.float64
    assert bool(((x[:, 0] >= 8) & (x[:, 0] <= 12)).all())
    out = p.evaluate_group((3, 11), x)
    assert out.shape == (9, 5, 2)


def _sd_of_cov(outs):
    """Per-entry standard deviation (times sqrt(N)) of a covariance
    estimate, from a draw ``outs`` (n, M) of the models' outputs."""
    x = outs - outs.mean(axis=0)
    m22 = np.einsum('ni,nj->ij', x ** 2, x ** 2) / len(x)
    C = x.T @ x / len(x)
    return np.sqrt(np.maximum(m22 - C ** 2, 0.0))


def _pilot_agrees(Ct, Cj, outs, N):
    sd = _sd_of_cov(outs) * np.sqrt(2.0 / N)     # difference of two pilots
    fin = np.isfinite(Cj)
    assert np.array_equal(fin, np.isfinite(Ct))
    assert np.all(np.abs(Ct - Cj)[fin] <= 6 * sd[fin] + 1e-14), (
        np.max((np.abs(Ct - Cj) / (sd + 1e-300))[fin]))


def _draw(p, n, seed):
    gen = torch.Generator().manual_seed(seed)
    if p._has_factored_model():
        x = p.sample_inputs(gen, n)
        return torch.stack([p.evaluate_model(l, x) for l in range(p.M)],
                           dim=2).numpy()             # (n, No, M)
    x = p.sample_group(gen, tuple(range(p.M)), n)
    out = p.evaluate_group(tuple(range(p.M)), x).numpy()
    return out[np.isfinite(out).all(axis=(1, 2))]


@pytest.mark.parametrize("which", ["analytic", "matern", "hh"])
def test_pilot_covariance_matches_jax(which):
    if which == "analytic":
        from bluest_tpu.models.analytic import ExpSeriesMultiProblem as J
        from bluest_tpu_torch.models.analytic import ExpSeriesMultiProblem as T
        kw, N = dict(n_models=4), 4096
    elif which == "matern":
        from bluest_tpu.models.matern2d import Matern2DProblem as J
        from bluest_tpu_torch.models.matern2d import Matern2DProblem as T
        kw, N = dict(grids=(16, 8, 4)), 2048
    else:
        from bluest_tpu.models.hodgkin_huxley import HodgkinHuxleyProblem as J
        from bluest_tpu_torch.models.hodgkin_huxley import (
            HodgkinHuxleyProblem as T)
        kw, N = dict(models=((0, 0.08), (2, 0.08), (0, 0.04))), 1024
    pt = T(covariance_estimation_samples=N, verbose=False, device="cpu",
           skip_projection=True, **kw)
    pj = J(covariance_estimation_samples=N, verbose=False,
           skip_projection=True, **kw)
    outs = _draw(pt, 8192 if which != "hh" else 2048, seed=99)
    for n in range(pt.n_outputs):
        _pilot_agrees(pt.get_covariance(n), pj.get_covariance(n),
                      outs[:, n, :], N)
