"""Slice level: the deep-grid diffusion hierarchy (grids past K1's 1025
cells, many KL modes, float64) in both packages.

A cut-down deep-grid problem -- grids (2048, 1026, 512, 128, 32), 512 KL
modes, f64, a 128-sample pilot, on the CPU -- is held to the JAX package
at the three levels the slice touches:

* model: ``DiffusionProblem.evaluate_model`` against the JAX problem's
  ``evaluate_model_jax`` on the same numpy xi, at the model tolerance of
  ``tests/test_torch_diffusion.py`` (max relative 1e-9, median 1e-11,
  both times max(1, (n/1024)^2): the system's condition grows with n^2).
  The max is held against the JAX model.  The median is held against an
  extended-precision (np.longdouble) solve of the same system, whose
  mode matrix is formed in np.longdouble in the test itself, beside
  the JAX model's own median error there: with 512 modes each package's
  f64 solve is off that solve by a median of up to ~3e-11 at n=2048, so
  the two f64 models differ by the sum of two such errors;
* allocation: the port's pilot graph, saved and loaded into
  ``bluest_tpu.BLUEProblem``, gives the same continuous cost within the
  IPM certificate's tolerance (1e-7 relative, as
  ``tests/test_torch_problem.py:test_torch_graph_loads_in_jax``);
* estimator: the port's ``solve`` within 4 error bars of an MC estimate
  of model 0 drawn from an independent numpy stream, evaluated through
  the model-level reference formulation (``solve_diffusion_outputs``).

On the card the two finest models run K1's wide tier and the rest K1;
here every model runs the plain version that both tiers share.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import bluest_tpu
from bluest_tpu.models.diffusion import DiffusionProblem as JaxDiffusion
from bluest_tpu_torch.models.diffusion import (DiffusionProblem,
                                               solve_diffusion_outputs)
from bluest_tpu_torch.ops import diffusion as k1

torch.set_num_threads(1)

GRIDS = (2048, 1026, 512, 128, 32)
KW = dict(grids=GRIDS, n_kl=512, sigma=1.0, nu=0.6, multi_output=True,
          verbose=False)
PILOT = 128
BUDGET = 1.5e4          # in units of the coarsest model's cost
MC = 2048


@pytest.fixture(autouse=True)
def _cold_ipm():
    """Both packages' warm-start caches start empty (see
    tests/test_torch_problem.py)."""
    from bluest_tpu.solvers import sdp as sdp_j
    from bluest_tpu_torch.solvers import sdp as sdp_t
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    p = DiffusionProblem(covariance_estimation_samples=PILOT, device="cpu",
                         dtype=torch.float64, **KW)
    npz = str(tmp_path_factory.mktemp("deep") / "deep_graph.npz")
    p.save_graph_data(npz)
    return p, npz


def test_deep_grid_tiers():
    """On the card the slice's two finest grids run the wide tier, the
    others K1, in both dtypes."""
    for dt in (torch.float32, torch.float64):
        assert [k1.tier(g, KW["n_kl"], dt) for g in GRIDS] == [
            "wide", "wide", "k1", "k1", "k1"]


def _extended_outputs(xis, n):
    """The three QoIs of the model's tridiagonal system solved by Thomas
    in np.longdouble (x86's 80-bit extended type), vectorized over the
    samples.  Its mode matrix sin(pi x_i k) sigma k^-nu sqrt(2) is formed
    here in np.longdouble from the formula, so it shares no code with
    either package's."""
    ld = np.longdouble
    pi = np.arccos(ld(-1))
    xf = (np.arange(n, dtype=ld) + ld(0.5)) / ld(n)
    k = np.arange(1, xis.shape[1] + 1, dtype=ld)
    ck = ld(KW["sigma"]) * k ** (-ld(KW["nu"])) * np.sqrt(ld(2))
    mck = np.sin(pi * xf[:, None] * k[None, :]) * ck[None, :]
    a = np.exp(xis.astype(ld) @ mck.T)
    h = np.longdouble(1) / n
    m = n - 1
    cp, dp = [], []
    c_prev = d_prev = np.zeros(len(xis), np.longdouble)
    for i in range(m):
        lo = -a[:, i] if i > 0 else 0
        r = 1 / ((a[:, i] + a[:, i + 1]) - lo * c_prev)
        c_prev = -a[:, i + 1] * r if i < m - 1 else 0 * r
        d_prev = (h * h - lo * d_prev) * r
        cp.append(c_prev)
        dp.append(d_prev)
    u = np.zeros((len(xis), n + 1), np.longdouble)
    for i in range(m - 1, -1, -1):
        u[:, i + 1] = dp[i] - cp[i] * u[:, i + 2]
    du = np.diff(u, axis=1)
    return np.stack([h * u.sum(axis=1), u[:, n // 2],
                     n * (a * du * du).sum(axis=1)], axis=1)


def test_deep_grid_models_match_jax(deep):
    p, _ = deep
    pj = JaxDiffusion(C=[np.eye(len(GRIDS))] * 3, **KW)
    assert p.n_modes == pj.n_modes == (512, 256, 128, 32, 8)
    xis = np.random.default_rng(8).standard_normal((48, KW["n_kl"]))
    for l, n in enumerate(GRIDS):
        ref = np.asarray(jax.jit(jax.vmap(lambda t: jnp.asarray(
            pj.evaluate_model_jax(l, t))))(jnp.asarray(xis)))
        got = p.evaluate_model(l, torch.as_tensor(xis)).numpy()
        assert got.shape == (48, 3)
        scale = max(1.0, (n / 1024) ** 2)
        assert (np.abs(got - ref) / np.abs(ref)).max() <= 1e-9 * scale
        ext = _extended_outputs(xis * (np.arange(KW["n_kl"])
                                       < p.n_modes[l]), n)
        err = np.abs(got - ext) / np.abs(ext)
        err_jax = np.abs(ref - ext) / np.abs(ext)
        assert err.max() <= 1e-9 * scale
        assert np.median(err) <= 1e-11 * scale
        assert np.median(err) <= 1.5 * np.median(err_jax)


def test_deep_grid_graph_allocates_in_jax(deep):
    """The port's pilot graph, loaded into the JAX package, gives the same
    continuous cost as the port from the same graph."""
    p, npz = deep
    pj = bluest_tpu.BLUEProblem(len(GRIDS), datafile=npz, n_outputs=3,
                                verbose=False)
    np.testing.assert_array_equal(pj.get_costs(), p.get_costs())
    for n in range(3):
        np.testing.assert_array_equal(pj.get_covariance(n),
                                      p.get_covariance(n))
    p.setup_solver(K=4, budget=BUDGET, continuous_relaxation=True)
    pj.setup_solver(K=4, budget=BUDGET, continuous_relaxation=True)
    ct = p.MOSAP_output["certificates"][-1]
    cj = pj.MOSAP_output["certificates"][-1]
    assert ct["status"] in ("optimal", "inaccurate")
    assert abs(ct["pobj"] - cj["pobj"]) <= 1e-7 * abs(cj["pobj"])


def test_deep_grid_solve_matches_mc(deep):
    """MLBLUE on the deep hierarchy within 4 error bars of an MC estimate
    of model 0 (independent numpy draws), every output."""
    p, _ = deep
    p.setup_solver(K=4, budget=BUDGET)
    mus, errs, _cost = p.solve(K=4, budget=BUDGET)
    mus = np.asarray(mus, float)
    errs = np.asarray(errs, float)
    assert np.all(np.isfinite(mus)) and np.all(errs > 0)
    xi = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (MC, KW["n_kl"])))
    q = solve_diffusion_outputs(xi, GRIDS[0], KW["sigma"], KW["nu"]).numpy()
    mc, se = q.mean(axis=0), q.std(axis=0, ddof=1) / np.sqrt(MC)
    assert np.all(np.abs(mus - mc) <= 4 * np.sqrt(errs ** 2 + se ** 2))
