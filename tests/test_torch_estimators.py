"""MLMC, MFMC and MC estimators: the port against the JAX package.

* Closed forms (``estimators/closed_forms.py``, ``best_integer_generic``)
  on seeded inputs: integer samples identical, errors, costs and bounds
  equal to 1e-12 relative.
* From one JAX-written graph npz (a 256-sample pilot of the small
  diffusion hierarchy), loaded by both packages:
  - ``setup_mlmc`` / ``setup_mfmc`` / ``solve_mc`` allocations identical
    (same models and samples; errors and total cost to 1e-12), in budget
    and eps modes;
  - estimator assembly at the "sums" level: both packages' sum fetches
    are patched to return the same per-group sums, and ``mus`` agree to
    1e-12;
  - estimates from each package's own random streams agree per output
    within 4 sqrt(err_torch^2 + err_jax^2);
  - ``compute_mlmc_data`` / ``compute_mfmc_data`` on a setup's own
    schedule reproduce its errors and cost, equal across packages.
"""

import numpy as np
import pytest
import torch

from bluest_tpu.estimators import closed_forms as jcf
from bluest_tpu.models.diffusion import DiffusionProblem as JaxDiffusion
from bluest_tpu.solvers.integer import best_integer_generic as j_generic
from bluest_tpu_torch.estimators import closed_forms as tcf
from bluest_tpu_torch.models.diffusion import DiffusionProblem
from bluest_tpu_torch.solvers.integer import best_integer_generic as t_generic

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _cold_ipm():
    """The interior-point solvers' warm-start caches are process-wide:
    every test starts with both empty, so no test's cone solves depend on
    which tests ran before it in the same process."""
    from bluest_tpu.solvers import sdp as sdp_j
    from bluest_tpu_torch.solvers import sdp as sdp_t
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()

KW = dict(grids=(32, 16, 8, 4), n_kl=8, sigma=1.0, nu=0.6,
          multi_output=True, verbose=False)
BUDGET = 2.0e4
EPS = 3.0e-3
MODES = {"budget": {"budget": BUDGET}, "eps": {"eps": EPS}}


def _close(a, b, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                               rtol=rtol, atol=0)


def _same_data(dt, dj):
    """Closed-form result dicts: integer samples identical, the rest to
    1e-12 (the variance closures compared at the returned samples)."""
    assert (dt is None) == (dj is None)
    if dj is None:
        return
    np.testing.assert_array_equal(dt["samples"], dj["samples"])
    _close(dt["error"], dj["error"])
    _close(dt["total_cost"], dj["total_cost"])
    var_t, var_j = dt["variance"], dj["variance"]
    if callable(var_j):
        var_t, var_j = var_t(dj["samples"]), var_j(dj["samples"])
    _close(var_t, var_j)
    for key in ("alphas", "order"):
        if key in dj:
            _close(dt[key], dj[key])


def _mlmc_levels(seed):
    rng = np.random.default_rng(seed)
    L = 3 + seed % 3
    v = np.sort(rng.uniform(0.01, 1.0, L))[::-1]
    w = np.sort(rng.uniform(1.0, 100.0, L))[::-1]
    return v, w


def _mfmc_inputs(seed):
    """M = 3..5 models whose cost ratios beat their correlation-gain
    ratios, so that every mode and variant below is feasible."""
    rng = np.random.default_rng(100 + seed)
    M = 3 + seed % 3
    sigmas = rng.uniform(0.5, 2.0, M)
    rhos = (np.array([1.0, 0.98, 0.9, 0.75, 0.5])[:M]
            * np.concatenate([[1.0], rng.uniform(0.99, 1.0, M - 1)]))
    costs = 100.0 * 8.0 ** -np.arange(M) * rng.uniform(0.8, 1.2, M)
    return sigmas, rhos, costs


@pytest.mark.parametrize("relax", [False, True])
@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("seed", range(4))
def test_mlmc_allocation_matches_jax(seed, mode, relax):
    v, w = _mlmc_levels(seed)
    kw = {"budget": 50.0 * w.sum()} if mode == "budget" else {"eps": 0.05}
    okt, dt = tcf.mlmc_allocation(v, w, continuous_relaxation=relax, **kw)
    okj, dj = jcf.mlmc_allocation(v, w, continuous_relaxation=relax, **kw)
    assert okt == okj and okj
    _same_data(dt, dj)


@pytest.mark.parametrize("variant", ["sorted", "small_budget", "forced"])
@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("seed", range(3))
def test_mfmc_allocation_matches_jax(seed, mode, variant):
    sigmas, rhos, costs = _mfmc_inputs(seed)
    kw = {"budget": 3.0e3} if mode == "budget" else {"eps": 0.05}
    if variant == "small_budget":
        kw["small_budget"] = True
    if variant == "forced":
        # swap the two cheapest models: an inverted near-tie order
        order = np.arange(len(rhos))
        order[-2:] = order[-2:][::-1]
        kw["order"] = order
    okt, dt = tcf.mfmc_allocation(sigmas, rhos, costs, **kw)
    okj, dj = jcf.mfmc_allocation(sigmas, rhos, costs, **kw)
    assert okt == okj and okj
    _same_data(dt, dj)


@pytest.mark.parametrize("seed", range(3))
def test_mfmc_check_low_budget_and_bounds_match_jax(seed):
    sigmas, rhos, costs = _mfmc_inputs(seed)
    samples = np.cumsum(np.arange(1, len(rhos) + 1) * 7)
    okt, dt = tcf.mfmc_check(sigmas, rhos, costs, samples)
    okj, dj = jcf.mfmc_check(sigmas, rhos, costs, samples)
    assert okt == okj and okj
    _same_data(dt, dj)
    for clamp in (False, True):
        np.testing.assert_array_equal(
            tcf.mfmc_low_budget(rhos, costs, 250.0, clamp=clamp),
            jcf.mfmc_low_budget(rhos, costs, 250.0, clamp=clamp))
    rng = np.random.default_rng(seed)
    V = rng.uniform(0.01, 1.0, (6, 4))
    W = rng.uniform(1.0, 10.0, (6, 4))
    V[0, 2] = np.inf
    mask = np.arange(4)[None, :] < rng.integers(1, 5, 6)[:, None]
    for kw in ({"budget": 500.0}, {"eps": 0.05}):
        ft, bt = tcf.mlmc_bounds_batch(V, W, mask, **kw)
        fj, bj = jcf.mlmc_bounds_batch(V, W, mask, **kw)
        np.testing.assert_array_equal(ft, fj)
        _close(bt, bj)


@pytest.mark.parametrize("seed", range(3))
def test_best_integer_generic_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sol = rng.uniform(0.5, 9.0, 6)
    w = rng.uniform(1.0, 3.0, 6)
    cap = 0.98 * float(np.ceil(sol) @ w)
    obj = lambda m: float(np.sum((m - sol) ** 2))
    constr = lambda m: m @ w <= cap
    bt, ft = t_generic(sol, obj, constr, N=4)
    bj, fj = j_generic(sol, obj, constr, N=4)
    np.testing.assert_array_equal(bt, bj)
    assert ft == fj


# ------------------- problem level, from one JAX npz ------------------ #

@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    npz = str(tmp_path_factory.mktemp("est") / "jax_graph.npz")
    JaxDiffusion(covariance_estimation_samples=256, **KW).save_graph_data(npz)
    pj = JaxDiffusion(datafile=npz, **KW)
    pt = DiffusionProblem(datafile=npz, device="cpu", **KW)
    return pt, pj


def _same_setup(dt, dj):
    assert list(dt["models"]) == list(dj["models"])
    np.testing.assert_array_equal(dt["samples"], dj["samples"])
    _close(dt["errors"], dj["errors"])
    _close(dt["total_cost"], dj["total_cost"])


@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("which", ["mlmc", "mfmc"])
def test_setup_allocations_match_jax(problems, which, mode):
    pt, pj = problems
    dt = getattr(pt, "setup_" + which)(**MODES[mode])
    dj = getattr(pj, "setup_" + which)(**MODES[mode])
    _same_setup(dt, dj)
    if which == "mfmc":
        _close(np.concatenate(dt["alphas"]), np.concatenate(dj["alphas"]))
    if mode == "eps":
        assert max(dt["errors"]) <= EPS * (1 + 1e-6)
    else:
        assert dt["total_cost"] <= BUDGET * (1 + 1e-12)


def _fake_sumse(No, groups, ns):
    """Deterministic per-group sums: sumse[n][i] for model i of a group."""
    out = []
    for g, N in zip(groups, ns):
        if N <= 0:
            out.append(None)
            continue
        rng = np.random.default_rng([int(l) for l in g] + [int(N)])
        out.append([[float(N) * (0.1 + 0.01 * rng.standard_normal())
                     for _ in g] for _ in range(No)])
    return out


def _inject(monkeypatch, p, calls):
    def fake_pipelined(group_list, n_list):
        calls.append(("pipelined", [list(g) for g in group_list],
                      [int(n) for n in n_list]))
        return _fake_sumse(p.n_outputs, group_list, n_list)

    def fake_blue_fn(ls, N, verbose=True, compute_mlmc_differences=False):
        calls.append(("blue_fn", list(ls), int(N)))
        return _fake_sumse(p.n_outputs, [ls], [N])[0], None, 0.0

    monkeypatch.setattr(p, "_pipelined_sumse", fake_pipelined)
    monkeypatch.setattr(p, "blue_fn", fake_blue_fn)


@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("which", ["mlmc", "mfmc", "mc"])
def test_assembly_from_injected_sums_matches_jax(problems, monkeypatch,
                                                 which, mode):
    """Same per-group sums into both packages' estimator assembly: the
    same sampling requests, and mus equal to 1e-12."""
    pt, pj = problems
    out, calls = {}, {}
    for name, p in (("t", pt), ("j", pj)):
        calls[name] = []
        _inject(monkeypatch, p, calls[name])
        out[name] = getattr(p, "solve_" + which)(**MODES[mode])
    assert calls["t"] == calls["j"] and calls["t"]
    (mt, et, ct), (mj, ej, cj) = out["t"], out["j"]
    _close(np.asarray(mt, float), np.asarray(mj, float))
    _close(et, ej)
    _close(ct, cj)


@pytest.mark.parametrize("which", ["mlmc", "mfmc", "mc"])
def test_estimates_from_own_streams_agree(problems, which):
    pt, pj = problems
    mt, et, ct = getattr(pt, "solve_" + which)(eps=EPS)
    mj, ej, cj = getattr(pj, "solve_" + which)(eps=EPS)
    mt, mj = np.asarray(mt, float), np.asarray(mj, float)
    et, ej = np.asarray(et, float), np.asarray(ej, float)
    assert np.all(np.isfinite(mt)) and np.all(et > 0)
    _close(et, ej)
    _close(ct, cj)
    assert np.all(et <= EPS * (1 + 1e-6))
    assert np.all(np.abs(mt - mj) <= 4 * np.sqrt(et ** 2 + ej ** 2))


@pytest.mark.parametrize("which", ["mlmc", "mfmc"])
def test_compute_data_consistent_with_setup(problems, which):
    pt, pj = problems
    res = {}
    for name, p in (("t", pt), ("j", pj)):
        d = getattr(p, "setup_" + which)(eps=EPS)
        if which == "mlmc":
            c = p.compute_mlmc_data(d["models"], d["samples"])
        else:
            # compute_mfmc_data takes the clique in model-index order and
            # returns it in the |rho|-descending order setup_mfmc emits
            by_model = dict(zip(d["models"], np.asarray(d["samples"])))
            clique = sorted(d["models"])
            c = p.compute_mfmc_data(clique, [by_model[m] for m in clique])
            assert list(c["models"]) == list(d["models"])
            _close(np.concatenate(c["alphas"]), np.concatenate(d["alphas"]))
        _close(c["errors"], d["errors"], rtol=1e-9)
        _close(c["total_cost"], d["total_cost"])
        res[name] = c
    _same_setup(res["t"], res["j"])
