"""The target-RMSE path: eps-mode MOSAP, per-model caps, the scipy NLP and
the eps entry points of BLUEProblem, against the JAX package.

* eps-mode MOSAP on seeded instances (M = 4..6 models, K = 2..3, one or
  two outputs; no seed used here falls back to the NLP in either
  package) and at flagship width (M=10, 3 outputs, K=4 -> L=385, the
  seeded covariances of tests/test_torch_allocation.py):
  - continuous costs within 1e-4 relative;
  - both integer points at V_n <= 1.0001 eps_n^2;
  - identical integer samples from a shared continuous point;
  - ``n_nlp_fallbacks == 0``.
* ``kkt_certificate`` at a shared point: equal to 1e-10.
* The NLP fallback: with the IPM cut to two iterations both cone
  candidates fail in both packages, both fall back once, and the
  max-variances agree within 1e-3.
* Per-model caps in budget and eps modes: caps held in both packages,
  continuous costs within 1e-4 relative.
* ``solver="scipy"`` against JAX's scipy path: max-variance within 1e-3.
* ``complexity_test`` rates equal across packages within 0.02.
* ``variance_test(N=16)`` of the port on the small diffusion problem:
  err/err_ex within [0.4, 1.9] (15 degrees of freedom; 0.40 is the 1e-4
  lower quantile of sqrt(chi2_15/15)).
* ``solve(eps=same)`` reruns no allocation; eps=0, nan or < 0 raise.
* ``solver`` in {admm, scs, spg} and ``{"polish": True}`` solve one seeded
  problem in both packages (costs within 1e-3, 1e-2, 1e-8).
"""

import numpy as np
import pytest
import torch

import bluest_tpu as J
import bluest_tpu_torch as T
from bluest_tpu_torch.allocation.sap import caps_satisfied
from bluest_tpu_torch.models.diffusion import DiffusionProblem

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

GRIDS = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
COSTS = np.array([g / GRIDS[-1] for g in GRIDS])
KW = dict(grids=(32, 16, 8, 4), n_kl=8, sigma=1.0, nu=0.6,
          multi_output=True, verbose=False)


def _instance(seed):
    """Seeded SPD covariances (one per output) and descending costs."""
    rng = np.random.default_rng(seed)
    M, K, No = 4 + seed % 3, 2 + seed % 2, 1 + seed % 2
    Cs = []
    for _ in range(No):
        A = rng.standard_normal((M, M))
        Cs.append(A @ A.T + 0.5 * M * np.eye(M))
    costs = np.sort(rng.uniform(0.1, 1, M))[::-1] * np.arange(M, 0, -1)
    eps = 0.05 * np.sqrt(max(C[0, 0] for C in Cs))
    return M, K, No, Cs, costs, eps


def _pair(seed):
    M, K, No, Cs, costs, eps = _instance(seed)
    pt = T.BLUEProblem(M, C=Cs, costs=costs, n_outputs=No, verbose=False,
                       device="cpu")
    pj = J.BLUEProblem(M, C=Cs, costs=costs, n_outputs=No, verbose=False)
    return pt, pj, K, eps


def _cost(mosap, m):
    return float(np.asarray(m, float) @ mosap.costs)


def _check_eps_pair(pt, pj, K, eps):
    for p in (pt, pj):
        p.setup_solver(K=K, eps=eps)
        assert p.MOSAP.n_nlp_fallbacks == 0
        assert all(c["status"] in ("optimal", "inaccurate")
                   for c in p.MOSAP.certificates)
        eps_n = np.broadcast_to(eps, (p.n_outputs,))
        assert np.all(p.MOSAP_output["variances"] <= 1.0001 * eps_n ** 2)
    mt, mj = pt.MOSAP, pj.MOSAP
    assert mt.flattened_groups == mj.flattened_groups
    ct, cj = (_cost(mt, mt.continuous_solution),
              _cost(mj, mj.continuous_solution))
    assert abs(ct - cj) <= 1e-4 * cj
    # same continuous point in, same integer samples out
    x = mj.continuous_solution.copy()
    it = mt.integer_projection(x.copy(), eps=mt.eps)
    ij = mj.integer_projection(x.copy(), eps=mj.eps)
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("seed", range(6))
def test_eps_mode_matches_jax(seed):
    pt, pj, K, eps = _pair(seed)
    _check_eps_pair(pt, pj, K, eps)


@pytest.fixture(scope="module")
def flagship():
    rng = np.random.default_rng(2)
    M = len(GRIDS)
    Cs = []
    for _ in range(3):
        A = rng.standard_normal((M, M)) * 0.05
        base = 0.97 ** np.abs(np.subtract.outer(np.arange(M), np.arange(M)))
        s = np.exp(rng.standard_normal(M) * 0.3)
        Cs.append(base * np.outer(s, s) + A @ A.T)
    pt = T.BLUEProblem(M, C=Cs, costs=COSTS, n_outputs=3, verbose=False,
                       device="cpu")
    pj = J.BLUEProblem(M, C=Cs, costs=COSTS, n_outputs=3, verbose=False)
    return pt, pj


def test_flagship_eps_mode_matches_jax(flagship):
    pt, pj = flagship
    _check_eps_pair(pt, pj, 4, 2.0e-3)
    assert pt.MOSAP.L == 385


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_kkt_certificate_matches_jax(seed):
    pt, pj, K, eps = _pair(seed)
    pj.setup_solver(K=K, eps=eps)
    pt.setup_solver(K=K, eps=eps)
    x = pj.MOSAP.continuous_solution.copy()
    # the optimum, and a perturbed point that is far from stationary
    x_bad = x * np.random.default_rng(seed).uniform(0.5, 1.5, x.shape)
    for m in (x, x_bad):
        kt = pt.MOSAP.kkt_certificate(m, eps=pt.MOSAP.eps)
        kj = pj.MOSAP.kkt_certificate(m, eps=pj.MOSAP.eps)
        for key in ("stationarity", "dual_infeasibility",
                    "primal_feasibility", "complementarity"):
            assert abs(kt[key] - kj[key]) <= 1e-10, key
        assert kt["n_active"] == kj["n_active"]
        np.testing.assert_allclose(kt["multipliers"], kj["multipliers"],
                                   rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_nlp_fallback_matches_jax(seed, monkeypatch):
    """An IPM cut to two iterations fails both eps candidates; both
    packages then fall back to the scipy NLP once.  Both IPMs warm-start
    exact re-solves from a content-hash cache: it is switched off (one
    env name serves both packages) so both run the same cold IPM."""
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    pt, pj, K, eps = _pair(seed)
    for p in (pt, pj):
        p.setup_solver(K=K, eps=eps,
                       optimization_solver_params={"max_iter": 2})
        assert p.MOSAP.n_nlp_fallbacks == 1
        assert [c["form"] for c in p.MOSAP.certificates] == [
            "direct-eps", "scaled-budget-epigraph"]
    vt = max(pt.MOSAP_output["variances"])
    vj = max(pj.MOSAP_output["variances"])
    assert abs(vt - vj) <= 1e-3 * vj


def _caps(pt, K, eps):
    """Caps at half of models 0 and 1's uncapped eps-mode usage."""
    pt.setup_solver(K=K, eps=eps)
    used = np.array([ee @ pt.MOSAP.samples for ee in pt.MOSAP.ES])
    caps = np.full(pt.M, np.inf)
    caps[:2] = np.maximum(2, np.floor(0.5 * used[:2]))
    return caps, float(pt.MOSAP_output["cost"])


@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("seed", [1, 3])
def test_caps_match_jax(seed, mode):
    pt, pj, K, eps = _pair(seed)
    caps, cost = _caps(pt, K, eps)
    if mode == "budget":
        kw = {"budget": 0.5 * cost}
    else:
        # seed 1 is infeasible at eps under these caps in both packages;
        # loosen the tolerance there until the capped optimum exists
        kw = {"eps": eps * (1.0 if seed == 3 else 2.0)}
    for p in (pt, pj):
        p.setup_solver(K=K, max_model_samples=caps, **kw)
        mo = p.MOSAP
        es, rhs = mo.get_max_sample_constraints(caps)
        assert len(es) == 2
        assert caps_satisfied(mo.samples, es, rhs, slack=1.0, atol=0.0)
        assert caps_satisfied(mo.continuous_solution, es, rhs)
        assert mo.n_nlp_fallbacks == 0
    ct = _cost(pt.MOSAP, pt.MOSAP.continuous_solution)
    cj = _cost(pj.MOSAP, pj.MOSAP.continuous_solution)
    assert abs(ct - cj) <= 1e-4 * cj
    if mode == "eps":
        eps_c = np.broadcast_to(kw["eps"], (pt.n_outputs,))
        assert np.all(pt.MOSAP_output["variances"] <= 1.0001 * eps_c ** 2)
    else:
        assert pt.MOSAP_output["cost"] <= 1.0001 * kw["budget"]


@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("seed", [0, 2])
def test_scipy_solver_matches_jax(seed, mode):
    pt, pj, K, eps = _pair(seed)
    kw = {"eps": eps} if mode == "eps" else {"budget": 1.0e3}
    vs = []
    for p in (pt, pj):
        p.setup_solver(K=K, solver="scipy", continuous_relaxation=True, **kw)
        vs.append(max(p.MOSAP.variances(p.MOSAP.continuous_solution)))
    assert abs(vs[0] - vs[1]) <= 1e-3 * vs[1]
    if mode == "eps":
        assert vs[0] <= 1.0001 * eps ** 2


@pytest.mark.parametrize("seed", [0, 5])
def test_complexity_rate_matches_jax(seed):
    pt, pj, K, eps = _pair(seed)
    eps_list = [2 * eps, eps, eps / 2]
    ct, rt = pt.complexity_test(eps_list, K=K)
    cj, rj = pj.complexity_test(eps_list, K=K)
    assert abs(rt - rj) <= 0.02
    assert 1.9 <= rt <= 2.1
    np.testing.assert_allclose(ct, cj, rtol=1e-3)


@pytest.fixture(scope="module")
def diffusion():
    return DiffusionProblem(covariance_estimation_samples=256, device="cpu",
                            seed=5, **KW)


def test_variance_test_chi_square_band(diffusion):
    err_ex, err = diffusion.variance_test(eps=4.0e-3, K=3, N=16)
    ratio = np.asarray(err) / np.asarray(err_ex)
    assert np.all((0.4 <= ratio) & (ratio <= 1.9)), ratio


def test_solve_reruns_allocation_only_on_a_new_tolerance(diffusion,
                                                         monkeypatch):
    p = diffusion
    p.setup_solver(K=3, eps=4.0e-3)
    calls = []
    real = type(p.MOSAP).solve

    def spy(self, *a, **k):
        calls.append(k.get("eps"))
        return real(self, *a, **k)

    monkeypatch.setattr(type(p.MOSAP), "solve", spy)
    p.solve(K=3, eps=4.0e-3, verbose=False)
    p.solve(K=3, eps=[4.0e-3] * 3, verbose=False)
    assert calls == []
    p.solve(K=3, eps=5.0e-3, verbose=False)
    assert len(calls) == 1
    p.solve(K=3, verbose=False)              # reuses the last allocation
    assert len(calls) == 1


@pytest.mark.parametrize("bad", [0.0, float("nan"), -1.0e-3])
def test_bad_tolerance_raises_in_both(bad):
    pt, pj, K, _ = _pair(0)
    for p in (pt, pj):
        with pytest.raises(ValueError):
            p.setup_solver(K=K, eps=bad)
        with pytest.raises(ValueError):
            p.setup_solver(K=K, eps=[bad] * p.n_outputs)


@pytest.mark.parametrize("kw", [{"solver": "admm"}, {"solver": "scs"},
                                {"solver": "spg"},
                                {"optimization_solver_params":
                                 {"polish": True}}])
def test_unported_families_raise(kw):
    """(The name is from when these four raised NotImplementedError in the
    port.)  Each family now solves one seeded problem in both packages
    (``_pair(1)``; the operator-splitting solver needs ~50k iterations a
    cone solve there in either package, so ``admm`` takes the two-output
    ``_pair(3)`` with the iterations capped at 8000 -- the direct form
    converges in ~2k and its epigraph cross-check runs out, in both
    packages -- and ``scs`` the one-output ``_pair(4)`` at the
    defaults): every tolerance met, no NLP fallback, and the continuous
    costs within the family's accuracy of each other -- 1e-3 for the
    operator-splitting solver (it stops at 1e-6 residuals), 1e-2 for the
    projected gradient on the smoothed max (the bias of its last
    temperature), 1e-8 for the polished interior-point points (polishing
    removes the solver's own error)."""
    seed = {"admm": 3, "scs": 4}.get(kw.get("solver"), 1)
    if kw.get("solver") == "admm":
        kw = dict(kw, optimization_solver_params={"max_iter": 8000})
    pt, pj, K, eps = _pair(seed)
    tol = {"admm": 1e-3, "scs": 1e-3, "spg": 1e-2}.get(kw.get("solver"),
                                                      1e-8)
    cost = []
    for p in (pt, pj):
        p.setup_solver(K=K, eps=eps, continuous_relaxation=True, **kw)
        assert p.MOSAP.n_nlp_fallbacks == 0
        m = np.asarray(p.MOSAP.samples, float)
        assert np.all(np.asarray(p.MOSAP.variances(m))
                      <= 1.0001 * eps ** 2)
        cost.append(_cost(p.MOSAP, m))
        if "solver" not in kw:
            assert p.MOSAP.polish_report["stationarity"] <= 1e-9
    assert abs(cost[0] - cost[1]) <= tol * cost[1]
    # and beside the port's own interior-point point
    ref = _pair(seed)[0]
    ref.setup_solver(K=K, eps=eps, continuous_relaxation=True)
    c_ref = _cost(ref.MOSAP, ref.MOSAP.samples)
    assert abs(cost[0] - c_ref) <= max(tol, 1e-4) * c_ref
