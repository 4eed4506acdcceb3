"""The single-output ``SAP.solve`` of the port against the JAX package.

Seeded instances (the generator of tests/test_polish.py, copied: M = 4..6
correlated models, K = 2..3, log-uniform descending costs), both packages
on the CPU in f64, both IPMs' warm-start caches off so both run the same
cold solves.

* ``solver`` in {sdp, scipy} x {budget, eps, budget + caps, eps + caps},
  the caps binding: continuous cost (eps) or variance (budget) within 1e-4
  relative for the IPM and 1e-3 for the NLP (the certificates' tolerances:
  the IPM accepts relgap <= 1e-4 as "inaccurate", trust-constr stops at
  ~1e-6), the tolerance / budget / caps held in both, no NLP fallback.
  The eps-mode NLP under caps starts from the reference's random point and
  can end infeasible: then it returns None in both packages alike.
* ``integer_projection`` from ONE shared continuous point: identical
  samples; ``best_integer_blue`` alone on the same input: identical value
  and samples, in both modes and under caps.
* The reference aliases ``cvxopt_solve`` / ``cvxpy_solve`` / ``ipopt_solve``
  record ``continuous_solution``; ``get_variance_functions`` returns the
  three closures; ``get_phi`` equals JAX's to 1e-12.
* ``kkt_certificate`` at the interior-point solver's point: stationarity
  <= 1e-5, and equal to JAX's at a shared point to 1e-9; the aliases'
  points within 1e-4 (the NLP's rescaled point only within its own
  accuracy, 0.1-0.5 in both packages).
* Missing budget/eps, a bad ``max_model_samples`` and an unknown solver
  raise ``ValueError``; an SDP cut to 2 iterations falls back to the NLP
  once in both packages.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.allocation.sap import SAP as SAP_J
from bluest_tpu.solvers.integer import best_integer_blue as bib_j
from bluest_tpu_torch.allocation.sap import SAP, caps_satisfied
from bluest_tpu_torch.solvers import sdp as sdp_t
from bluest_tpu_torch.solvers.integer import best_integer_blue as bib_t
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


@pytest.fixture(autouse=True)
def _cold_ipm(monkeypatch):
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    sdp_t._WARM_CACHE.clear()


def _instance(seed):
    rng = np.random.default_rng(seed)
    M, K = 4 + seed % 3, 2 + seed % 2
    A = rng.standard_normal((M, M))
    C = A @ A.T + 0.1 * np.eye(M)
    groups = [[list(c) for c in combinations(range(M), k)]
              for k in range(1, K + 1)]
    mc = np.sort(np.exp(rng.uniform(0.0, np.log(100.0), M)))[::-1]
    costs = np.array([mc[list(g)].sum() for gk in groups for g in gk])
    eps = 0.03 * np.sqrt(C[0, 0])
    return M, K, C, groups, costs, eps


def _pair(seed):
    M, K, C, groups, costs, eps = _instance(seed)
    return (SAP(C, K, groups, costs), SAP_J(C, K, groups, costs), costs,
            eps)


def _caps(st, eps):
    """Caps at half the uncapped eps-mode usage of the two most used
    low-fidelity models, so both caps bind."""
    m = st.solve(eps=eps, continuous_relaxation=True)
    used = np.array([ee @ m for ee in st.ES])
    top = 1 + np.argsort(-used[1:])[:2]
    caps = np.full(st.N, np.inf)
    caps[top] = np.maximum(2, np.floor(0.5 * used[top]))
    return caps, float(m @ st.costs)


MODES = ["budget", "eps", "budget-caps", "eps-caps"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("solver", ["sdp", "scipy"])
@pytest.mark.parametrize("seed", [1, 3])
def test_solve_matches_jax(seed, solver, mode):
    st, sj, costs, eps = _pair(seed)
    caps, cost = _caps(st, eps)
    kw = {"budget": 0.5 * cost} if mode.startswith("budget") else {"eps": eps}
    if mode.endswith("caps"):
        kw["max_model_samples"] = caps
    tol = 1e-4 if solver == "sdp" else 1e-3
    out = []
    for s in (st, sj):
        m = s.solve(solver=solver, continuous_relaxation=True, **kw)
        assert s.n_nlp_fallbacks == 0
        if m is None:
            # trust-constr from the reference's random eps-mode start
            # can end infeasible under caps: then both packages say so
            assert (solver, mode) == ("scipy", "eps-caps")
            out.append(None)
            continue
        np.testing.assert_array_equal(s.continuous_solution, m)
        if "budget" in kw:
            assert m @ costs <= kw["budget"] * 1.0001
        else:
            assert s.variance(m) <= 1.001 * eps ** 2
        if mode.endswith("caps"):
            es, rhs = s.get_max_sample_constraints(caps)
            assert len(es) == 2 and caps_satisfied(m, es, rhs)
        out.append((float(m @ costs), s.variance(m)))
    if None in out:
        assert out == [None, None]
        return
    (ct, vt), (cj, vj) = out
    if "budget" in kw:
        assert abs(vt - vj) <= tol * vj
    else:
        assert abs(ct - cj) <= tol * cj
    if solver == "sdp":
        assert [c["form"] for c in st.certificates] == \
            [c["form"] for c in sj.certificates]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", [0, 2, 4])
def test_integer_projection_from_a_shared_point(seed, mode):
    st, sj, costs, eps = _pair(seed)
    caps, cost = _caps(st, eps)
    kw = {"budget": 0.5 * cost} if mode.startswith("budget") else {"eps": eps}
    mms = caps if mode.endswith("caps") else None
    x = np.asarray(sj.solve(continuous_relaxation=True,
                            max_model_samples=mms, **kw), float)
    it = st.integer_projection(x.copy(), max_model_samples=mms, **kw)
    ij = sj.integer_projection(x.copy(), max_model_samples=mms, **kw)
    assert it.dtype == np.int64
    np.testing.assert_array_equal(it, ij)
    info = st.get_max_sample_constraints(mms)
    vt, ft = bib_t(x.copy(), st.psi, costs, st.e, max_samples_info=info, **kw)
    vj, fj = bib_j(x.copy(), sj.psi, costs, sj.e, max_samples_info=info, **kw)
    np.testing.assert_array_equal(vt, vj)
    assert abs(ft - fj) <= 1e-10 * abs(fj)
    np.testing.assert_array_equal(vt, it)


def test_best_integer_blue_infeasible_budget():
    st, _, costs, _ = _pair(0)
    x = np.full(st.L, 3.4)
    val, f = bib_t(x, st.psi, costs, st.e, budget=1.0)
    assert val is None and np.isinf(f)
    with pytest.raises(ValueError, match="brute-force"):
        # 1.2 N = 26 fractional entries to search (the check precedes
        # any use of psi)
        bib_t(np.full(30, 2.5), np.zeros((22 * 22, 30)), np.ones(30),
              np.ones(30), budget=1e9)


def test_full_solve_integer_path():
    st, sj, costs, eps = _pair(3)
    mt, mj = st.solve(eps=eps), sj.solve(eps=eps)
    assert mt.dtype == np.int64
    assert st.variance(mt) <= 1.0001 * eps ** 2
    assert abs(mt @ costs - mj @ costs) <= 0.02 * (mj @ costs)
    assert st.tot_cost == mt @ costs and st.eps == eps
    np.testing.assert_array_equal(st.samples, mt)
    # the estimator assembly reads the stored samples
    sums = [[0.0] * len(g) for g in st.flattened_groups]
    mu, var = st.compute_BLUE_estimator(sums)
    assert mu == 0.0 and abs(var - st.variance(mt)) <= 1e-12 * var


def test_aliases_and_closures():
    st, sj, costs, eps = _pair(1)
    for name, kw in (("cvxopt_solve", {"cvxopt_params": {"tol": 1e-7}}),
                     ("cvxpy_solve", {}), ("ipopt_solve", {})):
        st.continuous_solution = None
        m = getattr(st, name)(eps=eps, **kw)
        np.testing.assert_array_equal(st.continuous_solution, m)
        # the NLP's rescaled point is first-order accurate only to its
        # own tolerance (0.1-0.5 here, in both packages)
        assert st.kkt_certificate()["stationarity"] <= (
            1.0 if name == "ipopt_solve" else 1e-4)
        with pytest.raises(ValueError):
            getattr(st, name)()
    mj = sj.ipopt_solve(eps=eps)
    assert abs(m @ costs - mj @ costs) <= 1e-6 * (mj @ costs)
    mj = sj.cvxopt_solve(eps=eps)
    assert abs(m @ costs - mj @ costs) <= 1e-3 * (mj @ costs)
    get_phi, variance, variance_GH = st.get_variance_functions()
    np.testing.assert_allclose(get_phi(mj, 0.5), sj.get_phi(mj, 0.5),
                               rtol=1e-12, atol=1e-12)
    assert variance(mj) == st.variance(mj)
    assert variance_GH(mj)[2].shape == (st.L, st.L)


@pytest.mark.parametrize("seed", [1, 3, 6])
def test_kkt_certificate(seed):
    st, sj, costs, eps = _pair(seed)
    m = st.solve(eps=eps, continuous_relaxation=True)
    assert st.certificates[0]["status"] in ("optimal", "inaccurate")
    kt = st.kkt_certificate()
    assert kt["stationarity"] <= 1e-5
    assert kt["primal_feasibility"] <= 1e-6
    kj = sj.kkt_certificate(m, eps=eps)
    for key in ("stationarity", "dual_infeasibility", "primal_feasibility",
                "complementarity"):
        assert abs(kt[key] - kj[key]) <= 1e-9, key
    with pytest.raises(ValueError, match="solve first"):
        _pair(seed)[0].kkt_certificate()


def test_errors():
    st, _, costs, eps = _pair(0)
    with pytest.raises(ValueError, match="budget or RMSE"):
        st.solve()
    with pytest.raises(ValueError, match="budget or RMSE"):
        st.integer_projection(np.ones(st.L))
    with pytest.raises(ValueError, match="one entry per model"):
        st.solve(eps=eps, max_model_samples=[10, 10])
    with pytest.raises(ValueError, match="at least once"):
        st.solve(eps=eps, max_model_samples=[0] + [np.inf] * (st.N - 1))
    with pytest.raises(ValueError, match="'sdp' \\(default\\), 'admm', "
                                         "'scipy', 'spg'"):
        st.solve(eps=eps, solver="mosek")


def test_nlp_fallback_counts_in_both():
    st, sj, costs, eps = _pair(1)
    out = []
    for s in (st, sj):
        m = s.solve(eps=eps, continuous_relaxation=True,
                    solver_params={"max_iter": 2})
        assert s.n_nlp_fallbacks == 1
        assert [c["form"] for c in s.certificates] == [
            "direct-eps", "scaled-budget-epigraph"]
        out.append(float(m @ costs))
    assert abs(out[0] - out[1]) <= 1e-3 * out[1]
