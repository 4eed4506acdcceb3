"""The projected-gradient allocation family of the port against the JAX
package (``solvers/spg_alloc.py``, ``SAP.spg_solve``, ``MOSAP.spg_solve``).

Inputs come from numpy seeds (the generators of tests/test_allocation.py,
copied here); both packages run on the CPU in f64.

* ``budget_projection`` and ``capped_projection`` on seeded points
  (feasible, over budget, a zero cap): 1e-12 absolute on O(1..100) entries.
* ``_reg_variance`` against JAX to 1e-10 relative; its closed-form gradient
  against ``jax.grad`` to 1e-10 relative of the largest entry and against
  ``torch.autograd`` through the Cholesky to 1e-9.
* ``solve_budget_spg`` / ``solve_budget_spg_multi`` against JAX: objective
  (the variance, the max-variance) to 1e-6 relative, budget to 1e-9.
* ``solver="spg"`` through ``SAP`` / ``MOSAP`` in budget mode, eps mode,
  heterogeneous eps, and caps in both modes, under the gates of the JAX
  package's own tests: variance within 2e-3 (one output) or 2e-2 (smoothed
  max over two) of the interior-point solver's, cost within 1% / 10%.
"""

from itertools import combinations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bluest_tpu.allocation.sap import SAP as SAP_J
from bluest_tpu.solvers import spg_alloc as spg_j
from bluest_tpu_torch.allocation.mosap import MOSAP
from bluest_tpu_torch.allocation.sap import SAP
from bluest_tpu_torch.solvers import sdp as sdp_t
from bluest_tpu_torch.solvers import spg_alloc as spg_t
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


F64 = torch.float64


@pytest.fixture(autouse=True)
def _cold_ipm():
    sdp_t._WARM_CACHE.clear()
    yield
    sdp_t._WARM_CACHE.clear()


def _sap_data(M=6, K=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M))
    C = A @ A.T + M * np.eye(M)
    groups = [[list(c) for c in combinations(range(M), k)]
              for k in range(1, K + 1)]
    L = sum(len(g) for g in groups)
    costs = 1.0 + 5 * np.arange(L)[::-1].astype(float)
    return C, groups, costs


def make_sap(M=6, K=3, seed=0):
    C, groups, costs = _sap_data(M, K, seed)
    return SAP(C, K, groups, costs), C, costs


def make_mosap(M=5, K=2, No=2, seed=0):
    rng = np.random.default_rng(seed)
    Cs = []
    for _ in range(No):
        A = rng.standard_normal((M, M))
        Cs.append(A @ A.T + M * np.eye(M))
    groups = [[list(c) for c in combinations(range(M), k)]
              for k in range(1, K + 1)]
    w_model = np.array([2.0 ** (M - i) for i in range(M)])
    costs = np.array([w_model[list(g)].sum() for gk in groups for g in gk])
    return (MOSAP(Cs, K, [K] * No, groups, [groups] * No, costs,
                  [costs.copy() for _ in range(No)], verbose=False),
            Cs, costs)


# ------------------------------- projections ------------------------------ #

def _points(L, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 0.5, L),               # feasible
            rng.uniform(0.0, 40.0, L),              # over budget
            rng.standard_normal(L) * 20.0,          # signs mixed
            np.zeros(L)]


@pytest.mark.parametrize("seed", [0, 1])
def test_budget_projection_matches_jax(seed):
    L = 15
    w = np.random.default_rng(10 + seed).uniform(0.5, 8.0, L)
    pj = spg_j.budget_projection(w, 120.0)
    pt = spg_t.budget_projection(w, 120.0)
    for x in _points(L, seed):
        a = np.asarray(pj(jnp.asarray(x)))
        b = pt(torch.as_tensor(x)).numpy()
        assert np.max(np.abs(a - b)) <= 1e-12
        assert w @ b <= 120.0 * (1 + 1e-12) and np.all(b >= 0)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("zero_cap", [False, True])
def test_capped_projection_matches_jax(zero_cap, native):
    """Both routes of the port's Dykstra sweeps (the native host library
    and the loop over tensors) against the JAX package's."""
    from bluest_tpu_torch import _native
    assert _native.available()
    L = 12
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 8.0, L)
    rows = (rng.uniform(size=(2, L)) < 0.4).astype(float)
    rows[0, 0] = rows[1, 1] = 1.0
    rhs = np.array([0.0 if zero_cap else 6.0, 9.0])
    pj = spg_j.capped_projection(w, 120.0, rows, rhs)
    pt = spg_t.capped_projection(w, 120.0, rows, rhs, native=native)
    for x in _points(L, 3):
        a = np.asarray(pj(jnp.asarray(x)))
        b = pt(torch.as_tensor(x)).numpy()
        assert np.max(np.abs(a - b)) <= 1e-12
        assert w @ b <= 120.0 * (1 + 1e-12) and np.all(b >= 0)
        assert np.all(rows @ b <= rhs + 1e-12)
    if zero_cap:
        # a zero cap empties its support, not the whole vector
        b = pt(torch.as_tensor(_points(L, 3)[1])).numpy()
        assert np.all(b[rows[0] > 0] == 0) and b.max() > 0


# --------------------------- objective and gradient ----------------------- #

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reg_variance_and_gradient(seed):
    C, groups, costs = _sap_data(5, 3, seed)
    st, sj = SAP(C, 3, groups, costs), SAP_J(C, 3, groups, costs)
    m = np.random.default_rng(seed).uniform(0.5, 30.0, st.L)
    delta0 = spg_t._delta0_for(st.data, m)
    assert abs(delta0 - spg_j._delta0_for(sj.data, m)) <= 1e-12 * delta0
    fj = float(spg_j._reg_variance(sj.data, jnp.asarray(m), delta0))
    gj = np.asarray(jax.grad(
        lambda x: spg_j._reg_variance(sj.data, x, delta0))(jnp.asarray(m)))
    y = spg_t._reg_solve(st.data, torch.as_tensor(m), delta0)
    ft, gt = y[0], spg_t._reg_grad(st.data, y)
    assert abs(float(ft) - fj) <= 1e-10 * fj
    assert np.max(np.abs(gt.numpy() - gj)) <= 1e-10 * np.max(np.abs(gj))
    # the closed form against autograd through cholesky/cholesky_solve
    x = torch.as_tensor(m).clone().requires_grad_(True)
    fa = spg_t._reg_variance(st.data, x, delta0)
    (ga,) = torch.autograd.grad(fa, x)
    assert float(fa.detach()) == float(ft)
    assert float((ga - gt).abs().max()) <= 1e-9 * float(gt.abs().max())


def test_smoothed_max_gradient_against_autograd():
    mosap, _, costs = make_mosap()
    datas = [s.data for s in mosap.SAPS]
    maps = [torch.as_tensor(mp) for mp in mosap.mappings]
    m = torch.as_tensor(np.random.default_rng(0).uniform(1, 20, mosap.L))
    d0 = [spg_t._delta0_for(d, m.numpy()[mp])
          for d, mp in zip(datas, mosap.mappings)]
    wts = (0.02, 0.05)
    ys = [spg_t._reg_solve(d, m[mp], dd)
          for d, mp, dd in zip(datas, maps, d0)]
    f = spg_t._smoothed_max(ys, wts, 128.0)
    g = spg_t._smoothed_max_grad(datas, maps, ys, wts, 128.0, mosap.L)
    x = m.clone().requires_grad_(True)
    vs = torch.stack([spg_t._reg_variance(d, x[mp], dd) / wt
                      for d, mp, dd, wt in zip(datas, maps, d0, wts)])
    fa = torch.logsumexp(128.0 * vs, dim=0) / 128.0
    (ga,) = torch.autograd.grad(fa, x)
    assert abs(float(f) - float(fa)) <= 1e-14 * abs(float(fa))
    assert float((ga - g).abs().max()) <= 1e-9 * float(g.abs().max())


# ------------------------------ the solvers ------------------------------- #

@pytest.mark.parametrize("caps", [False, True])
def test_solve_budget_spg_matches_jax(caps):
    C, groups, costs = _sap_data(5, 2, 0)
    st, sj = SAP(C, 2, groups, costs), SAP_J(C, 2, groups, costs)
    budget = 100 * costs.sum()
    cr = crhs = None
    if caps:
        mms = np.full(5, np.inf)
        mms[-2:] = [10.0, 100.0]
        cr, crhs = st.get_max_sample_constraints(mms)
    mt = spg_t.solve_budget_spg(st.data, costs, budget, cr, crhs)
    mj = spg_j.solve_budget_spg(sj.data, costs, budget, cr, crhs)
    assert mt @ costs <= budget * (1 + 1e-9)
    vt, vj = st.variance(mt), st.variance(mj)
    assert abs(vt - vj) <= 1e-6 * vj
    if caps:
        assert np.all(np.asarray(cr) @ mt <= np.asarray(crhs) * (1 + 1e-9))


def test_solve_budget_spg_multi_matches_jax():
    from bluest_tpu.allocation.mosap import MOSAP as MOSAP_J
    mosap, Cs, costs = make_mosap()
    groups = [[list(g) for g in gk] for gk in mosap.multi_groups[0]]
    mj_ = MOSAP_J(Cs, 2, [2, 2], groups, [groups] * 2, costs,
                  [costs.copy()] * 2, verbose=False)
    budget = 200 * max(costs)
    mt = spg_t.solve_budget_spg_multi(
        [s.data for s in mosap.SAPS], mosap.mappings, mosap.L, costs, budget)
    mj = spg_j.solve_budget_spg_multi(
        [s.data for s in mj_.SAPS], mj_.mappings, mj_.L, costs, budget)
    assert mt @ costs <= budget * (1 + 1e-9)
    vt, vj = max(mosap.variances(mt)), max(mosap.variances(mj))
    assert abs(vt - vj) <= 1e-6 * vj


def test_eps_caps_budget_search_brackets():
    """The pure-Python bisection on a scalar model: V*(B) = 100 / B, the
    tolerance ratio hits 1 at B = 100; infeasible when the solve fails."""
    solve_at = lambda B, x0: np.array([B])
    ratio_of = lambda m: 100.0 / m[0]
    for B0 in (3.0, 100.0, 5000.0):
        m = spg_t.eps_caps_budget_search(solve_at, ratio_of, B0)
        assert 100.0 <= m[0] <= 100.0 * (1 + 2e-4)
    assert spg_t.eps_caps_budget_search(lambda B, x0: None, ratio_of,
                                        1.0, max_doubles=3) is None


# -------------------------- through SAP and MOSAP ------------------------- #

def test_sap_spg_matches_sdp_budget():
    sap, C, costs = make_sap(M=5, K=2)
    budget = 100 * costs.sum()
    m_sdp = sap.solve(budget=budget, solver="sdp", continuous_relaxation=True)
    m_spg = sap.solve(budget=budget, solver="spg", continuous_relaxation=True)
    assert m_spg @ costs <= budget * (1 + 1e-9)
    np.testing.assert_allclose(sap.variance(m_spg), sap.variance(m_sdp),
                               rtol=2e-3)
    assert sap.n_nlp_fallbacks == 0


def test_sap_spg_eps_mode():
    sap, C, costs = make_sap(M=5, K=2)
    eps = np.sqrt(C[0, 0]) / 50
    m = sap.solve(eps=eps, solver="spg", continuous_relaxation=True)
    np.testing.assert_allclose(sap.variance(m), eps ** 2, rtol=1e-6)
    m_sdp = sap.solve(eps=eps, solver="sdp", continuous_relaxation=True)
    assert m @ costs <= (m_sdp @ costs) * 1.01
    # the integer path on the same family
    mi = sap.solve(eps=eps, solver="spg")
    assert mi.dtype == np.int64 and sap.variance(mi) <= 1.0001 * eps ** 2


def test_mosap_spg_matches_sdp():
    mosap, Cs, costs = make_mosap()
    budget = 200 * max(costs)
    m_sdp = mosap.solve(budget=budget, solver="sdp",
                        continuous_relaxation=True)
    m_spg = mosap.solve(budget=budget, solver="spg",
                        continuous_relaxation=True)
    assert m_spg @ costs <= budget * (1 + 1e-9)
    # smoothed-max bias at the final temperature bounds the gap
    np.testing.assert_allclose(max(mosap.variances(m_spg)),
                               max(mosap.variances(m_sdp)), rtol=2e-2)
    eps = [np.sqrt(Cs[n][0, 0]) / 30 for n in range(2)]
    m_eps = mosap.solve(eps=eps, solver="spg", continuous_relaxation=True)
    Vs = mosap.variances(m_eps)
    for n in range(2):
        assert Vs[n] <= (eps[n] ** 2) * 1.0001


def test_mosap_spg_heterogeneous_eps():
    M = 3
    # output 0 helped by model 1, output 1 by model 2
    C0 = np.array([[1.0, 0.95, 0.1], [0.95, 1.0, 0.1], [0.1, 0.1, 1.0]])
    C1 = np.array([[1.0, 0.1, 0.95], [0.1, 1.0, 0.1], [0.95, 0.1, 1.0]])
    groups = [[[i] for i in range(M)],
              [list(c) for c in combinations(range(M), 2)]]
    flat = [g for gk in groups for g in gk]
    costs = np.array([10.0, 1.0, 1.0])
    gcosts = np.array([sum(costs[i] for i in g) for g in flat])
    mosap = MOSAP([C0, C1], 2, [2, 2], groups, [groups] * 2, gcosts,
                  [gcosts] * 2, verbose=False)
    eps = [0.02, 0.2]
    m_sdp = mosap.solve(eps=eps, solver="sdp", continuous_relaxation=True)
    m_spg = mosap.solve(eps=eps, solver="spg", continuous_relaxation=True)
    Vs = mosap.variances(m_spg)
    for n in range(2):
        assert Vs[n] <= (eps[n] ** 2) * 1.0001
    assert float(m_spg @ gcosts) <= 1.10 * float(m_sdp @ gcosts)


def test_sap_spg_caps_budget():
    sap, C, costs = make_sap(M=6, K=3)
    budget = 100 * costs.sum()
    mms = np.full(6, np.inf)
    mms[-2:] = [10.0, 100.0]
    m_sdp = sap.solve(budget=budget, max_model_samples=mms, solver="sdp",
                      continuous_relaxation=True)
    m_spg = sap.solve(budget=budget, max_model_samples=mms, solver="spg",
                      continuous_relaxation=True)
    es, rhs = sap.get_max_sample_constraints(mms)
    for ee, rr in zip(es, rhs):
        assert ee @ m_spg <= rr * 1.0001
    assert m_spg @ costs <= budget * 1.0001
    assert sap.variance(m_spg) <= 1.10 * sap.variance(m_sdp)


def test_sap_spg_caps_eps():
    sap, C, costs = make_sap(M=5, K=2)
    eps = np.sqrt(C[0, 0]) / 50
    m_unc = sap.solve(eps=eps, solver="sdp", continuous_relaxation=True)
    tot = np.array([sap.ES[i] @ m_unc for i in range(5)])
    i = int(np.argmax(tot[1:])) + 1
    caps = np.full(5, np.inf)
    caps[i] = max(tot[i] / 4.0, 2.0)
    m_sdp = sap.solve(eps=eps, max_model_samples=caps, solver="sdp",
                      continuous_relaxation=True)
    m_spg = sap.solve(eps=eps, max_model_samples=caps, solver="spg",
                      continuous_relaxation=True)
    es, rhs = sap.get_max_sample_constraints(caps)
    for ee, rr in zip(es, rhs):
        assert ee @ m_spg <= rr * 1.0001
    assert sap.variance(m_spg) <= (1.01 * eps) ** 2
    assert m_spg @ costs <= 1.10 * (m_sdp @ costs)


def test_mosap_spg_caps_eps():
    mosap, Cs, gcosts = make_mosap(M=5, K=2, No=2)
    eps = [np.sqrt(Cs[n][0, 0]) / 40 for n in range(2)]
    m_unc = mosap.solve(eps=eps, solver="sdp", continuous_relaxation=True)
    es_all, _ = mosap.get_max_sample_constraints(np.full(5, 1.0e18))
    totals = np.array([np.asarray(ee) @ m_unc for ee in es_all])
    i = int(np.argmax(totals[1:])) + 1
    caps = np.full(5, np.inf)
    caps[i] = max(totals[i] / 4.0, 2.0)
    m_sdp = mosap.solve(eps=eps, max_model_samples=caps, solver="sdp",
                        continuous_relaxation=True)
    m_spg = mosap.solve(eps=eps, max_model_samples=caps, solver="spg",
                        continuous_relaxation=True)
    es, rhs = mosap.get_max_sample_constraints(caps)
    for ee, rr in zip(es, rhs):
        assert ee @ m_spg <= rr * 1.0001
    Vs = mosap.variances(np.asarray(m_spg, float))
    for n in range(2):
        assert Vs[n] <= (1.01 * eps[n]) ** 2
    assert m_spg @ gcosts <= 1.10 * (m_sdp @ gcosts)
