"""The active-set Newton polish of the port against the JAX package.

``allocation/polish.py`` is numpy in both packages; what differs beneath
it are the variance / gradient / Hessian closures (torch f64 here, jitted
JAX there), which agree to ~1e-12 (tests/test_torch_psi.py).  Inputs come
from numpy seeds (the generator of tests/test_polish.py, copied here).

* ``polish_eps`` from ONE shared start (the JAX IPM's point) in both
  packages: polished cost equal to 1e-10 relative, stationarity and
  feasibility <= 1e-9 in both, the same support.
* The port's IPM, ADMM and scipy points polished independently: the same
  cost to 1e-9 relative (seeds 0-2).
  ADMM runs with ``max_iter=3000``: its direct form converges in under
  1700 steps on these instances, while the scaled epigraph cross-check
  stalls the splitting at ~1e-5 for all 60000 default steps in both
  packages (~1 ms a step in the eager loop).
* The rho = 0.999 ladder, a binding cap (held exactly, reported active,
  two families to one capped optimum), the coverage row at a large eps.
  Under a cap the reduced KKT system is singular along the unused groups
  and the Newton path is sensitive to the last bit of its start (from one
  shared start of seed 21 the JAX package converges and the port does not;
  from the port's IPM point neither does), so the capped cases use seeds
  whose path is stable in both packages.
* ``MOSAP.solve(eps, solver_params={"polish": True})`` sets
  ``polish_report``, keeps the tolerance and never raises the cost;
  budget mode ignores the option.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.allocation.polish import polish_eps as polish_j
from bluest_tpu.allocation.sap import SAP as SAP_J
from bluest_tpu_torch.allocation.mosap import MOSAP
from bluest_tpu_torch.allocation.polish import polish_eps
from bluest_tpu_torch.allocation.sap import SAP
from bluest_tpu_torch.solvers import sdp as sdp_t
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


M = 4
K = 2


@pytest.fixture(autouse=True)
def _cold_ipm(monkeypatch):
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    sdp_t._WARM_CACHE.clear()


def _groups(M=M, K=K):
    return [[list(c) for c in combinations(range(M), k)]
            for k in range(1, K + 1)]


def _sap_instance(seed, rho=None, M=M, K=K):
    rng = np.random.default_rng(seed)
    if rho is None:
        B = rng.standard_normal((M, M))
        C = B @ B.T + 0.1 * np.eye(M)
    else:
        s = np.linspace(1.0, 0.3, M)
        R = np.array([[rho ** abs(i - j) for j in range(M)]
                      for i in range(M)])
        np.fill_diagonal(R, 1.0)
        C = R * np.outer(s, s)
    groups = _groups(M, K)
    flat = [g for gk in groups for g in gk]
    costs = np.sort(np.exp(rng.uniform(0.0, np.log(100.0), M)))[::-1]
    gcosts = np.array([sum(costs[i] for i in g) for g in flat])
    eps = float(np.sqrt(C[0, 0]) * 0.03)
    return C, groups, gcosts, eps


@pytest.mark.parametrize("seed", range(3))
def test_polish_from_a_shared_start_matches_jax(seed):
    C, groups, gcosts, eps = _sap_instance(seed)
    sj, st = SAP_J(C, K, groups, gcosts), SAP(C, K, groups, gcosts)
    m0 = np.asarray(sj.solve(eps=eps, continuous_relaxation=True), float)
    rj = polish_j(sj, m0.copy(), eps)
    rt = polish_eps(st, m0.copy(), eps)
    for r in (rj, rt):
        assert r["converged"]
        assert r["stationarity"] <= 1e-9 and r["feasibility"] <= 1e-9
        assert np.all(r["variances"] <= (1 + 1e-9) * eps ** 2)
    assert abs(rt["cost"] - rj["cost"]) <= 1e-10 * rj["cost"]
    assert list(rt["support"]) == list(rj["support"])
    assert abs(rt["cost"] - m0 @ gcosts) <= 1e-5 * (m0 @ gcosts)


@pytest.mark.parametrize("seed", range(3))
def test_polish_makes_solver_families_identical(seed):
    """The IPM stops at ~1e-8, ADMM and the NLP at ~1e-6; polished
    independently they land on one optimum (convex problem, one KKT
    system)."""
    C, groups, gcosts, eps = _sap_instance(10 + seed)
    costs = {}
    for solver in ("sdp", "admm", "scipy"):
        sap = SAP(C, K, groups, gcosts)
        m = sap.solve(eps=eps, continuous_relaxation=True, solver=solver,
                      solver_params={"max_iter": 3000})
        assert sap.n_nlp_fallbacks == 0
        r = polish_eps(sap, m, eps)
        assert r["converged"], solver
        costs[solver] = r["cost"]
        ref = costs["sdp"]
        assert abs(r["cost"] - ref) <= 1e-9 * ref, solver
    print(seed, costs)


def test_polish_multi_output_mosap():
    rng = np.random.default_rng(42)
    Cs = []
    for _ in range(2):
        B = rng.standard_normal((M, M))
        Cs.append(B @ B.T + 0.1 * np.eye(M))
    groups = _groups()
    flat = [g for gk in groups for g in gk]
    costs = np.sort(np.exp(rng.uniform(0.0, np.log(100.0), M)))[::-1]
    gcosts = np.array([sum(costs[i] for i in g) for g in flat])
    eps = np.array([float(np.sqrt(Cs[n][0, 0]) * 0.03) for n in range(2)])
    mk = lambda: MOSAP(Cs, K, [K] * 2, groups, [groups] * 2, gcosts,
                       [gcosts] * 2, verbose=False)
    mos1, mos2 = mk(), mk()
    r1 = polish_eps(mos1, mos1.solve(eps=eps, continuous_relaxation=True),
                    eps)
    r2 = polish_eps(mos2, mos2.solve(eps=eps, continuous_relaxation=True,
                                     solver="scipy"), eps)
    assert r1["converged"] and r2["converged"]
    assert abs(r1["cost"] - r2["cost"]) <= 1e-9 * r1["cost"]
    for n in range(2):
        assert r1["variances"][n] <= (1 + 1e-9) * eps[n] ** 2


def test_polish_degenerate_ladder():
    C, groups, gcosts, eps = _sap_instance(7, rho=0.999, M=5)
    sap = SAP(C, 2, groups, gcosts)
    m = sap.solve(eps=eps, continuous_relaxation=True)
    r = polish_eps(sap, m, eps)
    assert r["stationarity"] <= 1e-9
    assert r["feasibility"] <= 1e-9


def _binding_cap(sap0, eps):
    """Cap the busiest low-fidelity model at half its free usage."""
    m_free = np.asarray(sap0.solve(eps=eps, continuous_relaxation=True),
                        float)
    usages = [float(sap0.ES[i] @ m_free) for i in range(sap0.N)]
    i_cap = 1 + int(np.argmax(usages[1:]))
    assert usages[i_cap] >= 4.0, "instance unusable for a binding cap"
    caps = np.full(sap0.N, np.inf)
    caps[i_cap] = max(0.5 * usages[i_cap], 2.0)
    return m_free, caps


def _check_capped(r, es, rhs, eps, tag):
    assert r["converged"], tag
    assert r["stationarity"] <= 1e-10, tag
    assert r["feasibility"] <= 1e-10, tag
    # the cap row is exactly tight and reported active
    assert 0 in r["active_caps"], tag
    assert float(es[0] @ r["m"]) == pytest.approx(rhs[0], rel=1e-9)
    assert np.all(r["variances"] <= (1 + 1e-9) * eps ** 2), tag


@pytest.mark.parametrize("solver", ["sdp", "scipy"])
@pytest.mark.parametrize("seed", [22, 25])
def test_polish_with_binding_cap_matches_jax(seed, solver):
    """One shared capped start (the JAX package's point) through both."""
    C, groups, gcosts, eps = _sap_instance(seed)
    sj, st = SAP_J(C, K, groups, gcosts), SAP(C, K, groups, gcosts)
    _, caps = _binding_cap(sj, eps)
    m = np.asarray(sj.solve(eps=eps, continuous_relaxation=True,
                            solver=solver, max_model_samples=caps), float)
    es, rhs = st.get_max_sample_constraints(caps)
    rj = polish_j(sj, m.copy(), eps, es=es, rhs=rhs)
    rt = polish_eps(st, m.copy(), eps, es=es, rhs=rhs)
    _check_capped(rj, es, rhs, eps, "jax")
    _check_capped(rt, es, rhs, eps, "port")
    assert abs(rt["cost"] - rj["cost"]) <= 1e-10 * rj["cost"]


def test_polish_with_binding_cap_across_families():
    """The port's own IPM and NLP points under a binding cap polish to one
    capped optimum, which costs no less than the free one."""
    C, groups, gcosts, eps = _sap_instance(25)
    sap0 = SAP(C, K, groups, gcosts)
    m_free, caps = _binding_cap(sap0, eps)
    r_free = polish_eps(sap0, m_free, eps)
    rows = []
    for s_ in ("sdp", "scipy"):
        sap = SAP(C, K, groups, gcosts)
        m = sap.solve(eps=eps, continuous_relaxation=True, solver=s_,
                      max_model_samples=caps)
        es, rhs = sap.get_max_sample_constraints(caps)
        r = polish_eps(sap, np.asarray(m, float), eps, es=es, rhs=rhs)
        _check_capped(r, es, rhs, eps, s_)
        assert r["cost"] >= r_free["cost"] * (1 - 1e-10), s_
        rows.append(r)
    assert abs(rows[0]["cost"] - rows[1]["cost"]) <= 1e-9 * rows[0]["cost"]


def test_polish_respects_coverage_row():
    C, groups, gcosts, _ = _sap_instance(31)
    sap = SAP(C, K, groups, gcosts)
    eps = 0.9 * float(np.sqrt(C[0, 0]))       # large eps: coverage binds
    m = sap.solve(eps=eps, continuous_relaxation=True)
    r = polish_eps(sap, np.asarray(m, float), eps)
    assert float(sap.e @ r["m"]) >= 1.0 - 1e-9
    assert r["feasibility"] <= 1e-8
    assert r["stationarity"] <= 1e-8
    if float(sap.e @ r["m"]) <= 1.0 + 1e-6:
        assert r["active_coverage"] == [0]


@pytest.mark.parametrize("solver,seed", [("sdp", 5), ("admm", 12)])
def test_mosap_solve_polish_option(solver, seed):
    C, groups, gcosts, eps = _sap_instance(seed)
    mk = lambda: MOSAP([C], K, [K], groups, [groups], gcosts, [gcosts],
                       verbose=False)
    m_raw = mk().solve(eps=eps, continuous_relaxation=True, solver=solver,
                       solver_params={"max_iter": 2000})
    mos = mk()
    assert mos.polish_report is None
    m_pol = mos.solve(eps=eps, continuous_relaxation=True, solver=solver,
                      solver_params={"polish": True, "max_iter": 2000})
    rep = mos.polish_report
    assert rep["feasibility"] <= 1e-9
    assert rep["stationarity"] <= 1e-8
    assert m_pol @ gcosts <= (m_raw @ gcosts) * (1 + 1e-12)
    assert max(mos.variances(m_pol)) <= (1 + 1e-9) * eps ** 2
    np.testing.assert_array_equal(mos.continuous_solution, m_pol)
    # the integer path from a polished point
    mi = mk().solve(eps=eps, solver="sdp", solver_params={"polish": True})
    assert mi.dtype == np.int64
    # budget mode: the option is eps-form only and is ignored
    mos_b = mk()
    mos_b.solve(budget=1.0e4, continuous_relaxation=True,
                solver_params={"polish": True})
    assert mos_b.polish_report is None
