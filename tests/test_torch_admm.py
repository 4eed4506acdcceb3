"""The operator-splitting cone solver of the port against the JAX package.

Inputs come from numpy seeds (the generator of tests/test_admm.py, copied
here); both packages run on the CPU in f64.

* ``solve_cone_lp_admm`` on a pure LP, a min-eigenvalue SDP and seeded
  MLBLUE budget and eps programs, (M, K) in {(4, 2), (5, 3)}:
  - with ``aa_memory=0, adaptive_scale=False, max_iter=200`` (a smooth
    map, a fixed number of steps) the returned ``x`` agree to 1e-9
    relative and ``pres``/``dres``/``gap`` to 1e-8;
  - with the defaults (Anderson acceleration and the dynamic scale are
    discontinuous in the iterate, so iteration counts may part) the
    status is equal, ``pobj`` agrees to 1e-5 relative and ``x`` to 1e-4
    relative of the largest entry with the port's interior-point solver.
* Woodbury on against off in the port: ``x`` to 1e-8 relative after the
  same 300 plain steps.
* The infeasible LP is ``"infeasible"`` in both; NaN data fails within 5
  iterations; an asymmetric ``As`` is symmetrised as the IPM does it
  (``pobj`` within 1e-3).
* ``SAP.solve`` / ``MOSAP.solve`` with ``solver="admm"`` against
  ``solver="sdp"`` in the port: continuous cost within 1e-3 relative, the
  tolerance and the caps held; ``"scs"`` is the same family.
* ``BLUEProblem(optimization_solver="admm")`` end to end on
  ``ExpSeriesProblem`` with ``device="cpu"``.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.solvers.admm import solve_cone_lp_admm as admm_jax
from bluest_tpu_torch.allocation import cones
from bluest_tpu_torch.allocation.mosap import MOSAP
from bluest_tpu_torch.allocation.sap import SAP
from bluest_tpu_torch.core import psi as psimod
from bluest_tpu_torch.core.groups import GroupStructure
from bluest_tpu_torch.solvers import sdp as sdp_t
from bluest_tpu_torch.solvers.admm import solve_cone_lp_admm as admm_t
from bluest_tpu_torch.solvers.sdp import solve_cone_lp as ipm_t
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


SMOOTH = dict(aa_memory=0, adaptive_scale=False, max_iter=200)


@pytest.fixture(autouse=True)
def _cold_ipm():
    sdp_t._WARM_CACHE.clear()
    yield
    sdp_t._WARM_CACHE.clear()


def _random_blue(seed, M, K):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M))
    C = A @ A.T + M * np.eye(M)
    groups = [[list(cc) for cc in combinations(range(M), k)]
              for k in range(1, K + 1)]
    gs = GroupStructure(M, groups, C=C)
    psi = psimod.GroupData.build(gs).psi.numpy()
    return C, gs, psi, groups


def _program(name):
    if name == "lp":
        # min -x1 - 2 x2  s.t. 0 <= x <= 1  ->  x* = (1, 1)
        return (np.array([-1.0, -2.0]),
                np.vstack([np.eye(2), -np.eye(2)]),
                np.array([1.0, 1.0, 0.0, 0.0]), None, None)
    if name == "mineig":
        # min x  s.t.  [[x, 1], [1, x]] >= 0  ->  x* = 1
        return (np.array([1.0]), None, None,
                np.array([[[[-1.0, 0.0], [0.0, -1.0]]]]),
                np.array([[[0.0, 1.0], [1.0, 0.0]]]))
    form, M, K = name
    C, gs, psi, _ = _random_blue(1234, M, K)
    w = np.geomspace(4.0, 1.0, gs.L)
    if form == "budget":
        return cones.build_budget_sdp([psi], [np.arange(gs.L)], gs.L, w,
                                      [gs.e], 1000.0)[:5]
    eps = np.sqrt(C[0, 0]) * 0.05
    return cones.build_eps_sdp([psi], [np.arange(gs.L)], gs.L, w, [gs.e],
                               np.array([eps]), 1.0)[:5]


PROGRAMS = ["lp", "mineig", ("budget", 4, 2), ("eps", 4, 2),
            ("budget", 5, 3), ("eps", 5, 3)]
IDS = ["lp", "mineig", "budget-4-2", "eps-4-2", "budget-5-3", "eps-5-3"]


@pytest.mark.parametrize("name", PROGRAMS, ids=IDS)
def test_smooth_trajectory_matches_jax(name):
    prog = _program(name)
    rj = admm_jax(*prog, **SMOOTH)
    rt = admm_t(*prog, **SMOOTH)
    assert rt.status == rj.status
    assert rt.iterations == rj.iterations
    scale = max(np.max(np.abs(rj.x)), 1e-300)
    assert np.max(np.abs(rt.x - rj.x)) <= 1e-9 * scale
    for key in ("pres", "dres", "gap"):
        assert abs(getattr(rt, key) - getattr(rj, key)) <= 1e-8, key


@pytest.mark.parametrize("name", PROGRAMS, ids=IDS)
def test_defaults_match_jax_and_ipm(name):
    prog = _program(name)
    kw = {"tol": 1e-8} if name in ("lp", "mineig") else {}
    rj = admm_jax(*prog, **kw)
    rt = admm_t(*prog, **kw)
    assert rt.status == rj.status == "optimal"
    assert abs(rt.pobj - rj.pobj) <= 1e-5 * max(1.0, abs(rj.pobj))
    ri = ipm_t(*prog)
    assert ri.status in ("optimal", "inaccurate")
    assert abs(rt.pobj - ri.pobj) <= 1e-5 * max(1.0, abs(ri.pobj))
    # every program here has a unique optimum
    assert np.max(np.abs(rt.x - ri.x)) <= 1e-4 * np.max(np.abs(ri.x))
    print("%s: iterations port %d, jax %d" % (name, rt.iterations,
                                              rj.iterations))


def test_woodbury_matches_dense():
    prog = _program(("budget", 5, 3))
    kw = dict(aa_memory=0, adaptive_scale=False, max_iter=300)
    rd = admm_t(*prog, woodbury=False, **kw)
    rw = admm_t(*prog, woodbury=True, **kw)
    assert rd.iterations == rw.iterations
    assert np.max(np.abs(rw.x - rd.x)) <= 1e-8 * np.max(np.abs(rd.x))
    assert abs(rw.pobj - rd.pobj) <= 1e-8 * abs(rd.pobj)


def test_infeasible_lp_in_both():
    # x <= -1 and x >= 0: infeasible
    c = np.array([1.0])
    Gl = np.array([[1.0], [-1.0]])
    hl = np.array([-1.0, 0.0])
    rj = admm_jax(c, Gl, hl, max_iter=5000)
    rt = admm_t(c, Gl, hl, max_iter=5000)
    assert rt.status == rj.status == "infeasible"
    assert rt.iterations == rj.iterations
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-12, equal_nan=True)


def test_nonfinite_data_fails_fast():
    c = np.ones(3)
    Gl = -np.eye(3)
    hl = np.array([np.nan, 0.0, 0.0])
    r = admm_t(c, Gl, hl, max_iter=60000)
    assert r.status == "failed"
    assert r.iterations <= 5


def test_empty_cone_raises():
    with pytest.raises(ValueError, match="empty cone"):
        admm_t(np.ones(2))


def test_symmetrizes_like_ipm():
    rng = np.random.default_rng(0)
    nx, n = 6, 3
    B = rng.standard_normal((nx, n, n))
    S = B @ np.swapaxes(B, -1, -2) + 0.5 * np.eye(n)   # PSD slices
    N = rng.standard_normal((nx, n, n)) * 0.3
    N = N - np.swapaxes(N, -1, -2)              # antisymmetric noise
    # covering SDP: min 1.x s.t. sum x_i S_i >= I, x >= 0 (pobj > 0)
    As = (-(S + N))[None]                       # asymmetric input
    Hs = (-np.eye(n))[None]
    c, Gl, hl = np.ones(nx), -np.eye(nx), np.zeros(nx)
    ri = ipm_t(c, Gl, hl, As, Hs)
    ra = admm_t(c, Gl, hl, As, Hs)
    rs = admm_t(c, Gl, hl, (As + np.swapaxes(As, -1, -2)) / 2, Hs)
    assert ra.status in ("optimal", "inaccurate")
    np.testing.assert_allclose(ra.pobj, ri.pobj, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(ra.x, rs.x)


# ----------------------- through SAP / MOSAP / BLUEProblem ---------------- #

def _sap_pair(seed=1234):
    C, gs, _, groups = _random_blue(seed, 4, 2)
    w = np.geomspace(8.0, 1.0, gs.L)
    return C, w, SAP(C, 2, groups, w), SAP(C, 2, groups, w)


@pytest.mark.parametrize("name", ["admm", "scs"])
@pytest.mark.parametrize("mode", ["eps", "budget"])
def test_sap_admm_against_sdp(mode, name):
    C, w, sap_a, sap_i = _sap_pair()
    eps = np.sqrt(C[0, 0]) / 25.0
    kw = {"eps": eps} if mode == "eps" else {"budget": 3000.0}
    ma = sap_a.solve(solver=name, continuous_relaxation=True, **kw)
    mi = sap_i.solve(solver="sdp", continuous_relaxation=True, **kw)
    assert sap_a.n_nlp_fallbacks == 0 and sap_i.n_nlp_fallbacks == 0
    assert all("dims" not in c for c in sap_a.certificates)
    if mode == "eps":
        assert abs(ma @ w - mi @ w) <= 1e-3 * (mi @ w)
        assert sap_a.variance(ma) <= eps ** 2 * 1.001
    else:
        assert ma @ w <= 3000.0 * (1 + 1e-6)
        assert abs(sap_a.variance(ma) - sap_i.variance(mi)) \
            <= 1e-3 * sap_i.variance(mi)


def test_sap_admm_integer_path():
    C, w, sap_a, _ = _sap_pair()
    eps = np.sqrt(C[0, 0]) / 25.0
    m_int = sap_a.solve(eps=eps, solver="admm")
    assert m_int.dtype == np.int64
    assert sap_a.variance(m_int) <= eps ** 2 * 1.0002
    assert sap_a.tot_cost == m_int @ w


def test_sap_admm_respects_caps():
    C, w, sap_a, sap_i = _sap_pair()
    eps = np.sqrt(C[0, 0]) / 20.0
    caps = np.array([np.inf, 200.0, 150.0, np.inf])
    ma = sap_a.solve(eps=eps, solver="admm", continuous_relaxation=True,
                     max_model_samples=caps)
    mi = sap_i.solve(eps=eps, solver="sdp", continuous_relaxation=True,
                     max_model_samples=caps)
    es, rhs = sap_a.get_max_sample_constraints(caps)
    assert len(es) == 2
    for ee, rr in zip(es, rhs):
        assert float(ee @ ma) <= rr * 1.001 + 1e-9
        assert float(ee @ mi) <= rr * 1.001 + 1e-9
    assert abs(ma @ w - mi @ w) <= 1e-3 * (mi @ w)


def test_mosap_admm_multi_output():
    """Heterogeneous tolerances on two outputs.  The scaled epigraph
    cross-check of this instance stalls the splitting at ~1e-5 for all of
    its 60000 default iterations in both packages (~5 s of compiled loop
    there, ~40 s of eager loop here), so ``max_iter`` is cut to 4000: the
    direct form converges in ~2600 and wins the race either way."""
    rng = np.random.default_rng(3)
    M, K, No = 4, 2, 2
    Cs = []
    for _ in range(No):
        A = rng.standard_normal((M, M))
        Cs.append(A @ A.T + M * np.eye(M))
    groups = [[list(cc) for cc in combinations(range(M), k)]
              for k in range(1, K + 1)]
    L = sum(len(gk) for gk in groups)
    w = np.geomspace(8.0, 1.0, L)
    mk = lambda: MOSAP(Cs, K, [K] * No, groups, [groups] * No, w,
                       [w.copy() for _ in range(No)], verbose=False)
    mos_a, mos_i = mk(), mk()
    eps = [np.sqrt(Cs[0][0, 0]) / 20.0, np.sqrt(Cs[1][0, 0]) / 35.0]
    ma = mos_a.solve(eps=eps, solver="admm", continuous_relaxation=True,
                     solver_params={"max_iter": 4000})
    mi = mos_i.solve(eps=eps, solver="sdp", continuous_relaxation=True)
    assert mos_a.n_nlp_fallbacks == 0
    assert [c["form"] for c in mos_a.certificates] == [
        "direct-eps", "scaled-budget-epigraph"]
    assert mos_a.certificates[0]["status"] == "optimal"
    assert abs(ma @ w - mi @ w) <= 1e-3 * (mi @ w)
    for n in range(No):
        assert mos_a.SAPS[n].variance(ma[mos_a.mappings[n]]) \
            <= eps[n] ** 2 * 1.005
    with pytest.raises(ValueError, match="'sdp' \\(default\\), 'admm', "
                                         "'scipy', 'spg'"):
        mos_a.solve(eps=eps, solver="mosek")


def test_blueproblem_admm_end_to_end():
    from bluest_tpu_torch.models.analytic import ExpSeriesProblem

    kw = dict(C=None, costs=np.array([9.0, 3.0, 1.0]),
              covariance_estimation_samples=128, verbose=False,
              device="cpu")
    p = ExpSeriesProblem(3, optimization_solver="admm", **kw)
    out = p.setup_solver(K=2, budget=2000.0)
    assert float(out["total_cost"]) <= 2000.0 * 1.0002
    assert p.MOSAP.n_nlp_fallbacks == 0
    mus, errs, tot = p.solve()
    assert np.all(np.isfinite(np.asarray(mus, dtype=float)))
    # the same pilot under the IPM: the same frontier
    p2 = ExpSeriesProblem(3, **kw)
    out2 = p2.setup_solver(K=2, budget=2000.0)
    e1 = float(np.max(np.asarray(out["errors"], dtype=float)))
    e2 = float(np.max(np.asarray(out2["errors"], dtype=float)))
    assert e1 <= 2.0 * e2 and e2 <= 2.0 * e1
