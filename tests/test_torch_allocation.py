"""Allocation level: the port's cone solver, cleanup walk and integer
projection against the JAX package.

* Seeded cone programs: the same status from both ``solve_cone_lp``s and
  objectives within 1e-7 relative.
* Flagship width (M=10 models, 3 outputs, the bench's grid costs, a
  seeded SPD covariance passed directly, K=4 -> L=385, budget mode):
  - the same groups, and continuous costs within 1e-6 relative;
  - continuous max-variances within 1e-4 relative: both IPMs stop on the
    degenerate optimal face with "inaccurate" certificates (relgap
    < 1e-4), and their last iterates are driven by round-off there;
  - from the same continuous point, the integer projection gives
    identical samples and variances within 1e-8 relative;
  - end to end, both integer allocations respect the budget and their
    max-variances agree within 1e-3 relative.  They need not be the same
    vector: the null-space cleanup walk picks directions from a
    32-dimensional null space whose SVD basis turns with 1e-15
    perturbations of its input, so the sparse vertex it reaches depends
    on round-off (recorded in ROADMAP.md, queue 3).
"""

from itertools import combinations

import numpy as np
import pytest
import torch

import bluest_tpu as J
from bluest_tpu.solvers.sdp import solve_cone_lp as jax_solve
import bluest_tpu_torch as T
from bluest_tpu_torch.allocation import cones
from bluest_tpu_torch.core import GroupStructure, psi as tpsi
from bluest_tpu_torch.solvers.sdp import solve_cone_lp as torch_solve
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


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


def _mlblue(seed, form):
    """Small MLBLUE allocation cone program (complete groups up to K)."""
    rng = np.random.default_rng(seed)
    M, K = 4 + seed % 3, 2 + seed % 2
    A = rng.standard_normal((M, M))
    C = A @ A.T + 0.5 * M * np.eye(M)
    groups = [[list(c) for c in combinations(range(M), k)]
              for k in range(1, K + 1)]
    gs = GroupStructure(M, groups, C=C)
    psi = tpsi.GroupData.build(gs).psi.numpy()
    w = gs.group_costs(np.sort(rng.uniform(0.1, 1, M))[::-1]
                       * np.arange(M, 0, -1))
    mp = [np.arange(gs.L)]
    if form == "budget":
        return cones.build_budget_sdp([psi], mp, gs.L, w, [gs.e], 1e3)[:5]
    return cones.build_eps_sdp([psi], mp, gs.L, w, [gs.e],
                               np.array([0.05]), 1.0)[:5]


def _cone(case):
    if case == "lp":                      # x* = (1, 1)
        return (np.array([-1.0, -2.0]), np.vstack([np.eye(2), -np.eye(2)]),
                np.array([1.0, 1.0, 0.0, 0.0]), None, None)
    if case == "min-eig":                 # min x s.t. [[x,1],[1,x]] >= 0
        return (np.array([1.0]), None, None,
                np.array([[[[-1.0, 0.0], [0.0, -1.0]]]]),
                np.array([[[0.0, 1.0], [1.0, 0.0]]]))
    kind, seed = case.split("-")
    seed = int(seed)
    if kind == "covering":                # x >= 0, sum_i x_i v_i v_i^T >= I
        rng = np.random.default_rng(seed)
        nx, n, nb = 6 + 3 * seed, 3 + seed % 3, 1 + seed % 2
        v = rng.standard_normal((nb, nx, n))
        return (rng.random(nx) + 0.1, -np.eye(nx), np.zeros(nx),
                -v[..., None] * v[..., None, :],
                -np.tile(np.eye(n), (nb, 1, 1)))
    return _mlblue(seed, kind)


# A fixed seeded set.  At the f64 floor a relgap near tol can be labelled
# "optimal" by one package and "inaccurate" by the other (seen on the
# eps form at seeds 6 and 7), and an "inaccurate" endpoint's objective is
# only certified to its relgap; every instance here was checked to land
# clear of both effects.
CONES = ["lp", "min-eig", "covering-2", "covering-3",
         "budget-0", "budget-1", "budget-3", "eps-0", "eps-1", "eps-3"]


@pytest.mark.parametrize("case", CONES)
def test_cone_programs_match_jax(case):
    prog = _cone(case)
    rj, rt = jax_solve(*prog), torch_solve(*prog)
    assert rt.status == rj.status
    assert rt.status in ("optimal", "inaccurate")
    assert abs(rt.pobj - rj.pobj) <= 1e-7 * max(1.0, abs(rj.pobj))


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
    budget = 2.0e5
    pj = J.BLUEProblem(M, C=Cs, costs=COSTS, n_outputs=3, verbose=False)
    pj.setup_solver(K=4, budget=budget)
    pt = T.BLUEProblem(M, C=Cs, costs=COSTS, n_outputs=3, verbose=False,
                       device="cpu")
    pt.setup_solver(K=4, budget=budget)
    return pj, pt, budget


def test_flagship_allocation_matches_jax(flagship):
    pj, pt, budget = flagship
    mj, mt = pj.MOSAP, pt.MOSAP
    assert mj.L == mt.L == 385
    assert mt.flattened_groups == mj.flattened_groups
    cj = mj.continuous_solution @ mj.costs
    ct = mt.continuous_solution @ mt.costs
    assert abs(ct - cj) <= 1e-6 * cj
    vj = max(mj.variances(mj.continuous_solution))
    vt = max(mt.variances(mt.continuous_solution))
    assert abs(vt - vj) <= 1e-4 * vj
    assert [c["status"] for c in mt.certificates] == ["inaccurate"]
    # end to end: both integer allocations are budget-feasible and
    # equally good within round-off-driven vertex choice
    for p in (pj, pt):
        assert p.MOSAP_output["samples"] @ p.MOSAP.costs <= 1.0001 * budget
    Vj = max(pj.MOSAP_output["variances"])
    Vt = max(pt.MOSAP_output["variances"])
    assert abs(Vt - Vj) <= 1e-3 * Vj


def test_flagship_integer_projection_matches_jax(flagship):
    """Same continuous point in, same integer samples out."""
    pj, pt, budget = flagship
    m0 = pj.MOSAP.continuous_solution.copy()
    sparse = pj.MOSAP.cleanup_solution(m0.copy(), tol=1e-7 * m0.max())
    ij = pj.MOSAP.integer_projection(sparse.copy(), budget=budget)
    it = pt.MOSAP.integer_projection(sparse.copy(), budget=budget)
    np.testing.assert_array_equal(it, ij)
    vj = np.asarray(pj.MOSAP.variances(ij.astype(float)))
    vt = np.asarray(pt.MOSAP.variances(it.astype(float)))
    np.testing.assert_allclose(vt, vj, rtol=1e-8, atol=0)
