"""The port's tutorial (tutorials/01_tutorial_torch.py) on the CPU, and
the allocations of its problems against the JAX package's on the same
known covariances and costs (so no random stream is involved): the eps
mode, user-prescribed groups, the inf sentinel graph and the two-output
problem, each within 1e-4 relative in total cost."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

from bluest_tpu.models.analytic import (ExpSeriesMultiProblem as JaxMulti,
                                        ExpSeriesProblem as JaxSingle)
from test_torch_examples import ROOT, run_script

torch.set_num_threads(1)

TUTORIALS = os.path.join(ROOT, "tutorials")
N_MODELS = 5
COSTS = np.array([2.0 ** (N_MODELS - i) for i in range(N_MODELS)])


@pytest.fixture(scope="module")
def tutorial():
    sys.path.insert(0, TUTORIALS)
    try:
        return importlib.import_module("01_tutorial_torch")
    finally:
        sys.path.remove(TUTORIALS)


@pytest.fixture(autouse=True)
def _cold_ipm():
    """Every test starts with both packages' warm-start caches empty."""
    from bluest_tpu.solvers import sdp as sdp_j
    from bluest_tpu_torch.solvers import sdp as sdp_t
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()


def spd(seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal((N_MODELS, N_MODELS))
    return scale * (a.T @ a)


def close(ct, cj):
    return abs(ct - cj) <= 1e-4 * abs(cj)


def test_tutorial_completes_on_the_cpu(tmp_path):
    res, text, _ = run_script("01_tutorial_torch", [], tmp_path,
                              where=TUTORIALS)
    assert text.rstrip().endswith("Tutorial completed.")
    assert res["mesh"]["world"] == 1
    assert res["snapshot_files"]
    for name in ("mc", "mlmc", "mfmc", "mlblue"):
        mus, errs, cost = res["basic"][name]
        assert np.all(np.isfinite(np.asarray(mus, float))) and cost > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_known_covariance_allocations_match_the_jax_package(tutorial, seed):
    """Part 1's eps mode and user groups, on part 2's known-covariance
    problem (problem3)."""
    C = spd(seed)
    pt = tutorial.MyProblem(N_MODELS, C=C.copy(), costs=COSTS, device="cpu",
                            verbose=False)
    pj = JaxSingle(N_MODELS, C=C.copy(), costs=COSTS, verbose=False)
    eps = 0.02 * np.sqrt(C[0, 0])
    bt = pt.setup_solver(K=N_MODELS, eps=eps)
    bj = pj.setup_solver(K=N_MODELS, eps=eps)
    assert close(bt["total_cost"], bj["total_cost"]), (bt, bj)
    groups = [[0], [1], [0, 3], [3, 4], [0, 1, 2, 3, 4]]
    bt = pt.setup_solver(groups=groups, eps=eps)
    bj = pj.setup_solver(groups=groups, eps=eps)
    assert close(bt["total_cost"], bj["total_cost"]), (bt, bj)
    assert all(g in groups for g in bt["models"])


def test_sentinel_graph_allocation_matches_the_jax_package(tutorial):
    """Part 2's problem4: models 0 and 1 never coupled (inf), the other
    entries known; no group of either package holds both."""
    C = spd(2)
    C[0, 1] = C[1, 0] = np.inf
    pt = tutorial.MyProblem(N_MODELS, C=C.copy(), costs=COSTS, device="cpu",
                            verbose=False)
    pj = JaxSingle(N_MODELS, C=C.copy(), costs=COSTS, verbose=False)
    eps = 0.02 * np.sqrt(C[0, 0])
    bt = pt.setup_solver(K=3, eps=eps)
    bj = pj.setup_solver(K=3, eps=eps)
    assert close(bt["total_cost"], bj["total_cost"]), (bt, bj)
    for out in (bt, bj):
        assert all(not (0 in g and 1 in g) for g in out["models"])


def test_multi_output_allocation_matches_the_jax_package(tutorial):
    """Part 3's two-output problem at eps2 = 2% of each output's sd."""
    C = [spd(3), spd(4, scale=5.0)]
    pt = tutorial.MyMultiProblem(N_MODELS, n_outputs=2, costs=COSTS,
                                 C=[c.copy() for c in C], device="cpu",
                                 verbose=False)
    pj = JaxMulti(N_MODELS, costs=COSTS, C=[c.copy() for c in C],
                  verbose=False)
    eps2 = [0.02 * np.sqrt(c[0, 0]) for c in C]
    bt = pt.setup_solver(K=N_MODELS, eps=eps2)
    bj = pj.setup_solver(K=N_MODELS, eps=eps2)
    assert close(bt["total_cost"], bj["total_cost"]), (bt, bj)
    assert np.all(np.asarray(bt["errors"]) <= 1.0001 * np.asarray(eps2))
