"""Slice level: DiffusionProblem end to end in both packages.

A JAX DiffusionProblem estimates its covariances from a 256-sample pilot
and writes the reference-format graph npz; the port loads it (and the JAX
package loads one the port wrote).  From the same graph, setup_solver
must give identical integer samples, and the estimates of solve -- drawn
from different random streams (threefry fold_in vs torch.Generator) --
must agree per output within 4 sqrt(err_torch^2 + err_jax^2).
"""

import numpy as np
import pytest
import torch

from bluest_tpu.models.diffusion import DiffusionProblem as JaxDiffusion
from bluest_tpu_torch import BLUEProblem
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

KW = dict(grids=(32, 16, 8, 4), n_kl=8, sigma=1.0, nu=0.6,
          multi_output=True, verbose=False)
BUDGET = 2.0e3


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("graphs")
    pj = JaxDiffusion(covariance_estimation_samples=256, **KW)
    jax_npz = str(d / "jax_graph.npz")
    pj.save_graph_data(jax_npz)
    pt = DiffusionProblem(covariance_estimation_samples=256, device="cpu",
                          **KW)
    torch_npz = str(d / "torch_graph.npz")
    pt.save_graph_data(torch_npz)
    return pj, jax_npz, pt, torch_npz


def test_jax_graph_loads_and_allocates_identically(graphs):
    pj, jax_npz, _pt, _ = graphs
    pt = DiffusionProblem(datafile=jax_npz, device="cpu", **KW)
    for n in range(3):
        np.testing.assert_array_equal(pt.get_covariance(n),
                                      pj.get_covariance(n))
    np.testing.assert_array_equal(pt.get_costs(), pj.get_costs())
    oj = pj.setup_solver(K=3, budget=BUDGET)
    ot = pt.setup_solver(K=3, budget=BUDGET)
    assert pt.MOSAP.L == pj.MOSAP.L
    assert ot["models"] == oj["models"]
    np.testing.assert_array_equal(pt.MOSAP_output["samples"],
                                  pj.MOSAP_output["samples"])
    np.testing.assert_allclose(pt.MOSAP_output["variances"],
                               pj.MOSAP_output["variances"], rtol=1e-8)

    mus_j, errs_j, cost_j = pj.solve(K=3, budget=BUDGET)
    mus_t, errs_t, cost_t = pt.solve(K=3, budget=BUDGET)
    assert cost_t == cost_j
    mus_t, mus_j = np.asarray(mus_t, float), np.asarray(mus_j, float)
    assert np.all(np.isfinite(mus_t)) and np.all(errs_t > 0)
    np.testing.assert_allclose(errs_t, errs_j, rtol=1e-8)
    bound = 4 * np.sqrt(np.asarray(errs_t) ** 2 + np.asarray(errs_j) ** 2)
    assert np.all(np.abs(mus_t - mus_j) <= bound)


def test_torch_graph_loads_in_jax(graphs):
    _pj, _, pt, torch_npz = graphs
    pj = JaxDiffusion(datafile=torch_npz, **KW)
    for n in range(3):
        np.testing.assert_array_equal(pj.get_covariance(n),
                                      pt.get_covariance(n))
        # dV is read from the upper triangle; loading folds it onto both
        np.testing.assert_array_equal(np.triu(pj.get_mlmc_variances()[n], 1),
                                      np.triu(pt.get_mlmc_variances()[n], 1))
    assert pj.SG == pt.SG
    np.testing.assert_array_equal(pj.get_costs(), pt.get_costs())
    # This pilot's graph has a flat optimal face (q_energy equals q_int
    # analytically, so two outputs nearly coincide): both IPMs certify
    # the same objective while their points differ at 1e-4, and the
    # rounding may then differ by a one-sample group.  Hold the
    # allocations to equal quality instead of equal vectors.
    pj.setup_solver(K=3, budget=BUDGET)
    pt.setup_solver(K=3, budget=BUDGET)
    cj, ct = pj.MOSAP.certificates[-1], pt.MOSAP.certificates[-1]
    assert abs(ct["pobj"] - cj["pobj"]) <= 1e-7 * abs(cj["pobj"])
    for p in (pj, pt):
        assert p.MOSAP_output["cost"] <= 1.0001 * BUDGET
    vj = max(pj.MOSAP_output["variances"])
    vt = max(pt.MOSAP_output["variances"])
    assert abs(vt - vj) <= 1e-3 * vj


def test_from_pilot_end_to_end(graphs):
    """The port's own pilot -> projection -> allocation -> estimate."""
    _pj, _, pt, _ = graphs
    for n in range(3):
        C = pt.get_covariance(n)
        assert np.all(np.isfinite(C))
        assert np.linalg.eigvalsh(C).min() > 0
    out = pt.setup_solver(K=3, budget=BUDGET)
    assert out["total_cost"] <= 1.0001 * BUDGET
    cert = pt.MOSAP_output["certificates"]
    assert cert and cert[0]["status"] in ("optimal", "inaccurate")
    mus, errs, cost = pt.solve(K=3, budget=BUDGET)
    assert len(mus) == 3 and np.all(np.isfinite(np.asarray(mus, float)))
    assert np.all(np.isfinite(errs)) and np.all(errs > 0)
    # q_energy = int a u'^2 = int u = q_int for -(a u')' = 1
    np.testing.assert_allclose(mus[2], mus[0], rtol=1e-6)
    stats = pt.sampling_stats
    assert sum(s["samples"] for s in stats.values()) >= 256


class _Quadratic:
    """y_l = a_l x + b_l x^2 with x ~ N(0, 1): C_lm = a_l a_m + 2 b_l b_m,
    E[y_l] = b_l."""
    a = np.array([1.0, 0.9, 0.7])
    b = np.array([0.5, 0.45, 0.2])


class Quadratic(BLUEProblem):
    """The _Quadratic family as a user's factored model."""

    def sample_inputs(self, generator, n):
        return torch.randn((n, 1), generator=generator,
                           dtype=torch.float64, device=self.device)

    def evaluate_model(self, l, x):
        return _Quadratic.a[l] * x + _Quadratic.b[l] * x * x


def test_factored_model_api_with_cost_estimation():
    """A user model through sample_inputs / evaluate_model: wall-time cost
    estimation, pilot covariances, allocation and estimate."""
    p = Quadratic(3, covariance_estimation_samples=20000, verbose=False,
                  device="cpu", seed=3)
    assert np.all(p.get_costs() > 0)
    C_true = (np.outer(_Quadratic.a, _Quadratic.a)
              + 2 * np.outer(_Quadratic.b, _Quadratic.b))
    np.testing.assert_allclose(p.get_covariance(0), C_true, atol=0.06)
    p.setup_solver(K=2, budget=1e3 * float(p.get_costs().sum()))
    mus, errs, _ = p.solve(K=2, budget=1e3 * float(p.get_costs().sum()))
    assert abs(float(mus[0]) - _Quadratic.b[0]) <= 4 * float(errs[0])
    with pytest.raises(NotImplementedError, match="item 14"):
        Quadratic(3, verbose=False, mesh="auto")
    with pytest.raises(TypeError):
        Quadratic(3, verbose=False, no_such_parameter=1)


def test_default_sampling_device_is_the_card():
    """Without device= a problem samples on the card: construction from
    known covariances and costs samples nothing, and on a host without a
    card the first sampling call raises instead of running on the CPU."""
    C = (np.outer(_Quadratic.a, _Quadratic.a)
         + 2 * np.outer(_Quadratic.b, _Quadratic.b))
    p = Quadratic(3, C=C, costs=[3.0, 2.0, 1.0], verbose=False)
    assert p.device.type == "cuda"
    p.setup_solver(K=2, budget=100.0)
    if torch.cuda.is_available():
        mus, _, _ = p.solve(K=2, budget=100.0)
        assert np.all(np.isfinite(np.asarray(mus, float)))
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            p.solve(K=2, budget=100.0)
    d = DiffusionProblem(C=[np.eye(4)] * 3, **KW)
    assert d.device.type == "cuda"
