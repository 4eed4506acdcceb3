"""SPG and the masked SPD projection: the port against the JAX package.

The same inputs go through ``bluest_tpu.linalg`` and
``bluest_tpu_torch.linalg``: the projected covariances agree to
1e-8 * max|C| with equal ``solver_info``; ``mark_uncorrelated`` is
identical.  At problem level, covariances with inf sentinels (known
values elsewhere, so no sampling) project to the same matrix in both
packages, and a NaN + inf pilot projects in both with the inf pair left
uncoupled.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from bluest_tpu.linalg.spd import (mark_uncorrelated as mark_jax,
                                   project_covariance_masked as masked_jax)
from bluest_tpu.linalg.spg import spg as spg_jax
from bluest_tpu_torch.linalg.spd import (mark_uncorrelated,
                                         project_covariance_masked)
from bluest_tpu_torch.linalg.spg import spg
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


F64 = torch.float64


def test_spg_quadratic():
    """Unconstrained quadratic: SPG finds the exact minimizer, at the
    JAX package's point and iteration count."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((8, 8))
    A = A @ A.T + 8 * np.eye(8)
    b = rng.standard_normal(8)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    res = spg(lambda x: 0.5 * x @ (At @ x) - bt @ x, lambda x: At @ x - bt,
              lambda x: x, torch.zeros(8, dtype=F64), eps=1e-10, maxit=500)
    assert res.solver_info == 0
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                               rtol=1e-7, atol=1e-8)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    ref = spg_jax(lambda x: 0.5 * x @ (Aj @ x) - bj @ x,
                  lambda x: Aj @ x - bj, lambda x: x, jnp.zeros(8),
                  eps=1e-10, maxit=500)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(ref.x),
                               atol=1e-10)
    assert res.solver_info == int(ref.solver_info)
    assert abs(res.it - int(ref.it)) <= 2


def test_spg_projected_box():
    """min ||x - c||^2 over x >= 0: solution is clip(c, 0)."""
    c = torch.tensor([1.0, -2.0, 3.0, -0.5], dtype=F64)
    res = spg(lambda x: 0.5 * ((x - c) @ (x - c)), lambda x: x - c,
              lambda x: torch.clamp(x, min=0.0), torch.ones(4, dtype=F64),
              eps=1e-12, maxit=200)
    np.testing.assert_allclose(res.x.numpy(), np.maximum(c.numpy(), 0),
                               atol=1e-10)
    cj = jnp.asarray(c.numpy())
    ref = spg_jax(lambda x: 0.5 * ((x - cj) @ (x - cj)), lambda x: x - cj,
                  lambda x: jnp.maximum(x, 0.0), jnp.ones(4), eps=1e-12,
                  maxit=200)
    assert res.solver_info == int(ref.solver_info) == 0


@pytest.mark.parametrize("code,kw", [(1, dict(maxit=1)),
                                     (2, dict(max_fevals=2))])
def test_spg_budget_codes(code, kw):
    """solver_info 1 (iterations) and 2 (evaluations), as in JAX."""
    rng = np.random.default_rng(4)
    A = rng.standard_normal((6, 6))
    A = A @ A.T + np.eye(6)
    b = rng.standard_normal(6)
    At, bt = torch.as_tensor(A), torch.as_tensor(b)
    res = spg(lambda x: 0.5 * x @ (At @ x) - bt @ x, lambda x: At @ x - bt,
              lambda x: x, torch.zeros(6, dtype=F64), eps=1e-12, **kw)
    Aj, bj = jnp.asarray(A), jnp.asarray(b)
    ref = spg_jax(lambda x: 0.5 * x @ (Aj @ x) - bj @ x,
                  lambda x: Aj @ x - bj, lambda x: x, jnp.zeros(6),
                  eps=1e-12, **kw)
    assert res.solver_info == int(ref.solver_info) == code
    assert (res.it, res.count) == (int(ref.it), int(ref.count))


def _partial_cov(seed, M):
    """A seeded covariance, perturbed off the SPD cone, with a symmetric
    set of unknown (NaN) off-diagonal entries."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M))
    C = A @ A.T / M + 0.1 * np.eye(M)
    E = rng.standard_normal((M, M)) * 0.3
    C = C + (E + E.T) / 2
    unknown = np.triu(rng.random((M, M)) < 0.3, 1)
    unknown = unknown | unknown.T
    C[unknown] = np.nan
    return C


@pytest.mark.parametrize("seed,M", [(0, 4), (1, 5), (2, 6), (3, 8),
                                    (4, 10), (5, 12), (6, 6)])
def test_project_covariance_masked_matches_jax(seed, M):
    """The known entries and the objective agree to 1e-8 * max|C|, with
    equal solver_info.  The unknown entries are not determined by the
    problem where the optimal set is a face (seeds 2, 4 and 6: the two
    packages' iterates part in its flat directions and stop at different
    points of it, up to 1.5e-5 apart at seed 2); there both points must
    be optimal: converged and in the cone."""
    C = _partial_cov(seed, M)
    mask = (~np.isnan(C)).astype(float)
    got, err, res = project_covariance_masked(C, mask)
    ref, err_j, res_j = masked_jax(C, mask)
    ref = np.asarray(ref)
    scale = np.nanmax(np.abs(C))
    known = mask > 0
    assert res.solver_info == int(res_j.solver_info) == 0
    assert np.abs(got - ref)[known].max() <= 1e-8 * scale
    assert abs(err - float(err_j)) <= 1e-8 * scale ** 2
    assert res.gpmax <= 1e-10
    assert np.linalg.eigvalsh((got + got.T) / 2).min() > 0
    np.testing.assert_allclose(got, got.T, rtol=0, atol=1e-14 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mark_uncorrelated_identical(seed):
    rng = np.random.default_rng(seed)
    M = 6
    A = rng.standard_normal((M, M))
    C = A @ A.T + np.eye(M)
    C[0, 3] = C[3, 0] = 1e-9                     # |rho| below 1e-7
    C[2, 5] = C[5, 2] = -3e-9
    keep = np.zeros((M, M), bool)
    keep[1, 4] = keep[4, 1] = True
    for kn in (None, keep):
        got = mark_uncorrelated(C, keep_nan_mask=kn)
        ref = mark_jax(C, keep_nan_mask=kn)
        np.testing.assert_array_equal(got, ref)
    assert np.isinf(got[0, 3]) and np.isnan(got[1, 4])


def _sentinel_problems(C, costs):
    from bluest_tpu import BLUEProblem as JaxProblem
    from bluest_tpu_torch import BLUEProblem
    kw = dict(C=C.copy(), costs=costs, verbose=False)
    return (BLUEProblem(len(costs), device="cpu", **kw),
            JaxProblem(len(costs), **kw))


def test_problem_masked_projection_inf_sentinels():
    """Known covariance off the SPD cone with two never-coupled pairs
    (inf): both packages project it by masked SPG to the same matrix and
    keep the pairs uncoupled, so no clique holds one."""
    rng = np.random.default_rng(7)
    M = 5
    A = rng.standard_normal((M, M))
    C = A @ A.T / M + 0.2 * np.eye(M)
    C[0, 2] = C[2, 0] = C[0, 2] + 2.0                # off the cone
    C[0, 1] = C[1, 0] = np.inf
    C[3, 4] = C[4, 3] = np.inf
    costs = np.array([16.0, 8.0, 4.0, 2.0, 1.0])
    pt, pj = _sentinel_problems(C, costs)
    Ct, Cj = pt.get_covariance(0), pj.get_covariance(0)
    assert np.array_equal(np.isnan(Ct), np.isnan(Cj))
    assert np.isnan(Ct[0, 1]) and np.isnan(Ct[3, 4])
    fin = np.isfinite(Cj)
    scale = np.abs(Cj[fin]).max()
    assert np.abs(Ct[fin] - Cj[fin]).max() <= 1e-8 * scale
    out = pt.setup_solver(K=3, budget=100.0)
    assert all(not ({0, 1} <= set(g) or {3, 4} <= set(g))
               for g in out["models"])


def test_problem_masked_projection_errors():
    """The masked branch raises when SPG does not converge, and leaves a
    covariance whose projection error is large unless bypassed (the JAX
    package's behaviour)."""
    from bluest_tpu import BLUEProblem as JaxProblem
    from bluest_tpu_torch import BLUEProblem
    C = np.array([[1.0, 0.99, np.inf], [0.99, 1.0, 0.99],
                  [np.inf, 0.99, 1.0]])
    C[0, 1] = C[1, 0] = 1.5                      # |rho| > 1: off the cone
    costs = np.array([4.0, 2.0, 1.0])
    for cls, extra in ((BLUEProblem, dict(device="cpu")), (JaxProblem, {})):
        p = cls(3, C=C.copy(), costs=costs, skip_projection=True,
                verbose=False, **extra)
        before = p.get_covariance(0).copy()
        err = p.project_covariance(0)
        assert err > p.params["spg_params"]["eps"]
        np.testing.assert_array_equal(p.get_covariance(0), before)
        p.project_covariance(0, bypass_error_check=True)
        after = p.get_covariance(0)
        assert np.isnan(after[0, 2])
        fin = np.isfinite(after)
        sub = np.where(fin, after, 0.0)
        assert np.linalg.eigvalsh(sub[:2, :2]).min() > 0
        q = cls(3, C=C.copy(), costs=costs, skip_projection=True,
                spg_params={"maxit": 1}, verbose=False, **extra)
        with pytest.raises(RuntimeError, match="did not converge"):
            q.project_covariance(0)


def test_problem_masked_projection_nan_and_inf_pilot():
    """NaN (estimate) + inf (never couple) through a pilot in both
    packages: the inf pair stays uncoupled, the projection converges,
    and the pilots agree within their sampling error (the streams
    differ)."""
    from bluest_tpu.models.analytic import ExpSeriesProblem as JaxExp
    from bluest_tpu_torch.models.analytic import ExpSeriesProblem
    M, N = 5, 2048
    C = np.full((M, M), np.nan)
    C[0, 1] = C[1, 0] = np.inf
    pt = ExpSeriesProblem(M, C=C.copy(), covariance_estimation_samples=N,
                          device="cpu", verbose=False)
    pj = JaxExp(M, C=C.copy(), covariance_estimation_samples=N,
                verbose=False)
    Ct, Cj = pt.get_covariance(0), pj.get_covariance(0)
    assert np.isnan(Ct[0, 1]) and np.isnan(Cj[0, 1])
    assert np.array_equal(np.isnan(Ct), np.isnan(Cj))
    fin = np.isfinite(Cj)
    d = np.sqrt(np.diag(Cj))
    # sd of a covariance estimate ~ sqrt((C_ii C_jj + C_ij^2) / N); the
    # difference of two independent estimates, at 6 sd
    sd = np.sqrt(2 * (np.outer(d, d) ** 2 + np.where(fin, Cj, 0) ** 2) / N)
    assert np.all(np.abs(Ct - Cj)[fin] <= 6 * sd[fin])
    out = pt.setup_solver(K=3, eps=0.05)
    assert all(not ({0, 1} <= set(g)) for g in out["models"])
