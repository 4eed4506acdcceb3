"""The BLUE's right-hand side ``y = sum_g R_g^T C_g^-1 S_g`` of the port's
``SAP.compute_BLUE_estimator`` against the reference's triple loop, kept
here as the plain version.

The port assembles ``y`` with array operations that make the loop's
products and sums in the loop's order, so ``y``, ``mu`` and ``var`` are
bit-equal to the loop's.  Cases: K = 1..4 and M = 4..12; f64 sums with a
Python-int 0 for unsampled groups; nonzero sums on unsampled groups;
vector-valued sums (D = 3) beside scalar 0s; a covariance of condition
>= 1e12.  Then ``MOSAP.compute_BLUE_estimators`` with two outputs whose
group mappings differ, and one case against the JAX package.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.allocation.sap import SAP as SAP_J
from bluest_tpu_torch.allocation.mosap import MOSAP
from bluest_tpu_torch.allocation.sap import SAP
from bluest_tpu_torch.config import allocation_device_scope
from bluest_tpu_torch.core import psi as psimod

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    with allocation_device_scope("cpu"):
        yield


def _loop_estimator(sap, sums, samples):
    """The reference's assembly (sap.py:99-119): a Python loop over every
    group, slot and member; returns (mu, var, y)."""
    y = [0.0 for _ in range(sap.N)]
    gidx = 0
    for k in range(1, sap.K + 1):
        groups_k = sap.gs.groups[k - 1]
        ics = sap.gs.invcovs[k - 1]
        for i in range(groups_k.shape[0]):
            s = sums[gidx]
            for j in range(k):
                acc = 0.0
                for l in range(k):
                    acc = acc + ics[i, j, l] * s[l]
                y[groups_k[i, j]] = y[groups_k[i, j]] + acc
            gidx += 1
    mu, var = psimod.host_estimator(sap.gs, sap.psi,
                                    np.asarray(samples, dtype=float), y)
    return mu, var, y


def _array_estimator(sap, sums, samples, monkeypatch):
    """The port's ``compute_BLUE_estimator``, with the ``y`` it hands to
    ``host_estimator``; returns (mu, var, y)."""
    seen = []
    orig = psimod.host_estimator

    def spy(gs, psi, m, y):
        seen.append(y)
        return orig(gs, psi, m, y)

    with monkeypatch.context() as mp:
        mp.setattr(psimod, "host_estimator", spy)
        mu, var = sap.compute_BLUE_estimator(sums, samples=samples)
    return mu, var, seen[0]


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float64).view(np.uint64)


def _covariance(rng, M, cond=None):
    if cond is None:
        A = rng.standard_normal((M, M))
        return A @ A.T + 0.1 * np.eye(M)
    Q, _ = np.linalg.qr(rng.standard_normal((M, M)))
    C = (Q * np.logspace(0.0, -np.log10(cond), M)) @ Q.T
    return 0.5 * (C + C.T)


def _groups(rng, M, K, per_class=40):
    """Every size class up to K: all combinations, or a random sorted
    subset of ``per_class`` of them; the singletons always whole."""
    out = []
    for k in range(1, K + 1):
        combos = [list(c) for c in combinations(range(M), k)]
        if k > 1 and len(combos) > per_class:
            pick = np.sort(rng.choice(len(combos), per_class, replace=False))
            combos = [combos[p] for p in pick]
        out.append(combos)
    return out


def _samples(rng, L):
    """About half the groups unsampled; group 0 (model 0 alone) sampled."""
    m = rng.integers(1, 50, L) * (rng.random(L) < 0.5)
    m[0] = max(int(m[0]), 7)
    return m


def _sums(rng, groups, samples, kind):
    flat = [g for gk in groups for g in gk]
    out = []
    for g, N in zip(flat, samples):
        k = len(g)
        if kind == "vector":
            out.append([rng.standard_normal(3) * N for _ in range(k)]
                       if N else [0 for _ in range(k)])
        elif N or kind == "unsampled_nonzero":
            out.append([np.float64(v) for v in
                        rng.standard_normal(k) * max(int(N), 1)])
        else:
            out.append([0 for _ in range(k)])
    return out


KINDS = ["f64_int0", "unsampled_nonzero", "vector", "ill_conditioned"]
SHAPES = [(4, 1), (6, 2), (9, 3), (12, 4)]


@pytest.mark.parametrize("M,K", SHAPES)
@pytest.mark.parametrize("kind", KINDS)
def test_assembly_bit_equal_to_loop(kind, M, K, monkeypatch):
    seed = 1000 * K + M + 17 * KINDS.index(kind)
    rng = np.random.default_rng(seed)
    C = _covariance(rng, M, cond=1e13 if kind == "ill_conditioned" else None)
    if kind == "ill_conditioned":
        assert np.linalg.cond(C) >= 1e12
    groups = _groups(rng, M, K)
    L = sum(len(gk) for gk in groups)
    sap = SAP(C, K, groups, np.ones(L))
    samples = _samples(rng, L)
    sums = _sums(rng, groups, samples, kind)

    mu_l, var_l, y_l = _loop_estimator(sap, sums, samples)
    mu_a, var_a, y_a = _array_estimator(sap, sums, samples, monkeypatch)

    assert var_a == var_l
    if kind == "vector":
        assert np.shape(mu_a) == np.shape(mu_l) == (3,)
        assert np.array_equal(_bits(mu_a), _bits(mu_l))
        y_l = [np.broadcast_to(v, (3,)) for v in y_l]
    else:
        assert np.ndim(mu_a) == 0 and mu_a == mu_l
        assert _bits(mu_a) == _bits(mu_l)
    assert np.array_equal(_bits(y_a), _bits(np.asarray(y_l, dtype=float)))


def test_assembly_rejects_sums_of_other_sizes():
    rng = np.random.default_rng(5)
    groups = _groups(rng, 4, 2)
    L = sum(len(gk) for gk in groups)
    sap = SAP(_covariance(rng, 4), 2, groups, np.ones(L))
    sums = _sums(rng, groups, np.ones(L, dtype=int), "f64_int0")
    sums[-1] = sums[-1][:1]
    with pytest.raises(ValueError, match="model sums"):
        sap.compute_BLUE_estimator(sums, samples=np.ones(L))


def test_mosap_estimators_with_differing_mappings():
    """Two outputs whose groups differ (output 1 drops model 3), so their
    ``mappings`` into the union differ: each output's estimate is its own
    SAP's loop estimate on its slice of the sums."""
    rng = np.random.default_rng(11)
    M, K = 5, 3
    Cs = [_covariance(rng, M), _covariance(rng, M)]
    g0 = _groups(rng, M, K, per_class=6)
    g1 = [[g for g in gk if 3 not in g] for gk in g0]
    union = [sorted({tuple(g) for g in g0[k]} | {tuple(g) for g in g1[k]})
             for k in range(K)]
    union = [[list(g) for g in gk] for gk in union]
    costs = np.array([1.0 + len(g) for gk in union for g in gk])
    multi_costs = [np.array([1.0 + len(g) for gk in mg for g in gk])
                   for mg in (g0, g1)]
    mosap = MOSAP(Cs, K, [K, K], union, [g0, g1], costs, multi_costs)
    assert not np.array_equal(mosap.mappings[0], mosap.mappings[1])

    samples = _samples(rng, mosap.L)
    sums = [_sums(rng, union, samples, "f64_int0") for _ in range(2)]
    mus, Vs = mosap.compute_BLUE_estimators(sums, samples)
    assert Vs.shape == (2,)
    for n in range(2):
        sums_n = [sums[n][g] for g in mosap.mappings[n]]
        mu, var, _ = _loop_estimator(mosap.SAPS[n], sums_n,
                                     samples[mosap.mappings[n]])
        assert mus[n] == mu
        assert np.array_equal(Vs[n], var)


def test_assembly_matches_jax_package():
    rng = np.random.default_rng(23)
    M, K = 8, 3
    C = _covariance(rng, M)
    groups = _groups(rng, M, K, per_class=20)
    L = sum(len(gk) for gk in groups)
    st, sj = SAP(C, K, groups, np.ones(L)), SAP_J(C, K, groups, np.ones(L))
    samples = _samples(rng, L)
    sums = _sums(rng, groups, samples, "unsampled_nonzero")
    mu_t, var_t = st.compute_BLUE_estimator(sums, samples=samples)
    mu_j, var_j = sj.compute_BLUE_estimator(sums, samples=samples)
    assert abs(var_t - var_j) <= 1e-12 * var_j
    assert abs(mu_t - mu_j) <= 1e-12 * np.sqrt(var_j)
