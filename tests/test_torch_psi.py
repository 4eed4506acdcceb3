"""psi level: the port's core/psi.py against the JAX package.

Seeded GroupStructures (numpy, shared by both packages) go through
``bluest_tpu.core.psi`` and ``bluest_tpu_torch.core.psi`` in f64; the
results must agree to 1e-12 relative.  The port's closed-form gradient
and Hessian are also held against torch.func autodiff of its variance.
"""

from itertools import combinations

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bluest_tpu.core import GroupStructure, psi as jpsi
from bluest_tpu_torch.core import GroupStructure as TGroupStructure
from bluest_tpu_torch.core import psi as tpsi
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


def make(M, K, seed, drop=0.0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M))
    C = A @ A.T + M * np.eye(M)
    groups = [[list(c) for c in combinations(range(M), k)
               if k == 1 or rng.random() >= drop]
              for k in range(1, K + 1)]
    m = rng.uniform(0.5, 3.0, sum(len(g) for g in groups))
    jd = jpsi.GroupData.build(GroupStructure(M, groups, C=C))
    td = tpsi.GroupData.build(TGroupStructure(M, groups, C=C))
    return jd, td, m, rng


def close(got, ref, rtol=1e-12):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-300)
    assert np.abs(got - ref).max() <= rtol * scale


CASES = [(4, 2, 0, 0.0), (6, 3, 1, 0.0), (7, 4, 2, 0.4), (10, 4, 3, 0.0)]


@pytest.mark.parametrize("M,K,seed,drop", CASES)
def test_psi_functions_match_jax(M, K, seed, drop):
    jd, td, m, rng = make(M, K, seed, drop)
    mt = torch.as_tensor(m)
    close(td.psi, jd.psi)
    close(tpsi.variance(td, mt), jpsi.variance(jd, jnp.asarray(m)))
    close(tpsi.variance(td, mt, 0.3), jpsi.variance(jd, jnp.asarray(m), 0.3))
    v, g, H = tpsi.variance_grad_hess(td, mt)
    vj, gj, Hj = jpsi.variance_grad_hess(jd, jnp.asarray(m))
    close(v, vj)
    close(g, gj)
    close(H, Hj)
    close(tpsi.cleanup_matrix(td, mt), jpsi.cleanup_matrix(jd, jnp.asarray(m)))
    y = rng.standard_normal(M)
    mu, var = tpsi.estimator_from_sums(td, mt, torch.as_tensor(y))
    muj, varj = jpsi.estimator_from_sums(jd, jnp.asarray(m), jnp.asarray(y))
    close(mu, muj)
    close(var, varj)
    flat = []
    for E in jd.onehots:
        for _ in range(E.shape[0]):
            flat.append(rng.standard_normal(E.shape[1]))
    close(tpsi.scatter_group_sums(td, flat), jpsi.scatter_group_sums(jd, flat))


@pytest.mark.parametrize("M,K,seed,drop", CASES[:3])
def test_grad_hess_match_torch_autodiff(M, K, seed, drop):
    _jd, td, m, _rng = make(M, K, seed, drop)
    mt = torch.as_tensor(m)
    f = lambda x: tpsi.variance(td, x)
    _, g, H = tpsi.variance_grad_hess(td, mt)
    close(g, torch.func.grad(f)(mt), rtol=1e-9)
    close(H, torch.func.hessian(f)(mt), rtol=1e-8)


def test_host_versions_agree():
    """psi (one-hot contractions: exact) and the numpy host variance are
    bit-identical between the packages."""
    groups = [[list(c) for c in combinations(range(6), k)]
              for k in range(1, 4)]
    C = np.eye(6) * 2.0 + 0.5
    gsj, gst = GroupStructure(6, groups, C=C), TGroupStructure(6, groups, C=C)
    psi_j = np.asarray(jpsi.GroupData.build(gsj).psi)
    psi_t = tpsi.GroupData.build(gst).psi.numpy()
    np.testing.assert_array_equal(psi_t, psi_j)
    m = np.random.default_rng(4).uniform(0.5, 3.0, gst.L)
    assert tpsi.host_variance(gst, psi_t, m) == jpsi.host_variance(
        gsj, psi_j, m)
