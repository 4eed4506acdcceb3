"""The integer corner search's dispatch and gather against the JAX
package's (``bluest_tpu/solvers/integer.py:100-161, 267-285, 533-538``),
on the host.

* ``_corner_variances`` (chunks of ``_CHUNK`` corners, one read) and
  ``_batch_variances_multi`` (every output in one read), through the
  plain versions in f64, against the JAX package's (which pads chunks,
  LL and batches) on the same inputs within 1e-12 relative, at B in {1,
  8191, 8192, 8193, 3*8192+5} and LL in {3, 4, 5, 13}, where the JAX
  package's padding and the chunk edges fall.  The inputs are one flagship-width output (M=10, K=4, the
  seeded covariances of ``test_torch_allocation.py``), its PHIs
  well-conditioned (every group in the base), so the two eighs' rounding
  stays far below the tolerance.
* ``best_integer_blue_multi`` gives the JAX package's integer samples on
  the seeded multi-output flagship instances (M=10, 3 outputs, L=385),
  from the same continuous point, in budget and eps mode, by the corner
  search and past its brute-force limit (the greedy waves and the
  polish).
* With ``_gather`` and every tensor read counted: one host read per
  ``_multi_helper`` call and per greedy wave, and nothing else read.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.solvers import integer as jinteger
from bluest_tpu_torch.config import allocation_device_scope
from bluest_tpu_torch.core import GroupStructure, psi as tpsi
from bluest_tpu_torch.solvers import integer

from test_torch_cuda import _flagship_width, _search_instance

torch.set_num_threads(1)

CHUNK = integer._CHUNK
BS = (1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host, as a caller without a card
    does."""
    with allocation_device_scope("cpu"):
        yield


@pytest.fixture(scope="module")
def psi():
    """One output's psi at flagship width (M=10, K=4: 385 groups)."""
    M = 10
    groups = [[list(g) for g in combinations(range(M), k)]
              for k in range(1, 5)]
    C = _flagship_width("cpu").get_covariance(0)
    data = tpsi.GroupData.build(GroupStructure(M, groups, C=C), device="cpu")
    return data.psi.numpy()


def _relative(got, ref):
    return float(np.max(np.abs(got - ref) / np.abs(ref)))


@pytest.mark.parametrize("LL", [3, 4, 5, 13])
@pytest.mark.parametrize("B", BS)
def test_corner_variances_match_jax(psi, B, LL):
    rng = np.random.default_rng(100 * LL + B % 97)
    idx = rng.choice(psi.shape[1], LL, replace=False)
    baseval = rng.integers(1, 40, psi.shape[1])
    baseval[idx] = 0
    basephi = psi @ baseval
    ms = rng.integers(0, 60, (LL, B)).astype(np.int32)
    got = integer._corner_variances(basephi, psi[:, idx], ms)
    ref = jinteger._corner_variances(basephi, psi[:, idx], ms)
    assert got.shape == ref.shape == (B,)
    assert _relative(got, ref) <= 1e-12


@pytest.mark.parametrize("B", BS)
def test_batch_variances_multi_match_jax(B):
    p = _flagship_width("cpu")
    p.prewarm_solver(K=4)
    m = p.MOSAP
    psis = [s.psi for s in m.SAPS]
    rng = np.random.default_rng(B)
    vals = rng.integers(1, 50, (m.L, B)).astype(np.float64)
    got = integer._batch_variances_multi(vals, psis, m.mappings)
    ref = jinteger._batch_variances_multi(vals, psis, m.mappings)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (B,)
        assert _relative(g, r) <= 1e-12


@pytest.mark.parametrize("ll_max", [15, 4])
@pytest.mark.parametrize("mode", ["budget", "eps"])
@pytest.mark.parametrize("seed", [2, 3])
def test_best_integer_blue_multi_matches_jax(seed, mode, ll_max):
    """The same continuous point in, the JAX package's samples out, by
    the corner search (ll_max 15) and by the greedy waves and the polish
    (ll_max 4, below the instances' LL)."""
    sol, psis, w, e, maps, how = _search_instance(seed, mode)
    LL = len(integer.feasible_integer_bounds(sol, 10, e=e)[2])
    assert (LL > ll_max) == (ll_max == 4)
    got, gv = integer.best_integer_blue_multi(sol, psis, w, e, maps,
                                              ll_max=ll_max, **how)
    ref, rv = jinteger.best_integer_blue_multi(sol, psis, w, e, maps,
                                               ll_max=ll_max, **how)
    assert got is not None and ref is not None
    np.testing.assert_array_equal(got, ref)
    assert abs(gv - rv) <= 1e-12 * abs(rv)


@pytest.mark.parametrize("ll_max", [15, 4])
def test_one_read_per_search_and_per_wave(monkeypatch, ll_max):
    """Every _multi_helper call dispatches all its outputs' chunks and
    reads them back in one _gather; every greedy wave (a
    _batch_variances_multi call) reads all its outputs in one; no other
    tensor is read to the host."""
    count = {"gather": 0, "helper": 0, "wave": 0, "reads": 0,
             "outputs": []}
    real = (integer._gather, integer._multi_helper,
            integer._batch_variances_multi)

    def gather(pending):
        count["gather"] += 1
        count["outputs"].append(len(pending))
        return real[0](pending)

    def helper(*a, **k):
        count["helper"] += 1
        return real[1](*a, **k)

    def wave(*a, **k):
        count["wave"] += 1
        return real[2](*a, **k)

    names = ("cpu", "numpy", "item", "tolist", "__float__", "__int__",
             "__bool__", "__index__")
    reads = {n: getattr(torch.Tensor, n) for n in names}

    def counted(n):
        def f(self, *a, **k):
            count["reads"] += 1
            return reads[n](self, *a, **k)
        return f

    monkeypatch.setattr(integer, "_gather", gather)
    monkeypatch.setattr(integer, "_multi_helper", helper)
    monkeypatch.setattr(integer, "_batch_variances_multi", wave)
    sol, psis, w, e, maps, how = _search_instance(2, "budget")
    for n in names:
        monkeypatch.setattr(torch.Tensor, n, counted(n))
    got, _ = integer.best_integer_blue_multi(sol, psis, w, e, maps,
                                             ll_max=ll_max, **how)
    for n in names:
        monkeypatch.setattr(torch.Tensor, n, reads[n])
    assert got is not None
    assert count["helper"] >= 1 and (count["wave"] > 0) == (ll_max == 4)
    assert count["gather"] == count["helper"] + count["wave"]
    # a gather reads one .cpu() and its .numpy(), nothing else is read
    assert count["reads"] == 2 * count["gather"]
    # every gather holds all three outputs' chunks
    assert all(k % 3 == 0 and k >= 3 for k in count["outputs"])
