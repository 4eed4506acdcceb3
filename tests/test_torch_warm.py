"""The warm-start cache of the port's interior-point solver
(``bluest_tpu_torch/solvers/sdp.py``) beside the JAX package's.

Programs come from numpy seeds (the MLBLUE-shaped generator of
tests/test_sdp.py, copied here, and a seeded MLBLUE eps program); both
packages run on the CPU in f64.

* A second solve of one program reports ``dims["warm_start"] is True``,
  takes fewer iterations and agrees in ``pobj`` to 1e-7 relative (``x`` to
  1e-6 of its largest entry).
* A different program of the same shape never hits.
* With ``BLUEST_TPU_IPM_WARM=0`` nothing is cached and the result is
  bit-equal to the first (cold) solve with the cache on and empty, and a
  blend weight of 0 leaves a hit bit-equal to the cold solve as well.
* A poisoned entry (finite garbage) that fails the warm attempt falls back
  to the cold result bit for bit and is dropped from the cache.
* More than ``_WARM_CACHE_MAX`` programs keep that many entries and evict
  the least recently used one (the JAX package evicts first-in-first-out).
* ``dims["warm_start"]`` stays True when the warm result wins.
* Warm and cold iteration counts beside the JAX package's on the same
  program: printed, equal within 3.
"""

from itertools import combinations

import numpy as np
import pytest
import torch

from bluest_tpu.solvers import sdp as sdp_j
from bluest_tpu_torch.allocation import cones
from bluest_tpu_torch.core import psi as psimod
from bluest_tpu_torch.core.groups import GroupStructure
from bluest_tpu_torch.solvers import sdp as sdp_t
from bluest_tpu_torch.config import allocation_device_scope

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _host_allocation():
    """These tests allocate on the host: they ask for it, as a caller
    without a card does (the allocation's default device is the card)."""
    with allocation_device_scope("cpu"):
        yield


OK = ("optimal", "inaccurate")


@pytest.fixture(autouse=True)
def _empty_caches(monkeypatch):
    monkeypatch.delenv("BLUEST_TPU_IPM_WARM", raising=False)
    monkeypatch.delenv("BLUEST_TPU_IPM_WARM_LAMBDA", raising=False)
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()
    yield
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()


def _random_mlblue_like(seed, L=40, No=2, n=4):
    rng = np.random.default_rng(seed)
    c = rng.random(L) + 0.5
    Gl = np.vstack([-np.eye(L), -rng.random((No, L))])
    hl = np.concatenate([np.zeros(L), -np.ones(No)])
    v = rng.standard_normal((No, L, n))
    As = -v[..., None] * v[..., None, :]
    Hs = np.tile(np.eye(n), (No, 1, 1)) * 5.0
    return c, Gl, hl, As, Hs


def _mlblue_eps(seed, M=5, K=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M))
    C = A @ A.T + M * np.eye(M)
    groups = [[list(cc) for cc in combinations(range(M), k)]
              for k in range(1, K + 1)]
    gs = GroupStructure(M, groups, C=C)
    psi = psimod.GroupData.build(gs).psi.numpy()
    w = np.geomspace(4.0, 1.0, gs.L)
    eps = np.sqrt(C[0, 0]) * 0.05
    return cones.build_eps_sdp([psi], [np.arange(gs.L)], gs.L, w, [gs.e],
                               np.array([eps]), 1.0)[:5]


PROGRAMS = {"lmi-7": lambda: _random_mlblue_like(7),
            "lmi-21": lambda: _random_mlblue_like(21, L=60, No=3),
            "mlblue-eps": lambda: _mlblue_eps(1234)}


def _same_bits(a, b):
    return (a.status == b.status and a.iterations == b.iterations
            and np.array_equal(a.x, b.x) and a.pobj == b.pobj
            and a.gap == b.gap and a.pres == b.pres and a.dres == b.dres)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_second_solve_is_warm_and_shorter(name):
    prog = PROGRAMS[name]()
    cold = sdp_t.solve_cone_lp(*prog)
    assert cold.status in OK and cold.dims["warm_start"] is False
    assert len(sdp_t._WARM_CACHE) == 1
    warm = sdp_t.solve_cone_lp(*prog)
    assert warm.status in OK
    assert warm.dims["warm_start"] is True      # kept: the warm result won
    assert warm.iterations < cold.iterations
    assert abs(warm.pobj - cold.pobj) <= 1e-7 * abs(cold.pobj)
    scale = float(np.max(np.abs(cold.x)))
    assert np.max(np.abs(warm.x - cold.x)) <= 1e-6 * scale
    assert len(sdp_t._WARM_CACHE) == 1


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_iterations_beside_jax(name):
    prog = PROGRAMS[name]()
    out = {}
    for tag, mod in (("port", sdp_t), ("jax", sdp_j)):
        cold = mod.solve_cone_lp(*prog)
        warm = mod.solve_cone_lp(*prog)
        assert cold.dims["warm_start"] is False
        assert warm.dims["warm_start"] is True
        out[tag] = (cold.iterations, warm.iterations)
        assert abs(warm.pobj - cold.pobj) <= 1e-7 * abs(cold.pobj)
    print("%s: cold/warm iterations port %s, jax %s"
          % (name, out["port"], out["jax"]))
    assert abs(out["port"][0] - out["jax"][0]) <= 3
    assert abs(out["port"][1] - out["jax"][1]) <= 3


def test_same_shape_other_program_never_hits():
    a, b = _random_mlblue_like(11), _random_mlblue_like(12)
    ra = sdp_t.solve_cone_lp(*a)
    rb = sdp_t.solve_cone_lp(*b)
    assert ra.status in OK and rb.status in OK
    assert rb.dims["warm_start"] is False
    assert len(sdp_t._WARM_CACHE) == 2
    # and b's own solve from an empty cache is the same solve, bit for bit
    sdp_t._WARM_CACHE.clear()
    assert _same_bits(sdp_t.solve_cone_lp(*b), rb)


def test_disabled_by_env_is_the_cold_solve(monkeypatch):
    prog = _random_mlblue_like(13)
    first = sdp_t.solve_cone_lp(*prog)            # cache on, empty: cold
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    r1 = sdp_t.solve_cone_lp(*prog)               # an entry exists: unread
    assert r1.dims["warm_start"] is False
    assert _same_bits(r1, first)
    sdp_t._WARM_CACHE.clear()
    r2 = sdp_t.solve_cone_lp(*prog)
    r3 = sdp_t.solve_cone_lp(*prog)
    assert not sdp_t._WARM_CACHE                  # nothing stored either
    assert r3.dims["warm_start"] is False
    assert _same_bits(r2, first) and _same_bits(r3, first)


def test_zero_blend_weight_is_the_cold_start(monkeypatch):
    """The env names are read at call time; wlam = 0 leaves the start
    untouched even on a hit."""
    prog = _mlblue_eps(1234)
    cold = sdp_t.solve_cone_lp(*prog)
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM_LAMBDA", "0")
    hit = sdp_t.solve_cone_lp(*prog)
    assert hit.dims["warm_start"] is True
    assert _same_bits(hit, cold)
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM_LAMBDA", "0.5")
    half = sdp_t.solve_cone_lp(*prog)
    assert half.status in OK
    assert abs(half.pobj - cold.pobj) <= 1e-7 * abs(cold.pobj)


def test_poisoned_entry_falls_back_to_cold_and_is_dropped():
    prog = _random_mlblue_like(7)
    cold = sdp_t.solve_cone_lp(*prog, max_iter=30)
    assert cold.status in OK
    (fp, entry), = sdp_t._WARM_CACHE.items()
    # finite garbage of the right shapes: a huge, indefinite "iterate"
    rng = np.random.default_rng(0)
    sdp_t._WARM_CACHE[fp] = tuple(
        1e12 * rng.standard_normal(a.shape) for a in entry)
    # too few iterations for the warm attempt to recover from it
    res = sdp_t.solve_cone_lp(*prog, max_iter=30)
    assert res.dims["warm_start"] is False
    assert _same_bits(res, cold)
    # the garbage is gone; what is cached now is the cold solve's iterate
    (fp2, entry2), = sdp_t._WARM_CACHE.items()
    assert fp2 == fp
    assert all(np.array_equal(a, b) for a, b in zip(entry2, entry))


def test_eviction_is_least_recently_used():
    n_max = sdp_t._WARM_CACHE_MAX
    assert n_max == 8
    progs = [_random_mlblue_like(100 + i, L=12, No=1, n=3)
             for i in range(n_max + 2)]
    for prog in progs[:n_max]:
        assert sdp_t.solve_cone_lp(*prog).status in OK
    keys = list(sdp_t._WARM_CACHE)
    assert len(keys) == n_max
    # a hit on the oldest entry moves it to the newest place ...
    assert sdp_t.solve_cone_lp(*progs[0]).dims["warm_start"] is True
    assert list(sdp_t._WARM_CACHE)[-1] == keys[0]
    # ... so the next two new programs evict the second and third oldest
    for prog in progs[n_max:]:
        assert sdp_t.solve_cone_lp(*prog).dims["warm_start"] is False
    left = list(sdp_t._WARM_CACHE)
    assert len(left) == n_max
    assert keys[0] in left and keys[1] not in left and keys[2] not in left
    assert sdp_t.solve_cone_lp(*progs[0]).dims["warm_start"] is True
    assert sdp_t.solve_cone_lp(*progs[1]).dims["warm_start"] is False


def test_mosap_rebuild_starts_warm():
    """The consumer: a MOSAP built twice on one graph re-solves the same
    cone program, and the second set-up's certificates say so."""
    from bluest_tpu_torch.allocation.sap import SAP
    rng = np.random.default_rng(3)
    M, K = 5, 3
    A = rng.standard_normal((M, M))
    C = A @ A.T + 0.1 * np.eye(M)
    groups = [[list(c) for c in combinations(range(M), k)]
              for k in range(1, K + 1)]
    mc = np.sort(np.exp(rng.uniform(0.0, np.log(100.0), M)))[::-1]
    costs = np.array([mc[list(g)].sum() for gk in groups for g in gk])
    eps = 0.03 * np.sqrt(C[0, 0])
    runs = []
    for _ in range(2):
        sap = SAP(C, K, groups, costs)
        m = sap.solve(eps=eps, continuous_relaxation=True)
        runs.append((float(m @ costs), sap.certificates[0]))
    (c0, cert0), (c1, cert1) = runs
    assert cert0["dims"]["warm_start"] is False
    assert cert1["dims"]["warm_start"] is True
    assert cert1["iterations"] < cert0["iterations"]
    assert abs(c1 - c0) <= 1e-6 * c0
