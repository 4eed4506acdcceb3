"""Where the port allocates: the device rule of ``bluest_tpu_torch.config``
and the interior-point iteration's host reads.

* The rule: ``BLUEST_TPU_ALLOC_DEVICE=cpu`` puts the allocation on the
  host whatever the scope; else an allocation object's own ``device``;
  else inside ``allocation_device_scope(device)`` the innermost scope's
  device; else the card.  A card that the rule names and the process
  lacks raises; nothing falls back.  These cases pretend a card exists
  (``torch.cuda.is_available`` patched) and never make a CUDA tensor.
* A problem allocates on its own device, and ``MOSAP``, ``SAP`` and
  ``solve_cone_lp`` on theirs: ``device="cpu"`` puts every cone solve,
  psi assembly and corner search on the host, and a card-device problem
  or object on a host without a card raises at its first allocation.
* The IPM iteration reads its device once (one packed tensor): counted
  through the tensor methods that copy a number to the host, on the
  flagship-width program (M=10, 3 outputs, K=4, L=385).

The file imports no jax, so it runs on the card's machine too.
"""

import threading

import numpy as np
import pytest
import torch

import bluest_tpu_torch as T
from bluest_tpu_torch import config
from bluest_tpu_torch.core import psi as psimod
from bluest_tpu_torch.solvers import integer, sdp

torch.set_num_threads(1)

GRIDS = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
COSTS = np.array([g / GRIDS[-1] for g in GRIDS])


@pytest.fixture(autouse=True)
def _cold_ipm(monkeypatch):
    """Empty warm cache and no device override from the environment."""
    sdp._WARM_CACHE.clear()
    monkeypatch.delenv("BLUEST_TPU_ALLOC_DEVICE", raising=False)


@pytest.fixture
def fake_card(monkeypatch):
    """The rule's checks see a card; no CUDA call is made."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def _flagship_covariances():
    """The seeded flagship-width covariances of the allocation tests."""
    rng = np.random.default_rng(2)
    M = len(GRIDS)
    Cs = []
    for _ in range(3):
        A = rng.standard_normal((M, M)) * 0.05
        base = 0.97 ** np.abs(np.subtract.outer(np.arange(M), np.arange(M)))
        s = np.exp(rng.standard_normal(M) * 0.3)
        Cs.append(base * np.outer(s, s) + A @ A.T)
    return Cs


CPU, CUDA = torch.device("cpu"), torch.device("cuda")


def test_rule_outside_any_scope_is_the_card(fake_card):
    assert config.allocation_device() == CUDA
    assert config.allocation_device("cpu") == CPU


def test_scopes_nest_and_the_innermost_wins(fake_card):
    with config.allocation_device_scope("cpu") as outer:
        assert outer == CPU and config.allocation_device() == CPU
        with config.allocation_device_scope("cuda"):
            assert config.allocation_device() == CUDA
            with config.allocation_device_scope():       # keeps the device
                assert config.allocation_device() == CUDA
        assert config.allocation_device() == CPU
    assert config.allocation_device() == CUDA


def test_cpu_override_beats_a_card_scope(fake_card, monkeypatch):
    monkeypatch.setenv("BLUEST_TPU_ALLOC_DEVICE", "cpu")
    assert config.allocation_device() == CPU
    assert config.allocation_device("cuda") == CPU
    with config.allocation_device_scope(torch.device("cuda")):
        assert config.allocation_device() == CPU
        with config.allocation_device_scope("cuda"):
            assert config.allocation_device() == CPU


def test_a_named_device_beats_the_scope(fake_card):
    """An allocation object's own ``device`` wins over the scope it is
    built in; without one it takes the scope's."""
    with config.allocation_device_scope("cuda"):
        assert config.allocation_device("cpu") == CPU
        assert config.allocation_device(torch.device("cpu")) == CPU
        assert config.allocation_device(None) == CUDA
    with config.allocation_device_scope("cpu"):
        assert config.allocation_device("cuda") == CUDA


def test_a_missing_card_raises_and_nothing_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        with config.allocation_device_scope("cuda"):
            pass
    with pytest.raises(RuntimeError, match="no CUDA card"):
        config.allocation_device()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        config.allocation_device("cuda")
    # the host override still allocates, on the host
    monkeypatch.setenv("BLUEST_TPU_ALLOC_DEVICE", "cpu")
    with config.allocation_device_scope("cuda"):
        assert config.allocation_device() == CPU


def test_decorator_forms_pin_a_call_to_one_device(fake_card):
    seen = []

    @config.on_allocation_device
    def work(x):
        seen.append(config.allocation_device())
        return x + 1

    with config.allocation_device_scope("cpu"):
        assert work(1) == 2
    assert work(2) == 3
    assert seen == [CPU, CUDA] and work.__wrapped__(3) == 4

    class Owner:
        device = torch.device("cpu")

        @config.on_own_device
        def where(self):
            return config.allocation_device()

    assert Owner().where() == CPU
    assert config.allocation_device() == CUDA


def test_a_scope_belongs_to_its_thread(fake_card):
    seen = []
    with config.allocation_device_scope("cpu"):
        t = threading.Thread(
            target=lambda: seen.append(config.allocation_device()))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and seen == [CUDA]


def _small_program():
    """A seeded MLBLUE budget program (M=4, K=2) and its SAP data."""
    from itertools import combinations
    from bluest_tpu_torch.allocation import cones
    from bluest_tpu_torch.core import GroupStructure
    rng = np.random.default_rng(0)
    M = 4
    A = rng.standard_normal((M, M))
    C = A @ A.T + 0.5 * M * np.eye(M)
    groups = [[list(c) for c in combinations(range(M), k)]
              for k in (1, 2)]
    costs = np.sort(rng.uniform(0.1, 1, M))[::-1] * np.arange(M, 0, -1)
    gs = GroupStructure(M, groups, C=C)
    psi = psimod.GroupData.build(gs, device="cpu").psi.numpy()
    w = gs.group_costs(costs)
    prog = cones.build_budget_sdp([psi], [np.arange(gs.L)], gs.L, w,
                                  [gs.e], 1e3)[:5]
    return C, groups, w, prog


def test_allocation_objects_take_a_device(monkeypatch):
    """``MOSAP``, ``SAP`` and ``solve_cone_lp`` run on the device they are
    given; without one they take the card, and on a host without a card
    they raise (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    C, groups, w, prog = _small_program()
    seen = _recording(monkeypatch)
    assert sdp.solve_cone_lp(*prog, device="cpu").status in (
        "optimal", "inaccurate")
    sap = T.SAP(C, 2, groups, w, device="cpu")
    mosap = T.MOSAP([C], 2, [2], groups, [groups], w, [w], device="cpu")
    assert sap.device == CPU and mosap.device == CPU
    assert all(s.device == CPU for s in mosap.SAPS)
    sap.solve(budget=1e3)
    assert seen and all(d == CPU and a == CPU for _, d, a in seen), seen
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sdp.solve_cone_lp(*prog)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.SAP(C, 2, groups, w)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.MOSAP([C], 2, [2], groups, [groups], w, [w])


def _recording(monkeypatch):
    """Wrap the allocation's device work; record the devices it ran on."""
    seen = []
    ipm, build, var00 = (sdp._ipm_solve, psimod.GroupData.build.__func__,
                         integer._chunk_var00)

    def rec_ipm(*a, **k):
        seen.append(("ipm", a[0].device, config.allocation_device()))
        return ipm(*a, **k)

    def rec_build(cls, gs, device=None):
        data = build(cls, gs, device=device)
        seen.append(("psi", data.psi.device, config.allocation_device()))
        return data

    def rec_var00(P):
        seen.append(("corners", P.device, config.allocation_device()))
        return var00(P)

    monkeypatch.setattr(sdp, "_ipm_solve", rec_ipm)
    monkeypatch.setattr(psimod.GroupData, "build", classmethod(rec_build))
    monkeypatch.setattr(integer, "_chunk_var00", rec_var00)
    return seen


def test_cpu_problem_allocates_on_the_host(monkeypatch):
    seen = _recording(monkeypatch)
    p = T.BLUEProblem(len(GRIDS), C=_flagship_covariances(), costs=COSTS,
                      n_outputs=3, verbose=False, device="cpu")
    p.setup_solver(K=3, budget=2.0e4)
    assert p.MOSAP.device == CPU
    assert {kind for kind, _, _ in seen} == {"ipm", "psi", "corners"}
    assert all(d == CPU and a == CPU for _, d, a in seen), seen


def test_host_override_allocates_a_card_problem_on_the_host(monkeypatch):
    """A default-device problem with known covariances samples nothing;
    BLUEST_TPU_ALLOC_DEVICE=cpu lets it allocate on a host without a
    card, all of it on the host."""
    monkeypatch.setenv("BLUEST_TPU_ALLOC_DEVICE", "cpu")
    seen = _recording(monkeypatch)
    p = T.BLUEProblem(len(GRIDS), C=_flagship_covariances(), costs=COSTS,
                      n_outputs=3, verbose=False)
    assert p.device.type == "cuda"
    p.setup_solver(K=3, budget=2.0e4)
    assert seen and all(d == CPU and a == CPU for _, d, a in seen), seen


def test_card_problem_without_a_card_raises_at_setup_solver():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the no-fallback case needs none")
    p = T.BLUEProblem(len(GRIDS), C=_flagship_covariances(), costs=COSTS,
                      n_outputs=3, verbose=False, skip_projection=True)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        p.setup_solver(K=3, budget=2.0e4)
    assert p.MOSAP is None and p.MOSAP_output is None
    # the SPD projection allocates too: construction raises the same way
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.BLUEProblem(len(GRIDS), C=_flagship_covariances(), costs=COSTS,
                      n_outputs=3, verbose=False)


_READS = ("__float__", "__int__", "__index__", "__bool__", "item", "tolist",
          "numpy", "cpu")


def test_ipm_iteration_reads_the_device_once(monkeypatch):
    """Host reads an iteration of the flagship-width budget program
    (L=385, the Woodbury path), counted through every tensor method
    that hands a number or an array to the host: at most 2 (one packed
    read of the stopping quantities and the factorization status)."""
    monkeypatch.setenv("BLUEST_TPU_IPM_WARM", "0")
    p = T.BLUEProblem(len(GRIDS), C=_flagship_covariances(), costs=COSTS,
                      n_outputs=3, verbose=False, device="cpu")
    p.prewarm_solver(K=4)
    counts = {"in_iteration": 0, "all": 0, "iterations": 0, "packed": 0}
    state = {"inside": False, "ipm": False}
    for name in _READS:
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            if state["ipm"]:
                counts["all"] += 1
            if state["inside"]:
                counts["in_iteration"] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    core, read, ipm = sdp._iteration_core, sdp._read, sdp._ipm_solve

    def counted_core(*a, **k):
        counts["iterations"] += 1
        state["inside"] = True
        try:
            return core(*a, **k)
        finally:
            state["inside"] = False

    def counted_read(t):
        counts["packed"] += 1
        return read(t)

    dims = []

    def counted_ipm(*a, **k):
        state["ipm"] = True
        try:
            out = ipm(*a, **k)
        finally:
            state["ipm"] = False
        dims.append((a[3].shape, bool(k.get("woodbury"))))
        return out

    monkeypatch.setattr(sdp, "_iteration_core", counted_core)
    monkeypatch.setattr(sdp, "_read", counted_read)
    monkeypatch.setattr(sdp, "_ipm_solve", counted_ipm)
    p.setup_solver(K=4, budget=2.0e5, continuous_relaxation=True)
    assert p.MOSAP.L == 385 and dims[0] == ((3, 385, 11, 11), False)
    it = counts["iterations"]
    assert it >= 20
    per_iteration = (counts["in_iteration"] + counts["packed"]) / it
    assert counts["in_iteration"] == 0 and counts["packed"] == it
    assert per_iteration <= 2
    # the start and the end of a solve read what they need once: the
    # whole solve stays within the iterations' reads and a constant
    assert counts["all"] <= 2 * it + 40 * len(dims), counts
