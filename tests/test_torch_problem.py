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
    # one device and one rank: "auto" is no mesh, and the problem solves
    q = Quadratic(3, C=C_true, costs=[3.0, 2.0, 1.0], verbose=False,
                  device="cpu", mesh="auto")
    assert q.mesh is None
    mus, errs, _ = q.solve(K=2, budget=3e3)
    assert abs(float(mus[0]) - _Quadratic.b[0]) <= 4 * float(errs[0])
    # a key outside default_params lands in params, as in the JAX package
    r = Quadratic(3, C=C_true, costs=[3.0, 2.0, 1.0], verbose=False,
                  device="cpu", no_such_parameter=1)
    assert r.params["no_such_parameter"] == 1


def test_default_sampling_device_is_the_card(monkeypatch):
    """Without device= a problem samples and allocates on the card:
    construction from known covariances and costs samples nothing but
    projects them on the card, so on a host without a card it raises;
    under BLUEST_TPU_ALLOC_DEVICE=cpu the problem allocates on the host,
    and its first sampling call raises instead of running on the CPU."""
    C = (np.outer(_Quadratic.a, _Quadratic.a)
         + 2 * np.outer(_Quadratic.b, _Quadratic.b))
    monkeypatch.delenv("BLUEST_TPU_ALLOC_DEVICE", raising=False)
    if torch.cuda.is_available():
        p = Quadratic(3, C=C, costs=[3.0, 2.0, 1.0], verbose=False)
        assert p.device.type == "cuda"
        p.setup_solver(K=2, budget=100.0)
        assert p.MOSAP.device.type == "cuda"
        mus, _, _ = p.solve(K=2, budget=100.0)
        assert np.all(np.isfinite(np.asarray(mus, float)))
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Quadratic(3, C=C, costs=[3.0, 2.0, 1.0], verbose=False)
        monkeypatch.setenv("BLUEST_TPU_ALLOC_DEVICE", "cpu")
        p = Quadratic(3, C=C, costs=[3.0, 2.0, 1.0], verbose=False)
        assert p.device.type == "cuda"
        p.setup_solver(K=2, budget=100.0)
        assert p.MOSAP.device.type == "cpu"
        with pytest.raises(RuntimeError, match='device="cpu"'):
            p.solve(K=2, budget=100.0)
    d = DiffusionProblem(C=[np.eye(4)] * 3, **KW)
    assert d.device.type == "cuda"


# ---------------- names the JAX package's users call ---------------------- #

def test_get_mlmc_variance_matches_jax(graphs):
    pj, jax_npz, _pt, _ = graphs
    pt = DiffusionProblem(datafile=jax_npz, device="cpu", **KW)
    for n in range(3):
        assert pt.get_mlmc_variance(n) is pt.get_mlmc_variances()[n]
        np.testing.assert_array_equal(np.triu(pt.get_mlmc_variance(n), 1),
                                      np.triu(pj.get_mlmc_variance(n), 1))
    np.testing.assert_array_equal(pt.get_mlmc_variance(), pt.dV[0])


def test_prewarm_solver_shape_contract():
    """prewarm_solver predicts exactly the group count setup_solver
    builds, as the JAX package's does on the same graph, and the later
    setup_solver reuses the structure it built."""
    from bluest_tpu.models.analytic import ExpSeriesProblem as JaxSeries
    from bluest_tpu_torch.models.analytic import ExpSeriesProblem
    C = np.eye(5) + 0.5
    C[0, 4] = C[4, 0] = np.inf     # uncouplable pair prunes cliques
    costs = np.array([16.0, 8, 4, 2, 1])
    pt = ExpSeriesProblem(5, C=C.copy(), costs=costs, verbose=False,
                          device="cpu")
    pj = JaxSeries(5, C=C.copy(), costs=costs, verbose=False)
    L_pred = pt.prewarm_solver(K=3)
    assert L_pred == pj.prewarm_solver(K=3)
    warmed = pt.MOSAP
    assert warmed is not None and warmed.L == L_pred
    blue = pt.setup_solver(K=3, budget=500.0)
    assert pt.MOSAP is warmed and pt.MOSAP.L == L_pred
    assert len(blue["models"]) <= L_pred
    mms = np.array([np.inf, 10000.0, np.inf, 20000.0, np.inf])
    assert pt.prewarm_solver(K=3, background=True, budget=500.0,
                             max_model_samples=mms) == L_pred
    assert pt.prewarm_solver(K=9) == pj.prewarm_solver(K=9)   # K > M clips


def test_subclass_keys_merge_into_params_as_in_the_jax_package():
    """A subclass that passes its own key through the constructor gets the
    params the JAX package gives it (the port adds only ``device``), and
    ``default_params`` and ``warning`` are set as there."""
    from bluest_tpu import BLUEProblem as JaxBLUEProblem
    from bluest_tpu import problem as problem_j
    from bluest_tpu_torch import problem as problem_t

    def make(base):
        class WithOwnKey(base):
            def __init__(self, **params):
                params.setdefault("refinement", 3)
                super().__init__(3, C=np.eye(3) + 0.5,
                                 costs=[4.0, 2.0, 1.0], verbose=False,
                                 **params)
        return WithOwnKey

    pj = make(JaxBLUEProblem)(tag="run-1", spg_params={"maxit": 7})
    pt = make(BLUEProblem)(tag="run-1", spg_params={"maxit": 7},
                           device="cpu")
    assert pt.params["refinement"] == pj.params["refinement"] == 3
    assert pt.params["tag"] == pj.params["tag"] == "run-1"
    assert set(pt.params) - set(pj.params) == {"device"}
    for k in pj.params:
        assert pt.params[k] == pj.params[k], k
    assert pt.params["spg_params"]["maxit"] == 7
    assert pt.default_params is problem_t.default_params
    assert pj.default_params is problem_j.default_params
    assert "tag" not in pt.default_params
    assert pt.warning is True and pj.warning is True


def test_plot_snapshots_tool_reads_the_port_s_files(tmp_path):
    """tools/plot_snapshots.py loads and summarizes the snapshot files the
    port writes (the npz layout both packages share)."""
    import io
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    try:
        from plot_snapshots import load_snapshot, summarize
    finally:
        sys.path.pop(0)
    from bluest_tpu_torch.models.analytic import ExpSeriesProblem
    snap = str(tmp_path / "snap.npz")
    p = ExpSeriesProblem(3, C=np.eye(3) + 0.5,
                         costs=np.array([4.0, 2.0, 1.0]), device="cpu",
                         verbose=False, samplefile=snap)
    p.blue_fn([0, 2], 64)
    s = load_snapshot(str(tmp_path / "snap02.npz"))
    assert s["models"] == [0, 2] and s["n_samples"] == 64
    assert s["values"][(0, 0)].shape[0] == 64
    assert s["values"][(0, 1)].shape[0] == 64
    buf = io.StringIO()
    summarize(s, stream=buf)
    assert "model 2" in buf.getvalue()


def test_kept_names_behave_as_the_jax_package_s(monkeypatch):
    """The device-policy and prewarm names of the JAX package exist in
    the port and give what the JAX package gives on a healthy host: None,
    a usable context, the undecorated function's results.  The port's
    scopes default to the card, so this host asks for the CPU."""
    monkeypatch.setenv("BLUEST_TPU_ALLOC_DEVICE", "cpu")
    from bluest_tpu import config as cj
    from bluest_tpu.allocation import mosap as mj
    from bluest_tpu.solvers import sdp as sj
    from bluest_tpu_torch import config as ct
    from bluest_tpu_torch.allocation import mosap as mt
    from bluest_tpu_torch.solvers import sdp as st
    assert ct.ensure_responsive_device() is None
    assert cj.ensure_responsive_device() is None       # pinned to the CPU
    assert ct.ensure_responsive_device(timeout=1.0, retries=2,
                                       fallback="cpu") is None
    for cfg in (cj, ct):
        with cfg.allocation_device_scope():
            assert cfg.on_allocation_device(lambda a, b=1: a + b)(2, b=3) == 5
    f = lambda x: x
    pinned = ct.on_allocation_device(f)      # runs f in a device scope
    assert pinned.__wrapped__ is f and pinned(7) == 7
    assert st.prewarm_mlblue(3, 1, 3) is None
    assert st.prewarm_mlblue(3, 1, 3, budget_epigraph=True, n_caps=2) is None
    # the port compiles no cone program, so it has none to warm; the JAX
    # package says the same of its solvers that run no compiled IPM
    assert mt.prewarm_forms_for(100.0, None, 10) == []
    assert mt.prewarm_forms_for(None, [np.inf, 5.0], 10, solver="sdp") == []
    assert mj.prewarm_forms_for(100.0, None, 10, solver="scipy") == []
    for dims in ({"nx": 385, "nb": 3, "n": 11, "rank": 120,
                  "woodbury": True},
                 {"nx": 40, "nb": 2, "n": 5, "rank": 0, "woodbury": False},
                 {"nx": 7, "nb": 1, "n": 3}):
        assert st.ipm_iteration_flops(dims) == sj.ipm_iteration_flops(dims)


@pytest.mark.parametrize("m", [1, 3, 7, 63, 255])
def test_cyclic_reduction_solve(m):
    """Held to thomas_solve at 1e-9 max relative in f64, and to the JAX
    package's cyclic reduction, on diagonally dominant systems."""
    import jax.numpy as jnp
    from bluest_tpu.models import diffusion as dj
    from bluest_tpu_torch.models import diffusion as dt
    rng = np.random.default_rng(m)
    lower = -rng.uniform(0.5, 1.5, (4, m))
    upper = -rng.uniform(0.5, 1.5, (4, m))
    lower[:, 0] = 0.0
    upper[:, -1] = 0.0
    diag = np.abs(lower) + np.abs(upper) + rng.uniform(0.1, 1.0, (4, m))
    rhs = rng.standard_normal((4, m))
    args = [torch.as_tensor(a) for a in (lower, diag, upper, rhs)]
    got = dt.cyclic_reduction_solve(*args).numpy()
    ref = dt.thomas_solve(*args).numpy()
    assert got.shape == (4, m)
    assert np.abs(got - ref).max() <= 1e-9 * np.abs(ref).max()
    jx = np.stack([np.asarray(dj.cyclic_reduction_solve(
        *[jnp.asarray(a[i]) for a in (lower, diag, upper, rhs)]))
        for i in range(4)])
    assert np.abs(got - jx).max() <= 1e-12 * np.abs(jx).max()


def test_solve_diffusion_outputs_batched_matches_jax():
    import jax.numpy as jnp
    from bluest_tpu.models import diffusion as dj
    from bluest_tpu_torch.models import diffusion as dt
    xis = np.random.default_rng(0).standard_normal((9, 6))
    got = dt.solve_diffusion_outputs_batched(torch.as_tensor(xis), 16, 1.0,
                                             0.6).numpy()
    ref = np.asarray(dj.solve_diffusion_outputs_batched(jnp.asarray(xis), 16,
                                                        1.0, 0.6))
    assert got.shape == ref.shape == (9, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    assert dt.solve_diffusion_outputs_batched is dt.solve_diffusion_outputs


# ---------------- save / load, profile_dir --------------------------------- #

def test_pickle_round_trip_then_solve(tmp_path):
    """A problem that has sampled and solved is pickled, loaded, and
    solves again: graphs, costs, parameters and the call counter travel,
    the engine and the allocation are rebuilt."""
    import pickle
    p = Quadratic(3, covariance_estimation_samples=2000, verbose=False,
                  device="cpu", seed=5, costs=[3.0, 2.0, 1.0])
    p.solve(K=2, budget=600.0)
    counter = p._call_counter
    assert p._engine is not None and p.MOSAP is not None
    q = pickle.loads(pickle.dumps(p))
    assert q._engine is None and q.MOSAP is None and q.MOSAP_output is None
    assert q.mesh is None and q._call_counter == counter
    np.testing.assert_array_equal(q.get_covariance(0), p.get_covariance(0))
    np.testing.assert_array_equal(q.get_costs(), p.get_costs())
    mus_q, errs_q, cost_q = q.solve(K=2, budget=600.0)
    # the original goes on from the same counter: the same streams
    mus_p, errs_p, cost_p = p.solve(K=2, budget=600.0)
    assert float(mus_q[0]) == float(mus_p[0]) and cost_q == cost_p
    np.testing.assert_array_equal(errs_q, errs_p)
    assert abs(float(mus_q[0]) - _Quadratic.b[0]) <= 4 * float(errs_q[0])


def test_profile_dir_writes_a_trace(tmp_path):
    C = (np.outer(_Quadratic.a, _Quadratic.a)
         + 2 * np.outer(_Quadratic.b, _Quadratic.b))
    d = tmp_path / "traces"
    p = Quadratic(3, C=C, costs=[3.0, 2.0, 1.0], verbose=False, device="cpu",
                  profile_dir=str(d))
    mus, _, _ = p.solve(K=2, budget=300.0)
    files = list(d.glob("solve_*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    import json
    with open(files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert np.isfinite(float(mus[0]))


# ---------------- the pipelined solve -------------------------------------- #

_A = np.array([1.0, 0.95, 0.8])
_B = np.array([0.5, 0.3, 0.1])
# at costs (100, 10, 1) and K=2 the allocation couples three groups
_C_Q = np.outer(_A, _A) + 2 * np.outer(_B, _B)


class Quadratic2(Quadratic):
    """y_l = a_l x + b_l x^2 with no two models perfectly correlated."""

    def evaluate_model(self, l, x):
        return _A[l] * x + _B[l] * x * x


class FlakyQuadratic(Quadratic2):
    """The same family with ~7% of draws non-finite (x > 1.5)."""

    def evaluate_model(self, l, x):
        y = super().evaluate_model(l, x)
        return torch.where(x > 1.5, torch.nan, y)


def _pair_of(cls, tmp_path, with_file, **kw):
    """Two equal problems (same seed, known covariances): one for the
    pipelined entry point, one for the loop of blue_fn calls."""
    out = []
    for tag in ("pipe", "loop"):
        f = str(tmp_path / (tag + ".npz")) if with_file else None
        out.append(cls(3, C=_C_Q, costs=[100.0, 10.0, 1.0], verbose=False,
                       device="cpu", seed=9, device_batch_size=16,
                       samplefile=f, **kw))
    return out


def _same_snapshots(tmp_path):
    import glob
    pipe = sorted(glob.glob(str(tmp_path / "pipe*.npz")))
    loop = sorted(glob.glob(str(tmp_path / "loop*.npz")))
    assert pipe and len(pipe) == len(loop)
    for a, b in zip(pipe, loop):
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])


def _groups_of(which, p, data):
    best = list(data["models"])
    samples = [int(m) for m in np.round(data["samples"])]
    if which == "mlmc":
        groups = [list(g) for g in zip(best[:-1], best[1:])] + [best[-1:]]
        return groups, samples
    incs = [samples[i] - (samples[i - 1] if i else 0)
            for i in range(len(samples))]
    return [best[i:] for i in range(len(best))], incs


@pytest.mark.parametrize("with_file", [False, True])
@pytest.mark.parametrize("cls", [Quadratic2, FlakyQuadratic])
@pytest.mark.parametrize("which", ["mlblue", "mlmc", "mfmc"])
def test_pipelined_sums_equal_the_per_group_path(tmp_path, which, cls,
                                                 with_file):
    """Dispatch-all-then-fetch-once gives, bit for bit, the sums of one
    blue_fn call per group in list order -- also when the model loses
    rows (the top-up draws from the group's own call) and with a
    samplefile, whose rows are then equal too."""
    pipe, loop = _pair_of(cls, tmp_path, with_file)
    seen = []
    real = pipe._pipelined_sumse

    def recording(group_list, n_list):
        out = real(group_list, n_list)
        seen.append(([list(g) for g in group_list],
                     [int(n) for n in n_list], out))
        return out

    pipe._pipelined_sumse = recording
    if which == "mlblue":
        mus, errs, _ = pipe.solve(K=2, budget=9000.0)
    elif which == "mlmc":
        mus, errs, _ = pipe.solve_mlmc(budget=9000.0)
    else:
        mus, errs, _ = pipe.solve_mfmc(budget=9000.0)
    (groups, ns, got), = seen
    assert sum(n > 0 for n in ns) >= 2
    for g, n, sumse in zip(groups, ns, got):
        if n == 0:
            assert sumse is None
            continue
        ref = loop.blue_fn(g, n)[0]
        assert np.array_equal(np.array(sumse), np.array(ref))
        assert np.isfinite(np.array(sumse)).all()
    assert loop._call_counter == pipe._call_counter == sum(n > 0 for n in ns)
    assert np.isfinite(float(mus[0]))
    if cls is Quadratic2:
        assert abs(float(mus[0]) - _B[0]) <= 5 * float(np.max(errs))
    if with_file:
        _same_snapshots(tmp_path)
    # the walls of the groups add up to the wall of the batch
    t = sum(s["wall_s"] for s in pipe.sampling_stats.values())
    assert 0 < t and sum(s["samples"] for s in pipe.sampling_stats.values()) \
        == sum(ns)


def test_sampling_stats_walls_add_up_to_the_batch_wall(monkeypatch):
    """One fetch has one wall: it is shared out pro rata by N."""
    from bluest_tpu_torch import problem as mod
    p = Quadratic2(3, C=_C_Q, costs=[3.0, 2.0, 1.0], verbose=False,
                   device="cpu", device_batch_size=16)
    ticks = iter([10.0, 14.0])
    monkeypatch.setattr(mod, "time", lambda: next(ticks))
    p._sample_groups([[0, 1], [2], [1, 2]], [30, 0, 10])
    st = p.sampling_stats
    assert set(st) == {(0, 1), (1, 2)}
    assert st[(0, 1)] == {"samples": 30, "wall_s": 3.0}
    assert st[(1, 2)] == {"samples": 10, "wall_s": 1.0}


def test_one_copy_of_sums_per_fetch_round():
    """All groups' sums reach the host in one copy; a model that loses
    rows costs one more copy per top-up round, not one per group."""
    for cls, rounds in ((Quadratic2, 1), (FlakyQuadratic, None)):
        p = cls(3, C=_C_Q, costs=[3.0, 2.0, 1.0], verbose=False,
                device="cpu", device_batch_size=16, seed=2)
        copies = []
        real = p._sums_to_host
        p._sums_to_host = lambda flat: copies.append(flat.numel()) \
            or real(flat)
        host = p._sample_groups([[0], [0, 1], [1, 2], [2]],
                                [40, 50, 60, 70])
        assert all(h[-1] == 0 for h in host)
        if rounds is not None:
            assert len(copies) == rounds
        else:
            assert 2 <= len(copies) <= 5
        # the first copy holds all four groups: se k + sc k^2 + d1 k^2 +
        # d2 k^2 + 1 entries each
        assert copies[0] == sum(k + 3 * k * k + 1 for k in (1, 2, 2, 1))
