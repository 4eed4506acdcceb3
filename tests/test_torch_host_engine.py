"""Black-box (host) models: the port's host engine against the JAX
package's, on the same numpy generator state.

  * sumse, sumsc, sumsd1 and sumsd2 equal JAX's ``host_engine.blue_fn``
    to 1e-12 relative (cost excluded: it is wall time), one sample per
    call and batched (``sample_batch_size > 1``), through the engine and
    through ``BLUEProblem.blue_fn``;
  * the bounded resample raises loudly;
  * ``host_workers=2`` gives the merged serial sums of the same worker
    seeds, and ``model_workers=2`` runs the nested path;
  * snapshot npz files hold the same keys and arrays as the JAX
    package's for the same seed, and either package appends to the
    other's file;
  * a pickled problem that has sampled carries no engine, generator or
    tensor;
  * the black-box kind runs every estimator.

The JAX package is imported inside the tests, so the workers that the
pool tests spawn (which import this module) import torch only.
"""

import pickle

import numpy as np
import pytest
import torch

from bluest_tpu_torch import BLUEProblem
from bluest_tpu_torch.models.analytic import ExpSeriesHostProblem
from bluest_tpu_torch.sampling import host_engine

torch.set_num_threads(1)


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


def _seeded_sampler(seed, batched):
    rng = np.random.RandomState(seed)
    if batched:
        def sampler(ls, N=1):
            z = rng.standard_normal(N)
            return [z + 0.1 * i for i in range(len(ls))]
    else:
        def sampler(ls):
            z = float(rng.standard_normal())
            return [z + 0.1 * i for i in range(len(ls))]
    return sampler


class _Model:
    """Two outputs, one of them a vector of length 3, per model."""

    def evaluate(self, ls, samples, N=1):
        outs0, outs1 = [], []
        for i, l in enumerate(ls):
            z = np.asarray(samples[i], dtype=float)
            outs0.append(np.exp(z) / (l + 1.0))
            outs1.append(np.stack([np.sin(z + k) for k in range(3)], axis=-1)
                         / (1.0 + l))
        return [outs0, outs1]


def _inners():
    return [lambda a, b: a * b, lambda a, b: np.dot(a, b)]


def _flat_sums(res):
    """The (sumse, sumsc, cost, sumsd1, sumsd2) tuple as arrays, cost out."""
    se, sc, _cost, d1, d2 = res
    return [np.asarray(se[n], float) for n in range(2)] + \
        [np.asarray(sc[n], float) for n in range(2)] + \
        [np.asarray(d1[n], float) for n in range(2)] + \
        [np.asarray(d2[n], float) for n in range(2)]


@pytest.mark.parametrize("N1,N", [(1, 37), (8, 50), (16, 45)])
def test_host_engine_sums_match_jax(N1, N):
    from bluest_tpu.sampling import host_engine as hj
    ls = [0, 2, 3]
    kw = dict(inners=_inners(), N1=N1, No=2, verbose=False,
              compute_mlmc_differences=True)
    got = host_engine.blue_fn(ls, N, _Model(),
                              sampler=_seeded_sampler(5, N1 > 1), **kw)
    ref = hj.blue_fn(ls, N, _Model(), sampler=_seeded_sampler(5, N1 > 1),
                     **kw)
    for g, r in zip(_flat_sums(got), _flat_sums(ref)):
        _close(g, r)


class _ProblemMixin:
    def __init__(self, *a, **k):
        self._rng = np.random.RandomState(11)
        super().__init__(*a, **k)

    def sampler(self, ls, N=1):
        z = self._rng.standard_normal(N)
        return [z for _ in ls]

    def evaluate(self, ls, samples, N=1):
        return [[np.exp(np.asarray(samples[i])) / (l + 1.0)
                 for i, l in enumerate(ls)]]


class PortHost(_ProblemMixin, BLUEProblem):
    pass


@pytest.mark.parametrize("batch", [1, 32])
def test_problem_blue_fn_matches_jax(batch):
    """BLUEProblem.blue_fn of both packages routes a black-box model to
    the host engine: same sums from the same generator state."""
    from bluest_tpu import BLUEProblem as JaxProblem

    class JaxHost(_ProblemMixin, JaxProblem):
        pass

    C = np.eye(3) + 0.5
    kw = dict(C=C.copy(), costs=np.array([4.0, 2.0, 1.0]),
              sample_batch_size=batch, verbose=False)
    pt, pj = PortHost(3, device="cpu", **kw), JaxHost(3, **kw)
    assert not pt._has_torch_model()
    rt = pt.blue_fn([0, 1, 2], 300, compute_mlmc_differences=True)
    rj = pj.blue_fn([0, 1, 2], 300, compute_mlmc_differences=True)
    for k in (0, 1, 3, 4):
        _close(np.asarray(rt[k], float), np.asarray(rj[k], float))


def test_host_engine_bounded_resample():
    """An intermittently failing model completes; one that always fails
    raises after max_resample + 1 attempts instead of hanging."""
    import itertools

    class Flaky:
        params = {"max_resample": 8}
        counter = itertools.count()

        def evaluate(self, ls, samples, N=1):
            bad = next(self.counter) % 3 == 0
            return [[np.nan if bad else float(samples[i])
                     for i in range(len(ls))]]

    def sampler(ls):
        return [1.0 for _ in ls]

    sumse, _, _ = host_engine.blue_fn([0, 1], 10, Flaky(), sampler=sampler,
                                      verbose=False)
    assert sumse[0][0] == pytest.approx(10.0)

    class AlwaysBad(Flaky):
        def evaluate(self, ls, samples, N=1):
            return [[np.nan for _ in ls]]

    with pytest.raises(RuntimeError, match="9 consecutive attempts"):
        host_engine.blue_fn([0, 1], 4, AlwaysBad(), sampler=sampler,
                            verbose=False)


def test_host_workers_equal_merged_serial_sums():
    """host_workers=2: each spawned worker reseeds through set_worker_id
    and samples its share; the merged sums equal the serial sums of the
    same two worker streams."""
    C = np.eye(3) + 0.5
    costs = np.array([4.0, 2.0, 1.0])
    p = ExpSeriesHostProblem(3, C=C.copy(), costs=costs, host_workers=2,
                             sample_batch_size=16, verbose=False,
                             device="cpu")
    N, ls = 101, [0, 1, 2]
    got = p.blue_fn(ls, N, compute_mlmc_differences=True)
    q = ExpSeriesHostProblem(3, C=C.copy(), costs=costs,
                             sample_batch_size=16, verbose=False,
                             device="cpu")
    acc = None
    for wid, n in enumerate((51, 50)):
        q.set_worker_id(wid)
        r = host_engine.blue_fn(ls, n, q, sampler=q.sampler, N1=16, No=1,
                                verbose=False, compute_mlmc_differences=True)
        r = [np.asarray(r[k], float) for k in (0, 1, 3, 4)]
        acc = r if acc is None else [a + b for a, b in zip(acc, r)]
    for g, r in zip([np.asarray(got[k], float) for k in (0, 1, 3, 4)], acc):
        _close(g, r)


class NestedHost(BLUEProblem):
    """An internally parallel black-box model: every rank of a group
    evaluates half of the terms and the group sums them (allreduce)."""

    def set_worker_id(self, wid):
        self._rng = np.random.default_rng(100 + wid)

    def sampler(self, ls, N=1):
        z = float(self._rng.standard_normal())
        return [z for _ in ls]

    def evaluate(self, ls, samples, N=1):
        comm = self.get_comm()
        out = []
        for i, l in enumerate(ls):
            part = np.exp(samples[i]) / (l + 1.0) * 0.5
            out.append(comm.allreduce(part) if comm is not None else 2 * part)
        return [out]


def test_model_workers_nested_groups():
    C = np.eye(2) + 0.5
    p = NestedHost(2, C=C.copy(), costs=np.array([2.0, 1.0]),
                   host_workers=2, model_workers=2, verbose=False,
                   device="cpu")
    sumse, sumsc, _ = p.blue_fn([0, 1], 40)
    q = NestedHost(2, C=C.copy(), costs=np.array([2.0, 1.0]), verbose=False,
                   device="cpu")
    se = 0.0
    for wid in (0, 1):
        q.set_worker_id(wid)
        se += host_engine.blue_fn([0, 1], 20, q, sampler=q.sampler,
                                  verbose=False)[0][0][1]
    assert sumse[0][1] == pytest.approx(se, rel=1e-12)


def _npz(path):
    with np.load(path, allow_pickle=True) as d:
        return {k: d[k] for k in d.files}


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(np.asarray(a[k].tolist(), float),
                                      np.asarray(b[k].tolist(), float))


@pytest.mark.parametrize("N1,outputs", [(1, None), (8, [0])])
def test_snapshot_files_match_jax(tmp_path, N1, outputs):
    """The same seed gives npz files with the same keys and arrays, and
    a file written by one package is appended to by the other."""
    from bluest_tpu.sampling import host_engine as hj
    ls = [0, 2]
    kw = dict(inners=_inners(), N1=N1, No=2, verbose=False,
              outputs_to_save=outputs)
    ft, fj = str(tmp_path / "t" / "s.npz"), str(tmp_path / "j" / "s.npz")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    host_engine.blue_fn(ls, 20, _Model(), sampler=_seeded_sampler(3, N1 > 1),
                        filename=ft, **kw)
    hj.blue_fn(ls, 20, _Model(), sampler=_seeded_sampler(3, N1 > 1),
               filename=fj, **kw)
    _same_arrays(_npz(str(tmp_path / "t" / "s02.npz")),
                 _npz(str(tmp_path / "j" / "s02.npz")))
    # cross appends: the port appends to the JAX file and vice versa
    host_engine.blue_fn(ls, 5, _Model(), sampler=_seeded_sampler(4, N1 > 1),
                        filename=fj, **kw)
    hj.blue_fn(ls, 5, _Model(), sampler=_seeded_sampler(4, N1 > 1),
               filename=ft, **kw)
    a = _npz(str(tmp_path / "t" / "s02.npz"))
    b = _npz(str(tmp_path / "j" / "s02.npz"))
    assert int(a["n_samples"][0]) == int(b["n_samples"][0]) == 25
    _same_arrays(a, b)


def _torch_objects(obj, seen=None):
    """Every torch tensor or generator reachable through the attributes,
    dicts, lists and tuples of ``obj``."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return []
    seen.add(id(obj))
    if isinstance(obj, (torch.Tensor, torch.Generator)):
        return [obj]
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (list, tuple)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return []
    return [t for x in items for t in _torch_objects(x, seen)]


def test_pickle_drops_device_state():
    """A problem that has sampled (engine, generator, cached model
    tensors, allocation) pickles without any of them, and the copy
    samples again."""
    from bluest_tpu_torch.models.diffusion import DiffusionProblem
    p = DiffusionProblem(grids=(16, 8, 4), n_kl=4, device="cpu",
                         covariance_estimation_samples=64, verbose=False)
    p.setup_solver(K=2, budget=50.0)
    assert p._engine is not None and p._masks and p.MOSAP is not None
    assert _torch_objects(p)
    q = pickle.loads(pickle.dumps(p))
    assert _torch_objects(q) == []
    assert q._engine is None and q._masks == {} and q.MOSAP is None
    assert q.MOSAP_output is None and q.device == p.device
    se = q.blue_fn([0, 1], 10)[0]
    assert np.isfinite(se[0][0])


def test_black_box_kind_runs_every_estimator():
    """The black-box kind through setup_solver + solve, solve_mc,
    setup_mlmc/solve_mlmc and setup_mfmc/solve_mfmc, on the host."""
    from bluest_tpu_torch.models.analytic import TRUE_MEAN
    p = ExpSeriesHostProblem(4, covariance_estimation_samples=1024,
                             sample_batch_size=256, verbose=False,
                             device="cpu")
    eps = 0.03
    p.setup_solver(K=3, eps=eps)
    runs = {"mlblue": p.solve(K=3, eps=eps), "mc": p.solve_mc(eps=eps),
            "mlmc": p.solve_mlmc(mlmc_data=p.setup_mlmc(eps=eps)),
            "mfmc": p.solve_mfmc(mfmc_data=p.setup_mfmc(eps=eps))}
    for name, (mus, errs, cost) in runs.items():
        assert abs(float(mus[0]) - TRUE_MEAN) <= 4 * float(errs[0]), name
        assert float(errs[0]) <= 1.0001 * eps and cost > 0, name
    assert p._engine is None           # no device engine was built
