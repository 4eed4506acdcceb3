"""Distribution level: two ranks of a ``torch.distributed`` job (gloo, on
the CPU, one thread each) against one process.

The counterparts of tests/test_sharding.py and tests/test_multihost.py
for the port.  This file is its own worker script: the tests start it
twice (``python tests/test_torch_mesh.py <rank> <nproc> <port> <out>
<case>``), each rank runs the case under a mesh and saves what it got,
and the test holds that against the same case run in the test process
without a mesh.  Sums must agree to 1e-12 relative (summation order is
all that differs) with equal ``n_failed``, estimates to 1e-10, snapshot
files row for row.  Where the JAX package has a counterpart the ranks'
results are held to it as well: the mesh names, shapes and refusals
against ``bluest_tpu.parallel.mesh`` over this process's CPU devices,
the sharded Matern field against ``bluest_tpu.models.matern2d`` on the
same white noise, and the two-rank allocation against the JAX problem's
from the same covariance.  The process group gets a 60 s timeout, so ranks that
stop agreeing on their collectives fail in a minute instead of hanging.
"""

import datetime
import glob
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bluest_tpu_torch import BLUEProblem
from bluest_tpu_torch.models.analytic import (ExpSeriesHostProblem,
                                              ExpSeriesProblem)
from bluest_tpu_torch.models.matern2d import (Matern2DProblem,
                                              sample_matern2d,
                                              sample_matern2d_sharded)
from bluest_tpu_torch.parallel import (MODEL_AXIS, SAMPLE_AXIS,
                                       dcn_sample_model_mesh, fetch_global,
                                       initialize_distributed, sample_mesh,
                                       sample_model_mesh)
from bluest_tpu_torch.sampling.engine import F64, SamplingEngine, zero_sums
from bluest_tpu_torch.sampling.group_engine import GroupEngine

torch.set_num_threads(1)

pytestmark = pytest.mark.distributed

EXACT_N = (1, 7, 9, 33, 65, 100, 300)


# ------------------------- the models of the cases ------------------------ #

def _fac_inputs(gen, n):
    return torch.randn(n, generator=gen, dtype=F64)


def _fac_model(l, th):
    return (th * (l + 1.0))[:, None]


def _grp_inputs(gen, ls, n):
    return torch.randn(n, generator=gen, dtype=F64)


def _grp_model(ls, z):
    base = torch.stack([torch.exp(z), z ** 2 + 1.0, torch.cos(z)], dim=1)
    base = base[:, list(ls)]
    return torch.stack([base, 2.0 * base], dim=1)          # (n, 2, L)


def _nan_model(ls, z):
    return torch.where(z > 0.5, torch.nan, z)[:, None, None]


class Flaky(BLUEProblem):
    """Factored model whose outputs are non-finite for ~16% of draws."""

    def sample_inputs(self, generator, n):
        return torch.randn(n, generator=generator, dtype=F64)

    def evaluate_model(self, l, z):
        v = torch.exp(z) / (1.0 + l)
        return torch.where(z > 1.0, torch.inf, v)[:, None]


class Vec(BLUEProblem):
    """Coupled-group model with vector outputs (d = 4)."""
    D = 4

    def sample_group(self, generator, ls, n):
        return torch.randn(n, generator=generator, dtype=F64)

    def evaluate_group(self, ls, z):
        t = torch.arange(self.D, dtype=F64)
        return torch.stack([torch.sin(t + z[:, None]) / (1.0 + l)
                            for l in ls], dim=1)[:, None]   # (n, 1, L, d)


def _flat(sums, No, k, mesh, d=1):
    """An engine's sums as one vector, added over the ranks of a mesh."""
    if sums is None:
        sums = zero_sums(No, k, "cpu", d)
    flat = torch.cat([t.reshape(-1).to(F64) for t in sums])
    if mesh is not None:
        flat = mesh.all_reduce_samples(flat)
    return flat.numpy()


def _known(M):
    return dict(C=np.eye(M) + 0.5, costs=2.0 ** -np.arange(M), device="cpu",
                verbose=False)


# ------------------------------- the cases -------------------------------- #

def _save(out, rank, res):
    if rank is not None:
        np.savez("%s.p%d.npz" % (out, rank), **res)
    return res


def case_engines(mesh, out=None, rank=None):
    """Engine and model level.  ``mesh`` None: the one-process values."""
    res = {}
    fac = SamplingEngine(_fac_inputs, _fac_model, 1, 8, "cpu", mesh=mesh)
    for N in EXACT_N:
        res["fac_%d" % N] = _flat(fac.sample_sums([0, 1], 5, 0, N), 1, 2,
                                  mesh)
    grp = GroupEngine(_grp_inputs, _grp_model, 2, 64, "cpu", mesh=mesh)
    res["grp_1000"] = _flat(grp.sample_sums((0, 1, 2), 42, 0, 1000), 2, 3,
                            mesh)
    grp8 = GroupEngine(_grp_inputs, _grp_model, 2, 8, "cpu", mesh=mesh)
    for N in EXACT_N:
        res["grp_%d" % N] = _flat(grp8.sample_sums((0, 2), 9, 1, N), 2, 2,
                                  mesh)
    nan = GroupEngine(_grp_inputs, _nan_model, 1, 64, "cpu", mesh=mesh)
    res["nan_resampled"] = _flat(nan.sample_sums((0,), 1, 0, 500), 1, 1, mesh)
    drop = GroupEngine(_grp_inputs, _nan_model, 1, 64, "cpu", mesh=mesh,
                       max_resample=0)
    res["nan_dropped"] = _flat(drop.sample_sums((0,), 3, 0, 500), 1, 1, mesh)

    # through the problem: the top-up of the factored engine, and vector
    # outputs where a rank holds no chunk (N below one chunk)
    p = Flaky(2, mesh=mesh, device_batch_size=32, **_known(2))
    se, sc, _ = p.blue_fn([0, 1], 200)
    res["flaky_se"], res["flaky_sc"] = np.array(se), np.array(sc)
    res["flaky_counter"] = np.array(p._call_counter)
    v = Vec(3, mesh=mesh, device_batch_size=64, **_known(3))
    se, sc, _, d1, d2 = v.blue_fn([0, 2], 20, compute_mlmc_differences=True)
    res["vec_se"], res["vec_sc"] = np.array(se), np.array(sc)
    res["vec_d1"], res["vec_d2"] = np.array(d1), np.array(d2)
    return _save(out, rank, res)


def case_meshes(mesh, out, rank):
    """Mesh shapes, divisibility errors, the gather of uneven rows and
    the sharded Matern field on a (1 x 2) mesh.  Two ranks only."""
    res = {}
    res["shape_1d"] = np.array([mesh.n_sample, mesh.n_model,
                                mesh.sample_rank, mesh.model_rank])
    assert mesh.axis_names == (SAMPLE_AXIS,)
    m12 = sample_model_mesh(1, 2)
    assert m12.axis_names == (SAMPLE_AXIS, MODEL_AXIS)
    assert m12.shape == {SAMPLE_AXIS: 1, MODEL_AXIS: 2}
    res["shape_12"] = np.array([m12.n_sample, m12.n_model, m12.sample_rank,
                                m12.model_rank])
    errs = []
    for build in (lambda: sample_model_mesh(2, 2), lambda: sample_mesh(3),
                  lambda: dcn_sample_model_mesh(n_model=3)):
        try:
            build()
            errs.append("")
        except ValueError as e:
            errs.append(str(e))
    res["errors"] = np.array(errs)
    dcn = dcn_sample_model_mesh()                 # LOCAL_WORLD_SIZE = 2
    res["shape_dcn"] = np.array([dcn.n_sample, dcn.n_model, dcn.sample_rank,
                                 dcn.model_rank])
    dcn1 = dcn_sample_model_mesh(n_model=1)
    res["shape_dcn1"] = np.array([dcn1.n_sample, dcn1.n_model,
                                  dcn1.sample_rank, dcn1.model_rank])
    assert dcn1.axis_names == (SAMPLE_AXIS,)

    # rows: rank 0 holds 3, rank 1 holds 5; then rank 1 holds none
    rows = torch.arange(3 + 2 * rank, dtype=F64)[:, None] + 10.0 * rank
    res["rows_uneven"] = fetch_global(rows * torch.ones(1, 2, dtype=F64),
                                      mesh.sample_group).numpy()
    res["rows_none"] = fetch_global(rows if rank == 0 else None).numpy()

    # the model axis: both ranks pass the same white noise
    w = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (5, 16, 16)))
    res["matern_field"] = sample_matern2d_sharded(w, 16, m12).numpy()
    res["matern_field_8"] = sample_matern2d_sharded(w, 8, m12).numpy()
    try:
        Matern2DProblem(grids=(9, 3), mesh=m12, C=[np.eye(2) + 0.5] * 3,
                        device="cpu", verbose=False)
        res["matern_error"] = np.array("")
    except ValueError as e:
        res["matern_error"] = np.array(str(e))
    # ranks of one model group draw the same chunks and the sums are
    # contributed once: (1 x 2) sums equal the unsharded one-process sums
    p = Matern2DProblem(grids=(16, 8), mesh=m12, C=[np.eye(2) + 0.5] * 3,
                        device="cpu", verbose=False, device_batch_size=16)
    se, sc, _ = p.blue_fn([0, 1], 40)
    res["matern_se"], res["matern_sc"] = np.array(se), np.array(sc)
    # a subclass's own reference to the mesh does not travel either
    q = pickle.loads(pickle.dumps(p))
    res["matern_pickled"] = np.array(q.mesh is None
                                     and q._model_mesh is None)
    return _save(out, rank, res)


def case_e2e(mesh, out, rank=None):
    """BLUEProblem end to end: pilot, allocation, solve, snapshots, then a
    black-box model.  ``mesh`` None: the one-process run."""
    from bluest_tpu_torch.solvers import sdp
    sdp._WARM_CACHE.clear()
    tag = out if mesh is None else out + ".snap"
    # the pilot is two chunks, so its sums (one chunk a rank, one add) are
    # those of one process bit for bit and both runs allocate from the
    # same covariances
    p = ExpSeriesProblem(5, mesh=mesh, verbose=False, device="cpu",
                         covariance_estimation_samples=64,
                         device_batch_size=32, samplefile=tag + ".npz")
    p.setup_solver(K=3, budget=100.0)
    calls = {"reduce": 0, "copy": 0}
    if mesh is not None:
        real_reduce = mesh.all_reduce_samples

        def counted_reduce(x, op="sum"):
            calls["reduce"] += op == "sum"
            return real_reduce(x, op)
        mesh.all_reduce_samples = counted_reduce
    real_copy = p._sums_to_host

    def counted_copy(flat):
        calls["copy"] += 1
        return real_copy(flat)
    p._sums_to_host = counted_copy
    mus, errs, cost = p.solve(K=3, budget=100.0)
    del p._sums_to_host
    res = dict(mu=np.asarray(mus, float), err=np.asarray(errs, float),
               samples=np.asarray(p.MOSAP_output["samples"]),
               cost=float(cost), C=p.get_covariance(0),
               reduces=calls["reduce"], copies=calls["copy"],
               verbose=np.array(ExpSeriesProblem(
                   3, mesh=mesh, C=np.eye(3) + 0.5, device="cpu").verbose))
    mu_mlmc, _, _ = p.solve_mlmc(budget=100.0)
    mu_mfmc, _, _ = p.solve_mfmc(budget=100.0)
    res["mu_mlmc"], res["mu_mfmc"] = np.array(mu_mlmc), np.array(mu_mfmc)
    # pickling drops the mesh (and its process groups)
    q = pickle.loads(pickle.dumps(p))
    res["pickled_mesh_none"] = np.array(q.mesh is None
                                        and q.params["mesh"] is None)

    # black-box model: every rank runs it redundantly, the root alone
    # writes its snapshot file
    h = ExpSeriesHostProblem(3, mesh=mesh, C=np.eye(3) + 0.5, verbose=False,
                             device="cpu", sample_batch_size=8,
                             samplefile=tag + "_host.npz")
    se, _, _ = h.blue_fn([0, 1], 24)
    res["host_se"] = np.array(se)

    # snapshot collection in bounded pieces: 13 chunks of 8 samples, three
    # chunks a piece, plus the top-up of the non-finite rows; the largest
    # gather of rows under the mesh is recorded
    f = Flaky(2, mesh=mesh, device_batch_size=8,
              samplefile=tag + "_pieces.npz", **_known(2))
    f._COLLECT_CHUNK = 24
    gathered = [0]
    if mesh is not None:
        real_fetch = mesh.fetch_rows

        def counted_fetch(x):
            y = real_fetch(x)
            gathered[0] = max(gathered[0], int(y.shape[0]))
            return y
        mesh.fetch_rows = counted_fetch
    se, sc, _ = f.blue_fn([0, 1], 100)
    if mesh is not None:
        del mesh.fetch_rows
    res["pieces_se"], res["pieces_sc"] = np.array(se), np.array(sc)
    res["pieces_max_rows"] = np.array(gathered[0])
    return _save(out, rank, res)


# a dispatch of five calls, (models, counter, N), in chunks of DEAL_BATCH
# rows: 17 chunks, three calls of one chunk, the last chunk of two calls
# short; model 1 is non-finite on ~7% of the draws
DEAL_BATCH = 200
DEAL_CALLS = [((0, 1, 2), 0, 1000), ((0,), 1, 150), ((1, 2), 2, 650),
              ((2,), 3, 90), ((0, 1), 4, 1150)]


def _deal_model(ls, z):
    out = _grp_model(ls, z)
    bad = (z > 1.5)[:, None, None] & (torch.tensor(ls) == 1)
    return torch.where(bad, torch.nan, out)


class Seeded(GroupEngine):
    """The group engine that notes (counter, chunk) of each stream it
    seeds, in order: the chunks this rank evaluated."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.seeded = []

    def seed(self, gen, seed, counter, chunk):
        self.seeded.append((counter, chunk))
        return super().seed(gen, seed, counter, chunk)


class FlakyGroups(BLUEProblem):
    """Coupled-group model of one output whose model 1 is non-finite on
    ~7% of draws."""

    def sample_group(self, generator, ls, n):
        return torch.randn(n, generator=generator, dtype=F64)

    def evaluate_group(self, ls, z):
        return _deal_model(ls, z)[:, :1]


def _recorded(fn):
    """(fn's result, the counters of its request, its spans), with the
    recorder on and fn run inside one root span."""
    from bluest_tpu_torch import profiling
    profiling.enable_spans()
    try:
        with profiling.span("solve") as root:
            got = fn()
    finally:
        profiling.disable_spans()
    return got, dict(root.attrs["counters"]), profiling.spans()


def case_deal(mesh, out=None, rank=None):
    """The deal of one dispatch's chunks to the ranks, on four ranks:
    which chunks each rank seeded, its counters and sums, with redraws
    and with the non-finite rows dropped; then the problem's fetch
    rounds and their spans.  ``mesh`` None: the one-process values."""
    res = {}
    calls = [(ls, c, N, 0) for ls, c, N in DEAL_CALLS]
    for name, max_resample in (("redraw", 64), ("drop", 0)):
        eng = Seeded(_grp_inputs, _deal_model, 2, DEAL_BATCH, "cpu",
                     max_resample=max_resample, mesh=mesh)
        sums, counters, _ = _recorded(lambda: eng.sample_calls(7, calls))
        for j, (ls, s) in enumerate(zip([c[0] for c in calls], sums)):
            res["%s_%d" % (name, j)] = _flat(s, 2, len(ls), mesh)
            if mesh is None:        # each call alone, through its own run
                res["%s_alone_%d" % (name, j)] = _flat(
                    eng.sample_sums(ls, 7, calls[j][1], calls[j][2]), 2,
                    len(ls), None)
        res[name + "_seeded"] = np.array(list(dict.fromkeys(eng.seeded)))
        res[name + "_mesh_chunks"] = np.array(counters.get("mesh.chunks",
                                                           -1))
    # through the problem: redraws in the engine, or none and the
    # non-finite rows topped up in further fetch rounds
    for name, max_resample in (("redraw", 64), ("topup", 0)):
        p = FlakyGroups(3, mesh=mesh, device_batch_size=DEAL_BATCH,
                        max_resample=max_resample, **_known(3))
        host, counters, spans = _recorded(lambda: p._sample_groups(
            [c[0] for c in DEAL_CALLS], [c[2] for c in DEAL_CALLS]))
        key = "problem_%s_" % name
        res[key + "sums"] = np.concatenate(
            [np.concatenate([np.ravel(x) for x in h]) for h in host])
        for k in ("rows.kept", "rows.drawn", "mesh.all_reduce",
                  "mesh.all_reduce_bytes", "host.sync.fetch"):
            res[key + k] = np.array(counters.get(k, -1))
        fetch = {s.id for s in spans if s.name == "mesh.fetch"}
        res[key + "mesh_fetch_spans"] = np.array(len(fetch))
        res[key + "syncs_in_mesh_fetch"] = np.array(sum(
            s.name == "host.sync" and s.attrs["site"] == "fetch"
            and s.parent in fetch for s in spans))
        res[key + "rounds"] = np.array([s.attrs["fetch_rounds"]
                                        for s in spans if s.name == "sample"])
    return _save(out, rank, res)


CASES = {"engines": case_engines, "meshes": case_meshes, "e2e": case_e2e,
         "deal": case_deal}


def worker(rank, nproc, port, out, case):
    initialize_distributed(device="cpu",
                           init_method="tcp://127.0.0.1:%s" % port,
                           world_size=nproc, rank=rank,
                           timeout=datetime.timedelta(seconds=60))
    print("TORCH_MESH_INIT_OK", flush=True)
    try:
        CASES[case](sample_mesh(), out, rank)
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------- the tests -------------------------------- #

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(out, case, nproc=2, timeout=300):
    """Start this file as ``nproc`` ranks and load what each saved; any
    rank's failure fails the test with the ranks' output."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(nproc), OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(nproc), port,
         str(out), case], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(nproc)]
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=timeout)
            outs.append(o.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs[len(outs):]:
            o, _ = p.communicate()
            outs.append(o.decode(errors="replace"))
        raise AssertionError("ranks timed out:\n" + "\n".join(
            o[-2000:] for o in outs))
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("a rank failed:\n" + "\n".join(
            o[-3000:] for o in outs))
    return [dict(np.load("%s.p%d.npz" % (out, r))) for r in range(nproc)]


@pytest.fixture(autouse=True)
def _cold_ipm():
    """The interior-point solvers' warm-start caches are process-wide:
    every test starts with both empty."""
    from bluest_tpu.solvers import sdp as sdp_j
    from bluest_tpu_torch.solvers import sdp as sdp_t
    sdp_t._WARM_CACHE.clear()
    sdp_j._WARM_CACHE.clear()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("engines") / "got")
    return _run_workers(out, "engines"), case_engines(None)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("meshes") / "got")
    return _run_workers(out, "meshes")


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e")
    ref = case_e2e(None, str(d / "ref"))
    return _run_workers(str(d / "got"), "e2e"), ref, str(d)


@pytest.fixture(scope="module")
def deal(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("deal") / "got")
    return _run_workers(out, "deal", nproc=4), case_deal(None)


def _deal_chunks():
    return [(c, k) for _ls, c, N in DEAL_CALLS
            for k in range(-(-N // DEAL_BATCH))]


@pytest.mark.parametrize("engine", ["redraw", "drop"])
def test_four_ranks_evaluate_each_chunk_of_a_dispatch_once(deal, engine):
    """Every chunk of the dispatch is seeded on exactly one of the four
    ranks, each rank's chunks a contiguous block of the dispatch's
    sequence, in rank order."""
    got, _ref = deal
    seeded = [[tuple(x) for x in g[engine + "_seeded"]] for g in got]
    assert sum(seeded, []) == _deal_chunks()


@pytest.mark.parametrize("engine", ["redraw", "drop"])
def test_four_ranks_hold_an_even_share_of_a_dispatch(deal, engine):
    """``mesh.chunks``: each rank's chunks of the dispatch, within one of
    17 / 4, though three of the five calls are a chunk or less (dealt
    call by call, rank 0 would hold 7 and rank 3 one)."""
    got, ref = deal
    total = len(_deal_chunks())
    counts = [int(g[engine + "_mesh_chunks"]) for g in got]
    assert counts == [len(g[engine + "_seeded"]) for g in got]
    assert sum(counts) == total
    assert all(abs(n - total / 4) <= 1 for n in counts)
    assert int(ref[engine + "_mesh_chunks"]) == -1      # no mesh: none


@pytest.mark.parametrize("engine", ["redraw", "drop"])
@pytest.mark.parametrize("call", range(len(DEAL_CALLS)))
def test_four_rank_dispatch_sums_match_one_process(deal, engine, call):
    got, ref = deal
    key = "%s_%d" % (engine, call)
    for g in got:
        _sums_close(g[key], ref[key])
    if engine == "redraw":
        assert ref[key][-1] == 0
    elif 1 in DEAL_CALLS[call][0]:
        assert ref[key][-1] > 0                 # dropped and counted


@pytest.mark.parametrize("engine", ["redraw", "drop"])
def test_one_process_runs_a_dispatch_in_call_order(deal, engine):
    """Without a mesh the dispatch is every call's chunks in order, and
    each call's sums are bit-equal to the call run alone."""
    _got, ref = deal
    assert [tuple(x) for x in ref[engine + "_seeded"]] == _deal_chunks()
    for j in range(len(DEAL_CALLS)):
        assert np.array_equal(ref["%s_%d" % (engine, j)],
                              ref["%s_alone_%d" % (engine, j)])


@pytest.mark.parametrize("engine", ["redraw", "topup"])
def test_mesh_fetch_is_recorded_under_a_mesh_only(deal, engine):
    """One ``mesh.fetch`` span a fetch round on every rank, each holding
    the round's ``host.sync`` of the copy; one ``all_reduce`` a round
    and one to agree on the output dimension; none of it without a
    mesh."""
    got, ref = deal
    key = "problem_%s_" % engine
    rounds = int(ref[key + "rounds"][0])
    assert rounds == (1 if engine == "redraw" else 3)
    for g in got:
        assert int(g[key + "rounds"][0]) == rounds
        assert int(g[key + "mesh_fetch_spans"]) == rounds
        assert int(g[key + "syncs_in_mesh_fetch"]) == rounds
        assert int(g[key + "host.sync.fetch"]) == rounds + 1
        assert int(g[key + "mesh.all_reduce"]) == rounds + 1
        assert int(g[key + "mesh.all_reduce_bytes"]) > 0
    assert int(ref[key + "mesh_fetch_spans"]) == 0
    assert int(ref[key + "host.sync.fetch"]) == rounds
    assert int(ref[key + "mesh.all_reduce"]) == -1


@pytest.mark.parametrize("engine", ["redraw", "topup"])
def test_rows_kept_are_each_ranks_own(deal, engine):
    """Under a mesh a rank counts its own rows kept against its own rows
    drawn; over the ranks they add up to one process's counts, which
    are the requested rows less those still non-finite; the sums match
    one process's."""
    got, ref = deal
    key = "problem_%s_" % engine
    kept = [int(g[key + "rows.kept"]) for g in got]
    drawn = [int(g[key + "rows.drawn"]) for g in got]
    assert all(0 < k < d for k, d in zip(kept, drawn))
    assert sum(kept) == int(ref[key + "rows.kept"])
    assert sum(drawn) == int(ref[key + "rows.drawn"])
    assert int(ref[key + "rows.kept"]) == sum(N for _ls, _c, N in DEAL_CALLS)
    scale = np.abs(ref[key + "sums"]).max()
    for g in got:
        assert np.abs(g[key + "sums"] - ref[key + "sums"]).max() \
            <= 1e-12 * scale


def _sums_close(got, ref):
    """Flat sums [se, sc, d1, d2, n_failed]: 1e-12 relative to the
    largest entry of the sums, n_failed equal."""
    assert got.shape == ref.shape
    assert got[-1] == ref[-1]
    scale = max(np.abs(ref[:-1]).max(), 1e-300)
    assert np.abs(got[:-1] - ref[:-1]).max() <= 1e-12 * scale


def test_sharded_group_sums_match_one_device(engines):
    got, ref = engines
    for g in got:
        _sums_close(g["grp_1000"], ref["grp_1000"])
        assert g["grp_1000"][-1] == 0
    assert np.array_equal(got[0]["grp_1000"], got[1]["grp_1000"])


@pytest.mark.parametrize("N", EXACT_N)
def test_exact_n_factored_engine(engines, N):
    """Sums over exactly N samples for N below one chunk, below one chunk
    a rank, and not a multiple of batch x ranks; against one process and
    against the chunks' own streams drawn by hand."""
    from bluest_tpu_torch.sampling.engine import generator_seed
    got, ref = engines
    for g in got:
        _sums_close(g["fac_%d" % N], ref["fac_%d" % N])
    gen = torch.Generator()
    th = torch.cat([_fac_inputs(gen.manual_seed(generator_seed(5, 0, c)),
                                min(8, N - 8 * c))
                    for c in range(-(-N // 8))]).numpy()
    se = got[0]["fac_%d" % N][:2]
    np.testing.assert_allclose(se, [th.sum(), 2 * th.sum()], rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(got[0]["fac_%d" % N][3],
                               2 * (th ** 2).sum(), rtol=1e-12)


@pytest.mark.parametrize("N", EXACT_N)
def test_exact_n_group_engine(engines, N):
    got, ref = engines
    for g in got:
        _sums_close(g["grp_%d" % N], ref["grp_%d" % N])


def test_nonfinite_rows_resampled_in_the_group_engine(engines):
    got, ref = engines
    for g in got:
        _sums_close(g["nan_resampled"], ref["nan_resampled"])
        assert np.isfinite(g["nan_resampled"]).all()
        assert g["nan_resampled"][-1] == 0
        # the resampled law is the normal truncated at 0.5: mean < 0
        assert g["nan_resampled"][0] / 500 < 0


def test_dropped_nonfinite_rows_do_not_poison_sums(engines):
    got, ref = engines
    for g in got:
        _sums_close(g["nan_dropped"], ref["nan_dropped"])
        assert np.isfinite(g["nan_dropped"]).all()
        assert 0 < g["nan_dropped"][-1] < 500


def test_nonfinite_rows_topped_up_in_the_factored_engine(engines):
    """Masked, counted and drawn again from the next chunks of the same
    call: the sums cover 200 finite samples on every rank, equal those
    of one process, and the top-up took no new call counter."""
    got, ref = engines
    for g in got:
        assert np.isfinite(g["flaky_se"]).all()
        np.testing.assert_allclose(g["flaky_se"], ref["flaky_se"],
                                   rtol=1e-12)
        np.testing.assert_allclose(g["flaky_sc"], ref["flaky_sc"],
                                   rtol=1e-12)
        assert g["flaky_counter"] == ref["flaky_counter"] == 1
    # exp(z) <= e on the kept rows, and the kept law is z <= 1
    assert np.all(ref["flaky_se"] / 200 < np.e)


def test_vector_outputs_where_a_rank_holds_no_chunk(engines):
    got, ref = engines
    for g in got:
        assert g["vec_se"].shape == (1, 2, Vec.D)
        for k in ("vec_se", "vec_sc", "vec_d1", "vec_d2"):
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-12, atol=1e-14)


def test_mesh_shapes_and_divisibility_errors(meshes):
    for r, g in enumerate(meshes):
        assert g["shape_1d"].tolist() == [2, 1, r, 0]
        assert g["shape_12"].tolist() == [1, 2, 0, r]
        assert g["shape_dcn"].tolist() == [1, 2, 0, r]
        assert g["shape_dcn1"].tolist() == [2, 1, r, 0]
        e = [str(x) for x in g["errors"]]
        assert "mesh larger than device count" in e[0]
        assert "mesh larger than device count" in e[1]
        assert "must divide the local rank count 2" in e[2]
    # the same names, shapes and refusals as the JAX package's meshes over
    # this process's CPU devices (ranks stand where devices stood)
    import jax
    from bluest_tpu.parallel import mesh as jmesh
    assert (SAMPLE_AXIS, MODEL_AXIS) == (jmesh.SAMPLE_AXIS, jmesh.MODEL_AXIS)
    n_dev = len(jax.devices())
    j12 = jmesh.sample_model_mesh(1, 2)
    assert j12.axis_names == (SAMPLE_AXIS, MODEL_AXIS)
    assert dict(j12.shape) == {SAMPLE_AXIS: 1, MODEL_AXIS: 2}
    j1d = jmesh.sample_mesh(2)
    assert j1d.axis_names == (SAMPLE_AXIS,)
    assert dict(j1d.shape) == {SAMPLE_AXIS: 2}
    jdcn = jmesh.dcn_sample_model_mesh()
    assert dict(jdcn.shape) == {SAMPLE_AXIS: 1, MODEL_AXIS: n_dev}
    assert jmesh.dcn_sample_model_mesh(n_model=1).axis_names \
        == (SAMPLE_AXIS,)
    e = [str(x) for x in meshes[0]["errors"]]
    with pytest.raises(ValueError) as too_large:
        jmesh.sample_model_mesh(n_dev, 2)
    assert e[0].startswith(str(too_large.value))
    with pytest.raises(ValueError) as indivisible:
        jmesh.dcn_sample_model_mesh(n_model=n_dev + 1)
    want = str(indivisible.value).replace(
        "n_model=%d" % (n_dev + 1), "n_model=3").replace(
        "local device count %d" % n_dev, "local rank count 2").replace(
        "DCN boundary", "node boundary")
    assert e[2] == want


def test_fetch_global_gathers_uneven_rows_in_rank_order(meshes):
    want = np.concatenate([np.arange(3.0), np.arange(5.0) + 10.0])
    for g in meshes:
        assert g["rows_uneven"].shape == (8, 2)
        np.testing.assert_array_equal(g["rows_uneven"][:, 0], want)
        np.testing.assert_array_equal(g["rows_none"][:, 0], np.arange(3.0))
    # one process, no process group: the array comes back as it is
    x = torch.arange(4.0)
    assert fetch_global(x) is x


def test_sharded_matern_field_equals_unsharded(meshes):
    w = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (5, 16, 16)))
    import jax
    import jax.numpy as jnp
    from bluest_tpu.models import matern2d as jmatern
    for n, key in ((16, "matern_field"), (8, "matern_field_8")):
        ref = sample_matern2d(w, n).numpy()
        # and the JAX package's field from the same white noise
        jref = np.asarray(jax.vmap(
            lambda wh: jmatern.sample_matern2d(wh, n))(jnp.asarray(
                w.numpy())))
        assert jref.dtype == np.float64
        for g in meshes:
            assert np.abs(g[key] - ref).max() <= 1e-12 * np.abs(ref).max()
            assert np.abs(g[key] - jref).max() <= 1e-12 * np.abs(jref).max()
    assert "divisible by the model-axis size" in str(
        meshes[0]["matern_error"])


def test_matern_problem_on_the_model_axis(meshes):
    p = Matern2DProblem(grids=(16, 8), C=[np.eye(2) + 0.5] * 3,
                        device="cpu", verbose=False, device_batch_size=16)
    se, sc, _ = p.blue_fn([0, 1], 40)
    for g in meshes:
        np.testing.assert_allclose(g["matern_se"], np.array(se), rtol=1e-12)
        np.testing.assert_allclose(g["matern_sc"], np.array(sc), rtol=1e-12)
        assert bool(g["matern_pickled"])


def test_two_rank_blueproblem_end_to_end(e2e):
    got, ref, _ = e2e
    # the ranks ran one program: identical results
    np.testing.assert_array_equal(got[0]["mu"], got[1]["mu"])
    np.testing.assert_array_equal(got[0]["samples"], got[1]["samples"])
    # and the split is invisible against one process
    np.testing.assert_array_equal(got[0]["C"], ref["C"])
    np.testing.assert_array_equal(got[0]["samples"], ref["samples"])
    assert got[0]["cost"] == ref["cost"]
    np.testing.assert_allclose(got[0]["mu"], ref["mu"], rtol=1e-10)
    np.testing.assert_allclose(got[0]["err"], ref["err"], rtol=1e-10)
    np.testing.assert_allclose(got[0]["mu_mlmc"], ref["mu_mlmc"], rtol=1e-10)
    np.testing.assert_allclose(got[0]["mu_mfmc"], ref["mu_mfmc"], rtol=1e-10)
    assert abs(float(ref["mu"][0]) - np.exp(0.5)) < 6 * float(ref["err"][0])
    # the allocation the ranks agreed on is the JAX package's from the
    # covariance they estimated
    from bluest_tpu.models.analytic import ExpSeriesProblem as JaxExpSeries
    pj = JaxExpSeries(5, C=got[0]["C"], verbose=False)
    pj.setup_solver(K=3, budget=100.0)
    np.testing.assert_array_equal(got[0]["samples"],
                                  pj.MOSAP_output["samples"])
    assert got[0]["cost"] == float(sum(
        int(m) * c for m, c in zip(pj.MOSAP_output["samples"],
                                   pj.MOSAP.costs)))


def test_one_collective_and_one_copy_per_fetch(e2e):
    """The solve's sums arrive in one all_reduce and one device -> host
    copy (no group lost samples, so there is one fetch round)."""
    got, ref, _ = e2e
    for g in got:
        assert int(g["reduces"]) == 1 and int(g["copies"]) == 1
    assert int(ref["reduces"]) == 0 and int(ref["copies"]) == 1


def test_snapshots_written_by_the_root_equal_one_process(e2e):
    got, ref, d = e2e
    ref_files = sorted(glob.glob(os.path.join(d, "ref*.npz")))
    got_files = sorted(glob.glob(os.path.join(d, "got.snap*.npz")))
    assert ref_files
    assert [os.path.basename(f)[len("ref"):] for f in ref_files] \
        == [os.path.basename(f)[len("got.snap"):] for f in got_files]
    for rf, gf in zip(ref_files, got_files):
        # (the host engine stores its samples as an object array)
        with np.load(rf, allow_pickle=True) as a, \
                np.load(gf, allow_pickle=True) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].shape[0] > 0
                for x, y in zip(a[k].ravel(), b[k].ravel()):
                    np.testing.assert_array_equal(
                        x, y, err_msg="%s:%s" % (gf, k))


def test_snapshot_rows_are_collected_in_bounded_pieces(e2e):
    """With a samplefile a call's rows leave the device piece by piece
    (``_COLLECT_CHUNK`` samples, whole chunks): no gather under the mesh
    holds more than a piece, the sums equal one process's, and one
    process's equal the sums of the same call without a samplefile bit
    for bit.  (The files are held row for row by the test above.)"""
    got, ref, _ = e2e
    for g in got:
        assert 0 < int(g["pieces_max_rows"]) <= 24
        np.testing.assert_allclose(g["pieces_se"], ref["pieces_se"],
                                   rtol=1e-12)
        np.testing.assert_allclose(g["pieces_sc"], ref["pieces_sc"],
                                   rtol=1e-12)
    plain = Flaky(2, device_batch_size=8, **_known(2))
    se, sc, _ = plain.blue_fn([0, 1], 100)
    np.testing.assert_array_equal(ref["pieces_se"], np.array(se))
    np.testing.assert_array_equal(ref["pieces_sc"], np.array(sc))


def test_rank_discipline(e2e):
    """Only the root is verbose; pickling drops the mesh; a black-box
    model runs redundantly on every rank (same sums as one process)."""
    got, ref, _ = e2e
    assert bool(ref["verbose"]) and bool(got[0]["verbose"])
    assert not bool(got[1]["verbose"])
    for g in got:
        assert bool(g["pickled_mesh_none"])
        np.testing.assert_array_equal(g["host_se"], ref["host_se"])


def test_mesh_without_a_process_group_raises():
    for build in (sample_mesh, lambda: sample_model_mesh(1, 1),
                  dcn_sample_model_mesh):
        with pytest.raises(RuntimeError, match="not initialised"):
            build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            initialize_distributed(init_method="tcp://127.0.0.1:1",
                                   world_size=1, rank=0)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
           sys.argv[5])
