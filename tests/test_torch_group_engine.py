"""The coupled-group engine and the snapshot-collecting paths.

  * group-engine sums equal ``combine`` on the same rows;
  * the per-row resample redraws only the failing rows: the finite rows
    of the first draw keep their inputs and outputs bit for bit, the
    redrawn ones are the next draws of the same generator, and the run
    ends with n_failed == 0;
  * vector outputs (n, No, L, d) with the dot product;
  * the collect variants (group and factored): snapshot rows equal the
    samples the sums cover -- the accepted draws' inputs, with the
    top-up rounds written through one sink -- over several
    ``_COLLECT_CHUNK`` chunks (a small override here), in the JAX
    package's npz layout;
  * the coupled-group kind runs every estimator;
  * the calls of one dispatch run as one sequence drawn one chunk ahead:
    the model's evaluations (models, inputs, outputs) are those of the
    sampling contract's one-by-one loop (``_one_by_one``, written here
    apart from the engine) and
    the sums those of a loop of the engine's own per-chunk steps, bit for
    bit, with failing rows in a chunk followed by one of its call, in a
    call's last chunk followed by the next call and in the last chunk;
    under two ranks of a CPU mesh each evaluation's rows come from the
    stream of the ``sample_group`` call just before it; the counters
    ``draw.ahead`` and ``draw.ahead_dropped``.

This file is also the worker script of its two-rank case: ``python
tests/test_torch_group_engine.py <rank> <port> <out>``.
"""

import datetime
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bluest_tpu_torch import BLUEProblem, profiling
from bluest_tpu_torch.models.analytic import TRUE_MEAN, ExpSeriesProblem
from bluest_tpu_torch.sampling.engine import (combine, finite_rows, fold,
                                              generator_seed)
from bluest_tpu_torch.sampling.group_engine import GroupEngine

torch.set_num_threads(1)
F64 = torch.float64


def _series(z, terms):
    ii = torch.arange(terms + 1, dtype=F64)
    return (z[:, None] ** ii / torch.exp(torch.lgamma(ii + 1.0))).sum(1)


class GroupSeries(BLUEProblem):
    """The tutorial hierarchy as a coupled-group model, with an input
    tuple (z, shift); rows with z > ``fail_above`` give NaN."""

    fail_above = float("inf")

    def sample_group(self, generator, ls, n):
        z = torch.randn(n, generator=generator, dtype=F64, device=self.device)
        return z, torch.full((n, 2), 0.5, dtype=F64, device=self.device)

    def evaluate_group(self, ls, inputs):
        z, shift = inputs
        cols = [torch.exp(z) if l == 0 else _series(z, self.M - l)
                for l in ls]
        out = torch.stack(cols, dim=1)[:, None, :] + 0 * shift[:, :1, None]
        return torch.where(z[:, None, None] > self.fail_above,
                           torch.full_like(out, float("nan")), out)


class FlakyGroup(GroupSeries):
    fail_above = 1.0


def _engine(p, **kw):
    return GroupEngine(p.sample_group, p.evaluate_group, p.n_outputs,
                       kw.pop("batch", 7), "cpu", **kw)


def _problem(cls=GroupSeries, M=3, **kw):
    return cls(M, C=np.eye(M) + 0.5, costs=2.0 ** -np.arange(M),
               device="cpu", verbose=False, **kw)


def test_group_sums_equal_combine_on_the_same_rows():
    p = _problem()
    eng = _engine(p)
    ls, N, seed = (0, 2), 30, 1234
    sums = eng.sample_sums(ls, seed, 2, N)
    gen = torch.Generator()
    rows = []
    for c, base in enumerate(range(0, N, 7)):
        gen.manual_seed(generator_seed(seed, 2, c))
        rows.append(p.evaluate_group(ls, p.sample_group(gen, ls,
                                                        min(7, N - base))))
    ref = combine(torch.cat(rows).movedim(2, 0), 0, N)
    for g, r in zip(sums, ref):
        assert torch.equal(g, r) or torch.allclose(g, r, rtol=1e-13,
                                                   atol=0)
    assert int(sums.n_failed) == 0


def test_per_row_resample_keeps_finite_rows():
    p = _problem(FlakyGroup)
    sizes = []

    def sample_group(generator, ls, n):
        sizes.append(n)
        return p.sample_group(generator, ls, n)

    eng = GroupEngine(sample_group, p.evaluate_group, p.n_outputs, 64, "cpu")
    ls, seed = (0, 1, 2), 77
    sums, vals, inputs, ok = eng.collect(ls, seed, 0, 64)
    assert bool(ok.all()) and int(sums.n_failed) == 0
    assert bool(finite_rows(vals).all())
    gen = torch.Generator().manual_seed(generator_seed(seed, 0, 0))
    z0, s0 = p.sample_group(gen, ls, 64)
    first = p.evaluate_group(ls, (z0, s0))
    good = finite_rows(first)
    assert 0 < int((~good).sum()) < 64         # some rows were redrawn
    assert torch.equal(vals[good], first[good])
    assert torch.equal(inputs[good, 0], z0[good])
    # the failing rows, in row order, take the finite ones of the next
    # draws of the same generator, in draw order; the round draws the
    # deficit over the finite share with a margin, so one round covers it
    bad = torch.nonzero(~good).flatten()
    assert sizes[0] == 64 and len(sizes) == 2
    assert sizes[1] == eng.redraw_rows(bad.numel(), 64, int(good.sum()))
    assert sizes[1] > bad.numel()
    z1, _ = p.sample_group(gen, ls, sizes[1])
    fin1 = z1[z1 <= p.fail_above]
    assert fin1.numel() >= bad.numel()
    assert torch.equal(inputs[bad, 0], fin1[:bad.numel()])
    assert torch.all(inputs[:, 0] <= p.fail_above)
    assert torch.equal(inputs[:, 1:], torch.full((64, 2), 0.5, dtype=F64))
    ref = combine(vals.movedim(2, 0), 0, 64)
    for g, r in zip(sums, ref):
        assert torch.allclose(g, r, rtol=1e-13, atol=0)


def test_resample_rounds_are_bounded():
    """A group that never gives a finite row stops after max_resample
    rounds, each drawing at most 4 batches, and counts every row failed.
    The second chunk is drawn ahead of the first one's read, and drawn
    again after the first one's redraws."""
    p = _problem(GroupSeries)
    sizes, evaluated = [], []

    def sample_group(generator, ls, n):
        sizes.append(n)
        return p.sample_group(generator, ls, n)

    def evaluate_group(ls, inputs):
        evaluated.append(inputs[0].shape[0])
        return torch.full((inputs[0].shape[0], 1, len(ls)), float("nan"),
                          dtype=F64)

    eng = GroupEngine(sample_group, evaluate_group, 1, 8, "cpu",
                      max_resample=3)
    sums = eng.sample_sums((0, 1), 5, 0, 10)
    assert int(sums.n_failed) == 10
    assert evaluated == [8, 32, 32, 32, 2, 32, 32, 32]
    assert sizes == [8, 2, 32, 32, 32, 2, 32, 32, 32]
    assert eng.redraw_rows(5, 10, 5) == 13           # 1.25 * 5 / 0.5
    assert eng.redraw_rows(5, 10, 10) == 7           # at least n_bad
    assert eng.redraw_rows(100, 10, 10) == 100       # never below n_bad


def test_no_resample_masks_and_counts():
    p = _problem(FlakyGroup)
    sums = _engine(p, max_resample=0).sample_sums((0, 1), 5, 0, 200)
    assert 10 < int(sums.n_failed) < 60        # P(z > 1) ~ 0.16
    # through the problem, the top-up covers N finite samples
    p.params["max_resample"] = 0
    se = p.blue_fn([0, 1], 200)[0]
    assert p.sampling_stats[(0, 1)]["samples"] == 200
    assert np.isfinite(se[0][0])


class VecGroup(BLUEProblem):
    D = 4

    def sample_group(self, generator, ls, n):
        return torch.randn(n, generator=generator, dtype=F64)

    def evaluate_group(self, ls, z):
        k = torch.arange(self.D, dtype=F64)
        cols = [torch.sin(z[:, None] + k) / (1.0 + 0.1 * l) for l in ls]
        return torch.stack(cols, dim=1)[:, None]           # (n, 1, L, D)

    def get_models_inner_products(self):
        return [lambda a, b: np.dot(a, b)]


def test_vector_outputs_group_engine():
    """Array-valued QoIs through the group engine with the dot product
    (the JAX package's tests/test_problem_e2e.py vector case)."""
    p = VecGroup(3, costs=np.array([4.0, 2.0, 1.0]), device="cpu",
                 covariance_estimation_samples=2048, verbose=False)
    C = p.get_covariance()
    assert np.all(np.isfinite(np.diag(C))) and C[0, 0] > 0
    eps = 0.05 * np.sqrt(C[0, 0])
    mus, errs, _ = p.solve(K=2, eps=eps)
    mu = np.asarray(mus[0])
    assert mu.shape == (VecGroup.D,)
    ref = np.sin(np.arange(VecGroup.D)) * np.exp(-0.5)
    np.testing.assert_allclose(mu, ref, atol=6 * max(errs[0], 0.05))
    s = _engine(p).sample_sums((0, 2), 3, 0, 20)
    assert s.sumse.shape == (1, 2, VecGroup.D)
    assert s.sumsd1.shape == (1, 2, 2, VecGroup.D)


def _snap(path):
    with np.load(path, allow_pickle=True) as d:
        return {k: d[k] for k in d.files}


def _check_file(p, path, ls, N):
    """Rows == the samples the sums cover, and each stored row is the
    model's output on its stored input."""
    d = _snap(path)
    assert list(d["models"][0]) == list(ls)
    assert int(d["n_samples"][0]) == N == p.sampling_stats[tuple(ls)][
        "samples"]
    for i in range(len(ls)):
        assert d["values_0_%d" % i].shape[0] == N
        assert d["inputs_%d" % i].shape[0] == N
    return d


@pytest.mark.parametrize("cls", [GroupSeries, FlakyGroup])
def test_group_collect_over_chunks(tmp_path, cls):
    p = _problem(cls, max_resample=2)
    p._COLLECT_CHUNK = 16
    p.params["samplefile"] = str(tmp_path / "g.npz")
    ls, N = (0, 2), 50
    se, sc, _ = p.blue_fn(list(ls), N)
    d = _check_file(p, str(tmp_path / "g02.npz"), ls, N)
    z = torch.as_tensor(d["inputs_0"][:, 0])
    shift = torch.as_tensor(d["inputs_0"][:, 1:])
    vals = p.evaluate_group(ls, (z, shift))[:, 0]
    for i in range(2):
        np.testing.assert_array_equal(d["values_0_%d" % i],
                                      vals[:, i].numpy())
        assert se[0][i] == pytest.approx(float(vals[:, i].sum()),
                                         rel=1e-12)
    assert sc[0][0, 1] == pytest.approx(float((vals[:, 0] * vals[:, 1])
                                              .sum()), rel=1e-12)


@pytest.mark.parametrize("kind", ["group", "group-flaky", "group-redraw",
                                  "factored", "factored-flaky"])
def test_sums_with_a_samplefile_equal_sums_without(tmp_path, kind):
    """A samplefile changes no stream and no summation order: the
    collect pieces (here 2 chunks each, 4 pieces) go on through the chunk
    streams of the call and fold into one running sum, so every sum is
    bit-equal to the same call's without a samplefile ("group-redraw":
    chunks with failing rows, whose draws made ahead are drawn again)."""
    out = []
    for f in (None, str(tmp_path / "s.npz")):
        if kind.startswith("group"):
            p = _problem(GroupSeries if kind == "group" else FlakyGroup,
                         max_resample=0 if "flaky" in kind else 2,
                         device_batch_size=8, samplefile=f, seed=4)
            p._COLLECT_CHUNK = 16
        else:
            cls = FlakyFactored if "flaky" in kind else ExpSeriesProblem
            p = cls(3, C=np.eye(3) + 0.5, device="cpu", verbose=False,
                    device_batch_size=8, samplefile=f, seed=4)
        out.append(p.blue_fn([0, 2], 50, compute_mlmc_differences=True))
        assert p._call_counter == 1
    (se0, sc0, _, d10, d20), (se1, sc1, _, d11, d21) = out
    for a, b in ((se0, se1), (sc0, sc1), (d10, d11), (d20, d21)):
        assert np.array_equal(np.array(a), np.array(b))
        assert np.isfinite(np.array(a)).all()
    _check_file(p, str(tmp_path / "s02.npz"), (0, 2), 50)


class FlakyFactored(ExpSeriesProblem):
    def evaluate_model(self, l, z):
        out = super().evaluate_model(l, z)
        return torch.where(z[:, None] > 1.0, torch.nan, out)


@pytest.mark.parametrize("cls", [ExpSeriesProblem, FlakyFactored])
def test_factored_collect(tmp_path, cls):
    """The factored engine's collect mode: non-finite rows are dropped
    from the snapshot and the top-up rows reach it, so the rows equal
    the covered samples."""
    p = cls(3, C=np.eye(3) + 0.5, device="cpu", verbose=False,
            device_batch_size=16, samplefile=str(tmp_path / "f.npz"))
    ls, N = (0, 1, 2), 60
    se = p.blue_fn(list(ls), N)[0]
    d = _check_file(p, str(tmp_path / "f012.npz"), ls, N)
    z = torch.as_tensor(d["inputs_0"][:, 0])
    for i, l in enumerate(ls):
        v = ExpSeriesProblem.evaluate_model(p, l, z)[:, 0].numpy()
        np.testing.assert_array_equal(d["values_0_%d" % i], v)
        assert se[0][i] == pytest.approx(float(v.sum()), rel=1e-12)
        np.testing.assert_array_equal(d["inputs_%d" % i], d["inputs_0"])


def test_device_snapshot_layout_matches_jax(tmp_path):
    """A device-engine snapshot has the JAX package's keys, dtypes and
    shapes (the streams differ, so not its values), and the two packages
    append to each other's file."""
    from bluest_tpu.models.analytic import ExpSeriesMultiProblem as J
    from bluest_tpu_torch.models.analytic import ExpSeriesMultiProblem as T
    kw = dict(C=[np.eye(3) + 0.5] * 2, costs=np.array([4.0, 2.0, 1.0]),
              verbose=False, outputs_to_save=[1])
    pt = T(3, device="cpu", samplefile=str(tmp_path / "t.npz"), **kw)
    pj = J(3, samplefile=str(tmp_path / "j.npz"), **kw)
    pt.blue_fn([0, 2], 40)
    pj.blue_fn([0, 2], 40)
    a, b = _snap(str(tmp_path / "t02.npz")), _snap(str(tmp_path / "j02.npz"))
    assert sorted(a) == sorted(b)
    for k in a:
        assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
    pt.params["samplefile"] = str(tmp_path / "j.npz")
    pt.blue_fn([0, 2], 10)
    pj.params["samplefile"] = str(tmp_path / "t.npz")
    pj.blue_fn([0, 2], 10)
    for f in ("t02.npz", "j02.npz"):
        d = _snap(str(tmp_path / f))
        assert int(d["n_samples"][0]) == 50
        assert all(d[k].shape[0] == 50 for k in d
                   if k.startswith(("values", "inputs")))


def test_spill_path_streams_through_the_spool(tmp_path, monkeypatch):
    """Past the spill threshold the sink spools to disk next to the
    samplefile; the file is the same as the in-memory path's."""
    files = {}
    for spill in ("0", "0.0001"):
        monkeypatch.setenv("BLUEST_TPU_SNAPSHOT_SPILL_MB", spill)
        d = tmp_path / ("s" + spill.replace(".", ""))
        d.mkdir()
        p = _problem(samplefile=str(d / "s.npz"))
        p._COLLECT_CHUNK = 16
        p.blue_fn([0, 1], 40)
        files[spill] = _snap(str(d / "s01.npz"))
        assert not [f for f in os.listdir(d) if "snapspool" in f]
    a, b = files.values()
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_group_kind_runs_every_estimator():
    p = GroupSeries(4, costs=2.0 ** -np.arange(4), device="cpu",
                    covariance_estimation_samples=2048, verbose=False)
    assert p._has_group_model() and not p._has_factored_model()
    eps = 0.03
    p.setup_solver(K=3, eps=eps)
    runs = {"mlblue": p.solve(K=3, eps=eps), "mc": p.solve_mc(eps=eps),
            "mlmc": p.solve_mlmc(mlmc_data=p.setup_mlmc(eps=eps)),
            "mfmc": p.solve_mfmc(mfmc_data=p.setup_mfmc(eps=eps))}
    for name, (mus, errs, cost) in runs.items():
        assert abs(float(mus[0]) - TRUE_MEAN) <= 4 * float(errs[0]), name
        assert float(errs[0]) <= 1.0001 * eps and cost > 0, name
    assert isinstance(p._engine, GroupEngine)


def test_factored_kind_runs_every_estimator():
    p = ExpSeriesProblem(4, device="cpu", covariance_estimation_samples=2048,
                         verbose=False)
    eps = 0.03
    runs = {"mlblue": p.solve(K=3, eps=eps), "mc": p.solve_mc(eps=eps),
            "mlmc": p.solve_mlmc(eps=eps), "mfmc": p.solve_mfmc(eps=eps)}
    for name, (mus, errs, cost) in runs.items():
        assert abs(float(mus[0]) - TRUE_MEAN) <= 4 * float(errs[0]), name


def test_unported_parameters_raise():
    # mesh and profile_dir are ported: one process without a process
    # group has no mesh, a mesh by another name raises, and a mesh
    # function without a process group raises
    assert _problem(mesh="auto").mesh is None
    assert _problem(profile_dir="/nonexistent").params["profile_dir"]
    with pytest.raises(ValueError, match="mesh must be"):
        _problem(mesh="ring")
    from bluest_tpu_torch.parallel import sample_mesh
    with pytest.raises(RuntimeError, match="not initialised"):
        sample_mesh()
    # a key outside default_params lands in params, as in the JAX package
    assert _problem(no_such_parameter=1).params["no_such_parameter"] == 1
    p = _problem(comm=object(), sample_batch_size=4, max_resample=3,
                 host_workers=1, model_workers=1, outputs_to_save=[0])
    assert p.params["max_resample"] == 3 and p.get_comm() is None


# ------------- the calls of a dispatch: one sequence, one chunk ahead ------------- #

SEQ_SEED = 2 ** 33 + 7
SEQ_BATCH = 16
# (models, call counter, N): 4, 3 and 3 chunks of up to 16 rows
SEQ_CALLS = [((0, 1), 3, 60), ((1, 2), 4, 40), ((0, 2), 5, 44)]
# chunks (counter, index) whose rows fail where z > 0: one followed by a
# chunk of its call, a call's last chunk followed by the next call, a
# call's first chunk and the sequence's last chunk
SEQ_FAILING = [(3, 1), (3, 3), (4, 0), (5, 2)]


class Patchy:
    """A toy coupled-group model with input tuples (z, flag): z standard
    normal from the generator, flag 1 in the chunks whose stream is in
    ``failing``; outputs (n, 2, L), NaN where flag is 1 and z > 0, in a
    failing chunk's redraws too.  Keeps the stream of every
    ``sample_group`` call and every evaluation as (models, inputs,
    outputs, the stream of the ``sample_group`` call before it)."""

    def __init__(self, failing=()):
        self.failing = {generator_seed(SEQ_SEED, c, k) for c, k in failing}
        self.draws, self.evaluated = [], []

    def sample_group(self, generator, ls, n):
        stream = generator.initial_seed()
        self.draws.append(stream)
        z = torch.randn(n, generator=generator, dtype=F64)
        return z, torch.full((n,), float(stream in self.failing), dtype=F64)

    def evaluate_group(self, ls, inputs):
        z, flag = inputs
        out = torch.stack([torch.stack([z * (l + 1.0), torch.cos(z + l)],
                                       dim=1) for l in ls], dim=2)
        out = torch.where(((flag > 0) & (z > 0))[:, None, None],
                          torch.full_like(out, float("nan")), out)
        self.evaluated.append((tuple(ls), inputs, out, self.draws[-1]))
        return out


def _seq_engine(toy, mesh=None):
    return GroupEngine(toy.sample_group, toy.evaluate_group, 2, SEQ_BATCH,
                       "cpu", mesh=mesh)


def _seq_sums(eng):
    return eng.sample_calls(SEQ_SEED, [(ls, counter, N, 0)
                                       for ls, counter, N in SEQ_CALLS])


def _same_outputs(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _stream(counter, chunk):
    """Chunk ``chunk`` of call ``counter``'s stream by the sampling
    contract: the two 32-bit words of ``SeedSequence([seed, counter,
    chunk])``, high word first."""
    s = np.random.SeedSequence([SEQ_SEED, counter, chunk]).generate_state(
        2, dtype=np.uint32)
    return (int(s[0]) << 32) | int(s[1])


def _finite(o):
    return torch.isfinite(o).flatten(1).all(dim=1)


def _one_by_one(toy, ls, counter, N, max_resample=64):
    """One call by the sampling contract, one chunk after another: a
    chunk draws and evaluates from its own stream, then redraws its
    failing rows in rounds from the same stream, each round's finite
    rows given in order to the failing rows in order (a round draws
    ``min(max(ceil(1.25 bad / share), bad), max(bad, 4 batch))``, share:
    finite rows over rows drawn so far, floored at 1/64).  Returns every
    evaluation as (inputs, outputs) and the (No, L) sums of the rows."""
    evals, total = [], 0
    for c in range(math.ceil(N / SEQ_BATCH)):
        gen = torch.Generator().manual_seed(_stream(counter, c))
        x = toy.sample_group(gen, ls, min(SEQ_BATCH, N - c * SEQ_BATCH))
        o = toy.evaluate_group(ls, x)
        evals.append((x, o))
        ok = _finite(o)
        drawn, accepted = o.shape[0], int(ok.sum())
        for _ in range(max_resample):
            bad = torch.nonzero(~ok).flatten()
            if bad.numel() == 0:
                break
            share = max(accepted / drawn, 1.0 / 64)
            m = min(max(math.ceil(1.25 * bad.numel() / share), bad.numel()),
                    max(bad.numel(), 4 * SEQ_BATCH))
            nx = toy.sample_group(gen, ls, m)
            no = toy.evaluate_group(ls, nx)
            evals.append((nx, no))
            good = torch.nonzero(_finite(no)).flatten()
            drawn, accepted = drawn + m, accepted + good.numel()
            good = good[:bad.numel()]
            take = bad[:good.numel()]
            o = o.index_copy(0, take, no[good])
            ok = ok.index_fill(0, take, True)
        assert bool(ok.all())
        total = total + o.sum(dim=0)
    return evals, total


def _rows_from_their_streams(evaluated):
    """Each evaluation's inputs are the next draws of the stream of the
    ``sample_group`` call just before it: replayed stream by stream."""
    gens = {}
    for _ls, (z, _flag), _out, stream in evaluated:
        if stream not in gens:
            gens[stream] = torch.Generator().manual_seed(stream)
        assert torch.equal(z, torch.randn(z.shape[0], generator=gens[stream],
                                          dtype=F64))


def test_dispatch_sequence_is_the_one_by_one_loop():
    """Three calls run as one sequence drawn one chunk ahead: the model's
    evaluations are the sampling contract's one-by-one loop, call by
    call (``_one_by_one``), and the sums are bit for bit those of a loop
    of the engine's per-chunk steps, chunk after chunk."""
    toy = Patchy(SEQ_FAILING)
    got = _seq_sums(_seq_engine(toy))
    ref = Patchy(SEQ_FAILING)
    want = []
    for (ls, counter, N), sums in zip(SEQ_CALLS, got):
        calls, total = _one_by_one(ref, ls, counter, N)
        want += [(ls, x, o) for x, o in calls]
        assert int(sums.n_failed) == 0
        assert torch.allclose(sums.sumse[..., 0], total, rtol=1e-13, atol=0)
    assert len(toy.evaluated) == len(want) > 10     # the failing chunks redraw
    for (ls, x, o, _stream), (ls_w, x_w, o_w) in zip(toy.evaluated, want):
        assert ls == ls_w
        assert all(torch.equal(a, b) for a, b in zip(x, x_w))
        _same_outputs(o, o_w)
    _rows_from_their_streams(toy.evaluated)

    # the same chunks through the engine's steps, one after another
    one = Patchy(SEQ_FAILING)
    eng = _seq_engine(one)
    gen = torch.Generator()
    for (ls, counter, N), sums in zip(SEQ_CALLS, got):
        acc = None
        for c in range(math.ceil(N / SEQ_BATCH)):
            base = c * SEQ_BATCH
            _x, o, _ok = eng.draw(eng.seed(gen, SEQ_SEED, counter, c), ls,
                                  min(SEQ_BATCH, N - base))
            acc = fold(combine, acc, o.movedim(2, 0), base, N)
        assert all(torch.equal(a, b) for a, b in zip(sums, acc))
    assert len(one.evaluated) == len(toy.evaluated)
    for a, b in zip(one.evaluated, toy.evaluated):
        _same_outputs(a[2], b[2])


def test_draw_ahead_counters():
    """Every chunk but the sequence's first is drawn ahead of the read
    before it; the draws ahead of the chunks after a failing one, all but
    the last, are dropped and drawn again.  One count read a chunk, one
    read of the failing rows a failing chunk."""
    toy = Patchy(SEQ_FAILING)
    eng = _seq_engine(toy)
    profiling.enable_spans()
    try:
        with profiling.span("dispatch") as root:
            _seq_sums(eng)
    finally:
        profiling.disable_spans()
    counters = root.attrs["counters"]
    chunks = sum(math.ceil(N / SEQ_BATCH) for _ls, _c, N in SEQ_CALLS)
    assert counters["draw.ahead"] == chunks - 1
    assert counters["draw.ahead_dropped"] == len(SEQ_FAILING) - 1
    assert counters["host.sync.draw.count"] == chunks
    assert counters["host.sync.draw.bad"] == len(SEQ_FAILING)
    redraws = sum(s.name == "sample.redraw" for s in profiling.spans())
    assert counters["host.sync.draw.good"] == redraws >= len(SEQ_FAILING)
    assert len(toy.draws) == len(toy.evaluated) + len(SEQ_FAILING) - 1
    # the same toy without failing chunks drops nothing
    profiling.enable_spans()
    try:
        with profiling.span("dispatch") as root:
            _seq_sums(_seq_engine(Patchy()))
    finally:
        profiling.disable_spans()
    assert root.attrs["counters"]["draw.ahead"] == chunks - 1
    assert "draw.ahead_dropped" not in root.attrs["counters"]


def test_several_groups_with_a_samplefile_equal_sums_without(tmp_path):
    """The problem's dispatch of several groups with redraws and top-up
    rounds: with a samplefile each call is collected on its own, without
    one the calls run as one sequence; the sums are bit-equal."""
    out = []
    for f in (None, str(tmp_path / "s.npz")):
        p = _problem(FlakyGroup, M=4, max_resample=1, device_batch_size=8,
                     samplefile=f, seed=6)
        p._COLLECT_CHUNK = 16
        out.append(p._sample_groups([(0, 1), (2,), (1, 2, 3)], [30, 17, 41]))
    for a, b in zip(*out):
        for x, y in zip(a, b):
            assert np.array_equal(np.asarray(x), np.asarray(y))
        assert a[-1] == 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh_worker(rank, port, out):
    """One rank of the two-rank case: the sequence under a sample mesh;
    saves the evaluations and this rank's sums."""
    from bluest_tpu_torch.parallel import initialize_distributed, sample_mesh
    initialize_distributed(device="cpu",
                           init_method="tcp://127.0.0.1:%s" % port,
                           world_size=2, rank=rank,
                           timeout=datetime.timedelta(seconds=60))
    try:
        toy = Patchy(SEQ_FAILING)
        sums = _seq_sums(_seq_engine(toy, sample_mesh()))
        torch.save({"evaluated": toy.evaluated,
                    "sums": [None if s is None else list(s) for s in sums]},
                   "%s.p%d.pt" % (out, rank))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.distributed
def test_two_ranks_evaluate_the_rows_of_their_last_draw(tmp_path):
    """Under a two-rank CPU mesh each rank runs its chunks of the three
    calls as one sequence: each evaluation's rows come from the stream of
    the ``sample_group`` call just before it, the ranks' first draws
    cover every chunk once, and their sums add up to one process's."""
    out = str(tmp_path / "got")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + env.get("PYTHONPATH", "").split(os.pathsep))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(r), port, out], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    got = [torch.load("%s.p%d.pt" % (out, r)) for r in range(2)]
    firsts = []
    for g in got:
        _rows_from_their_streams(g["evaluated"])
        seen = set()
        for _ls, _x, _o, stream in g["evaluated"]:
            if stream not in seen:
                seen.add(stream)
                firsts.append(stream)
    assert sorted(firsts) == sorted(
        generator_seed(SEQ_SEED, counter, c) for _ls, counter, N in SEQ_CALLS
        for c in range(math.ceil(N / SEQ_BATCH)))
    one = _seq_sums(_seq_engine(Patchy(SEQ_FAILING)))
    for j, want in enumerate(one):
        parts = [g["sums"][j] for g in got if g["sums"][j] is not None]
        for i, w in enumerate(want):
            total = sum(p[i] for p in parts)
            if i == len(want) - 1:
                assert int(total) == int(w) == 0
            else:
                assert torch.allclose(total, w, rtol=1e-12, atol=1e-12)


if __name__ == "__main__":
    _mesh_worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
