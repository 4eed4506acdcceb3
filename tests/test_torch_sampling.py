"""Sums level: the port's combiner against the JAX kernel engine's.

The same per-sample outputs -- with NaN/inf rows, rows past N, and N not
a multiple of the chunk -- go through ``KernelEngineV2``'s combiner and
the port's ``combine``.  se, sc, d1, d2 must agree to 1e-12 relative and
n_failed exactly.
"""

import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from bluest_tpu.sampling.kernel_engine import KernelEngineV2
from bluest_tpu_torch import profiling
from bluest_tpu_torch.sampling.engine import (SamplingEngine, add_sums,
                                              combine, combine_plain,
                                              finite_rows, generator_seed)
from bluest_tpu_torch.sampling.group_engine import (GroupEngine,
                                                    factored_hooks)

torch.set_num_threads(1)


def _outputs(k, rows, No, d, seed):
    rng = np.random.default_rng(seed)
    shape = (k, rows, No) + ((d,) if d > 1 else ())
    outs = rng.standard_normal(shape) * rng.uniform(0.5, 2.0, (k, 1, 1)
                                                    + ((1,) if d > 1 else ()))
    outs[0, 3] = np.nan                      # one model fails on row 3
    outs[k - 1, 10, 0] = np.inf              # another on row 10
    outs[:, 40] = -np.inf                    # every model on row 40
    return outs


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * max(np.abs(ref).max(), 1e-300)


@pytest.mark.parametrize("k,No,d", [(1, 1, 1), (3, 3, 1), (4, 2, 1),
                                    (2, 1, 3)])
@pytest.mark.parametrize("base,N", [(0, 50), (0, 64), (64, 100)])
def test_combiner_matches_jax(k, No, d, base, N):
    rows = 64
    outs = _outputs(k, rows, No, d, seed=k * 10 + No + base)
    eng = KernelEngineV2(None, None, n_models=k, No=No, batch_size=rows)
    ref = eng._get_combiners(rows, rows)[0](
        tuple(jnp.asarray(o) for o in outs), base, N)
    got = combine(torch.as_tensor(outs), base, N)
    for name, g, r in zip(("se", "sc", "d1", "d2"), got[:4], ref[:4]):
        _close(g.numpy().reshape(np.shape(r)), r)
    assert int(got.n_failed) == int(ref[4])


def test_engine_couples_models_and_masks():
    """Every model of a group sees the same draw: a model returning xi[0]
    gives identical per-model sums and zero MLMC differences; N that is
    not a chunk multiple is covered exactly once."""
    def sample_inputs(gen, n):
        return torch.randn((n, 4), generator=gen, dtype=torch.float64)

    def evaluate_model(l, xi):
        return xi[:, :1]

    eng = SamplingEngine(sample_inputs, evaluate_model, No=1, batch_size=7,
                         device="cpu")
    N = 30
    s = eng.sample_sums([0, 2, 5], 0, 5, N)
    se = s.sumse.numpy()[0, :, 0]
    assert np.all(se == se[0])
    assert np.all(s.sumsd2.numpy() == 0) and np.all(s.sumsd1.numpy() == 0)
    assert int(s.n_failed) == 0
    # the chunks' own streams, drawn one by one, give the same sums
    gen = torch.Generator()
    xs = torch.cat([sample_inputs(gen.manual_seed(generator_seed(0, 5, c)), n)
                    for c, n in enumerate((7, 7, 7, 7, 2))])[:, 0]
    np.testing.assert_allclose(se[0], float(xs.sum()), rtol=1e-13)
    np.testing.assert_allclose(s.sumsc.numpy()[0, 0, 1],
                               float((xs * xs).sum()), rtol=1e-13)
    # a fresh counter is a fresh stream; the same counter repeats
    assert generator_seed(0, 6) != generator_seed(0, 5)
    again = eng.sample_sums([0, 2, 5], 0, 5, N)
    assert torch.equal(again.sumse, s.sumse)
    z = eng.sample_sums([1, 2], 0, 5, 0)
    assert z.sumsc.shape == (1, 2, 2) and float(z.sumse.abs().sum()) == 0
    both = add_sums(s, s)
    assert torch.equal(both.sumse, 2 * s.sumse)


def _chunk_engine(batch=7):
    def sample_inputs(gen, n):
        return torch.randn((n, 2), generator=gen, dtype=torch.float64)

    def evaluate_model(l, xi):
        return xi[:, :1] * (l + 1.0)

    return SamplingEngine(sample_inputs, evaluate_model, No=1,
                          batch_size=batch, device="cpu"), sample_inputs


def test_chunk_streams_do_not_depend_on_the_chunks_before():
    """Chunk c of a call holds the same draws whatever precedes it: the
    sums of chunks [2, 5) taken alone (first_chunk=2) equal the call's
    sums less those of its first two chunks, and chunk 3 drawn by hand
    from its own seed is what the engine drew."""
    eng, sample_inputs = _chunk_engine()
    whole = eng.sample_sums([0, 1], 11, 4, 35)            # chunks 0..4
    head = eng.sample_sums([0, 1], 11, 4, 14)             # chunks 0, 1
    tail = eng.sample_sums([0, 1], 11, 4, 21, first_chunk=2)
    for w, h, t in zip(whole[:4], head[:4], tail[:4]):
        np.testing.assert_allclose((h + t).numpy(), w.numpy(), rtol=1e-13,
                                   atol=1e-13)
    only3 = eng.sample_sums([0], 11, 4, 7, first_chunk=3)
    gen = torch.Generator().manual_seed(generator_seed(11, 4, 3))
    x3 = sample_inputs(gen, 7)[:, 0]
    assert float(only3.sumse[0, 0, 0]) == float(x3.to(torch.float64).sum())


def test_chunk_seeds_are_distinct_and_reproducible():
    seeds = {generator_seed(s, c, k) for s in (0, 1) for c in range(4)
             for k in range(6)}
    assert len(seeds) == 2 * 4 * 6
    assert all(0 <= s < 2 ** 64 for s in seeds)
    assert generator_seed(3, 2, 1) == generator_seed(3, 2, 1)
    # chunk 0 is the call's own stream
    assert generator_seed(3, 2) == generator_seed(3, 2, 0)
    eng, _ = _chunk_engine()
    a = eng.sample_sums([0], 0, 1, 20)
    b = eng.sample_sums([0], 0, 2, 20)
    c = eng.sample_sums([0], 0, 1, 20, first_chunk=1)
    assert float(a.sumse[0, 0, 0]) != float(b.sumse[0, 0, 0])
    assert float(a.sumse[0, 0, 0]) != float(c.sumse[0, 0, 0])


def test_rank_chunks_partition_every_call():
    """Contiguous blocks of whole chunks: every chunk on exactly one
    rank, in rank order, for calls shorter than the rank count too."""
    from types import SimpleNamespace
    from bluest_tpu_torch.sampling.engine import rank_chunks
    assert list(rank_chunks(5)) == [0, 1, 2, 3, 4]
    for R in (1, 2, 3, 8):
        for n_chunks in (0, 1, 2, 5, 8, 17):
            got = [list(rank_chunks(n_chunks, SimpleNamespace(
                n_sample=R, sample_rank=r))) for r in range(R)]
            assert sum(got, []) == list(range(n_chunks))
            assert max(len(g) for g in got) == -(-n_chunks // R)


def _factored_draw(gen, n):
    return torch.randn((n, 3), generator=gen, dtype=torch.float64)


def _factored_model(l, x):
    """(n, 2) outputs; model 2 fails on the rows whose third input is
    above 1."""
    out = x[:, :2] * (l + 1.0) + x[:, 2:] ** 2
    bad = (x[:, 2:] > 1.0) & (l == 2)
    return torch.where(bad, torch.full_like(out, float("nan")), out)


@pytest.mark.parametrize("kind", ["SamplingEngine", "GroupEngine"])
@pytest.mark.parametrize("N,first", [(1, 0), (63, 3), (65, 0), (150, 3)])
def test_factored_hooks_run_the_one_loop_without_a_read(kind, N, first):
    """A factored model's engine, and the group engine with no redraw over
    the same hooks: one draw a chunk and one call a model a chunk, no
    read of a count (no ``host.sync`` span), every row counted drawn, and
    sums, ``collect``'s rows and mask bit-equal to a loop written out
    chunk by chunk (seed, draw, stack, ``combine_plain``, add)."""
    seen = {"draws": 0, "evals": 0}

    def draw(gen, n):
        seen["draws"] += 1
        return _factored_draw(gen, n)

    def model(l, x):
        seen["evals"] += 1
        return _factored_model(l, x)

    batch, ls, seed, counter = 64, (0, 2, 3), 7, 5
    if kind == "SamplingEngine":
        eng = SamplingEngine(draw, model, 2, batch, "cpu")
    else:
        eng = GroupEngine(*factored_hooks(draw, model), 2, batch, "cpu",
                          max_resample=0)
    chunks = math.ceil(N / batch)
    profiling.enable_spans()
    try:
        with profiling.span("request") as root:
            sums = eng.sample_sums(ls, seed, counter, N, first_chunk=first)
    finally:
        profiling.disable_spans()
    assert not [s for s in profiling.spans() if s.name == "host.sync"]
    assert root.attrs["counters"]["rows.drawn"] == N
    assert seen == {"draws": chunks, "evals": len(ls) * chunks}

    gen, want, vals, inputs = torch.Generator(), None, [], []
    for c in range(chunks):
        n = min(batch, N - c * batch)
        x = _factored_draw(gen.manual_seed(
            generator_seed(seed, counter, first + c)), n)
        outs = torch.stack([_factored_model(l, x) for l in ls])
        want = add_sums(want, combine_plain(outs, c * batch, N))
        vals.append(outs.movedim(0, 2))
        inputs.append(x)
    vals, inputs = torch.cat(vals), torch.cat(inputs)
    assert int(want.n_failed) > 0 or N == 1
    exact = dict(rtol=0, atol=0, equal_nan=True)
    total, got_vals, got_inputs, mask = eng.collect(ls, seed, counter, N,
                                                    first_chunk=first)
    first_call = eng.sample_calls(seed, [(ls, counter, N, first),
                                         ((1,), counter + 1, 40, 0)])[0]
    for got in (sums, total, first_call):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    torch.testing.assert_close(got_vals, vals, **exact)
    assert torch.equal(got_inputs, inputs)
    assert torch.equal(mask, finite_rows(vals))
