"""K6 (``bluest_tpu_torch/ops/combine.py``, ``csrc/combine.cu``), the
sampling combiner, on the CPU.

The kernel runs only on a card (``tests/test_torch_cuda.py`` holds it
against ``combine_plain`` and against the mirror below there).  Here a
mirror of its algorithm in plain PyTorch -- the plan's tiles, (slot, lane)
threads and blocks, each thread's running sums over its rows in order,
the warp butterflies, the groups in order, the blocks' partials added by
lanes striding the blocks and a butterfly, the mirrored triangles and the
running sums it adds into -- is held against ``combine_plain`` and the JAX package's
combiner (``KernelEngineV2._get_combiners``) at 1e-12 relative, with
``n_failed`` exact, on outputs with NaN, inf and past-N rows and calls
with N <= base.  Then the plan's variant by shape, the C entry points and
constants of the source, and ``combine`` on CPU tensors, which is
``combine_plain`` bit for bit and never touches the library.
"""

import os
import re

import numpy as np
import pytest
import torch

from bluest_tpu_torch import profiling
from bluest_tpu_torch.ops import combine as k6
from bluest_tpu_torch.sampling import engine
from bluest_tpu_torch.sampling.engine import (SampleSums, add_sums, combine,
                                              combine_plain)

torch.set_num_threads(1)

F64 = torch.float64

# test_torch_sampling.py's (k, No, d), then the cell's groups: the Euler
# model alone and the K=3 groups of five outputs, and a 12-model group
SAMPLING_CASES = [(1, 1, 1), (3, 3, 1), (4, 2, 1), (2, 1, 3)]
CELL_CASES = [(1, 5, 1), (3, 5, 1), (12, 5, 1)]


def _entries(k, No, d):
    """(op, n, i, j, c) of each entry, in the kernel's order (decode)."""
    out = []
    for n in range(No):
        out += [(0, n, i, 0, c) for i in range(k) for c in range(d)]
        out += [(1, n, i, j, 0) for i in range(k) for j in range(i, k)]
        out += [(2, n, i, j, c) for i in range(k) for j in range(i + 1, k)
                for c in range(d)]
        out += [(3, n, i, j, 0) for i in range(k) for j in range(i + 1, k)]
    return out


def _terms(V, ents, k, d):
    """(rows, E) per-row terms, each operation rounded on its own as the
    kernel's term() rounds it."""
    cols = []
    for op, n, i, j, c in ents:
        x, y = (n * k + i) * d + c, (n * k + j) * d + c
        if op == 0:
            cols.append(V[:, x])
        elif op == 2:
            cols.append(V[:, x] - V[:, y])
        elif op == 1:
            s = V[:, x] * V[:, y]
            for cc in range(1, d):
                s = s + V[:, x + cc] * V[:, y + cc]
            cols.append(s)
        else:
            z = V[:, x] - V[:, y]
            s = z * z
            for cc in range(1, d):
                z = V[:, x + cc] - V[:, y + cc]
                s = s + z * z
            cols.append(s)
    return torch.stack(cols, dim=1)


def _butterfly(v, offsets):
    """v (..., lanes) after xor shuffles at ``offsets``, each lane adding
    its partner's value to its own."""
    idx = torch.arange(v.shape[-1])
    for off in offsets:
        v = v + v[..., idx ^ off]
    return v


def k6_mirror(outs, base, N, into=None):
    """Mirror of K6: the sums of ``combine`` from the kernel's plan and
    order of summation, added at the end to ``into`` (running sums, a
    SampleSums or None; left as they are).  Returns a SampleSums."""
    if outs.dim() == 3:
        outs = outs[..., None]
    k, rows, No, d = outs.shape
    pl = k6.plan(k, rows, No, d)
    V = outs.permute(1, 2, 0, 3).to(F64).reshape(rows, pl.width)
    valid = base + torch.arange(rows) < N
    fin = torch.isfinite(V).all(dim=1)
    ok = valid & fin
    ents = _entries(k, No, d)
    T = _terms(V, ents, k, d)
    S, ne, R, B = pl.slots, k6.NE, pl.rows, pl.blocks
    lanes = k6.THREADS // S
    # each (block, lane)'s rows, in the order the thread adds them
    seqs = [[[t * R + r for t in range(b, -(-rows // R), B)
              for r in range(l, min(R, rows - t * R), lanes)]
             for l in range(lanes)] for b in range(B)]
    steps = max(len(s) for b in seqs for s in b)
    order = torch.full((B, lanes, max(steps, 1)), -1, dtype=torch.long)
    for b in range(B):
        for l in range(lanes):
            order[b, l, :len(seqs[b][l])] = torch.tensor(seqs[b][l],
                                                         dtype=torch.long)
    part = torch.zeros(B, pl.entries, dtype=F64)
    for p in range(pl.passes):
        e0 = p * S * ne
        Ep = min(S * ne, pl.entries - e0)
        x = torch.arange(S)[:, None] + S * torch.arange(ne)[None, :]
        live = x < Ep                                   # (S, ne)
        cols = torch.where(live, e0 + x, 0)
        acc = torch.zeros(B, lanes, S, ne, dtype=F64)
        for m in range(steps):
            r = order[:, :, m]                          # (B, lanes)
            take = (r >= 0) & ok[r.clamp(min=0)]
            t = T[r.clamp(min=0)][:, :, cols]           # (B, lanes, S, ne)
            add = take[:, :, None, None] & live
            acc = torch.where(add, acc + t, acc)
        # threads tid = s lanes + l; a slot's lanes inside a warp, then
        # its groups of LW lanes in order
        acc = acc.transpose(1, 2).reshape(B, k6.THREADS, ne).transpose(1, 2)
        LW = min(lanes, 32)
        acc = _butterfly(acc, [o for o in (16, 8, 4, 2, 1) if o < LW])
        acc = acc.reshape(B, ne, S, lanes // LW, LW)[..., 0]  # holders
        v = acc[..., 0]
        for g in range(1, lanes // LW):
            v = v + acc[..., g]
        v = v.transpose(1, 2)                           # (B, S, ne)
        part[:, cols[live]] = v[:, live]
    # the last block: lanes striding the blocks in order, then a butterfly
    lane_sum = torch.zeros(pl.entries, 32, dtype=F64)
    for b in range(B):
        lane_sum[:, b % 32] = lane_sum[:, b % 32] + part[b]
    total = _butterfly(lane_sum, (16, 8, 4, 2, 1))[:, 0]
    se = torch.zeros(No, k, d, dtype=F64)
    sc = torch.zeros(No, k, k, dtype=F64)
    d1 = torch.zeros(No, k, k, d, dtype=F64)
    d2 = torch.zeros(No, k, k, dtype=F64)
    for (op, n, i, j, c), v in zip(ents, total):
        if op == 0:
            se[n, i, c] = v
        elif op == 1:
            sc[n, i, j] = sc[n, j, i] = v
        elif op == 2:
            d1[n, i, j, c], d1[n, j, i, c] = v, -v
        else:
            d2[n, i, j] = d2[n, j, i] = v
    nf = (valid & ~fin).sum()
    sums = SampleSums(se, sc, d1, d2, nf)
    if into is None:
        return sums
    return SampleSums(*[a + b for a, b in zip(into, sums)])


def _outputs(k, rows, No, d, seed):
    """Model-major outputs (k, rows, No[, d]) with a failing model on row
    3, another on row 10, every model on row 40 and NaN in the last row's
    last value; correlated models around an offset, as a hierarchy's
    outputs are."""
    rng = np.random.default_rng(seed)
    shape = (rows, No) + ((d,) if d > 1 else ())
    common = 3.0 + rng.standard_normal(shape)
    outs = np.stack([common + 0.1 * (i + 1) * rng.standard_normal(shape)
                     for i in range(k)])
    outs[0, 3 % rows] = np.nan
    outs[k - 1, 10 % rows, 0] = np.inf
    if rows > 40:
        outs[:, 40] = -np.inf
    outs[k - 1, rows - 1, No - 1] = np.nan
    return torch.from_numpy(outs)


def _close(got, ref, rtol=1e-12):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= rtol * max(
        np.abs(ref).max(initial=0.0), 1e-300)


def _holds(got, ref):
    for g, r in zip(got[:4], ref[:4]):
        _close(g, r)
    assert int(got[4]) == int(ref[4])


@pytest.mark.parametrize("k,No,d", SAMPLING_CASES + CELL_CASES)
@pytest.mark.parametrize("rows,base,N", [(64, 0, 50), (64, 64, 100),
                                         (700, 0, 650), (700, 700, 700),
                                         (700, 1000, 200)])
def test_mirror_matches_plain_and_jax(k, No, d, rows, base, N):
    """The mirror against combine_plain and the JAX package's combiner:
    1e-12 relative, n_failed exact; N <= base adds nothing."""
    import jax.numpy as jnp
    from bluest_tpu.sampling.kernel_engine import KernelEngineV2
    outs = _outputs(k, rows, No, d, seed=100 * k + 10 * No + d + rows)
    got = k6_mirror(outs, base, N)
    _holds(got, combine_plain(outs, base, N))
    eng = KernelEngineV2(None, None, n_models=k, No=No, batch_size=rows)
    ref = eng._get_combiners(rows, rows)[0](
        tuple(jnp.asarray(o.numpy()) for o in outs), base, N)
    for g, r in zip(got[:4], ref[:4]):
        _close(g.numpy().reshape(np.shape(r)), r)
    assert int(got.n_failed) == int(ref[4])
    if N <= base:
        assert all(float(t.abs().sum()) == 0 for t in got[:4])
        assert int(got.n_failed) == 0


@pytest.mark.parametrize("k,No,d,rows", [(1, 5, 1, 70001), (2, 5, 1, 3001),
                                         (12, 10, 1, 300), (3, 2, 3, 999),
                                         (1, 8, 1, 513), (1, 9, 1, 513)])
def test_mirror_matches_plain_across_blocks_and_passes(k, No, d, rows):
    """Shapes past one block (264 blocks, several tiles a block), past one
    pass of the grid (12 models, 10 outputs: 2220 entries) and on either
    side of a slot count (16 and 18 entries: 2 and 4 slots); in float32
    too."""
    outs = _outputs(k, rows, No, d, seed=rows + k)
    pl = k6.plan(k, rows, No, d)
    assert pl.passes == (2 if (k, No) == (12, 10) else 1)
    _holds(k6_mirror(outs, 5, rows - 7), combine_plain(outs, 5, rows - 7))
    o32 = outs.float()
    _holds(k6_mirror(o32, 0, rows), combine_plain(o32, 0, rows))


def test_mirror_reads_any_layout_and_mirrors_exactly():
    """The group engine's blocks moved model-major (not contiguous) give
    the contiguous copy's sums bit for bit; sc and d2 are symmetric, d1
    antisymmetric, and the diagonals of d1 and d2 zero, exactly."""
    rows, No, k = 300, 5, 3
    block = _outputs(k, rows, No, 1, seed=7).permute(1, 2, 0).contiguous()
    moved = block.movedim(2, 0)                # (k, rows, No), strided
    assert not moved.is_contiguous()
    got = k6_mirror(moved, 0, rows)
    for a, b in zip(got, k6_mirror(moved.contiguous(), 0, rows)):
        assert torch.equal(a, b)
    assert torch.equal(got.sumsc, got.sumsc.mT)
    assert torch.equal(got.sumsd2, got.sumsd2.mT)
    assert torch.equal(got.sumsd1, -got.sumsd1.transpose(1, 2))
    assert float(torch.diagonal(got.sumsd2, dim1=1, dim2=2).abs().sum()) == 0
    assert float(torch.diagonal(got.sumsd1, dim1=1, dim2=2).abs().sum()) == 0


def test_mirror_adds_its_prior_as_add_sums_does():
    """Sums added into running sums: the running sums + the chunk's,
    entry for entry, which is add_sums of the two."""
    outs = _outputs(3, 500, 5, 1, seed=3)
    first = k6_mirror(outs[:, :250], 0, 500)
    second = k6_mirror(outs[:, 250:], 250, 500)
    both = k6_mirror(outs[:, 250:], 250, 500, into=first)
    for a, b in zip(both, add_sums(first, second)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,No,d,slots", [
    (1, 5, 1, 2), (1, 1, 1, 1), (1, 8, 1, 2), (1, 4, 3, 2), (2, 2, 1, 2),
    (1, 9, 1, 4), (2, 5, 1, 8), (3, 5, 1, 16), (12, 5, 1, 256),
    (2, 1, 3, 2), (4, 2, 1, 8), (1, 16, 1, 4)])
def test_plan_is_chosen_by_shape(k, No, d, slots):
    """The fewest slots of NE sums a thread that cover a row's No
    per_output(k, d) sums (at most a block's threads); the tile and the
    grid fit their limits, and nothing but the shape enters."""
    assert k6.per_output(1, 1) == 2 and k6.per_output(3, 1) == 15
    assert k6.per_output(12, 1) == 222
    for rows in (0, 1, 77, 262144):
        pl = k6.plan(k, rows, No, d)
        assert pl == k6.plan(k, rows, No, d)
        assert pl.slots == slots
        assert pl.entries == No * k6.per_output(k, d)
        assert pl.slots & (pl.slots - 1) == 0 and pl.slots <= k6.THREADS
        assert pl.slots * k6.NE * pl.passes >= pl.entries
        assert pl.slots == 1 or (pl.slots // 2) * k6.NE < pl.entries
        assert pl.pitch % 2 == 1 and pl.pitch >= pl.width
        assert 1 <= pl.rows <= k6.THREADS
        assert 8 * pl.rows * pl.pitch <= k6.TILE_BYTES
        assert 1 <= pl.blocks <= k6.MAX_BLOCKS
        assert pl.blocks == max(1, min(k6.MAX_BLOCKS, -(-rows // pl.rows)))
        assert pl.shared_bytes <= 48 * 1024
    with pytest.raises(ValueError):
        k6.plan(1, 10, 4096, 1)             # a row wider than the tile
    with pytest.raises(ValueError):
        k6.plan(0, 10, 5, 1)


def test_cell_chunks_plan():
    """The cell's Euler group (k = 1, five outputs) at 262,144 rows: two
    slots of 128 lanes, a tile of 256 rows, 264 blocks, one pass."""
    pl = k6.plan(1, 262144, 5, 1)
    assert (pl.slots, pl.rows, pl.blocks, pl.passes) == (2, 256, 264, 1)


def _source():
    path = os.path.join(os.path.dirname(k6.__file__), os.pardir, "csrc",
                        "combine.cu")
    with open(path) as f:
        return f.read()


def test_source_has_the_entry_points_and_the_wrappers_constants():
    text = _source()
    for name in ("bluest_combine_sums", "bluest_combine_max_blocks",
                 "bluest_combine_threads", "bluest_combine_ne"):
        assert 'extern "C" int %s(' % name in text
    define = lambda n: int(re.search(r"#define %s (\d+)" % n, text).group(1))
    assert define("K6_THREADS") == k6.THREADS
    assert define("K6_MAX_BLOCKS") == k6.MAX_BLOCKS
    assert define("K6_NE") == k6.NE
    assert define("K6_MAX_PITCH") == k6.MAX_PITCH
    # no floating-point atomics on the sums: the order is the shape's
    assert not re.search(r"atomicAdd\([^)]*(part|out|acc)", text)
    # the running sums are written, or added into in place: no third mode
    sig = re.search(r'extern "C" int bluest_combine_sums\(([^)]*)\)',
                    text).group(1)
    assert "void* const* sums, int accumulate" in " ".join(sig.split())


@pytest.mark.parametrize("k,No,d", SAMPLING_CASES + CELL_CASES)
def test_combine_on_cpu_is_combine_plain_bit_for_bit(k, No, d):
    outs = _outputs(k, 200, No, d, seed=k + No)
    ref = combine_plain(outs, 10, 180)
    for a, b in zip(combine(outs, 10, 180), ref):
        assert torch.equal(a, b)
    prior = combine_plain(outs[:, :50], 0, 180)
    want = add_sums(prior, ref)
    into = SampleSums(*[t.clone() for t in prior])
    got = combine(outs, 10, 180, into)
    assert all(a is b for a, b in zip(got, into))    # added in place
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_cpu_tensors_never_touch_the_library(monkeypatch):
    """The host's route runs the plain einsums: no build, no launch, and
    the wrapper refuses a CPU tensor outright."""
    def refuse(*a, **kw):
        raise AssertionError("the K6 library was asked for on the CPU")
    monkeypatch.setattr(k6, "build_library", refuse)
    before = k6.combine_sums.launches
    eng = engine.SamplingEngine(
        lambda gen, n: torch.randn((n, 2), generator=gen, dtype=F64),
        lambda l, x: x[:, :1] * (l + 1.0), No=1, batch_size=7, device="cpu")
    eng.sample_sums([0, 1], 0, 3, 30)
    combine(_outputs(2, 20, 1, 1, 0), 0, 20)
    assert k6.combine_sums.launches == before
    with pytest.raises(ValueError):
        k6.combine_sums(_outputs(2, 20, 1, 1, 0), 0, 20)


def test_engine_sums_fold_chunks_as_before():
    """A call's sums on the host are the chunks' combine_plain sums added
    in chunk order, bit for bit, and a caller's running sums handed to
    collect are left as they are."""
    def sample_inputs(gen, n):
        return torch.randn((n, 3), generator=gen, dtype=F64)

    def evaluate_model(l, x):
        return x[:, :2] * (l + 1.0) + x[:, 2:] ** (l + 1)

    eng = engine.SamplingEngine(sample_inputs, evaluate_model, No=2,
                                batch_size=7, device="cpu")
    N, ls = 30, [0, 2]
    got = eng.sample_sums(ls, 4, 1, N)
    want = None
    gen = torch.Generator()
    for c in range(5):
        gen.manual_seed(engine.generator_seed(4, 1, c))
        x = sample_inputs(gen, min(7, N - 7 * c))
        outs = torch.stack([evaluate_model(l, x) for l in ls])
        want = add_sums(want, combine_plain(outs, 7 * c, N))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    held = SampleSums(*[t.clone() for t in got])
    total, *_ = eng.collect(ls, 4, 2, N, acc=held)
    for a, b in zip(held, got):
        assert torch.equal(a, b)
    assert not torch.equal(total.sumse, got.sumse)


def test_request_counts_k6_launches():
    """``k6.launches`` on a request's root is the change of
    ``combine_sums.launches`` across it, beside ``k2.launches``."""
    profiling.enable_spans()
    try:
        with profiling.span("solve"):
            k6.combine_sums.launches += 3
        with profiling.span("solve"):
            pass
    finally:
        profiling.disable_spans()
        k6.combine_sums.launches -= 3
    roots = [s for s in profiling.spans() if s.parent is None]
    assert [s.attrs["counters"]["k6.launches"] for s in roots] == [3, 0]
    assert all(s.attrs["counters"]["k2.launches"] == 0 for s in roots)
