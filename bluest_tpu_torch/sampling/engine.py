"""What every sampling engine shares: the per-chunk streams, the deal of
chunks to ranks and the masked f64 combiner.

Port of ``bluest_tpu/sampling/kernel_engine.py`` (the per-model sweep and
its combiner) and of ``SampleSums`` (``jax_engine.py:34``).  For a group
``ls`` of models and N samples, each chunk of up to ``batch_size``
samples

  * draws the random inputs ONCE on the problem's device, from a
    ``torch.Generator`` seeded for this chunk alone
    (``generator_seed(seed, counter, chunk_index)``): what chunk c holds
    depends on no chunk before it, so any rank can start in the middle --
    the property ``fold_in(key, global_index)`` gives the JAX engines, at
    chunk granularity,
  * evaluates every model of the group on that same input tensor -- the
    coupling that ``fold_in(key, idx)`` gives the JAX engine -- and
  * folds the outputs into the MLBLUE sums in float64 on the device:
    sums of outputs, cross products and pairwise MLMC differences, with
    rows whose index is >= N or whose outputs are non-finite weighted 0
    (non-finite rows are counted in ``n_failed``): on a card one launch
    of K6 (``ops/combine.py``) a chunk, which adds the chunk's sums into
    the call's running sums; on the host ``combine_plain``'s einsums.

The loop over the chunks is ``group_engine.GroupEngine``'s;
``SamplingEngine`` (importable from here) is that loop over a factored
model's hooks, with no redraw.  The sums stay on the device; the caller
copies the sums of all its groups to the host in one piece.  Under a mesh
of R sample ranks (``parallel/mesh.py``) the chunks of every call of a
dispatch, in the dispatch's order, are dealt as one list: rank r takes a
contiguous block of it (:func:`rank_chunks`), within one chunk of every
other rank's share, and returns its partial sums of each call --
``None`` where it holds no chunk of the call; the caller adds the
ranks' sums with one ``all_reduce``.  ``collect`` (snapshot collection, the
counterpart of ``KernelEngineV2.sample_sums(collect=True,
on_chunk=...)``) also returns the rows of this rank's chunks -- outputs,
flattened inputs and the mask of the finite rows, which are exactly the
samples the sums cover -- on the device; the caller collects a call in
bounded pieces of whole chunks and under a mesh gathers each piece's
rows in rank order, which is chunk order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.combine import combine_sums

F64 = torch.float64


class SampleSums(NamedTuple):
    sumse: torch.Tensor       # (No, L, d)  sum of outputs (d = output dim)
    sumsc: torch.Tensor       # (No, L, L) sum of pairwise inner products
    sumsd1: torch.Tensor      # (No, L, L, d) sum of differences (i - j)
    sumsd2: torch.Tensor      # (No, L, L) sum of squared difference norms
    n_failed: torch.Tensor    # non-finite samples (int64 scalar)


def generator_seed(seed: int, counter: int, chunk_index: int = 0) -> int:
    """64-bit generator seed for chunk ``chunk_index`` of call ``counter``
    of a problem seeded with ``seed``: distinct counters and distinct
    chunks give independent, reproducible streams."""
    s = np.random.SeedSequence(
        [int(seed), int(counter), int(chunk_index)]).generate_state(
            2, dtype=np.uint32)
    return (int(s[0]) << 32) | int(s[1])


def rank_chunks(n_chunks: int, mesh=None) -> range:
    """The positions, of ``n_chunks`` chunks in order, that this rank
    evaluates: all of them without a mesh, else the contiguous block of
    sample rank r, ``floor(n_chunks / R)`` positions and one more for
    each of the first ``n_chunks mod R`` ranks (empty for a rank past
    the end), so that no two ranks differ by more than one chunk."""
    if mesh is None:
        return range(n_chunks)
    per, extra = divmod(n_chunks, mesh.n_sample)
    r = mesh.sample_rank
    lo = r * per + min(r, extra)
    return range(lo, lo + per + (r < extra))


def combine_plain(outs: torch.Tensor, base: int, N: int) -> SampleSums:
    """Masked f64 MLBLUE sums of one chunk, in plain PyTorch: the CPU's
    route and K6's reference.

    ``outs``: (k, rows, No) or (k, rows, No, d) -- model-major outputs of
    the chunk whose first row has global sample index ``base``.  The
    counterpart of ``KernelEngineV2._get_combiners``' ``core``."""
    if outs.dim() == 3:
        outs = outs[..., None]
    P = outs.permute(1, 2, 0, 3).to(F64)                  # (rows, No, k, d)
    rows = P.shape[0]
    idx = base + torch.arange(rows, device=P.device)
    finite = torch.isfinite(P)
    ok = finite.flatten(1).all(dim=1)
    valid = idx < N
    w = (valid & ok).to(F64)
    nf = (valid & ~ok).sum()
    P = torch.where(finite, P, torch.zeros((), dtype=F64, device=P.device))
    se = torch.einsum('bnld,b->nld', P, w)
    Pw = P * w[:, None, None, None]
    sc = torch.einsum('bnid,bnjd->nij', Pw, P)
    D = P[:, :, :, None, :] - P[:, :, None, :, :]
    d1 = torch.einsum('bnijd,b->nijd', D, w)
    d2 = torch.einsum('bnijd,bnijd->nij', D * w[:, None, None, None, None], D)
    return SampleSums(se, sc, d1, d2, nf)


def combine(outs: torch.Tensor, base: int, N: int,
            into: Optional[SampleSums] = None) -> SampleSums:
    """The masked f64 MLBLUE sums of one chunk (:func:`combine_plain`'s
    arguments): new tensors, or added in place into ``into`` (running
    sums of the same shapes that the caller owns), which is returned.  A
    CUDA tensor launches K6 (``ops.combine.combine_sums``): one kernel
    that reads each row once and writes or adds the chunk's sums.
    Anything else runs :func:`combine_plain`."""
    if outs.is_cuda:
        return SampleSums(*combine_sums(outs, base, N, into))
    part = combine_plain(outs, base, N)
    if into is None:
        return part
    for t, p in zip(into, part):
        t += p
    return into


def add_sums(a: Optional[SampleSums],
             b: Optional[SampleSums]) -> Optional[SampleSums]:
    """Elementwise sum; ``None`` (a rank that held no chunk) adds
    nothing."""
    if a is None or b is None:
        return b if a is None else a
    return SampleSums(*[x + y for x, y in zip(a, b)])


def own_sums(acc: Optional[SampleSums]) -> Optional[SampleSums]:
    """A contiguous copy of sums a caller hands to a call, which the call
    then adds its chunks into (the caller's own are left as they are)."""
    if acc is None:
        return None
    return SampleSums(*[t.clone(memory_format=torch.contiguous_format)
                        for t in acc])


def fold(combiner: Callable, acc: Optional[SampleSums], outs: torch.Tensor,
         base: int, N: int) -> SampleSums:
    """A call's running sums ``acc`` (None before its first chunk, else
    the call's own) after its chunk ``outs``.  On a card ``combiner``
    (the engine module's ``combine``) launches K6, which writes the first
    chunk's sums and adds each later chunk into them in place.  On the
    host the chunk's sums are a value of their own, ``combiner(outs,
    base, N)``, added to ``acc``: bit for bit the same as ``combine(outs,
    base, N, acc)``, and the seam where a test swaps the combiner of
    every chunk."""
    if outs.is_cuda:
        return combiner(outs, base, N, acc)
    return add_sums(acc, combiner(outs, base, N))


def zero_sums(No: int, k: int, device, d: int = 1) -> SampleSums:
    z = lambda *s: torch.zeros(s, dtype=F64, device=device)
    return SampleSums(z(No, k, d), z(No, k, k), z(No, k, k, d), z(No, k, k),
                      torch.zeros((), dtype=torch.int64, device=device))


def finite_rows(outs: torch.Tensor) -> torch.Tensor:
    """(n,) mask of the rows of ``outs`` (leading dimension n) that are
    finite in every entry."""
    return torch.isfinite(outs).flatten(1).all(dim=1)


def flat_inputs(inputs) -> torch.Tensor:
    """(n, q) snapshot form of a batch of inputs: a tensor, or a tuple or
    list of tensors, each with leading dimension n, flattened per row and
    concatenated (the JAX engines' per-sample ravel of the input tree)."""
    leaves = list(inputs) if isinstance(inputs, (tuple, list)) else [inputs]
    n = leaves[0].shape[0]
    return torch.cat([x.reshape(n, -1) for x in leaves], dim=1)


def check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "sampling device %s: no CUDA card is available; pass "
            "device=\"cpu\" to sample on the host CPU" % device)
    return device


def __getattr__(name):
    # SamplingEngine is the group engine's loop over a factored model's
    # hooks, defined beside that loop, whose module imports this one
    if name == "SamplingEngine":
        from .group_engine import SamplingEngine
        return SamplingEngine
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
