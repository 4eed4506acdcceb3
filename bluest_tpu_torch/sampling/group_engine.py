"""Coupled-group sampling engine: models that are sampled group by group.

Port of ``bluest_tpu/sampling/jax_engine.py`` (``build_group_engine``
and ``build_group_collect_engine``) for models that do not factor into
one shared input and per-model evaluations.  The user gives two batched
torch overloads:

  * ``sample_group(generator, ls, n)``: n coupled inputs for the models
    ``ls`` -- a tensor, or a tuple of tensors, with leading dimension n,
    on the problem's device;
  * ``evaluate_group(ls, inputs)``: the outputs, ``(n, No, len(ls))``, or
    ``(n, No, len(ls), d)`` for vector outputs (the dot product is then
    the inner product, reference blue_fn.py:159-167).

For a group and N samples each chunk of up to ``batch_size`` rows draws
and evaluates once, then redraws only the rows whose outputs are not
finite, up to ``max_resample`` rounds, from the chunk's own stream
(``generator_seed(seed, counter, chunk_index)``, so that what a chunk
holds depends on no chunk before it and a rank of a mesh can take any
block of chunks): the
finite rows keep their inputs and outputs (the JAX engine's per-sample
``fold_in`` resample, ``jax_engine.py:42-62``).  Each round draws,
evaluates the whole group once (for Hodgkin-Huxley on the card, one
kernel launch) and reads its count of finite rows back to the host: a
fixed cost per round, whatever its row count.  So a round draws enough
candidates that its finite ones are expected to cover the failing rows
-- the deficit over the finite share seen so far in the chunk, with a
margin -- and hands them, in draw order, to the failing rows in row
order; the accepted draws are finite
draws of the group's stream, as the JAX loop's are.  Rows still failing
after the last round are masked out of the sums and counted in
``n_failed``.  The f64 sums come from the same combiner as the factored
engine's (``engine.combine``: on a card K6, one launch a chunk).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import profiling as prof
from .engine import (SampleSums, check_device, combine, finite_rows,
                     flat_inputs, fold, generator_seed, own_sums,
                     rank_chunks, zero_sums)


def _take_rows(inputs, idx):
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(x[idx] for x in inputs)
    return inputs[idx]


def _put_rows(inputs, idx, new):
    """Out of place: ``inputs`` with rows ``idx`` replaced by ``new``."""
    if isinstance(inputs, (tuple, list)):
        return type(inputs)(x.index_copy(0, idx, y)
                            for x, y in zip(inputs, new))
    return inputs.index_copy(0, idx, new)


class GroupEngine:
    """Coupled sampling of groups of a coupled-group model on one device."""

    def __init__(self, sample_group: Callable, evaluate_group: Callable,
                 No: int, batch_size: int, device, max_resample: int = 64,
                 mesh=None):
        if int(batch_size) < 1:
            raise ValueError("batch_size must be >= 1, got %s" % batch_size)
        self.sample_group = sample_group
        self.evaluate_group = evaluate_group
        self.No = int(No)
        self.batch = int(batch_size)
        self.device = check_device(device)
        self.max_resample = max(int(max_resample), 0)
        self.mesh = mesh

    def redraw_rows(self, n_bad: int, drawn: int, accepted: int) -> int:
        """Candidates to draw for ``n_bad`` failing rows when ``accepted``
        of the chunk's ``drawn`` rows so far were finite: 1.25 n_bad over
        the finite share (floored at 1/64), at least n_bad and at most
        max(n_bad, 4 batch_size)."""
        share = max(accepted / max(drawn, 1), 1.0 / 64)
        m = math.ceil(1.25 * n_bad / share)
        return min(max(m, n_bad), max(n_bad, 4 * self.batch))

    def draw(self, gen: torch.Generator, ls, n: int):
        """n coupled samples of group ``ls``: (inputs, outputs (n, No, L[,
        d]), ok (n,)).  Non-finite rows are redrawn: each round draws
        ``redraw_rows`` candidates and gives its finite ones, in order, to
        the rows still failing."""
        inputs, outs = self._evaluate(gen, ls, n)
        ok = finite_rows(outs)
        with prof.host_sync("draw.count") if prof.recording else prof.OFF:
            accepted = int(ok.sum())
        drawn = n
        for _ in range(self.max_resample):
            with prof.host_sync("draw.bad") if prof.recording else prof.OFF:
                bad = torch.nonzero(~ok).flatten()
            if bad.numel() == 0:
                break
            m = self.redraw_rows(bad.numel(), drawn, accepted)
            with (prof.span("sample.redraw", failing=bad.numel(), rows=m)
                  if prof.recording else prof.OFF):
                new_in, new_out = self._evaluate(gen, ls, m)
                with (prof.host_sync("draw.good") if prof.recording
                      else prof.OFF):
                    good = torch.nonzero(finite_rows(new_out)).flatten()
                drawn, accepted = drawn + m, accepted + good.numel()
                with (prof.span("sample.splice") if prof.recording
                      else prof.OFF):
                    good = good[:bad.numel()]
                    take = bad[:good.numel()]
                    outs = outs.index_copy(0, take, new_out[good])
                    inputs = _put_rows(inputs, take,
                                       _take_rows(new_in, good))
                    ok = ok.index_fill(0, take, True)
        if prof.recording:
            prof.count("rows.drawn", drawn)
        return inputs, outs, ok

    def _evaluate(self, gen: torch.Generator, ls, n: int):
        """(inputs, outputs) of n fresh draws of group ``ls``."""
        with (prof.span("sample.inputs", rows=n) if prof.recording
              else prof.OFF):
            inputs = self.sample_group(gen, ls, n)
        with (prof.span("model.evaluate", models=len(ls), rows=n)
              if prof.recording else prof.OFF):
            outs = self.evaluate_group(ls, inputs)
        return inputs, outs

    def _chunks(self, ls, seed: int, counter: int, N: int, first_chunk: int,
                acc: Optional[SampleSums]):
        """This rank's chunks of the call: chunk c draws, and redraws, from
        the stream ``(seed, counter, first_chunk + c)``; the resample
        rounds are local to the rank (no collective inside).  Yields each
        chunk's inputs, outputs and finite mask and the call's running
        sums after it, ``acc`` plus the chunks so far (``acc`` itself is
        left as it is)."""
        with prof.span("sample.seed") if prof.recording else prof.OFF:
            gen = torch.Generator(device=self.device)
        acc = own_sums(acc)
        for c in rank_chunks(math.ceil(N / self.batch), self.mesh):
            base = c * self.batch
            n_c = min(self.batch, N - base)
            with (prof.span("sample.chunk", chunk=first_chunk + c, rows=n_c)
                  if prof.recording else prof.OFF):
                with (prof.span("sample.seed") if prof.recording
                      else prof.OFF):
                    gen.manual_seed(generator_seed(seed, counter,
                                                   first_chunk + c))
                inputs, outs, ok = self.draw(gen, ls, n_c)
                # combine masks non-finite rows itself; the rows are
                # model-major
                with (prof.span("sample.combine", rows=n_c)
                      if prof.recording else prof.OFF):
                    acc = fold(combine, acc, outs.movedim(2, 0), base, N)
            yield inputs, outs, ok, acc

    def sample_sums(self, ls: Sequence[int], seed: int, counter: int, N: int,
                    first_chunk: int = 0) -> Optional[SampleSums]:
        """MLBLUE sums of group ``ls`` over N coupled samples of the
        streams ``(seed, counter, first_chunk + c)``.  Returns device
        tensors: this rank's partial sums under a mesh, ``None`` where it
        holds no chunk."""
        ls = tuple(int(l) for l in ls)
        N = int(N)
        acc = zero_sums(self.No, len(ls), self.device) if N <= 0 else None
        for _inputs, _outs, _ok, acc in self._chunks(ls, seed, counter, N,
                                                     first_chunk, acc):
            pass
        return acc

    def collect(self, ls: Sequence[int], seed: int, counter: int, N: int,
                first_chunk: int = 0, acc: Optional[SampleSums] = None
                ) -> Tuple[Optional[SampleSums], Optional[torch.Tensor],
                           Optional[torch.Tensor], Optional[torch.Tensor]]:
        """``sample_sums`` that also returns every row's outputs
        ``vals`` (N, No, L[, d]), flattened inputs (N, q) -- the accepted
        draw's -- and the (N,) mask of the finite rows the sums cover, all
        on the device (``build_group_collect_engine``).  Under a mesh
        these are this rank's rows, ``None`` where it holds no chunk.
        The chunks' sums are folded onto ``acc`` (the running sums of the
        earlier pieces of one call), in chunk order."""
        ls = tuple(int(l) for l in ls)
        N = int(N)
        vals, inputs, valid = [], [], []
        for inp, outs, ok, acc in self._chunks(ls, seed, counter, N,
                                               first_chunk, acc):
            vals.append(outs)
            inputs.append(flat_inputs(inp))
            valid.append(ok)
        if not vals:
            return acc, None, None, None
        return acc, torch.cat(vals), torch.cat(inputs), torch.cat(valid)
