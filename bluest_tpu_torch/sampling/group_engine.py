"""The port's sampling engine: the one loop over a call's chunks.

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
``fold_in`` resample, ``jax_engine.py:42-62``).  A chunk's count of
finite rows reaches the host through one read: on a card the count is
copied asynchronously into a pinned slot of the engine behind a CUDA
event, and the host waits on that event alone.  Only a chunk whose count
falls short reads which rows failed; each redraw round draws, evaluates
the whole group once (for Hodgkin-Huxley on the card, one kernel launch)
and reads which of its rows are finite: a fixed cost per round, whatever
its row count.  So a round draws enough
candidates that its finite ones are expected to cover the failing rows
-- the deficit over the finite share seen so far in the chunk, with a
margin -- and hands them, in draw order, to the failing rows in row
order; the accepted draws are finite
draws of the group's stream, as the JAX loop's are.  Rows still failing
after the last round are masked out of the sums and counted in
``n_failed``.  The f64 sums come from ``engine.combine`` (on a card K6,
one launch a chunk).

A factored model (one shared input, one call a model) is a group model
whose draw ignores ``ls`` and whose evaluation stacks the per-model calls
(:func:`factored_hooks`), with no redraw: :class:`SamplingEngine`.  With
``max_resample == 0`` no chunk reads the card: non-finite rows are masked
and counted, and the problem's fetch rounds top them up.

The calls of one dispatch run as one sequence of chunks, drawn one chunk
ahead: chunk c + 1's inputs are drawn before the host waits for chunk
c's count, so the card has c + 1's draw and then its evaluation queued
while the host folds chunk c and draws c + 2.  The model sees the
evaluations of a loop that takes one chunk at a time (``draw``): chunk
c's, its redraws, then chunk c + 1's, and each evaluation comes after
the ``sample_group`` call that drew its rows, with no draw between them.
So a draw made ahead of a chunk whose predecessor needs redraws is
dropped and drawn again from its generator seeded afresh: the same
numbers.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

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


def _rows(inputs) -> int:
    return (inputs[0] if isinstance(inputs, (tuple, list))
            else inputs).shape[0]


class _Chunk(NamedTuple):
    call: int       # its call's index in the sequence
    ls: tuple
    counter: int
    index: int      # its chunk index in the call's streams
    base: int       # its first row in the call
    n: int
    N: int          # the call's rows


def factored_hooks(sample_inputs: Callable, evaluate_model: Callable):
    """(sample_group, evaluate_group) of a factored model:
    ``sample_inputs(generator, n)`` draws n inputs that every model of a
    group shares and ``evaluate_model(l, inputs)`` returns model ``l``'s
    outputs, (n, No) or (n, No, d).  The evaluation is the model-major
    stack viewed row-major, so the combiner's ``movedim`` gives K6 the
    stack as it lies in memory."""
    def sample_group(gen, ls, n):
        return sample_inputs(gen, n)

    def evaluate_group(ls, inputs):
        return torch.stack([evaluate_model(l, inputs)
                            for l in ls]).movedim(0, 2)
    return sample_group, evaluate_group


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
        # chunk k of a sequence draws from generator k % 2, so the draw
        # ahead of chunk k + 1 leaves chunk k's stream where its redraws
        # go on from
        self._gens = tuple(torch.Generator(device=self.device)
                           for _ in range(2))
        self._slot = None       # on a card: (pinned count, its event)

    def redraw_rows(self, n_bad: int, drawn: int, accepted: int) -> int:
        """Candidates to draw for ``n_bad`` failing rows when ``accepted``
        of the chunk's ``drawn`` rows so far were finite: 1.25 n_bad over
        the finite share (floored at 1/64), at least n_bad and at most
        max(n_bad, 4 batch_size)."""
        share = max(accepted / max(drawn, 1), 1.0 / 64)
        m = math.ceil(1.25 * n_bad / share)
        return min(max(m, n_bad), max(n_bad, 4 * self.batch))

    # the per-chunk primitives: draw() and the sequence are made of them

    def seed(self, gen: torch.Generator, seed: int, counter: int,
             chunk: int) -> torch.Generator:
        """``gen`` seeded with the stream of chunk ``chunk`` of call
        ``counter``."""
        with prof.span("sample.seed"):
            gen.manual_seed(generator_seed(seed, counter, chunk))
        return gen

    def draw_inputs(self, gen: torch.Generator, ls, n: int):
        """n fresh coupled inputs of group ``ls``."""
        with prof.span("sample.inputs", rows=n):
            return self.sample_group(gen, ls, n)

    def evaluate(self, ls, inputs) -> torch.Tensor:
        with prof.span("model.evaluate", models=len(ls), rows=_rows(inputs)):
            return self.evaluate_group(ls, inputs)

    def count(self, outs: torch.Tensor):
        """(ok, count): the (n,) mask of the finite rows of ``outs`` and
        their number, on a card also copied, without waiting, into the
        engine's pinned slot behind an event.  One count is in flight at
        a time: :meth:`read_count` it before the next.  The copy and the
        event go on the count's card, whichever card is current."""
        ok = finite_rows(outs)
        count = ok.sum()
        if count.is_cuda:
            with torch.cuda.device(count.device):
                if self._slot is None:
                    self._slot = (torch.empty((), dtype=torch.int64,
                                              pin_memory=True),
                                  torch.cuda.Event())
                held, event = self._slot
                held.copy_(count, non_blocking=True)
                event.record()
        return ok, count

    def read_count(self, count: torch.Tensor) -> int:
        """The host value of a :meth:`count`: on a card a wait on its
        event, which does not drain the stream."""
        with prof.host_sync("draw.count"):
            if not count.is_cuda:
                return int(count)
            held, event = self._slot
            event.synchronize()
            return int(held)

    def redraw(self, gen: torch.Generator, ls, inputs, outs, ok,
               accepted: int):
        """(inputs, outs, ok) of a chunk whose first draw gave ``accepted``
        finite rows: each round draws ``redraw_rows`` candidates and gives
        its finite ones, in order, to the rows still failing.  Reads which
        rows failed once, and which candidates are finite each round."""
        n = outs.shape[0]
        drawn = n
        if accepted < n and self.max_resample:
            with prof.host_sync("draw.bad"):
                bad = torch.nonzero(~ok).flatten()
            for _ in range(self.max_resample):
                m = self.redraw_rows(bad.numel(), drawn, accepted)
                with prof.span("sample.redraw", failing=bad.numel(), rows=m):
                    new_in = self.draw_inputs(gen, ls, m)
                    new_out = self.evaluate(ls, new_in)
                    with prof.host_sync("draw.good"):
                        good = torch.nonzero(finite_rows(new_out)).flatten()
                    drawn, accepted = drawn + m, accepted + good.numel()
                    with prof.span("sample.splice"):
                        good = good[:bad.numel()]
                        take, bad = bad[:good.numel()], bad[good.numel():]
                        outs = outs.index_copy(0, take, new_out[good])
                        inputs = _put_rows(inputs, take,
                                           _take_rows(new_in, good))
                        ok = ok.index_fill(0, take, True)
                if bad.numel() == 0:
                    break
        prof.count("rows.drawn", drawn)
        return inputs, outs, ok

    def draw(self, gen: torch.Generator, ls, n: int):
        """n coupled samples of group ``ls``, one step after another:
        (inputs, outputs (n, No, L[, d]), ok (n,)), non-finite rows
        redrawn (:meth:`redraw`)."""
        inputs = self.draw_inputs(gen, ls, n)
        outs = self.evaluate(ls, inputs)
        ok, count = self.count(outs)
        return self.redraw(gen, ls, inputs, outs, ok, self.read_count(count))

    def _run(self, seed: int, calls, accs, keep: bool = False):
        """Every chunk of ``calls`` [(ls, counter, N, first_chunk)] that
        this rank holds, as one sequence drawn one chunk ahead (the
        module's docstring); the redraws are local to the rank (no
        collective inside).  Under a mesh the chunks of all the calls, in
        order, are dealt as one list (``rank_chunks`` of its length), so
        every rank holds as many chunks of the dispatch as any other, or
        one fewer.  Returns each call's running sums, ``accs`` (the sums
        each call starts from, or None) plus its chunks, and with
        ``keep`` each call's chunks' (inputs, outputs, ok)."""
        todo = []
        for j, (ls, counter, N, first_chunk) in enumerate(calls):
            for c in range(math.ceil(N / self.batch)):
                base = c * self.batch
                todo.append(_Chunk(j, ls, counter, first_chunk + c, base,
                                   min(self.batch, N - base), N))
        if self.mesh is not None:
            todo = [todo[k] for k in rank_chunks(len(todo), self.mesh)]
            prof.count("mesh.chunks", len(todo))
        # the rows of this rank's chunks; the fetch takes off those that
        # stay non-finite
        prof.count("rows.kept", sum(ch.n for ch in todo))
        accs = [own_sums(a) for a in accs]
        kept = [[] for _ in calls]
        gens = self._gens
        redraws = self.max_resample > 0

        def draw_ahead(k):
            """Chunk k's first draw, before chunk k - 1's count is read."""
            if k >= len(todo):
                return None
            prof.count("draw.ahead")
            return first_draw(k)

        def first_draw(k):
            ch = todo[k]
            gen = self.seed(gens[k % 2], seed, ch.counter, ch.index)
            return self.draw_inputs(gen, ch.ls, ch.n)

        def check(outs):
            """A chunk's first evaluation's (ok, count) on its way to the
            host; nothing without redraws, where the combiner masks the
            non-finite rows and no chunk reads the card."""
            return self.count(outs) if redraws else (None, None)

        k = 0
        for j, (ls, counter, N, first_chunk) in enumerate(calls):
            with prof.span("sample.group", models=ls, N=N, counter=counter,
                           first_chunk=first_chunk):
                while k < len(todo) and todo[k].call == j:
                    ch = todo[k]
                    with prof.span("sample.chunk", chunk=ch.index, rows=ch.n):
                        if k == 0:
                            inputs = first_draw(0)
                            outs = self.evaluate(ch.ls, inputs)
                            ok, count = check(outs)
                            ahead = draw_ahead(1)
                        if redraws:
                            accepted = self.read_count(count)
                            inputs, outs, ok = self.redraw(
                                gens[k % 2], ch.ls, inputs, outs, ok,
                                accepted)
                            if ahead is not None and accepted < ch.n:
                                # the redraws came after the draw ahead
                                prof.count("draw.ahead_dropped")
                                ahead = first_draw(k + 1)
                        else:
                            prof.count("rows.drawn", ch.n)
                        if ahead is not None:
                            outs_next = self.evaluate(todo[k + 1].ls, ahead)
                        # combine masks non-finite rows itself; the rows
                        # are model-major
                        with prof.span("sample.combine", rows=ch.n):
                            accs[j] = fold(combine, accs[j],
                                           outs.movedim(2, 0), ch.base, ch.N)
                        if keep:
                            kept[j].append((inputs, outs, finite_rows(outs)
                                            if ok is None else ok))
                        if ahead is not None:
                            inputs, outs = ahead, outs_next
                            ok, count = check(outs)
                            ahead = draw_ahead(k + 2)
                    k += 1
        return accs, kept

    def sample_calls(self, seed: int, calls) -> List[Optional[SampleSums]]:
        """MLBLUE sums of each call ``(ls, counter, N, first_chunk)`` of a
        dispatch: N coupled samples of group ``ls`` from the streams
        ``(seed, counter, first_chunk + c)``, every call's chunks in one
        sequence.  Returns device tensors, one a call: this rank's
        partial sums under a mesh, ``None`` where it holds no chunk."""
        calls = [(tuple(int(l) for l in ls), counter, int(N), first_chunk)
                 for ls, counter, N, first_chunk in calls]
        accs = [zero_sums(self.No, len(ls), self.device) if N <= 0 else None
                for ls, _counter, N, _first in calls]
        return self._run(seed, calls, accs)[0]

    def sample_sums(self, ls: Sequence[int], seed: int, counter: int, N: int,
                    first_chunk: int = 0) -> Optional[SampleSums]:
        """MLBLUE sums of group ``ls`` over N coupled samples of the
        streams ``(seed, counter, first_chunk + c)``: :meth:`sample_calls`
        of one call."""
        return self.sample_calls(seed, [(ls, counter, N, first_chunk)])[0]

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
        (acc,), (rows,) = self._run(seed, [(ls, counter, int(N),
                                            first_chunk)], [acc], keep=True)
        if not rows:
            return acc, None, None, None
        inputs, vals, valid = zip(*rows)
        return (acc, torch.cat(vals), torch.cat([flat_inputs(x)
                                                 for x in inputs]),
                torch.cat(valid))



class SamplingEngine(GroupEngine):
    """Coupled sampling of groups of a factored model on one device: the
    group loop over :func:`factored_hooks` with no redraw.

    ``sample_inputs(generator, n)`` draws n shared inputs (a tensor, or a
    tuple or list of tensors, with leading dimension n) and
    ``evaluate_model(l, inputs)`` returns model ``l``'s outputs, shape
    (n, No) or (n, No, d).  ``collect``'s ``vals`` are (N, No, k[, d])."""

    def __init__(self, sample_inputs: Callable, evaluate_model: Callable,
                 No: int, batch_size: int, device, mesh=None):
        super().__init__(*factored_hooks(sample_inputs, evaluate_model), No,
                         batch_size, device, max_resample=0, mesh=mesh)
