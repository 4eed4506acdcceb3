"""The samples that a problem's sampling call draws, worked out again.

The port documents its sampling contract (``sampling/engine.py``,
``sampling/group_engine.py``, ``problem.py``'s ``_sample_groups``):

  * chunk c of sampling call ``counter`` of a problem seeded ``seed``
    draws from a ``torch.Generator`` on the problem's device seeded with
    the two 32-bit words of ``numpy.random.SeedSequence([seed, counter,
    c])``, high word first, in chunks of ``batch`` rows;
  * a factored model evaluates each model of the group on the chunk's
    inputs, one model after another;
  * a coupled-group model evaluates the group once a draw and redraws the
    rows whose outputs are not finite, up to ``max_resample`` rounds a
    chunk, from the chunk's own stream: a round draws
    ``min(max(ceil(1.25 bad / share), bad), max(bad, 4 batch))``
    candidates (share: finite rows over rows drawn so far in the chunk,
    floored at 1/64) and gives its finite ones, in order, to the failing
    rows in order;
  * rows still failing are left out of the sums, and their number is
    drawn again from the next chunks of the same call, for up to 4
    rounds.

This is a frozen copy of that recipe, so that the reference draws the
inputs that the timed path drew without asking the program for them.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator_seed(seed: int, counter: int, chunk: int) -> int:
    s = np.random.SeedSequence([int(seed), int(counter), int(chunk)]
                               ).generate_state(2, dtype=np.uint32)
    return (int(s[0]) << 32) | int(s[1])


def finite(o):
    return torch.isfinite(o).flatten(1).all(dim=1)


def _redraw_rows(bad: int, drawn: int, accepted: int, batch: int) -> int:
    share = max(accepted / max(drawn, 1), 1.0 / 64)
    m = math.ceil(1.25 * bad / share)
    return min(max(m, bad), max(bad, 4 * batch))


class _Chunk:
    """One chunk's rows, filled by its redraw rounds: a round draws
    ``want`` candidates from the chunk's own stream and gives its finite
    ones, in order, to the failing rows in order."""

    def __init__(self, gen, o):
        self.gen, self.o, self.ok = gen, o, finite(o)
        self.drawn, self.accepted = o.shape[0], int(self.ok.sum())
        self.bad = None

    def want(self, batch: int) -> int:
        """Candidates to draw in the next round; 0 once every row is
        finite."""
        self.bad = torch.nonzero(~self.ok).flatten()
        if self.bad.numel() == 0:
            return 0
        return _redraw_rows(self.bad.numel(), self.drawn, self.accepted,
                            batch)

    def fill(self, no):
        good = torch.nonzero(finite(no)).flatten()
        self.drawn += no.shape[0]
        self.accepted += good.numel()
        good = good[:self.bad.numel()]
        take = self.bad[:good.numel()]
        self.o = self.o.index_copy(0, take, no[good])
        self.ok = self.ok.index_fill(0, take, True)

    def sums(self):
        """(No, k) float64 sums of the finite rows, and the failing
        rows' number."""
        o = torch.where(self.ok[:, None, None], self.o.to(torch.float64),
                        torch.zeros((), dtype=torch.float64,
                                    device=self.o.device))
        return o.sum(dim=0), int((~self.ok).sum())


def _one_by_one(ls, gens, sizes, draw, produce, calls, max_resample, batch):
    """The chunks as the engine makes them: each to its end, in turn."""
    out = []
    for gen, n in zip(gens, sizes):
        x = draw(gen, n)
        o = produce(ls, x)
        calls.append((x, o))
        ch = _Chunk(gen, o)
        for _ in range(max_resample):
            m = ch.want(batch)
            if not m:
                break
            nx = draw(gen, m)
            no = produce(ls, nx)
            calls.append((nx, no))
            ch.fill(no)
        out.append(ch)
    return out


def _all_at_once(ls, gens, sizes, draw, produce, calls, max_resample,
                 batch):
    """The same chunks with every chunk's first draw, and then each
    round's redraws, given to ``produce`` in one call."""
    def evaluate(xs):
        outs = torch.split(produce(ls, torch.cat(xs)),
                           [x.shape[0] for x in xs])
        calls.extend(zip(xs, outs))
        return outs

    chunks = [_Chunk(gen, o) for gen, o in zip(
        gens, evaluate([draw(gen, n) for gen, n in zip(gens, sizes)]))]
    for _ in range(max_resample):
        todo = [(ch, m) for ch in chunks for m in [ch.want(batch)] if m]
        if not todo:
            break
        for (ch, _m), no in zip(todo, evaluate([draw(ch.gen, m)
                                                for ch, m in todo])):
            ch.fill(no)
    return chunks


def follow(ls, N: int, seed: int, counter: int, batch: int, device, draw,
           produce, max_resample: int = 0, batched: bool = False):
    """Follow one sampling call of group ``ls`` of N samples: ``draw(gen,
    n)`` draws n rows of inputs, ``produce(ls, x)`` gives the outputs,
    (n, No, len(ls)), that stand for the program's on them.  Returns
    (calls, sums): every evaluation as (inputs, outputs), in the order
    the engine makes them, and the (No, len(ls)) float64 sums of the
    outputs of the call's samples.  ``batched`` gives ``produce`` every
    chunk of a round in one call (for a ``produce`` that takes any
    number of rows, as the reference model does): the same samples, the
    calls in another order."""
    calls, total, first, need = [], None, 0, int(N)
    run = _all_at_once if batched else _one_by_one
    for _ in range(5):
        if need <= 0:
            break
        sizes = [min(batch, need - c * batch)
                 for c in range(math.ceil(need / batch))]
        gens = []
        for c in range(len(sizes)):
            gens.append(torch.Generator(device=device))
            gens[-1].manual_seed(generator_seed(seed, counter, first + c))
        failed = 0
        for ch in run(ls, gens, sizes, draw, produce, calls, max_resample,
                      batch):
            part, bad = ch.sums()
            total = part if total is None else total + part
            failed += bad
        first += len(sizes)
        need = failed
    if need > 0:
        raise RuntimeError("group %s: %d samples never came out finite"
                           % (list(ls), need))
    return calls, total
