"""Factored-model sampling engine: per-chunk draws + the masked f64 combiner.

Port of ``bluest_tpu/sampling/kernel_engine.py`` (the per-model sweep and
its combiner) and of ``SampleSums`` (``jax_engine.py:34``).  For a group
``ls`` of models and N samples, each chunk of up to ``batch_size``
samples

  * draws the random inputs ONCE from the group's ``torch.Generator`` on
    the problem's device,
  * evaluates every model of the group on that same input tensor -- the
    coupling that ``fold_in(key, idx)`` gives the JAX engine -- and
  * folds the outputs into the MLBLUE sums in float64 on the device:
    sums of outputs, cross products and pairwise MLMC differences, with
    rows whose index is >= N or whose outputs are non-finite weighted 0
    (non-finite rows are counted in ``n_failed``).

The sums stay on the device; the caller copies them to the host once per
group.  With ``on_chunk`` (snapshot collection, the counterpart of
``KernelEngineV2.sample_sums(collect=True, on_chunk=...)``) each chunk's
finite rows -- outputs and flattened inputs -- also go to the host, so
the snapshot rows are exactly the samples the sums cover.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

F64 = torch.float64


class SampleSums(NamedTuple):
    sumse: torch.Tensor       # (No, L, d)  sum of outputs (d = output dim)
    sumsc: torch.Tensor       # (No, L, L) sum of pairwise inner products
    sumsd1: torch.Tensor      # (No, L, L, d) sum of differences (i - j)
    sumsd2: torch.Tensor      # (No, L, L) sum of squared difference norms
    n_failed: torch.Tensor    # non-finite samples (int64 scalar)


def generator_seed(seed: int, counter: int) -> int:
    """64-bit generator seed for call ``counter`` of a problem seeded with
    ``seed``: distinct counters give independent, reproducible streams."""
    s = np.random.SeedSequence([int(seed), int(counter)]).generate_state(
        2, dtype=np.uint32)
    return (int(s[0]) << 32) | int(s[1])


def combine(outs: torch.Tensor, base: int, N: int) -> SampleSums:
    """Masked f64 MLBLUE sums of one chunk.

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


def add_sums(a: SampleSums, b: SampleSums) -> SampleSums:
    return SampleSums(*[x + y for x, y in zip(a, b)])


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


class SamplingEngine:
    """Coupled sampling of groups of a factored model on one device.

    ``sample_inputs(generator, n)`` draws n shared inputs (a tensor with
    leading dimension n) and ``evaluate_model(l, inputs)`` returns model
    ``l``'s outputs, shape (n, No) or (n, No, d)."""

    def __init__(self, sample_inputs: Callable, evaluate_model: Callable,
                 No: int, batch_size: int, device):
        if int(batch_size) < 1:
            raise ValueError("batch_size must be >= 1, got %s" % batch_size)
        self.sample_inputs = sample_inputs
        self.evaluate_model = evaluate_model
        self.No = int(No)
        self.batch = int(batch_size)
        self.device = check_device(device)

    def sample_sums(self, ls: Sequence[int], seed: int, N: int,
                    on_chunk: Optional[Callable] = None) -> SampleSums:
        """MLBLUE sums of group ``ls`` over N coupled samples drawn from a
        generator seeded with ``seed``.  Returns device tensors.  With
        ``on_chunk(vals, inputs, attempted_rows)`` each chunk's finite
        rows are handed over as numpy arrays: ``vals`` (rows, No, k[, d])
        and ``inputs`` (rows, q)."""
        ls = [int(l) for l in ls]
        N = int(N)
        if N <= 0:
            return zero_sums(self.No, len(ls), self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        acc = None
        for base in range(0, N, self.batch):
            n_c = min(self.batch, N - base)
            theta = self.sample_inputs(gen, n_c)
            outs = torch.stack([self.evaluate_model(l, theta) for l in ls])
            part = combine(outs, base, N)
            acc = part if acc is None else add_sums(acc, part)
            if on_chunk is not None:
                # drop non-finite rows: the combiner masks them out of the
                # sums and the problem's top-up resamples the deficit, so
                # the snapshot rows equal the samples the sums cover
                vals = outs.movedim(0, 2)                  # (n_c, No, k[, d])
                sel = finite_rows(vals).cpu().numpy()
                on_chunk(vals.cpu().numpy()[sel],
                         flat_inputs(theta).cpu().numpy()[sel], n_c)
        return acc
