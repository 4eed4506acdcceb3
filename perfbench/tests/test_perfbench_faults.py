"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run (set-up, the window, the check
against the plain reference) on the host at a small budget, skipping the
look for a card, with one fault planted in the program: half of each
chunk's rows left out and the sums scaled to the rest, the tail of each
chunk's rows off by a part in ten thousand (a wrong tail, a bad lane), or
the answer altered where it is produced.  The same run without a fault
is correct.
"""

import numpy as np
import pytest

from perfbench import harness

SEED = 2 ** 32 + 17


def _run(cell, **overrides):
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                            overrides=overrides)


def _half_batch(monkeypatch):
    """The combiner weighs every other row of a chunk and doubles the
    sums: half of the batch left out, the mean taken over the rest."""
    from bluest_tpu_torch.sampling import engine, group_engine
    combine = engine.combine

    def half(outs, base, N):
        s = combine(outs[:, ::2], base, N)
        return engine.SampleSums(*(2 * t for t in s[:4]), s[4])
    monkeypatch.setattr(engine, "combine", half)
    monkeypatch.setattr(group_engine, "combine", half)


def _chunk_tails_altered(monkeypatch):
    """The last 64 rows of every group evaluation (a chunk, or a redraw)
    off by a part in ten thousand: under 1% of the rows, and the sums and
    the estimate follow them, so only the rows' comparison with the
    reference sees it."""
    from bluest_tpu_torch.models.hodgkin_huxley import HodgkinHuxleyProblem
    orig = HodgkinHuxleyProblem.evaluate_group

    def altered(self, ls, params):
        out = orig(self, ls, params).clone()
        out[-64:] *= 1 + 1e-4
        return out
    monkeypatch.setattr(HodgkinHuxleyProblem, "evaluate_group", altered)


def _estimate_altered(monkeypatch):
    """The first output's estimate moved by twice its error bar."""
    from bluest_tpu_torch.allocation.mosap import MOSAP
    orig = MOSAP.compute_BLUE_estimators

    def altered(self, sums, samples):
        mus, Vs = orig(self, sums, samples)
        mus = list(mus)
        mus[0] = mus[0] + 2 * np.sqrt(Vs[0])
        return mus, Vs
    monkeypatch.setattr(MOSAP, "compute_BLUE_estimators", altered)


CASES = {
    "hh12.estimate_k3": dict(budget=2e4),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_sound_run_is_correct(cell):
    res = _run(cell, **CASES[cell])
    assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("cell, fault", [
    ("hh12.estimate_k3", _half_batch),
    ("hh12.estimate_k3", _chunk_tails_altered),
    ("hh12.estimate_k3", _estimate_altered),
])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cell, **CASES[cell])
    assert not res["correct"], res["checks"]
