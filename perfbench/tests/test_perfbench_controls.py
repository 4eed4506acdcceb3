"""The controls of the correctness check, at a size a test run holds:
the reference in the precision below the configuration's, put in the
program's place, fails one of the cell's numbers.  On the card they run
at the cells' own sizes (``perfbench/controls.py``)."""

import pytest

from perfbench import controls, harness

SEED = 2 ** 32 + 23
# cell -> the overrides that make it small enough for the host
CASES = {
    "hh12.estimate_k3": dict(budget=2e4),
}


@pytest.mark.parametrize("cell", sorted(CASES))
def test_control_fails_a_number(cell):
    nums = dict(controls.control_numbers(cell, SEED, "cpu", CASES[cell]))
    limits = harness.cell_files(cell)[0]["limits"]
    assert any(nums[k] > lim for k, lim in limits.items()), nums
