"""A whole run of each cell at ``tiny_test()`` sizes on the CPU (the
harness's look for a card skipped), with the timed path broken underneath
(``benchmark/faults.py``), comes out not correct; the same run unbroken
comes out correct."""

import pytest

from benchmark import faults, harness
from benchmark.tests.bench_tiny import tiny_run

SEED = 2**31 + 901
CELLS = ["large-v3.offline-greedy", "turbo.serve-poisson", "large-v3.offline-beam5", "turbo.offline-greedy"]
CASES = [(cell, fault) for cell in CELLS for fault in ("token", "half", "stuck")] + [("large-v3.offline-beam5", "parent")]


@pytest.mark.parametrize("cell", CELLS)
def test_an_unbroken_run_is_correct(cell):
    out = tiny_run(cell, SEED)
    assert out["result"]["correct"], out["result"]["compared"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_run_is_not_correct(cell, fault):
    width = 5 if "beam" in cell else 1
    with faults.planted(harness.family_module("whisper"), fault, width):
        out = tiny_run(cell, SEED)
    assert not out["result"]["correct"], out["readings"]
