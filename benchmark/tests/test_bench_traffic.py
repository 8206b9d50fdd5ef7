"""The traffic is made from ``--seed`` alone: the same seed gives the same
inputs, another seed the same set of sizes and arrivals in another order."""

import numpy as np

from benchmark import harness
from benchmark.traffic import offline_batches, open_loop_poisson

SEED = 2**31 + 12345  # a seed past 32 signed bits, as a run may be given


def test_offline_pool_repeats_from_its_seed():
    p = harness.load_workload("large-v3.offline-greedy")["traffic"] | {"pool": 6, "clip_seconds": 1}
    a, b, c = (offline_batches.make_pool(p, s) for s in (SEED, SEED, SEED + 1))
    assert all(np.array_equal(x.samples, y.samples) for x, y in zip(a, b))
    assert not all(np.array_equal(x.samples, y.samples) for x, y in zip(a, c))
    assert sorted(len(x.samples) for x in a) == sorted(len(x.samples) for x in c)


def test_open_loop_repeats_from_its_seed():
    p = harness.load_workload("turbo.serve-poisson")["traffic"] | {"pool": 9, "clip_seconds": [0.5, 1.5]}
    a, b, c = (open_loop_poisson.make_pool(p, s) for s in (SEED, SEED, SEED + 1))
    assert all(np.array_equal(x.samples, y.samples) and x.rate == y.rate for x, y in zip(a, b))
    key = lambda pool: sorted((round(x.seconds, 6), x.rate, x.stereo) for x in pool)
    assert key(a) == key(c) and [x.seconds for x in a] != [x.seconds for x in c]
    assert sum(x.rate == 44_100 for x in a) == 3  # a third of nine at 44.1 kHz


def test_arrivals_hold_the_same_gaps_in_another_order():
    g1, g2, g3 = (open_loop_poisson.arrival_gaps(10.0, 30.0, s) for s in (SEED, SEED, SEED + 1))
    assert g1 == g2 and g1 != g3 and sorted(g1) == sorted(g3)
    assert len(g1) == 300
    assert abs(sum(g1) - 30.0) < 1.5  # the window holds its 300 arrivals
