"""The rate and percentile arithmetic counts every request, and a failed
or refused request as missing every limit."""

import math

import pytest

from benchmark import harness


def metric(name, record):
    return harness.metric_module(name).read(record, None)


def test_percentile_is_the_nearest_rank_over_every_request():
    values = [float(v) for v in range(1, 101)]
    assert harness.percentile(values, 0.95) == 95.0
    assert harness.percentile(values, 0.50) == 50.0
    assert harness.percentile([7.0], 0.95) == 7.0


def test_a_failed_request_counts_as_infinitely_late():
    lat = [10.0] * 95 + [float("inf")] * 5
    assert harness.percentile(lat, 0.95) == 10.0
    lat[94] = float("inf")  # a sixth failure reaches the 95th percentile
    assert math.isinf(harness.percentile(lat, 0.95))
    assert metric("latency_p95_ms", {"latencies_ms": lat}) is None  # no number stands for it
    assert metric("latency_p50_ms", {"latencies_ms": lat}) == 10.0


def test_rate_is_all_the_audio_over_all_the_window():
    assert metric("audio_s_per_s", {"audio_s": 960.0 * 7, "window_s": 30.5}) == pytest.approx(960.0 * 7 / 30.5)


def test_batch_fill_is_real_requests_over_batches():
    assert metric("serving.batch_fill", {"batches": 40, "batched_requests": 250}) == 6.25
    assert metric("serving.batch_fill", {"batches": 0, "batched_requests": 0}) is None


def test_the_sample_judged_holds_the_longest_request():
    from benchmark.reference import Served

    served = [Served([0.0] * (100 + i), 16000, 50259, False, [1] * (5 if i != 13 else 9), 9) for i in range(30)]
    picked = harness.sample_served(served, 2**31 + 5)
    assert len(picked) == harness.SAMPLE_REQUESTS and served[13] in picked
    assert picked == harness.sample_served(served, 2**31 + 5)


def test_a_suffixed_metric_reads_with_its_base_reader():
    assert harness.metric_module("step.mfu_pct.serve").__file__.endswith("metrics/step.mfu_pct.py")
    assert harness.metric_module("audio_s_per_s.beam").__file__.endswith("metrics/audio_s_per_s.py")
    assert harness.metric_module("serving.batch_fill").__file__.endswith("metrics/serving.batch_fill.py")
    with pytest.raises(FileNotFoundError):
        harness.metric_module("no_such_metric.offline")


def test_every_metric_of_the_benchmark_has_a_reader():
    import json

    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_module(m["name"]).read), m["name"]
