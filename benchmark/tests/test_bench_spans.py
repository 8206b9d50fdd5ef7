"""The readers of the program's spans (``serving.queue_wait_ms``,
``serving.idle_pct``, ``step.encode_ms.serve``, ``loop.launch_ms``): None
on a run with nothing recorded, a run whose record names no recorded
part (every run of today's harness) or a program without the recorder;
the right numbers on a recording made by hand; and nothing of the spans
that lie outside the recorded part."""

import types

import pytest

from benchmark import harness
from whisper_burn_tpu_torch.utils import profiling

MS = 1_000_000  # ns
RECORDED = {"recorded": (0, 10_000 * MS)}
READERS = ("serving.queue_wait_ms.serve", "serving.idle_pct.serve", "step.encode_ms.serve", "loop.launch_ms.offline",
           "loop.launch_ms.beam")
WORKER, MAIN = 11, 12


def read(name, record=RECORDED):
    beam_width = 5 if name.endswith(".beam") else 1  # the beam cell's traffic, else greedy
    ctx = types.SimpleNamespace(family=harness.family_module("whisper"), params={"beam_width": beam_width})
    return harness.metric_module(name).read(record, ctx)


def span(name, start_ms, end_ms, thread=WORKER, device_ms=None, ids=None, **counters):
    s = profiling.Span(name, ids or {}, int(start_ms * MS), int(end_ms * MS), thread=thread)
    s.device_ms, s.counters = device_ms, counters
    return s


def recording(spans):
    rec = profiling.Recording()
    for s in spans:
        rec.add(s)
    return rec


@pytest.fixture
def current(monkeypatch):
    def use(rec):
        monkeypatch.setattr(profiling, "current_recording", lambda: rec)

    return use


def test_the_serve_reader_is_its_own_file():
    assert harness.metric_module("step.encode_ms.serve").__file__.endswith("metrics/step.encode_ms.serve.py")
    assert harness.metric_module("loop.launch_ms.beam").__file__.endswith("metrics/loop.launch_ms.py")


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_none(name, current, monkeypatch):
    current(None)
    assert read(name) is None
    current(recording([]))
    assert read(name) is None
    monkeypatch.delattr(profiling, "current_recording")  # a program without the recorder
    assert read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_a_run_without_a_recorded_part_reads_none(name, current):
    current(recording([span("serving.queued", 0, 100), span("serving.wait", 0, 10), span("serving.wait", 20, 30),
                       span("greedy_decode.decode", 0, 1, replays=1, launch_ns=MS)]))
    assert read(name, {"trace": None}) is None
    assert read(name, {"trace": {"window_s": 1.0}}) is None  # a traced run of today's harness


def test_spans_outside_the_recorded_part_are_left_out(current):
    """A server's drain after the part: its queued spans, its cycles, its
    encodes and a decode loop recorded after ``recorded`` ends (or before
    it starts) change no reading."""
    inside = [
        span("serving.queued", 100, 300, ids={"request": 0, "parent": 0}),
        span("serving.wait", 100, 200), span("serving.collect", 200, 300),
        span("greedy_decode.encode", 300, 320, device_ms=240.0, rows=8),
        span("greedy_decode.cross_fill", 320, 330, device_ms=16.0),
        span("greedy_decode.decode", 330, 600, steps=101, replays=100, launch_ns=100 * MS),
        span("beam_decode.decode", 610, 900, thread=MAIN, steps=51, replays=50, launch_ns=50 * MS),
        span("serving.wait", 1000, 1010),
    ]
    drain = [
        span("serving.queued", 0, 150, ids={"request": 1, "parent": 1}),  # submitted before the part
        span("serving.queued", 1100, 5000, ids={"request": 2, "parent": 2}),
        span("serving.wait", 1400, 1600),  # ends after the part
        span("serving.wait", 2000, 2001),
        span("serving.wait", 2001, 2002), span("serving.collect", 2002, 2500),
        span("greedy_decode.encode", 2500, 2600, device_ms=9000.0, rows=8),
        span("greedy_decode.cross_fill", 2600, 2610, device_ms=9000.0),
        span("greedy_decode.decode", 2610, 2700, steps=11, replays=10, launch_ns=900 * MS),
        span("beam_decode.decode", 2700, 2800, thread=MAIN, steps=11, replays=10, launch_ns=900 * MS),
    ]
    part = {"recorded": (50 * MS, 1500 * MS)}
    current(recording(inside))
    alone = {name: read(name, part) for name in READERS}
    current(recording(inside + drain))
    assert {name: read(name, part) for name in READERS} == alone
    assert alone == {
        "serving.queue_wait_ms.serve": pytest.approx(200.0),
        "serving.idle_pct.serve": pytest.approx(100.0 * 200 / 900),
        "step.encode_ms.serve": pytest.approx(256.0 / 8),
        "loop.launch_ms.offline": pytest.approx(1.0),
        "loop.launch_ms.beam": pytest.approx(1.0),
    }


def test_queue_wait_is_the_mean_queued_span(current):
    current(recording([span("serving.queued", 0, 100, ids={"request": 0, "parent": 0}),
                       span("serving.queued", 50, 350, ids={"request": 1, "parent": 0}),
                       span("serving.wait", 0, 10)]))
    assert read("serving.queue_wait_ms.serve") == pytest.approx(200.0)


def test_idle_share_is_wait_and_collect_over_whole_cycles(current):
    current(recording([
        span("serving.wait", 0, 100), span("serving.collect", 100, 150), span("pipeline.prepare", 150, 200),
        span("serving.wait", 500, 520), span("serving.collect", 520, 540),
        span("serving.wait", 1000, 1400),  # the last wait starts no whole cycle
        span("serving.wait", 0, 900, thread=MAIN), span("serving.wait", 1000, 1100, thread=MAIN),
    ]))
    # worker: 150 + 40 ms of 1000; the other thread's one cycle: 900 of 1000
    assert read("serving.idle_pct.serve") == pytest.approx(100.0 * (150 + 40 + 900) / 2000)


def test_encode_ms_is_the_workers_device_time_a_row(current):
    current(recording([
        span("serving.wait", 0, 10),
        span("greedy_decode.encode", 20, 40, device_ms=240.0, rows=8),
        span("greedy_decode.cross_fill", 40, 45, device_ms=16.0),
        span("greedy_decode.encode", 100, 120, device_ms=250.0, rows=8),
        span("greedy_decode.cross_fill", 120, 125, device_ms=None),  # not resolved: left out with its encode
        span("greedy_decode.encode", 20, 40, thread=MAIN, device_ms=999.0, rows=1),  # not the worker's
        span("greedy_decode.cross_fill", 40, 45, thread=MAIN, device_ms=999.0),
    ]))
    assert read("step.encode_ms.serve") == pytest.approx((240.0 + 16.0) / 8)


def test_launch_ms_is_host_ns_over_replays(current):
    current(recording([
        span("greedy_decode.decode", 0, 500, steps=223, replays=222, launch_ns=666 * MS),
        span("beam_decode.decode", 600, 900, steps=101, replays=100, launch_ns=334 * MS),
        span("greedy_decode.decode", 1000, 1001, steps=3),  # eager steps: no launch counted
    ]))
    assert read("loop.launch_ms.offline") == pytest.approx(666.0 / 222)  # the greedy loop's spans
    assert read("loop.launch_ms.beam") == pytest.approx(334.0 / 100)  # the beam loop's
