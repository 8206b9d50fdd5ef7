"""The port's span recorder (``whisper_burn_tpu_torch/utils/profiling.py``)
on the CPU at ``WhisperConfig.tiny_test()``: the serving worker's cycle
and each request's time in the queue, the trace's clock, the decode
loop's step count, and nothing recorded with the launch log off."""

import json
import threading

import numpy as np
import pytest
import torch

from whisper_burn_tpu_torch import serving
from whisper_burn_tpu_torch.models import beam as beam_mod
from whisper_burn_tpu_torch.models import whisper as w
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import WhisperPipeline
from whisper_burn_tpu_torch.utils import profiling

CFG = WhisperConfig.tiny_test()
MAX_TOKENS = 6
CYCLE = ("serving.wait", "serving.collect", "pipeline.prepare", "pipeline.device_step", "pipeline.detokenize",
         "serving.reply")


def _pipeline(beam_width: int = 1) -> WhisperPipeline:
    return WhisperPipeline((CFG, random_params(CFG, seed=0, device="cpu")), compute=Compute.parity(),
                           max_tokens=MAX_TOKENS, beam_width=beam_width, device="cpu")


@pytest.fixture(scope="module")
def pipeline():
    return _pipeline()


def _clip(seed: int, seconds: float = 0.4) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * (200 + 50 * seed) * t) + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(autouse=True)
def _log_off():
    """Each test starts and ends with the launch log off."""
    _build.LAUNCH_LOG = None
    yield
    _build.LAUNCH_LOG = None


def test_serving_cycle_and_queue_spans(pipeline):
    """Three requests at ``batch_size=2``: each has one ``serving.queued``
    span that ends where its batch's ``serving.collect`` ends and carries
    that batch's id, and each whole cycle of the worker (one
    ``serving.wait`` start to the next) holds its ``wait``, ``collect``,
    ``prepare``, ``device_step``, ``detokenize`` and ``reply`` spans once
    each, in that order, one after another and inside the cycle. The host
    time between two spans is reported, not bounded: it is the host's to
    give, and a busy host stretches it."""
    clips = [_clip(i) for i in range(3)]
    with profiling.record() as rec:
        t = serving.BatchingTranscriber(pipeline, batch_size=2, max_wait_ms=50.0)
        reqs = [t.submit(c, "en") for c in clips]
        for r in reqs:
            r.wait(120)
        t.shutdown()
    queued = rec.named("serving.queued")
    assert sorted(s.ids["request"] for s in queued) == [r.id for r in reqs]
    collect = {s.ids["batch"]: s for s in rec.named("serving.collect")}
    for s in queued:
        assert s.end_ns == collect[s.ids["parent"]].end_ns
        assert s.start_ns <= s.end_ns
    assert sum(len([q for q in queued if q.ids["parent"] == b]) for b in collect) == 3

    waits = sorted(rec.named("serving.wait"), key=lambda s: s.start_ns)
    worker = {s.thread for s in waits}
    assert len(worker) == 1 and len(waits) >= 3  # two batches, then the wait the shutdown ends
    cycle_spans = [s for s in rec.named(*CYCLE) if s.thread in worker]
    for a, b in zip(waits, waits[1:]):
        inside = sorted((s for s in cycle_spans if a.start_ns <= s.start_ns < b.start_ns), key=lambda s: s.start_ns)
        gaps = [(x.name, y.start_ns - x.end_ns) for x, y in zip(inside, inside[1:] + [b])]
        print("gaps between the cycle's spans, ns:", gaps)
        assert [s.name for s in inside] == list(CYCLE), gaps
        assert inside[0] is a and all(g >= 0 for _, g in gaps), gaps
        assert sum(s.end_ns - s.start_ns for s in inside) <= b.start_ns - a.start_ns


def test_trace_holds_every_thread_on_the_profilers_clock(pipeline, tmp_path):
    """Inside ``trace(dir)`` the exported file holds the worker thread's
    ``serving.*`` spans, and the main thread's ``greedy_decode.encode``
    span starts within 1 ms of the profiler's own range of that name. The
    profiler's ranges are the model step's alone: a range nested in an
    outer one would take its kernels out of the outer one's device span."""
    with profiling.trace(tmp_path) as path:
        t = serving.BatchingTranscriber(pipeline, batch_size=2, max_wait_ms=5.0)
        t.transcribe(_clip(0), "en", timeout=120)
        t.shutdown()
        pipeline.transcribe(_clip(1), "auto")
    assert _build.LAUNCH_LOG is None
    events = json.loads(path.read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == profiling.SPAN_CATEGORY]
    main = threading.get_native_id()
    assert {"serving.wait", "serving.collect", "serving.queued", "serving.reply"} <= {
        e["name"] for e in ours if e["tid"] != main}
    (program,) = [e for e in ours if e["name"] == "greedy_decode.encode" and e["tid"] == main]
    (profiled,) = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "greedy_decode.encode"
                   and e["tid"] == main]
    assert abs(float(program["ts"]) - float(profiled["ts"])) < 1000.0
    ranges = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert "greedy_decode.detect" in {e["name"] for e in ours}
    assert ranges <= {"greedy_decode.encode", "greedy_decode.cross_fill", "greedy_decode.prefill",
                      "greedy_decode.decode", "decode_step.logits"}, ranges


@pytest.mark.parametrize("beam_width", [1, 3])
def test_decode_span_counts_the_loops_steps(beam_width, monkeypatch):
    """The ``*.decode`` span's ``steps`` counter is the number of steps
    the loop took (on the CPU every step runs eagerly: no replays)."""
    pipe = _pipeline(beam_width)
    runner_cls = w.GreedyRunner if beam_width == 1 else beam_mod.BeamRunner
    taken = []
    step = runner_cls.step
    monkeypatch.setattr(runner_cls, "step", lambda self, *a: (taken.append(1), step(self, *a))[1])
    with profiling.record() as rec:
        pipe.transcribe_batch([_clip(0), _clip(1)], ["en", "en"])
    stage = "greedy_decode" if beam_width == 1 else "beam_decode"
    (decode,) = rec.named(f"{stage}.decode")
    assert decode.counters["steps"] == len(taken) == MAX_TOKENS - 1
    assert "replays" not in decode.counters
    (encode,) = rec.named(f"{stage}.encode")
    assert encode.counters["rows"] == 2


def test_detect_span_nests_in_prefill(pipeline):
    with profiling.record() as rec:
        pipeline.transcribe(_clip(2), "auto")
    (detect,) = rec.named("greedy_decode.detect")
    (prefill,) = rec.named("greedy_decode.prefill")
    assert prefill.start_ns <= detect.start_ns <= detect.end_ns <= prefill.end_ns


def test_nothing_recorded_with_the_launch_log_off(pipeline):
    before = profiling.current_recording()
    n = len(before.spans) if before is not None else 0
    t = serving.BatchingTranscriber(pipeline, batch_size=2, max_wait_ms=5.0)
    t.transcribe(_clip(0), "en", timeout=120)
    t.shutdown()
    pipeline.transcribe(_clip(1), "auto")
    after = profiling.current_recording()
    assert after is before
    assert (len(after.spans) if after is not None else 0) == n
    with profiling.span("anything") as s:
        profiling.count(steps=1)
    assert s is None


def test_a_new_launch_log_starts_a_new_recording(pipeline):
    with profiling.record() as first:
        pipeline.transcribe(_clip(0), "en")
    with profiling.record() as second:
        pass
    assert second is not first and not second.spans and first.named("pipeline.device_step")
    assert profiling.current_recording() is second
