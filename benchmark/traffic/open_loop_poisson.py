"""An open loop of Poisson arrivals into ``BatchingTranscriber.submit``.

Parameters (the workload file's ``traffic``): ``rate`` requests a second,
the transcriber's ``batch``, ``max_wait_ms`` and ``max_pending``, a
``pool`` of clips with lengths spread evenly over ``clip_seconds``
(``[low, high]``), ``share_44k_stereo`` of them at 44.1 kHz in two channels
(sent as their mean, as a WAV reader downmixes them) and the rest 16 kHz
mono, half tones and half noise, ``language``, ``max_tokens`` and
``trace_seconds``, how long a traced run profiles the same load after its
window.

Every seed makes the same set of clips and the same set of gaps between
arrivals in another order: the gaps are the quantiles of the exponential
distribution of mean 1 / rate, ``rate x seconds`` of them, so the window
holds the same number of requests in every run. A request is due at its
arrival; its latency runs from then to the moment its result is handed
back, so a stall that delays later submits counts against them. The load
goes on past the window until every request due in it has its answer.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from benchmark import audio, program_trace

LEAD_S = 0.05  # between the window's start and its first arrival
LATE_S = 60.0  # how long past the window's close an answer is waited for


def make_pool(p: dict, seed: int) -> list:
    """The clips: their lengths, rates and kinds are one fixed set (every
    ``1 / share_44k_stereo``-th length in two channels at 44.1 kHz, every
    other one a tone), drawn and ordered from the seed."""
    rng = np.random.default_rng(seed)
    n = p["pool"]
    low, high = p["clip_seconds"]
    every = round(1 / p["share_44k_stereo"])
    kinds = [(float(s), i % every == 1, i % 2 == 0) for i, s in enumerate(np.linspace(low, high, n))]
    return [audio.make_clip(rng, s, 44_100 if st else audio.WHISPER_RATE, st, t) for s, st, t in audio.spread(kinds, rng)]


def arrival_gaps(rate: float, seconds: float, seed: int) -> list:
    n = max(1, round(rate * seconds))
    gaps = [-math.log(1.0 - (i + 0.5) / n) / rate for i in range(n)]
    return audio.spread(gaps, np.random.default_rng([seed, 1]))


class Waiter(threading.Thread):
    """Takes each request's answer in submit order (batches finish in that
    order) and stamps when it came; one that has not come by its
    ``deadline`` never came."""

    def __init__(self):
        super().__init__(daemon=True)
        self.pending, self.done = [], []
        self._cv = threading.Condition()
        self._stopping = False

    def add(self, entry: dict) -> None:
        with self._cv:
            self.pending.append(entry)
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify()

    def run(self) -> None:
        while True:
            with self._cv:
                while not self.pending and not self._stopping:
                    self._cv.wait()
                if not self.pending:
                    return
                entry = self.pending.pop(0)
            req = entry["request"]
            came = req is not None and req.event.wait(max(0.0, entry["deadline"] - time.perf_counter()))
            entry["answered"] = time.perf_counter() if came else None
            entry["result"] = req.result if came and req.error is None else None
            self.done.append(entry)


def warm_up_clips(pool: list, batch: int) -> list:
    """One batch of the mix: a 44.1 kHz clip and 16 kHz ones."""
    by_rate = sorted(pool, key=lambda c: -c.rate)
    return [by_rate[0]] + [c for c in pool if c.rate == audio.WHISPER_RATE][: batch - 1]


def run(ctx, pipe) -> dict:
    import torch
    from torch.profiler import record_function
    from whisper_burn_tpu_torch.audio.io import AudioBuffer
    from whisper_burn_tpu_torch.serving import BatchingTranscriber, ServerOverloadedError

    from benchmark import trace

    p = ctx.params
    pool = make_pool(p, ctx.seed)
    order = np.random.default_rng([ctx.seed, 2]).permutation(len(pool))
    gaps = arrival_gaps(p["rate"], ctx.seconds, ctx.seed)
    prepare_ms = []  # (start, ms) of each batch's host work

    prepare = pipe.prepare_batch

    def timed_prepare(audios, languages=None, _prepare=prepare):
        t0 = time.perf_counter()
        out = _prepare(audios, languages)
        prepare_ms.append((t0, (time.perf_counter() - t0) * 1e3))
        return out

    pipe.prepare_batch = timed_prepare
    tracer = program_trace.Tracer(pipe, p["max_tokens"], 1) if ctx.trace else None
    server = BatchingTranscriber(pipe, batch_size=p["batch"], max_wait_ms=p["max_wait_ms"], max_pending=p["max_pending"])
    waiter = Waiter()
    prof = window = None
    try:
        for r in [server.submit(AudioBuffer(c.samples, c.rate), p["language"]) for c in warm_up_clips(pool, p["batch"])]:
            r.wait(600)
        stats = server.stats
        waiter.start()
        ctx.mark_window_start()
        t0 = time.perf_counter() + LEAD_S
        close = t0 + ctx.seconds
        counters = {"start": (stats.batches, stats.batched_requests)}
        due, i, window_n, late_s, traced_until = t0, 0, len(gaps), 0.0, None
        while True:
            now = time.perf_counter()
            if "end" not in counters and now >= close:
                counters["end"] = (stats.batches, stats.batched_requests)
            if i >= window_n and len(waiter.done) >= window_n:  # every request due in the window has its answer
                if tracer is None or traced_until is not None and now >= traced_until:
                    break
                if traced_until is None:  # the traced part: the same load, profiled
                    prof = trace.Profiler().__enter__()  # takes seconds: the window starts after it
                    window = record_function(trace.WINDOW).__enter__()
                    window_at = time.perf_counter()
                    tracer.arm()
                    traced_until = time.perf_counter() + p["trace_seconds"]
                    due = max(due, time.perf_counter())  # the arrivals go on from here, not in a burst
                    continue
            if due > now:
                time.sleep(due - now)
            clip = pool[order[i % len(pool)]]
            try:
                req = server.submit(AudioBuffer(clip.samples, clip.rate), p["language"])
            except ServerOverloadedError:
                req = None
            if i < window_n:
                late_s = max(late_s, time.perf_counter() - due)
            waiter.add({"due": due, "deadline": close + LATE_S, "clip": clip, "request": req, "in_window": i < window_n})
            due += gaps[i % len(gaps)]
            i += 1
        counters.setdefault("end", (stats.batches, stats.batched_requests))
        traced = None
        if tracer is not None:
            tracer.disarm()
            torch.cuda.synchronize()
            window.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            traced = program_trace.summarize(ctx, prof.read(), tracer.batches, 1, p["max_tokens"], window_at)
    finally:
        server.shutdown()
        if tracer is not None:
            tracer.close()
        pipe.prepare_batch = prepare
        waiter.stop()
        waiter.join()
    window = [e for e in waiter.done if e["in_window"]]
    latencies = [(e["answered"] - e["due"]) * 1e3 if e["result"] is not None else float("inf") for e in window]
    served = [ctx.family.served(e["clip"], e["result"], p) for e in window if e["result"] is not None]
    (b0, r0), (b1, r1) = counters["start"], counters["end"]
    return {
        "window_s": ctx.seconds,
        "attempted": len(window),
        "completed": len(served),
        "failed": len(window) - len(served),
        "latencies_ms": latencies,
        "audio_s": sum(len(s.samples) / s.rate for s in served),
        "batches": b1 - b0,
        "batched_requests": r1 - r0,
        "prepare_ms": [ms for t, ms in prepare_ms if t0 <= t < close],
        "late_submit_ms": late_s * 1e3,
        "unanswered_at_close": sum(1 for e in window if e["answered"] is None or e["answered"] > close),
        "served": served,
        "trace": traced,
    }
