"""Closed-loop offline batches through the program's ``transcribe_batch``.

Parameters (the workload file's ``traffic``): ``batch`` utterances a
call, ``clip_seconds`` each, ``language``, ``beam_width``, ``max_tokens``,
``pool`` distinct utterances (half tones, half noise, in an order drawn
from the seed, so every seed makes the same work) and ``trace_batches``,
the batches a traced run profiles after its window.

The window runs from the first timed batch's start to the synced end of
the last batch that started inside ``--seconds`` (``transcribe_batch``
returns after the tokens are read back from the device).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark import audio, program_trace


def make_pool(p: dict, seed: int) -> list:
    rng = np.random.default_rng(seed)
    kinds = audio.spread([i % 2 == 0 for i in range(p["pool"])], rng)
    return [audio.make_clip(rng, p["clip_seconds"], audio.WHISPER_RATE, False, tone) for tone in kinds]


def batches(pool: list, batch: int):
    """Batch i: the pool's next ``batch`` clips, cyclically."""
    i = 0
    while True:
        yield [pool[(i * batch + j) % len(pool)] for j in range(batch)]
        i += 1


def run(ctx, pipe) -> dict:
    p = ctx.params
    pool = make_pool(p, ctx.seed)
    langs = [p["language"]] * p["batch"]
    feed = batches(pool, p["batch"])
    pipe.transcribe_batch([c.samples for c in next(feed)], langs)  # warm-up: builds, captures, fills every cache

    ctx.mark_window_start()
    served, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        clips = next(feed)
        results = pipe.transcribe_batch([c.samples for c in clips], langs)
        served += [ctx.family.served(c, r, p) for c, r in zip(clips, results)]
    window_s = time.perf_counter() - t0
    record = {
        "window_s": window_s,
        "attempted": len(served),
        "completed": len(served),
        "failed": 0,
        "audio_s": sum(len(s.samples) / s.rate for s in served),
        "served": served,
        "trace": None,
    }
    if ctx.trace:
        traced = [next(feed) for _ in range(p["trace_batches"])]
        record["trace"] = program_trace.offline(ctx, pipe, [[c.samples for c in b] for b in traced], langs)
    return record

