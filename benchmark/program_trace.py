"""The traced part of a run: whole batches of the cell's own traffic under
``torch.profiler``, with the program's launch log on, reduced to the
numbers the per-layer readers take (``benchmark/metrics/``).

The benchmark's spans are ranges around calls into the program's layers:
``bench.traced_window`` around the traced part and ``bench.decode_batch``
around each of the program's ``decode_batch`` calls (the model step of a
batch); the program's own ranges (``<entry>.encode``, ``.cross_fill``,
``.decode``, where the family's ``entry`` names the model step: Whisper's
``greedy_decode`` or ``beam_decode``) and its launch log
(``ops/_build.LAUNCH_LOG``: each hand-written launch with its shape, graph
replays included) are read as they are. The model's operations, the
sizes and cache positions the kernels' bounds read, and its decode
loop's steps are the family's to count.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.profiler import record_function

from benchmark import trace

STAGES = ("encode", "cross_fill")


def samples_of(tokens, max_tokens: int) -> int:
    """Samples a stream took: its served tokens and the EOT that ended it early."""
    return len(tokens) + (1 if len(tokens) < max_tokens else 0)


class Tracer:
    """Wraps the pipeline instance's ``decode_batch``: while armed, each
    batch that starts is traced whole (its launches logged, its span
    named); ``disarm`` waits for the one in flight."""

    def __init__(self, pipe, max_tokens: int, beam_width: int):
        from whisper_burn_tpu_torch.ops import _build

        self._build, self.pipe = _build, pipe
        self.max_tokens, self.beam_width = max_tokens, beam_width
        self.batches, self.armed = [], False
        self._idle = threading.Event()
        self._idle.set()
        self._decode = pipe.decode_batch
        pipe.decode_batch = self._traced_decode

    def _traced_decode(self, batch):
        if not self.armed:
            return self._decode(batch)
        self._idle.clear()
        try:
            start, t0 = len(self._build.LAUNCH_LOG), time.perf_counter()
            with record_function(trace.BATCH):
                out = self._decode(batch)
            self.batches.append({
                "log": list(self._build.LAUNCH_LOG[start:]), "rows": len(batch.samples), "detect": batch.detect,
                "samples": [samples_of(r.tokens, self.max_tokens) for r in out], "host": (t0, time.perf_counter()),
            })
            return out
        finally:
            self._idle.set()

    def arm(self) -> None:
        self._build.LAUNCH_LOG = []
        self.armed = True

    def disarm(self) -> None:
        self.armed = False
        self._idle.wait()

    def close(self) -> None:
        self._build.LAUNCH_LOG = None
        self.pipe.decode_batch = self._decode  # what it wrapped (the observer's wrapper, where one is installed)


def summarize(ctx, raw: dict, batches: list, beam_width: int, max_tokens: int, window_at: float = 0.0) -> dict:
    """The numbers the readers take, from the trace of the traced batches
    (``window_at``: the window's start on ``perf_counter``, where the
    batches ran in a thread the profiler does not trace)."""
    lo, hi = trace.window(raw)
    spans = trace.batch_spans(raw, [b["host"] for b in batches], window_at)
    if len(spans) != len(batches):
        raise AssertionError(f"{len(spans)} device spans of {trace.BATCH} for {len(batches)} traced batches")
    family = ctx.family
    entry = family.entry(beam_width)
    stage_ms = collections.Counter()
    for stage in STAGES + ("decode",):
        for a, b in trace.device_spans(raw, f"{entry}.{stage}"):
            if any(s <= a < e for s, e in spans):
                stage_ms[stage] += (b - a) / 1e3
    shape = ctx.shape
    model_flops = sum(family.request_flops(shape, n, beam_width, b["detect"]) for b in batches for n in b["samples"])
    for b, span in zip(batches, spans):
        b["span"] = span
    roof = trace.kernel_roofline(raw, batches, family.kernel_dims(shape),
                                 lambda log, position: family.positions(shape, log, position))
    busy = trace.busy_us(raw["device"], lo, hi)
    ops = collections.Counter()
    for e in raw["device"]:
        if lo <= e["ts"] < hi:
            ops[e["name"][:120]] += e["dur"] / 1e6
    gaps = sorted(trace.idle_gaps(raw, lo, hi), key=lambda g: g[0] - g[1])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6,
        "batches": len(batches),
        "rows": sum(b["rows"] for b in batches),
        "real": sum(len(b["samples"]) for b in batches),
        "stage_ms": dict(stage_ms),
        "decode_steps": sum(family.decode_steps(b["samples"], max_tokens) for b in batches),
        "model_flops": model_flops,
        "step_s": sum(e - s for s, e in spans) / 1e6,
        "roofline": roof,
        "device_ops": [[n, s] for n, s in ops.most_common(10)],
        "idle_gaps": [[_host_doing(raw, a, b), (b - a) / 1e6] for a, b in gaps],
        "trace_bytes": raw["file_bytes"],
        "device_events": sum(1 for e in raw["device"] if lo <= e["ts"] < hi),
    }


def _host_doing(raw: dict, a: float, b: float) -> str:
    """What the host was in during an idle gap: the innermost host range or
    call that covers the gap's middle."""
    mid = (a + b) / 2
    covering = [e for e in raw["host"] + [r for r in raw["ranges"] if r["cat"] == "user_annotation"]
                if e["ts"] <= mid < e["ts"] + e["dur"]]
    return min(covering, key=lambda e: e["dur"])["name"][:120] if covering else "nothing traced"


def offline(ctx, pipe, batch_audios: list, langs: list) -> dict:
    """Trace whole batches of ``transcribe_batch`` after the window."""
    p = ctx.params
    tracer = Tracer(pipe, p["max_tokens"], p["beam_width"])
    try:
        tracer.arm()
        with trace.Profiler() as prof:
            torch.cuda.synchronize()
            with record_function(trace.WINDOW):
                window_at = time.perf_counter()
                for audios in batch_audios:
                    pipe.transcribe_batch(audios, langs)
                torch.cuda.synchronize()
        tracer.disarm()
    finally:
        tracer.close()
    return summarize(ctx, prof.read(), tracer.batches, p["beam_width"], p["max_tokens"], window_at)
