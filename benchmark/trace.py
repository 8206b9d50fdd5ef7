"""The traced run's device trace: taken with ``torch.profiler``, written to
``TMPDIR``, read back into a small record and deleted.

Frozen copies from ``chip_smoke.py``: ``DEVICE_CATS`` (:236), ``KERNEL_OF``
and ``OURS`` (:239-249), the profiling of ``traced`` (:274-296) and
``signature`` (:299-301); the matching of launches to the launch log
follows ``traced_run`` (:2518-2563), with the signatures learned from the
trace itself. Imports nothing of the program; the launch log it matches
is handed to it.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import re
import sys
import tempfile
from pathlib import Path

from benchmark.chip import BF16_FLOP_PER_S, HBM_BYTES_PER_S

KERNELS = Path(__file__).resolve().parent / "kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the hand-written kernels as the trace names them, by launch-counter name
KERNEL_OF = {"q4_matmul": "q4_matmul", "decode_self_attention": "self_attn",
             "decode_attention_merged": "merged_attn", "decode_attention_layer": "layer_attn",
             "decode_attention_layer_unscaled": "layer_unscaled", "decode_cross_attention": "cross_attn",
             "decode_cross_attention_unpacked": "cross_unpacked", "encoder_attention": "encoder_attn",
             "write_cache_slot": "slot", "write_cache_slot_beam": "slot_beam",
             "decode_attention_merged_int4": "merged_int4",
             "decode_attention_layer_int4": "layer_int4", "encoder_attention_heads": "encoder_heads",
             "fused_ffn": "ffn"}
OURS = re.compile(r"\b(q4_matmul|self_attn|merged_attn|layer_attn|layer_unscaled|cross_attn|cross_unpacked"
                  r"|encoder_attn|slot|slot_beam|merged_int4|layer_int4|encoder_heads|ffn)(?:_wgmma)?_kernel[<(]")
WINDOW = "bench.traced_window"
BATCH = "bench.decode_batch"


class Profiler:
    """``torch.profiler`` over host and device, started and stopped by hand.
    It records the device's work whichever thread launched it, and the host
    ranges of the thread that started it only."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.start()
        return self

    def __exit__(self, *exc):
        self.prof.stop()

    def read(self) -> dict:
        """The trace's device events, ranges and host events, compact; the
        exported file is deleted once read."""
        fd, path = tempfile.mkstemp(prefix="bench-trace-", suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            events = json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)
        device, ranges, host = [], [], []
        for e in events:
            cat = e.get("cat")
            if "dur" not in e:
                continue
            if cat in DEVICE_CATS:
                device.append({"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"]),
                               "grid": str(e.get("args", {}).get("grid"))})
            elif cat in ("user_annotation", "gpu_user_annotation"):
                ranges.append({"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"]), "cat": cat})
            elif cat in ("cpu_op", "cuda_runtime", "cuda_driver", "python_function"):
                host.append({"name": e["name"], "ts": float(e["ts"]), "dur": float(e["dur"])})
        device.sort(key=lambda e: e["ts"])
        return {"device": device, "ranges": ranges, "host": host, "file_bytes": size}


def device_spans(trace: dict, name: str) -> list[tuple[float, float]]:
    """Device spans (µs) of the ranges called ``name``, in time order."""
    return sorted((r["ts"], r["ts"] + r["dur"]) for r in trace["ranges"]
                  if r["cat"] == "gpu_user_annotation" and r["name"] == name)


def host_spans(trace: dict, name: str) -> list[tuple[float, float]]:
    return sorted((r["ts"], r["ts"] + r["dur"]) for r in trace["ranges"]
                  if r["cat"] == "user_annotation" and r["name"] == name)


def window(trace: dict) -> tuple[float, float]:
    """The traced window: the host span of ``bench.traced_window``."""
    (span,) = host_spans(trace, WINDOW)
    return span


def batch_spans(trace: dict, host: list, window_at: float) -> list[tuple[float, float]]:
    """The traced batches' device spans: the device ranges of
    ``bench.decode_batch`` where the thread that decoded them was traced;
    else (a serving worker's thread) their host spans ``host``
    (``perf_counter`` seconds), placed on the trace's clock by the window's
    start ``window_at``, each narrowed to the device work inside it."""
    spans = device_spans(trace, BATCH)
    if spans or not host:
        return spans
    lo = window(trace)[0]
    out = []
    for a, b in host:
        a_us, b_us = lo + (a - window_at) * 1e6, lo + (b - window_at) * 1e6
        inside = [e for e in trace["device"] if a_us <= e["ts"] < b_us]
        if inside:
            out.append((inside[0]["ts"], max(e["ts"] + e["dur"] for e in inside)))
    return out


def busy_us(events: list, lo: float, hi: float) -> float:
    """Microseconds of ``[lo, hi)`` in which some device event runs."""
    total, end = 0.0, lo
    for e in events:
        a, b = max(e["ts"], end), min(e["ts"] + e["dur"], hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(trace: dict, lo: float, hi: float) -> list[tuple[float, float]]:
    gaps, end = [], lo
    for e in trace["device"]:
        if e["ts"] > end and e["ts"] < hi:
            gaps.append((end, e["ts"]))
        end = max(end, e["ts"] + e["dur"])
    if end < hi:
        gaps.append((end, hi))
    return gaps


def signature(e: dict) -> tuple[str, str]:
    """A kernel launch as the trace shows it: its name and grid."""
    return e["name"], e["grid"]


def bound_module(kernel: str):
    """``benchmark/kernels/<kernel>.py``: the kernel's bytes and operations."""
    path = KERNELS / f"{kernel}.py"
    if not path.exists():
        raise KeyError(f"no bound for kernel {kernel!r}: add benchmark/kernels/{kernel}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_kernel_{kernel}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def match_launches(events: list, logged: list) -> tuple[list, int, bool]:
    """Each logged launch's device µs (None where the trace lost its
    record), walking the kernel's traced launches in time order beside the
    log; a launch's signature is learned at its shape's first launch.
    Returns the durations, the records lost and whether the walk matched
    every traced launch."""
    sig_of, durations, j = {}, [], 0
    for key in logged:
        if j < len(events):
            sig = signature(events[j])
            if sig_of.setdefault(key, sig) == sig:
                durations.append(events[j]["dur"])
                j += 1
                continue
        durations.append(None)
    return durations, durations.count(None), j == len(events)


def kernel_roofline(trace: dict, batches: list, dims: dict, positions) -> dict:
    """The hand-written kernels' share of their roofline over the traced
    batches: the sum of each launch's bound over the sum of its device
    time. A lost record counts at the mean of its kernel and shape.
    From the family: ``dims``, the model's sizes that the bounds read
    (``kernel_dims``); ``positions(log, position)``, the cache position of
    each of a kernel's launches in one batch."""
    bound_s = time_us = 0.0
    lost = collections.Counter()
    for batch in batches:
        lo, hi = batch["span"]
        ours = [e for e in trace["device"] if lo <= e["ts"] < hi and OURS.search(e["name"])]
        by_kernel = collections.defaultdict(list)
        for e in ours:
            by_kernel[OURS.search(e["name"]).group(1)].append(e)
        names = {n for n, _ in batch["log"]}
        unknown = set(by_kernel) - {KERNEL_OF[n] for n in names}
        if unknown:
            raise AssertionError(f"traced kernels {sorted(unknown)} were never logged")
        for name in sorted(names):
            logged = [tuple(s) for n, s in batch["log"] if n == name]
            mod = bound_module(name)
            durs, n_lost, whole = match_launches(by_kernel.get(KERNEL_OF[name], []), logged)
            if not whole:  # the walk failed: count the kernel's mean time at every launch
                traced = by_kernel.get(KERNEL_OF[name], [])
                mean = sum(e["dur"] for e in traced) / max(len(traced), 1)
                durs, n_lost = [mean] * len(logged), len(logged) - len(traced)
            means = collections.defaultdict(list)
            for key, d in zip(logged, durs):
                if d is not None:
                    means[key].append(d)
            fallback = max((sum(v) / len(v) for v in means.values()), default=0.0)
            for key, d, pos in zip(logged, durs, positions(logged, mod.POSITION)):
                nbytes, flops = mod.bound(key, pos, dims)
                bound_s += max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
                if d is None:
                    d = sum(means[key]) / len(means[key]) if means[key] else fallback
                time_us += d
            lost[name] += n_lost
    if lost and sum(lost.values()):
        print(f"trace: launch records lost by kernel {dict(lost)}", file=sys.stderr)
    return {"bound_s": bound_s, "time_s": time_us / 1e6, "lost": dict(lost)}
