"""What the span recorder (``whisper_burn_tpu_torch/utils/profiling.py``)
costs while it is on, with the profiler off, in the benchmark's cells, and
whether its spans lie on the profiler's clock, on one CUDA card.

    python3 scripts/torch_recorder_cost.py --seed <n> --seconds <s> --pairs <k> <cell> [<cell> ...]

For each cell (``benchmark/workloads/<cell>.json``): the benchmark's
program over its weights drawn from the seed, with the benchmark's
observer installed as in its windows; then ``pairs`` times the window
with the launch log off, on, on, off (on from the window's start, so the
warm-up batch each window starts with is not recorded). Each window gives
the cell's end-to-end metrics; the windows with the log on also give the
readings of the readers of the recorder's spans (``serving.*``,
``step.encode_ms.serve``, ``loop.launch_ms``) over the part from the
window's start to the traffic's return, here without the profiler's cost
in them (the benchmark's traced part runs under the profiler, which
distorts these spans, so ``BENCHMARK.json`` does not read them yet), and
each span name's count and mean host and device ms. With ``--clock`` it last traces one batch of
the first cell under ``utils/profiling.trace`` and gives, for each of the
main thread's model-step spans, its start less the profiler's range of
the same name, in µs.

Prints one JSON line a window, the clock line and each cell's medians.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
READERS = ("serving.queue_wait_ms.serve", "serving.idle_pct.serve", "step.encode_ms.serve", "loop.launch_ms.offline")


def window(cell: str, ctx, pipe, traffic, on: bool) -> dict:
    from benchmark import harness
    from whisper_burn_tpu_torch.ops import _build

    start, part = ctx.mark_window_start, []

    def mark():
        start()
        if on:
            _build.LAUNCH_LOG = []
            part.append(time.perf_counter_ns())

    ctx.mark_window_start = mark
    try:
        record = traffic.run(ctx, pipe)
        part.append(time.perf_counter_ns())
    finally:
        _build.LAUNCH_LOG = None
        ctx.mark_window_start = start
    out = {"cell": cell, "log": on}
    for m in harness.cell_metrics(cell, False):
        if m["name"] != "setup_s":
            out[m["name"]] = harness.metric_module(m["name"]).read(record, ctx)
    if on:
        for name in READERS:
            out[name] = harness.metric_module(name).read({**record, "recorded": part}, ctx)
        out["spans"] = span_means()
    return out


def span_means() -> dict:
    """Each span name of the recording: its count, mean host ms and mean
    device ms (where it has device events)."""
    from whisper_burn_tpu_torch.utils import profiling

    rec = profiling.current_recording()
    by_name = {}
    for s in rec.named(*{s.name for s in rec.spans}):
        by_name.setdefault(s.name, []).append(s)
    means = {}
    for name, spans in sorted(by_name.items()):
        dev = [s.device_ms for s in spans if s.device_ms is not None]
        means[name] = [len(spans), statistics.mean(s.ms for s in spans), statistics.mean(dev) if dev else None]
    return means


def clock(ctx, pipe) -> dict:
    """One batch of the cell's first traffic under ``utils/profiling.trace``."""
    from whisper_burn_tpu_torch.utils import profiling

    p = ctx.params
    audios = [c.samples for c in importlib.import_module(f"benchmark.traffic.{p['kind']}").make_pool(p, ctx.seed)][:2]
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as path:
            pipe.transcribe_batch(audios, ["en"] * len(audios))
        events = json.loads(path.read_text())["traceEvents"]
        size = path.stat().st_size
    main = threading.get_native_id()
    ours = {e["name"]: float(e["ts"]) for e in events if e.get("cat") == profiling.SPAN_CATEGORY and e["tid"] == main}
    theirs = {e["name"]: float(e["ts"]) for e in events if e.get("cat") == "user_annotation" and e["tid"] == main}
    workers = sorted({e["tid"] for e in events if e.get("cat") == profiling.SPAN_CATEGORY} - {main})
    return {"clock_us": {n: ours[n] - theirs[n] for n in sorted(ours) if n in theirs}, "trace_bytes": size,
            "other_threads": len(workers)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    for i, cell in enumerate(args.cells):
        for line in cell_cost(cell, args.seed, args.seconds, args.pairs, args.clock and i == 0):
            print(json.dumps(line), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name()}))
    return 0


def cell_cost(cell: str, seed: int, seconds: float, pairs: int, with_clock: bool, device: str = "cuda",
              workload: dict | None = None, shape=None):
    """Yields each window's line, the clock's, then the medians with the
    log off and on of each end-to-end metric."""
    from benchmark import harness
    from benchmark.observe import Observer

    ctx = harness.make_context(cell, seed, seconds, False, device, workload=workload, shape=shape)
    p = ctx.params
    traffic = importlib.import_module(f"benchmark.traffic.{p['kind']}")
    pipe = harness.build_program(ctx, p["beam_width"], p["max_tokens"])
    observer = Observer(pipe, p["max_tokens"])
    runs = []
    try:
        for _ in range(pairs):
            for on in (False, True, True, False):
                runs.append(window(cell, ctx, pipe, traffic, on))
                yield runs[-1]
        if with_clock:
            yield {"cell": cell, **clock(ctx, pipe)}
    finally:
        observer.close()
        del pipe
        harness.free_program()
    summary = {"cell": cell, "summary": True}
    for m in harness.cell_metrics(cell, False):
        off = [r[m["name"]] for r in runs if not r["log"] and r.get(m["name"]) is not None]
        on = [r[m["name"]] for r in runs if r["log"] and r.get(m["name"]) is not None]
        if off and on:
            summary[m["name"]] = {"off": statistics.median(off), "on": statistics.median(on),
                                  "change_pct": 100.0 * (statistics.median(on) / statistics.median(off) - 1.0)}
    yield summary


if __name__ == "__main__":
    sys.exit(main())
