"""The benchmark of the PyTorch/CUDA port, one cell a run.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. It makes the cell's inputs and weights from ``--seed``, builds the
program under test on the card through the configuration's model family
(``families/<family>.py``; Whisper's builds or loads the port's kernels
into ``build/kernels/`` in the checkout and builds its
``WhisperPipeline``), warms up the cell's own shape, measures for
``--seconds``, then judges a sample of what the timed path served, and
what the program said of it, against the family's plain reference. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics of
``BENCHMARK.json``, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
check compared beside its limit, which also close standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"  # fixed paths in the checkout: only a checkout's first run builds


def _cache_dirs() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"  # a library that would load JAX by itself does not


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str, *, workload: dict | None = None,
             shape=None, control: bool | dict = False, judged: int | None = None, keep: bool = False,
             bench_dir: Path | None = None) -> dict:
    """One run of cell ``name``: the result object (and, under ``record``,
    what the run measured). ``bench_dir`` holds the cell's workload,
    configuration and family files (``benchmark/`` where None)."""
    import torch

    from benchmark import harness

    ctx = harness.make_context(name, seed, seconds, trace, device, workload=workload, shape=shape, control=control,
                               bench_dir=bench_dir or harness.HERE)
    p = ctx.params
    traffic = importlib.import_module(f"benchmark.traffic.{p['kind']}")
    program = ctx.family.build(ctx)
    observer = ctx.family.observe(program, p)
    try:
        record = traffic.run(ctx, program)
    finally:
        observer.close()
    peak = harness.memory_peak_bytes(ctx.device)
    metrics = harness.read_metrics(ctx, record, name)
    del program
    harness.release(ctx)
    verdict = harness.check(ctx, record["served"], judged or harness.SAMPLE_REQUESTS, keep)
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": ctx.workload["chips"], "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"] and record["failed"] == 0, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": dev}
    t = record["trace"]
    if t is not None:
        dev.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    result["compared"] = verdict["compared"]
    return {"result": result, "record": record, "readings": verdict.get("readings"), "ctx": ctx}


def _notes(out: dict) -> dict:
    rec, ctx = out["record"], out["ctx"]
    notes = {"setup_s": ctx.setup_s, "window_s": rec["window_s"], "completed": rec["completed"],
             "readings": out["readings"]}
    for key in ("late_submit_ms", "batches", "batched_requests"):
        if key in rec:
            notes[key] = rec[key]
    t = rec["trace"]
    if t is not None:
        notes["trace"] = {k: t[k] for k in ("batches", "rows", "decode_steps", "trace_bytes", "device_events",
                                            "stage_ms", "step_s", "model_flops")}
        notes["trace"]["lost_records"] = t["roofline"]["lost"]
    return notes


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    chips = harness.load_workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cell {args.workload} needs {chips} CUDA device(s); this machine has {found}", file=sys.stderr)
        return 3
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda")
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {', '.join(loaded)}: nothing of JAX or the JAX package may run here", file=sys.stderr)
        return 4
    result = out["result"]
    print(json.dumps(_notes(out), default=float), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
