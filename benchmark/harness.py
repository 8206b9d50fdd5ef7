"""What every cell's run shares: the run's context, the program under test
built from the benchmark's inputs, the check of its outputs against the
reference, and the result line.

It knows no model. Everything of one it reaches through the module of
the configuration's family (``families/<family>.py``, found by the
configuration file's ``family`` key): the shapes, the program's build and
release, and the reference's readings.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_burn_tpu")  # top-level module names a run may not hold
SAMPLE_REQUESTS = 8  # requests the reference judges a run


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time, read
    from /proc), so that set-up counts the interpreter and the imports."""
    ticks = os.sysconf("SC_CLK_TCK")
    start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


@dataclasses.dataclass
class Context:
    """One run: the cell, its configuration, the seed and the options."""

    workload: dict
    config: dict
    family: object  # the configuration's family module (``families/<family>.py``)
    shape: object  # the family's shapes of the configuration
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: dict | None = None  # the control run (benchmark/calibrate.py), None for the program alone
    setup_s: float | None = None
    setup_t0: float = dataclasses.field(default_factory=time.perf_counter)

    @property
    def params(self) -> dict:
        return self.workload["traffic"]

    def __post_init__(self):
        self._age0 = process_age_s()

    def mark_window_start(self) -> None:
        """Set-up ends where the first timed request starts."""
        self.setup_s = self._age0 + time.perf_counter() - self.setup_t0


def load_workload(name: str, bench_dir: Path = HERE) -> dict:
    return json.loads((bench_dir / "workloads" / f"{name}.json").read_text())


def load_config(name: str, bench_dir: Path = HERE) -> dict:
    return json.loads((bench_dir / "configs" / f"{name}.json").read_text())


def family_module(name: str, bench_dir: Path = HERE):
    """The model family ``name`` (a configuration file's ``family``):
    ``families/<name>.py`` under ``bench_dir``, the benchmark's own
    directory by default. It is held in ``sys.modules`` as
    ``benchmark.families.<name>``, so that it loads once."""
    path = (bench_dir / "families" / f"{name}.py").resolve()
    key = f"benchmark.families.{name}"
    mod = sys.modules.get(key)
    if mod is not None and Path(mod.__file__).resolve() == path:
        return mod
    if not path.exists():
        raise FileNotFoundError(f"no module for model family {name!r}: add {path}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def make_context(workload_name: str, seed: int, seconds: float, trace: bool, device, *, workload: dict | None = None,
                 shape=None, control: bool | dict = False, bench_dir: Path = HERE) -> Context:
    """``control``: True runs the configuration file's control in place of
    the program; a dict runs that change instead (``calibrate.py``).
    ``bench_dir`` holds the ``workloads/``, ``configs/`` and ``families/``
    the run reads."""
    workload = workload or load_workload(workload_name, bench_dir)
    config = load_config(workload["config"], bench_dir)
    family = family_module(config["family"], bench_dir)
    control = config["control"] if control is True else control or None
    return Context(workload, config, family, shape or family.shape(config), seed, seconds, trace,
                   torch.device(device), control)


def release(ctx: Context) -> None:
    """Drop the program's state: the family's (its runners, caches and
    graphs), then what the collector and the card's allocator hold."""
    ctx.family.free()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# -- adapters: the call shapes of scripts/torch_recorder_cost.py -----------

_ADAPTED: list = []  # the contexts ``build_program`` built for, which ``free_program`` releases


def build_program(ctx: Context, beam_width: int, max_tokens: int):
    """Adapter: ``ctx.family.build(ctx)``, for a caller that still passes
    the traffic's beam width and token cap (the family reads both from
    ``ctx.params``; a caller whose differ is refused)."""
    if (beam_width, max_tokens) != (ctx.params["beam_width"], ctx.params["max_tokens"]):
        raise ValueError(f"beam width {beam_width} and token cap {max_tokens} are not the traffic's")
    _ADAPTED.append(ctx)
    return ctx.family.build(ctx)


def free_program() -> None:
    """Adapter: ``release`` of each context ``build_program`` built for."""
    while _ADAPTED:
        release(_ADAPTED.pop())


def memory_peak_bytes(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def percentile(values: list[float], p: float) -> float:
    """Nearest rank: the smallest value with at least ``p`` of them at or
    below it (``inf`` for a request that failed or never came)."""
    if not values:
        raise ValueError("no values")
    ranked = sorted(values)
    return ranked[max(0, math.ceil(p * len(ranked)) - 1)]


def sample_served(served: list, seed: int, n: int = SAMPLE_REQUESTS) -> list:
    """``n`` of the served requests, drawn from the seed, the longest
    (most samples judged, then most audio) among them."""
    if len(served) <= n:
        return list(served)
    key = lambda i: (len(served[i].tokens), len(served[i].samples) / served[i].rate)
    longest = max(range(len(served)), key=key)
    rest = [i for i in range(len(served)) if i != longest]
    rng = np.random.default_rng([seed, 7])
    picked = [longest] + sorted(rng.choice(rest, size=n - 1, replace=False).tolist())
    return [served[i] for i in picked]


def check(ctx: Context, served: list, n: int = SAMPLE_REQUESTS, keep: bool = False) -> dict:
    """The reference's judgement of ``n`` of the served requests (the
    family's ``judge``, which runs after the program is freed), each
    compared number beside the cell's limit. Where the run's control is
    the reference's (a ``control`` that names a ``reference``: the
    reference computed a precision step below the configuration, put in
    the program's place), the numbers compared are the control's, read
    over the same requests and reported under ``control_``."""
    sample = sample_served(served, ctx.seed, n)
    if not sample:
        return {"correct": False, "compared": {}, "why": "no request was served in the window"}
    readings = ctx.family.judge(ctx, sample, keep)
    side = "control_" if (ctx.control or {}).get("reference") else ""
    limits = ctx.workload["correct_limits"]
    finite = lambda v: v if v is not None and math.isfinite(v) else None  # inf or NaN prints as null: not correct
    compared = {name: {"value": finite(readings[side + name]), "limit": limit} for name, limit in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in compared.values())
    return {"correct": ok, "compared": compared, "readings": readings}


def metric_module(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, else that of
    its name less its last dotted part, and so on (``step.mfu_pct.serve``
    reads with ``metrics/step.mfu_pct.py``): a suffix that only says which
    end-to-end metric a reading moves needs no file of its own."""
    stem = name
    while not (HERE / "metrics" / f"{stem}.py").exists():
        if "." not in stem:
            raise FileNotFoundError(f"no reader in benchmark/metrics for metric {name!r}")
        stem = stem.rsplit(".", 1)[0]
    path = HERE / "metrics" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, trace: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` gives this cell: its end-to-end ones
    untraced, its per-layer ones traced."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = bench["per_layer" if trace else "end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def read_metrics(ctx: Context, record: dict, cell: str) -> dict:
    out = {}
    for m in cell_metrics(cell, ctx.trace):
        value = metric_module(m["name"]).read(record, ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            print(f"metric {m['name']}: nothing to read in this run", file=sys.stderr)
    return out


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (this process's
    ``sys.modules`` by default), each compared whole: the port's
    ``whisper_burn_tpu_torch`` is not the JAX package's ``whisper_burn_tpu``."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))
