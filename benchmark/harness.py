"""What every cell's run shares: the run's context, the program under test
built from the benchmark's inputs, the check of its outputs against the
reference, and the result line.

Only ``build_program`` (and what the traffic modules drive) touches the
program, ``whisper_burn_tpu_torch``; it is imported inside the functions
that use it, so that the reference and the counts load without it.
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

from benchmark import model_config
from benchmark.model_config import ModelShape

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
    shape: ModelShape
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


def load_workload(name: str) -> dict:
    return json.loads((HERE / "workloads" / f"{name}.json").read_text())


def make_context(workload_name: str, seed: int, seconds: float, trace: bool, device, *, workload: dict | None = None,
                 shape: ModelShape | None = None, control: bool | dict = False) -> Context:
    """``control``: True runs the configuration file's control in place of
    the program; a dict runs that change instead (``calibrate.py``)."""
    workload = workload or load_workload(workload_name)
    config = model_config.load_config(workload["config"])
    control = config["control"] if control is True else control or None
    return Context(workload, config, shape or model_config.model_shape(config), seed, seconds, trace,
                   torch.device(device), control)


def program_compute(ctx: Context):
    """The configuration's compute as the port's ``Compute`` (with a
    calibration's change to it, where ``ctx.control`` names ``Compute``
    fields)."""
    from whisper_burn_tpu_torch.ops.compute import Compute

    c = ctx.config["compute"]
    if c["preset"] != "fastest":
        raise ValueError(f"unknown compute preset {c['preset']!r}")
    compute = Compute.fastest(kv_bits=c["kv_bits"]).replace(quantized_logits=c["quantized_logits"], w8a8=c["w8a8"])
    change = {k: v for k, v in (ctx.control or {}).items() if k not in ("logits", "reference")}
    return compute.replace(**change) if change else compute


def lower_logits(ctx: Context, pipe) -> None:
    """A lower step that ``calibrate.py`` can run in the program itself
    (``{"logits": ...}``; no configuration's control): the program's
    logits product one precision step below the configuration's, in place
    in the pipeline's prepared tables before its first batch. ``"int4"`` (below int8 logits): kernel A's logits
    table requantized to codes in [-7, 7] with absmax/7 scales a 32-row
    block; ``"float8_e4m3fn"`` (below bf16 logits): the tied embedding
    rounded to float8 a row."""
    kind = (ctx.control or {}).get("logits")
    if kind is None:
        return
    dec = pipe.params["decoder"]
    if kind == "int4":
        q = dec["tok_emb_q"]
        w = (q["qw"].float().reshape(-1, 32, q["qw"].shape[1]) * q["scales"][:, None, :])
        s4 = torch.clamp_min(w.abs().amax(dim=1), 1e-12) / 7.0
        q["qw"].copy_(torch.clamp(torch.round(w / s4[:, None, :]), -7, 7).to(torch.int8).reshape(q["qw"].shape))
        q["scales"].copy_(s4)
    elif kind == "float8_e4m3fn":
        from benchmark.reference import to_float8

        dec["tok_emb"].copy_(to_float8(dec["tok_emb"].float()).to(dec["tok_emb"].dtype))
    else:
        raise ValueError(f"unknown logits control {kind!r}")


def build_program(ctx: Context, beam_width: int, max_tokens: int):
    """The port's ``WhisperPipeline`` over the benchmark's weights (drawn
    on the device from the seed), its kernels built or loaded."""
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    if ctx.device.type == "cuda":
        from whisper_burn_tpu_torch.ops import _build

        _build.build_all()
    from benchmark.weights import make_weights

    s = ctx.shape
    cfg = WhisperConfig(n_mels=s.n_mels, n_audio_ctx=s.n_audio_ctx, n_audio_state=s.d_model, n_audio_head=s.heads,
                        n_audio_layer=s.encoder_layers, n_text_ctx=s.n_text_ctx, n_text_state=s.d_model,
                        n_text_head=s.heads, n_text_layer=s.decoder_layers, n_vocab=s.n_vocab, n_lang=s.n_lang)
    weights = make_weights(s, ctx.seed, ctx.device)
    pipe = WhisperPipeline((cfg, weights), compute=program_compute(ctx), max_tokens=max_tokens,
                           beam_width=beam_width, device=ctx.device)
    lower_logits(ctx, pipe)
    return pipe


def free_program() -> None:
    """Drop the program's runners, caches and graphs."""
    from whisper_burn_tpu_torch.models.whisper import clear_runners

    clear_runners()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


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
    """The reference's judgement of ``n`` of the served requests, each
    compared number beside the cell's limit. Runs after the program is
    freed, over the weights drawn again from the seed. Where the run's
    control is the reference's (``{"reference": "float8_e4m3fn"}``: the
    reference computed a precision step below the configuration), the
    numbers compared are the control's, read over the same requests."""
    from benchmark.reference import Numerics, Reference, judge
    from benchmark.weights import make_weights

    sample = sample_served(served, ctx.seed, n)
    if not sample:
        return {"correct": False, "compared": {}, "why": "no request was served in the window"}
    weights, numerics = make_weights(ctx.shape, ctx.seed, ctx.device), Numerics.of(ctx.config["compute"])
    lowered = (ctx.control or {}).get("reference")
    if lowered not in (None, "float8_e4m3fn"):
        raise ValueError(f"unknown reference control {lowered!r}")
    control = Reference(ctx.shape, weights, numerics, lowered=True) if lowered else None
    readings = judge(Reference(ctx.shape, weights, numerics), sample, ctx.device, keep, control)
    side = "control_" if control is not None else ""
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
