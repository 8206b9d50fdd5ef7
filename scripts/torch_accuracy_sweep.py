"""What each quantized serving mode of the PyTorch/CUDA port costs in
agreement, at a real model's width and depth.

    python3 scripts/torch_accuracy_sweep.py --config large_v3 --seeds 2 \\
        --steps 64 --batch 4 --fixture host [--rows all] [--only a,b] \\
        [--device cuda] [--out ACCURACY_TORCH]

Two references separate the two axes:

* the serving rows: each variant of ``eval/quant_accuracy.VARIANTS`` is
  teacher-forced along the greedy trajectory of ``Compute.parity()`` on
  the SAME Q4_0 weights, so a disagreement is the variant's caches and
  compute, not the weights. ``_struct`` rows do the same on the peaked
  fixture (``models/params.structured_params``). Floors:
  ``quant_accuracy.FLOORS``, ``OPT_FLOORS``, ``STRUCT_FLOORS``;
* ``weight_q4``: Q4_0 weights against f32 weights, both at f32 compute
  (iid weights at a 51k vocab give a flat logit surface, so its agreement
  is tie-breaking noise and only its drift is bounded), and
  ``weight_q4_struct``, the same on the peaked fixture.

``--fixture host`` draws the weights with numpy, the JAX package's own
fixtures for each seed (``ACCURACY.json``'s are seeds 0 and 1), and makes
the Q4 member of each matched f32/Q4 pair on the device with
``repack_f32``'s arithmetic; ``device`` draws them on the device from a
``torch.Generator`` (other numbers for the same seed, seconds instead of
minutes). Mel and language tokens come from numpy's ``default_rng(1000 +
seed)`` as in ``scripts/accuracy_sweep.py``. The device defaults to
``cuda``. ``--rows`` picks a subset (serving, weight, struct,
serving_struct) and ``--only`` a set of serving variants. Results go to
``<out>.json`` and ``<out>.md`` after every seed; their header names the
card and its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from whisper_burn_tpu_torch.eval.quant_accuracy import VARIANTS, compare_variant, reference_run  # noqa: E402
from whisper_burn_tpu_torch.models.config import WhisperConfig  # noqa: E402
from whisper_burn_tpu_torch.models.params import (  # noqa: E402
    device_random_params,
    quantize_linears,
    random_params,
    structured_params,
)
from whisper_burn_tpu_torch.models.whisper import clear_runners  # noqa: E402
from whisper_burn_tpu_torch.ops.compute import Compute, resolve_device  # noqa: E402
from whisper_burn_tpu_torch.transcribe import prepare_params  # noqa: E402

CONFIGS = {
    "large_v3": WhisperConfig.large_v3,
    "turbo": WhisperConfig.large_v3_turbo,
    "medium": WhisperConfig.medium,
    "tiny": lambda: WhisperConfig.tiny_test().replace(n_audio_ctx=16, n_text_ctx=64),
}
ROWS = ("all", "serving", "weight", "struct", "serving_struct")
META = {  # row: (reference, compute, KV cache)
    "q4_bf16": ("q4 @ f32", "bf16", "bf16"),
    "q4_int8kv": ("q4 @ f32", "bf16", "int8 self + int8 cross"),
    "q4_int4kv": ("q4 @ f32", "bf16", "int8 self + int4 cross"),
    "q4_int4kv_q8log": ("q4 @ f32", "bf16 + int8 logits", "int8 self + int4 cross"),
    "q4_w8a8": ("q4 @ f32", "bf16 + W8A8", "int8 self + int4 cross"),
    "q4_int4selfkv": ("q4 @ f32", "bf16", "int4-group self + int4 cross"),
    "q4_int4selfkv_full": ("q4 @ f32", "bf16 + int8 logits + W8A8", "int4-group self + int4 cross"),
    "q4_selfv4": ("q4 @ f32", "bf16", "int8-K/int4-V self + int4 cross"),
    "q4_selfv4_full": ("q4 @ f32", "bf16 + int8 logits + W8A8", "int8-K/int4-V self + int4 cross"),
    "weight_q4": ("f32 weights (iid)", "f32", "f32"),
    "weight_q4_struct": ("f32 weights (peaked fixture)", "f32", "f32"),
}


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[torch.cuda.current_device() if device.index is None else device.index]


def f32_fixture(cfg, seed: int, structured: bool, fixture: str, device: torch.device) -> dict:
    """The f32 member of the seed's matched pair, on ``device``."""
    if fixture == "device":
        return device_random_params(cfg, seed, quantized=False, structured=structured, device=device)
    draw = structured_params if structured else random_params
    return draw(cfg, seed, quantized=False, device=device)  # the numpy arrays go with the call


def free(device: torch.device) -> None:
    """Drop the seed's runners and whatever they held."""
    clear_runners()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run_sweep(cfg_name: str, seeds: int, steps: int, batch: int, device, fixture: str = "host", on_seed=None,
              rows: str = "all", only: set[str] | None = None) -> dict:
    """The rows of ``rows`` for seeds ``0 .. seeds - 1``; ``on_seed`` gets
    the summary so far after every seed."""
    device = resolve_device(device)
    cfg = CONFIGS[cfg_name]()
    variants = {k: v for k, v in VARIANTS.items() if not only or k in only}
    ref_compute = Compute.parity()
    do_serving, do_weight = rows in ("all", "serving"), rows in ("all", "weight")
    do_struct, do_serving_struct = rows in ("all", "struct"), rows in ("all", "serving_struct")
    acc: dict[str, list] = {}
    if do_serving:
        acc.update((k, []) for k in variants)
    if do_serving_struct:
        acc.update((k + "_struct", []) for k in variants)
    if do_weight:
        acc["weight_q4"] = []
    if do_struct:
        acc["weight_q4_struct"] = []
    t_all = time.perf_counter()

    def serving_rows(q4: dict, mel, langs, suffix: str) -> None:
        ref_tokens, ref_lg, valid = reference_run(prepare_params(q4, ref_compute), cfg, mel, langs, ref_compute,
                                                  steps)
        for name, comp in variants.items():
            row = compare_variant(ref_lg, valid, prepare_params(q4, comp), cfg, mel, langs, ref_tokens, comp, steps)
            acc[name + suffix].append(dict(seed=seed, **row))

    def weight_row(f32: dict, q4: dict, mel, langs, name: str) -> None:
        ref_tokens, ref_lg, valid = reference_run(prepare_params(f32, ref_compute), cfg, mel, langs, ref_compute,
                                                  steps)
        row = compare_variant(ref_lg, valid, prepare_params(q4, ref_compute), cfg, mel, langs, ref_tokens,
                              ref_compute, steps)
        acc[name].append(dict(seed=seed, **row))

    for seed in range(seeds):
        t0 = time.perf_counter()
        rng = np.random.default_rng(1000 + seed)
        mel = torch.from_numpy(rng.standard_normal((batch, cfg.n_mels, cfg.n_audio_ctx * 2)).astype(np.float32))
        langs = torch.from_numpy(rng.integers(cfg.lang_token_start, cfg.lang_token_end, size=batch).astype(np.int32))
        mel, langs = mel.to(device), langs.to(device)
        for structured, serve, weigh in ((False, do_serving, do_weight), (True, do_serving_struct, do_struct)):
            if not (serve or weigh):
                continue
            f32 = f32_fixture(cfg, seed, structured, fixture, device)
            q4 = quantize_linears(f32)
            if weigh:
                weight_row(f32, q4, mel, langs, "weight_q4_struct" if structured else "weight_q4")
            del f32
            free(device)
            if serve:
                serving_rows(q4, mel, langs, "_struct" if structured else "")
            del q4
            free(device)
        print(f"seed {seed} done in {time.perf_counter() - t0:.1f}s: "
              + ", ".join(f"{k}={v[-1]['token_agreement']:.4f}" for k, v in acc.items()), file=sys.stderr, flush=True)
        if on_seed is not None:
            on_seed(summarize(acc, cfg_name, seed + 1, steps, batch, fixture, device, time.perf_counter() - t_all))
    return summarize(acc, cfg_name, seeds, steps, batch, fixture, device, time.perf_counter() - t_all)


def summarize(acc: dict, cfg_name: str, seeds: int, steps: int, batch: int, fixture: str, device: torch.device,
              wall_s: float) -> dict:
    variants = {}
    for name, rows in acc.items():
        agree = [r["token_agreement"] for r in rows]
        variants[name] = dict(
            token_agreement_mean=float(np.mean(agree)),
            token_agreement_min=float(np.min(agree)),
            max_logit_drift=float(np.max([r["max_logit_drift"] for r in rows])),
            norm_drift_max=float(np.max([r["norm_drift"] for r in rows])),
            per_seed=rows,
        )
    return dict(
        config=cfg_name, seeds=seeds, steps=steps, batch=batch, fixture=fixture,
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        card=card_line(device), torch=torch.__version__, cuda=torch.version.cuda, wall_s=wall_s,
        variants=variants,
    )


def write_outputs(result: dict, out: str) -> None:
    with open(out + ".json", "w") as f:
        json.dump(result, f, indent=1)
    jax_rows = {}
    jax_json = ROOT / "ACCURACY.json"
    if result["fixture"] == "host" and jax_json.exists():
        jax_rows = json.loads(jax_json.read_text())["variants"]
    lines = [
        "# ACCURACY_TORCH — the PyTorch/CUDA port's quantization sweep",
        "",
        f"Card: `{result['card']}` (nvidia-smi name, power limit); torch {result['torch']}, CUDA {result['cuda']}.",
        f"Config **{result['config']}** at full width and depth, {result['seeds']} seeds x {result['batch']} "
        f"streams x {result['steps']} teacher-forced steps per row, `{result['fixture']}` fixtures, "
        f"{result['wall_s']:.1f} s. Generated by `python3 scripts/torch_accuracy_sweep.py` "
        "(whisper_burn_tpu_torch/eval/quant_accuracy.py).",
        "",
        "Serving rows: reference = the SAME Q4_0 weights at `Compute.parity()` (f32, TF32 off), so a "
        "disagreement is the variant's caches and compute. `weight_q4` compares Q4_0 with f32 weights "
        "(iid weights: a flat logit surface, its agreement is tie-breaking noise); `_struct` rows use the "
        "peaked fixture. Floors: tests/test_torch_accuracy.py.",
        "",
        "| row | reference | compute | KV cache | agreement mean / min | per seed | max logit drift "
        "| drift / ref-logit-std | ACCURACY.json mean / per seed (TPU) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for name, s in result["variants"].items():
        struct = name.endswith("_struct") and name != "weight_q4_struct"
        ref, comp, kv = META[name.removesuffix("_struct") if struct else name]
        ref = "q4s @ f32" if struct else ref
        per_seed = ", ".join(f"{r['token_agreement']:.4f}" for r in s["per_seed"])
        j = jax_rows.get(name)
        jax_cell = (f"{j['token_agreement_mean']:.4f} / "
                    + ", ".join(f"{r['token_agreement']:.4f}" for r in j["per_seed"])) if j else "—"
        lines.append(f"| {name} | {ref} | {comp} | {kv} | {s['token_agreement_mean']:.4f} / "
                     f"{s['token_agreement_min']:.4f} | {per_seed} | {s['max_logit_drift']:.3f} | "
                     f"{s['norm_drift_max']:.3f} | {jax_cell} |")
    lines.append("")
    with open(out + ".md", "w") as f:
        f.write("\n".join(lines))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="large_v3", choices=sorted(CONFIGS))
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fixture", default="host", choices=["host", "device"])
    ap.add_argument("--rows", default="all", choices=ROWS)
    ap.add_argument("--only", default=None, help="comma list restricting the serving variants")
    ap.add_argument("--out", default="ACCURACY_TORCH")
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == "cuda":
        from whisper_burn_tpu_torch.ops import _build

        _build.build_all()
    result = run_sweep(args.config, args.seeds, args.steps, args.batch, device, args.fixture,
                       on_seed=lambda partial: write_outputs(partial, args.out), rows=args.rows,
                       only=set(args.only.split(",")) if args.only else None)
    write_outputs(result, args.out)
    print(json.dumps({k: v["token_agreement_mean"] for k, v in result["variants"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
