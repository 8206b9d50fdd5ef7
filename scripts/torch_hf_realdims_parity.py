"""Token parity of the PyTorch/CUDA port against HF ``generate()`` at
Large-V3 width, offline, on the CPU.

    python3 scripts/torch_hf_realdims_parity.py [--layers 4] [--max-new 64] \\
        [--batch 4] [--beam 2] [--seed 0] [--out HF_PARITY_TORCH]

The protocol of ``eval/hf_oracle.py`` at D 1280, 20 heads (64 wide), 128
mels, vocab 51866, 1500 audio frames and ``--layers`` encoder and decoder
layers (4 + 4 by default: every width the kernels see is Large-V3's, the
CPU oracle's cost kept small). The port's intake path (HF state dict ->
``convert_state_dict`` -> Q4_0 GGUF -> ``load_whisper_from_gguf`` ->
``prepare_params``) feeds ``greedy_decode``; the same GGUF dequantized back
into the HF model makes ``generate()`` an independent implementation of
the greedy protocol over the same weights:

* ``Compute.parity()`` must match HF token for token;
* each serving mode records its agreement with the same HF trajectories,
  and with the port's own bf16 trajectory (``vs_bf16``). After a single
  near-tie flip a greedy trajectory on random weights differs everywhere,
  so each row is also teacher-forced along HF's trajectory
  (``eval/quant_accuracy``): its per-step agreement with the f32 logits
  there, and the f32 top-2 logit margin at each stream's first
  divergence, tell a near-tie flip from a fault of a cache mode;
* with ``--beam W > 1``, ``beam_decode`` against HF beam search; where a
  row's best hypothesis differs from HF's, both hypotheses are scored
  teacher-forced, in f32 and in the row's own compute, as the beam scores
  them: whether f32 ranks HF's first by a hair while the row's compute
  ranks its own first (the precision reordered a near-tie) or the row's
  compute too ranks HF's first (its beam lost the better hypothesis). The
  row's beam is then stepped eagerly to find the step at which HF's
  prefix left its W live beams, and the margin there to the W-th beam
  kept, in the row's compute and in f32: a pruning near-tie or a fault;
* the mel frontend against ``WhisperFeatureExtractor`` at 128 mels.

Runs on the CPU (``device="cpu"``, the plain versions): the HF side has no
card to run on. The audio is synthetic (noise, a tone pair, a chirp,
amplitude-modulated noise), made from ``--seed``. Writes ``<out>.json``
and ``<out>.md``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import platform
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from whisper_burn_tpu_torch.audio.mel import MelFrontend  # noqa: E402
from whisper_burn_tpu_torch.eval.quant_accuracy import compare_variant, forced_logits  # noqa: E402
from whisper_burn_tpu_torch.eval.hf_oracle import (  # noqa: E402
    agreement,
    build_hf_fixture,
    convert_and_load,
    hf_generate_greedy,
    writeback_gguf_to_hf,
)
from whisper_burn_tpu_torch.models import beam as beam_mod  # noqa: E402
from whisper_burn_tpu_torch.models.beam import beam_decode  # noqa: E402
from whisper_burn_tpu_torch.models.config import EOT, MIN_TOKENS  # noqa: E402
from whisper_burn_tpu_torch.models.params import params_to_torch  # noqa: E402
from whisper_burn_tpu_torch.models.whisper import clear_runners, greedy_decode, self_cache_len  # noqa: E402
from whisper_burn_tpu_torch.ops.compute import Compute  # noqa: E402
from whisper_burn_tpu_torch.transcribe import prepare_params  # noqa: E402

CHUNK = 480_000  # 30 s at 16 kHz
SERVING = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
ROWS = {  # row: (compute, description)
    "parity_f32": (Compute.parity(), "f32"),
    "fast_bf16": (Compute.fast(), "bf16, bf16 caches"),
    "serving_int8kv": (Compute.fastest(), "bf16, int8 self + cross KV"),
    "serving_default_int4cross_q8log_w8a8": (SERVING, "bf16, int8 self + int4 cross, int8 logits, W8A8"),
    "serving_int4self": (SERVING.replace(self_kv_bits=4), "serving + int4-group self KV (opt-in)"),
    "serving_mixed_8k4v": (SERVING.replace(self_kv_vbits=4), "serving + int8-K/int4-V self KV (opt-in)"),
}
BEAM_ROWS = {
    "beam_parity_f32": (Compute.parity(), "beam search, f32"),
    "beam_fast_bf16": (Compute.fast(), "beam search, bf16"),
    "beam_serving_int8kv": (Compute.fastest(), "beam search, bf16, int8 self + cross KV"),
    "beam_serving_no_q8log": (SERVING.replace(quantized_logits=False), "beam search, serving minus int8 logits"),
    "beam_serving_int8cross": (Compute.fastest().replace(quantized_logits=True, w8a8=True),
                               "beam search, serving with int8 (not int4) cross KV"),
    "beam_serving_default": (SERVING, "beam search, the full serving compute"),
}


def synthetic_audio(b: int, seed: int) -> np.ndarray:
    """``b`` seeded 30 s rows: noise, a tone pair, a chirp, modulated noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(CHUNK, dtype=np.float32) / 16000.0
    gens = [
        lambda: (rng.standard_normal(CHUNK) * 0.05).astype(np.float32),
        lambda: (0.1 * np.sin(2 * np.pi * 220 * t) + 0.05 * np.sin(2 * np.pi * 523 * t)).astype(np.float32),
        lambda: (0.1 * np.sin(2 * np.pi * (100 + 40 * t) * t)).astype(np.float32),
        lambda: (rng.standard_normal(CHUNK) * 0.1 * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32),
    ]
    return np.stack([gens[i % len(gens)]() for i in range(b)])


def first_divergence(ours: np.ndarray, n_gen: int, theirs: np.ndarray) -> int:
    """The first step where the two trajectories differ (-1: none within
    the shorter one)."""
    return next((i for i in range(min(int(n_gen), len(theirs))) if int(ours[i]) != int(theirs[i])), -1)


def score(ours: np.ndarray, n_gen: np.ndarray, theirs: list) -> dict:
    agr = [agreement(ours[i], n_gen[i], theirs[i]) for i in range(len(theirs))]
    exact = all(int(n_gen[i]) == len(theirs[i]) and np.array_equal(ours[i][: n_gen[i]], theirs[i])
                for i in range(len(theirs)))
    return {"agreement_mean": float(np.mean(agr)), "agreement_min": float(np.min(agr)), "token_exact": bool(exact),
            "per_stream": agr, "first_divergence_vs_hf": [first_divergence(ours[i], n_gen[i], theirs[i])
                                                          for i in range(len(theirs))]}


def padded(seqs: list, steps: int) -> torch.Tensor:
    """Generated ids per stream, EOT-filled to ``[B, steps]`` int32."""
    out = torch.full((len(seqs), steps), EOT, dtype=torch.int32)
    for i, t in enumerate(seqs):
        out[i, : len(t)] = torch.from_numpy(np.asarray(t, np.int32))
    return out


def token_logprobs(params, cfg, mel, langs, tokens: torch.Tensor, comp, steps: int) -> torch.Tensor:
    """``[steps, B]`` float64: each sample's log-prob teacher-forced along
    ``tokens`` in ``comp``, EOT suppressed below ``MIN_TOKENS`` as the
    beam suppresses it."""
    lg = forced_logits(params, cfg, mel, langs, tokens, comp, steps)[:, :, : cfg.n_vocab].double()
    lg[:MIN_TOKENS, :, EOT] = float("-inf")
    return torch.log_softmax(lg, dim=-1).gather(-1, tokens[:, :steps].T.long()[..., None])[..., 0]


def hypothesis_scores(params, cfg, mel, langs, tokens: torch.Tensor, lengths: list, comp, steps: int) -> np.ndarray:
    """Each stream's hypothesis (its first ``lengths[i]`` samples of
    ``tokens``, then EOT where it stopped before ``steps``) scored as the
    beam scores it with length penalty 1 (``models/beam``): its samples'
    log-probs teacher-forced in ``comp``, plus the EOT's where it stopped,
    over its length, the EOT counted."""
    lp = token_logprobs(params, cfg, mel, langs, tokens, comp, steps)
    out = []
    for i, n in enumerate(lengths):
        ended = n < steps  # its EOT is tokens[i, n]
        out.append(float(lp[: n + ended, i].sum()) / (n + ended))
    return np.array(out)


def pruning(params, parity_params, cfg, mel, langs, comp, width: int, steps: int, hf: torch.Tensor,
            streams: list) -> dict:
    """Step the row's beam eagerly (``models/beam.beam_step``, as
    ``beam_decode`` runs it) and find, for each of ``streams``, the first
    sample #k after which no live beam holds HF's prefix ``hf[i, :k+1]``.
    There: HF's prefix's cumulative log-prob (its parent beam's score plus
    the sample's teacher-forced log-prob) minus the W-th live beam's score,
    in the row's compute (``own_margin``; negative: pruned) and in f32
    (both prefixes teacher-forced; ``f32_margin``, positive: f32 keeps
    HF's). ``None`` where HF's prefix stays live to the end."""
    b = mel.shape[0]
    own_lp = token_logprobs(params, cfg, mel, langs, hf, comp, steps)
    state = beam_mod.new_beam_state(cfg, comp, b, width, self_cache_len(cfg, steps), steps, mel.device)
    beam_mod.start_beam_request(params, cfg, mel, langs, comp, state, detect=False, task="transcribe")
    found, parent_sc = {}, {i: 0.0 for i in streams}
    for k in range(steps):
        if k > 0:
            beam_mod.beam_step(params, cfg, state, comp, (k - 1) % 2, length_penalty=1.0, early_stopping=False)
        rows = state.tokens.reshape(b, width, steps)
        scores = state.scores.reshape(b, width)
        for i in [i for i in streams if i not in found]:
            live = (rows[i, :, : k + 1] == hf[i, : k + 1]).all(dim=1)
            if live.any():
                parent_sc[i] = float(scores[i][live][0])
                continue
            kept = int(scores[i].argmin())
            found[i] = {"sample": k, "hf_token": int(hf[i, k]), "kept_prefix_last": int(rows[i, kept, k]),
                        "own_margin": parent_sc[i] + float(own_lp[k, i]) - float(scores[i, kept]),
                        "kept": rows[i, kept, : k + 1].clone()}
        if len(found) == len(streams):
            break
    out = {}
    for i in streams:
        if i not in found:
            out[i] = None
            continue
        f = found.pop(i)
        k = f["sample"]
        kept = hf.clone()
        kept[i, : k + 1] = f.pop("kept")
        f32_hf = token_logprobs(parity_params, cfg, mel, langs, hf, Compute.parity(), k + 1)[:, i].sum()
        f32_kept = token_logprobs(parity_params, cfg, mel, langs, kept, Compute.parity(), k + 1)[:, i].sum()
        out[i] = {**f, "f32_margin": float(f32_hf - f32_kept)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--beam", type=int, default=2, help="beam width of the beam leg (<= 1 skips it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="HF_PARITY_TORCH")
    args = ap.parse_args()
    import transformers

    t0 = time.time()
    print(f"[1/5] HF fixture: D=1280, 20 heads, 128 mels, vocab 51866, {args.layers}+{args.layers} layers",
          flush=True)
    hf = build_hf_fixture(enc_layers=args.layers, dec_layers=args.layers, seed=args.seed)
    print("[2/5] convert -> Q4_0 GGUF -> load -> write back", flush=True)
    blob, loaded = convert_and_load(hf)
    writeback_gguf_to_hf(hf, blob)
    cfg = loaded.config.replace(gelu="erf")
    assert (cfg.n_audio_state, cfg.n_audio_head, cfg.n_mels, cfg.n_vocab) == (1280, 20, 128, 51866)

    print("[3/5] mel frontend against WhisperFeatureExtractor", flush=True)
    audio = synthetic_audio(args.batch, args.seed)
    mel = MelFrontend(n_mels=128, norm="slaney")(torch.from_numpy(audio)).numpy()
    fe = transformers.WhisperFeatureExtractor(feature_size=128)
    fe_mel = fe(list(audio), sampling_rate=16000, return_tensors="np", padding="max_length")["input_features"]
    n = min(mel.shape[-1], fe_mel.shape[-1])
    mel_diff = float(np.max(np.abs(mel[..., :n] - fe_mel[..., :n])))
    print(f"    max |ours - HF| = {mel_diff:.2e}", flush=True)

    print("[4/5] HF generate", flush=True)
    langs = np.full((args.batch,), cfg.lang_token_start, np.int32)  # <|en|>
    t_hf = time.time()
    theirs = hf_generate_greedy(hf, cfg, mel, langs, max_new=args.max_new)
    hf_s = time.time() - t_hf
    beam_theirs, beam_hf_s = None, 0.0
    if args.beam > 1:
        t_hf = time.time()
        beam_theirs = hf_generate_greedy(hf, cfg, mel, langs, max_new=args.max_new, num_beams=args.beam)
        beam_hf_s = time.time() - t_hf
    print(f"    {hf_s:.0f} s greedy (lens {[len(x) for x in theirs]}), {beam_hf_s:.0f} s beam", flush=True)
    del hf
    gc.collect()

    print("[5/5] the port's rows", flush=True)
    raw = params_to_torch(loaded.params, "cpu")
    mel_t, langs_t = torch.from_numpy(mel), torch.from_numpy(langs)
    # HF's trajectory (EOT-filled), and the f32 logits teacher-forced along it
    hf_tokens = torch.full((args.batch, args.max_new), EOT, dtype=torch.int32)
    for i, t in enumerate(theirs):
        hf_tokens[i, : len(t)] = torch.from_numpy(t.astype(np.int32))
    parity = Compute.parity()
    hf_lg = forced_logits(prepare_params(raw, parity), cfg, mel_t, langs_t, hf_tokens, parity,
                          args.max_new)[:, :, : cfg.n_vocab]
    hf_valid = torch.arange(args.max_new)[:, None] < torch.tensor([max(len(t), 1) for t in theirs])[None, :]
    top2 = hf_lg.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()  # [steps, B], f32 logits along HF's trajectory
    rows, tokens_by_row = {}, {}
    for name, (comp, _) in ROWS.items():
        t_row = time.time()
        params = prepare_params(raw, comp)
        res = greedy_decode(params, cfg, mel_t, langs_t, comp, max_tokens=args.max_new)
        clear_runners()
        tokens_by_row[name] = (res.tokens.numpy(), res.n_generated.numpy())
        rows[name] = score(*tokens_by_row[name], theirs)
        forced = compare_variant(hf_lg, hf_valid, params, cfg, mel_t, langs_t, hf_tokens, comp, args.max_new)
        rows[name].update(teacher_forced_agreement=forced["token_agreement"], norm_drift=forced["norm_drift"],
                          f32_margin_at_divergence=[None if d < 0 else float(margin[d, i]) for i, d in
                                                    enumerate(rows[name]["first_divergence_vs_hf"])],
                          wall_s=time.time() - t_row)
        del params
        print(f"    {name}: mean {rows[name]['agreement_mean']:.4f} exact {rows[name]['token_exact']} "
              f"div@{rows[name]['first_divergence_vs_hf']} margin {rows[name]['f32_margin_at_divergence']} "
              f"forced {forced['token_agreement']:.4f} ({rows[name]['wall_s']:.0f} s)", flush=True)
    bf16_tokens, bf16_n = tokens_by_row["fast_bf16"]
    for name, r in rows.items():
        vs = score(*tokens_by_row[name], [bf16_tokens[i][: int(bf16_n[i])] for i in range(args.batch)])
        r["vs_bf16_mean"], r["vs_bf16_min"] = vs["agreement_mean"], vs["agreement_min"]
    beam_rows = {}
    if beam_theirs is not None:
        hf_beam = padded(beam_theirs, args.max_new)
        hf_lens = [len(t) for t in beam_theirs]
        f32_hf = hypothesis_scores(prepare_params(raw, parity), cfg, mel_t, langs_t, hf_beam, hf_lens, parity,
                                   args.max_new)
        for name, (comp, _) in BEAM_ROWS.items():
            t_row = time.time()
            params = prepare_params(raw, comp)
            res = beam_decode(params, cfg, mel_t, langs_t, comp, beam_width=args.beam, max_tokens=args.max_new)
            clear_runners()
            beam_rows[name] = score(res.tokens.numpy(), res.n_generated.numpy(), beam_theirs)
            if not beam_rows[name]["token_exact"]:
                # HF's hypothesis minus the row's, scored in f32 and in the row's compute
                ours, lens = res.tokens, [int(n) for n in res.n_generated]
                f32_ours = hypothesis_scores(prepare_params(raw, parity), cfg, mel_t, langs_t, ours, lens, parity,
                                             args.max_new)
                own_hf = hypothesis_scores(params, cfg, mel_t, langs_t, hf_beam, hf_lens, comp, args.max_new)
                own_ours = hypothesis_scores(params, cfg, mel_t, langs_t, ours, lens, comp, args.max_new)
                div = beam_rows[name]["first_divergence_vs_hf"]
                differs = [d >= 0 or lens[i] != hf_lens[i] for i, d in enumerate(div)]
                pruned = pruning(params, prepare_params(raw, parity), cfg, mel_t, langs_t, comp, args.beam,
                                 args.max_new, hf_beam, [i for i in range(args.batch) if differs[i]])
                beam_rows[name].update(
                    f32_score_gap=[float(f32_hf[i] - f32_ours[i]) if differs[i] else None for i in range(args.batch)],
                    own_score_gap=[float(own_hf[i] - own_ours[i]) if differs[i] else None for i in range(args.batch)],
                    hf_prefix_pruned=[pruned.get(i) for i in range(args.batch)])
            beam_rows[name]["wall_s"] = time.time() - t_row
            del params
            print(f"    {name}: mean {beam_rows[name]['agreement_mean']:.4f} "
                  f"exact {beam_rows[name]['token_exact']} div@{beam_rows[name]['first_divergence_vs_hf']} "
                  f"f32 gap {beam_rows[name].get('f32_score_gap')} own gap {beam_rows[name].get('own_score_gap')} "
                  f"pruned {beam_rows[name].get('hf_prefix_pruned')} "
                  f"({beam_rows[name]['wall_s']:.0f} s)", flush=True)

    host = f"{platform.machine()}, {os.cpu_count()} cores, torch {torch.__version__} (CPU run: no device figure)"
    payload = {
        "protocol": "eval/hf_oracle at Large-V3 width (scripts/torch_hf_realdims_parity.py)",
        "dims": {"d_model": 1280, "n_heads": 20, "n_mels": 128, "vocab": 51866, "layers": args.layers,
                 "n_audio_ctx": 1500},
        "batch": args.batch, "max_new": args.max_new, "seed": args.seed, "device": "cpu", "host": host,
        "audio": "synthetic: noise, 220+523 Hz tones, 100 Hz chirp, 3 Hz modulated noise",
        "gguf_mb": len(blob) / 1e6, "mel_max_abs_diff_vs_hf_extractor": mel_diff,
        "hf_generate_lens": [len(x) for x in theirs], "hf_generate_s": hf_s, "rows": rows,
        "beam": {"width": args.beam, "hf_generate_s": beam_hf_s, "rows": beam_rows} if beam_rows else None,
        "wall_s": time.time() - t0,
    }
    with open(args.out + ".json", "w") as f:
        json.dump(payload, f, indent=1)
    md = [
        "# HF_PARITY_TORCH — the port against HF generate at Large-V3 width (offline, CPU)",
        "",
        f"A random-init HF Whisper at Large-V3 width (D 1280, 20 heads, 128 mels, vocab 51866, 1500 frames), "
        f"{args.layers}+{args.layers} layers, through the port's intake (convert -> Q4_0 GGUF -> loader -> "
        "prepare_params); the same GGUF dequantized back into HF, so both run the same weights "
        "(whisper_burn_tpu_torch/eval/hf_oracle.py). HF `generate()` decodes the same greedy protocol "
        "independently.",
        "",
        f"{args.batch} streams x {args.max_new} max tokens of synthetic audio ({payload['audio']}). "
        f"Run on the CPU ({host}); its walls are host walls. HF oracle lengths: {payload['hf_generate_lens']}.",
        "",
        f"Mel frontend against `WhisperFeatureExtractor` (128 mels): max abs diff **{mel_diff:.2e}**.",
        "",
        "| row | compute | token-exact | vs HF mean / min | vs our bf16 mean / min | first divergence "
        "| f32 top-2 margin there | teacher-forced agreement |",
        "|---|---|---|---|---|---|---|---|",
    ]
    gaps = lambda gs: "[" + ", ".join("—" if g is None else f"{g:+.4f}" for g in gs) + "]"
    fmt = lambda ms: "[" + ", ".join("—" if m is None else f"{m:.3g}" for m in ms) + "]"
    for name, r in rows.items():
        md.append(f"| {name} | {ROWS[name][1]} | {'**yes**' if r['token_exact'] else 'no'} | "
                  f"{r['agreement_mean']:.4f} / {r['agreement_min']:.4f} | "
                  f"{r['vs_bf16_mean']:.4f} / {r['vs_bf16_min']:.4f} | {r['first_divergence_vs_hf']} | "
                  f"{fmt(r['f32_margin_at_divergence'])} | {r['teacher_forced_agreement']:.4f} |")
    for name, r in beam_rows.items():
        md.append(f"| {name} (W={args.beam}) | {BEAM_ROWS[name][1]} | {'**yes**' if r['token_exact'] else 'no'} | "
                  f"{r['agreement_mean']:.4f} / {r['agreement_min']:.4f} | — | {r['first_divergence_vs_hf']} "
                  "| — | — |")
    if any("f32_score_gap" in r for r in beam_rows.values()):
        md += ["", "Beam rows whose best hypothesis differs from HF's: HF's hypothesis minus the row's, each "
               "scored as the beam scores it (log-probs teacher-forced, over the length; length penalty 1), in "
               "f32 and in the row's own compute. A small positive f32 gap with a negative own gap is a near-tie "
               "that the row's precision reordered; a positive own gap means the row's beam lost a "
               "hypothesis that its own logits rank higher, a search error. The last columns say where: the "
               "first sample after which HF's prefix held no live beam of the row's, and HF's prefix's "
               "cumulative log-prob there minus the W-th live beam's, in the row's compute (negative: pruned) "
               "and in f32 (positive: f32 keeps HF's). Both small: a near-tie at the pruning boundary that "
               "the precision flipped.", "",
               "| row | f32 score gap per stream | own-compute score gap per stream | HF's prefix pruned at sample "
               "| own margin there | f32 margin there |", "|---|---|---|---|---|---|"]
        cell = lambda ps, key, f: "[" + ", ".join("—" if p is None else f(p[key]) for p in ps) + "]"
        for name, r in beam_rows.items():
            if "f32_score_gap" in r:
                ps = r["hf_prefix_pruned"]
                md.append(f"| {name} | {gaps(r['f32_score_gap'])} | {gaps(r['own_score_gap'])} | "
                          f"{cell(ps, 'sample', str)} | {cell(ps, 'own_margin', '{:+.4f}'.format)} | "
                          f"{cell(ps, 'f32_margin', '{:+.4f}'.format)} |")
    md += [
        "",
        "The f32 row must be token-exact. A greedy trajectory on random weights differs everywhere after a "
        "single near-tie flip, so a serving row's `vs HF` agreement counts from its first divergence; "
        "`vs our bf16` scores it against the port's own bf16 trajectory; the f32 top-2 logit margin at the "
        "divergence (the logits' std is about 1) and the row's teacher-forced agreement along HF's "
        "trajectory (eval/quant_accuracy) say whether a near-tie flipped. Beam rows score `beam_decode` "
        "against HF `generate(num_beams=W)` over the same weights. Generated by "
        "`python3 scripts/torch_hf_realdims_parity.py`.",
        "",
    ]
    with open(args.out + ".md", "w") as f:
        f.write("\n".join(md))
    print(json.dumps({"ok": rows["parity_f32"]["token_exact"], "wall_s": payload["wall_s"]}))
    return 0 if rows["parity_f32"]["token_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
