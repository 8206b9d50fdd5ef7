"""Greedy transcription: encode -> cross-KV fill -> prompt prefill -> decode loop.

Port of ``whisper_burn_tpu/models/whisper.py``.

* prompt ``[SOT, lang, TRANSCRIBE or TRANSLATE, NO_TIMESTAMPS]``
* EOT suppressed on the first sample and while fewer than MIN_TOKENS exist
* greedy argmax over the full vocab; EOT-filled after a stream stops;
  the loop ends when every stream is done or at ``max_tokens``
* language auto-detect: argmax of a ``[SOT]`` pass over the language rows

The loop makes no host sync per token: argmax and the done flags stay on
the device, positions are host integers, and whether every stream is done
is read at most once every ``DONE_CHECK_EVERY`` steps. Finished streams
emit EOT either way, so the tokens are the same as stopping at once.

Each stage runs inside a ``torch.profiler.record_function`` range named
``greedy_decode.<stage>`` (encode, cross_fill, prefill, decode), so a
profiler trace of a request splits its time by stage on the host and on
the device. :func:`encode_and_fill` and :func:`prompt_logits` are the
stages that beam search (``models/beam.py``) shares.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from whisper_burn_tpu_torch.models.config import EOT, MAX_TOKENS, MIN_TOKENS, SOT, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import (
    KVCache,
    decode_step,
    fill_cross_cache,
    init_cache,
    prefill,
)
from whisper_burn_tpu_torch.models.encoder import encode
from whisper_burn_tpu_torch.ops.compute import Compute, set_fp32_precision

PROMPT_LEN = 4
DONE_CHECK_EVERY = 16


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # int32 [B, max_tokens]; EOT-filled after stop
    n_generated: torch.Tensor  # int32 [B]; non-EOT token count per stream
    lang_tokens: torch.Tensor  # int32 [B]; the language token used


def detect_language(params: dict, cfg: WhisperConfig, cache: KVCache, compute: Compute) -> torch.Tensor:
    """Language token per stream from a 1-step ``[SOT]`` pass with the
    argmax restricted to [50259, 50259 + n_lang)."""
    if cfg.lang_token_end > cfg.n_vocab:
        raise ValueError(
            f"vocab ({cfg.n_vocab}) does not contain the language-token range "
            f"[{cfg.lang_token_start}, {cfg.lang_token_end})"
        )
    b = cache.self_v.shape[1]
    sot = torch.full((b, 1), SOT, dtype=torch.long, device=cache.self_v.device)
    lang_logits = prefill(
        params, cfg, sot, cache, compute,
        logit_rows=(cfg.lang_token_start, cfg.lang_token_end), write_cache=False,
    )
    return lang_logits.argmax(dim=-1).to(torch.int32) + cfg.lang_token_start


def encode_and_fill(
    params: dict, cfg: WhisperConfig, mel: torch.Tensor, compute: Compute, max_tokens: int, stage: str
) -> KVCache:
    """Encode mel ``[B, n_mels, 3000]`` and fill a fresh cache's cross K/V,
    in the ranges ``<stage>.encode`` and ``<stage>.cross_fill``. The self
    cache is allocated once at the full ``ctx`` (prompt + max_tokens,
    64-aligned: 256 for 224 tokens); the JAX package grows it in two
    phases, but the decode kernels read only keys below ``pos``, so the
    tokens are the same."""
    set_fp32_precision(compute)
    with record_function(f"{stage}.encode"):
        enc_out = encode(params, mel, cfg, compute)
    ctx = min(cfg.n_text_ctx, max(64, -(-(PROMPT_LEN + max_tokens) // 64) * 64))
    with record_function(f"{stage}.cross_fill"):
        cache = init_cache(cfg, mel.shape[0], compute, ctx, mel.device)
        fill_cross_cache(params, cfg, enc_out, cache, compute)
    return cache


def prompt_logits(
    params: dict, cfg: WhisperConfig, cache: KVCache, lang_tokens: torch.Tensor, compute: Compute,
    *, detect: bool, task: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill the prompt ``[SOT, lang, task, NO_TIMESTAMPS]`` into
    ``cache``; returns sample #0's logits (EOT suppressed) and the
    language tokens (entries ``< 0`` auto-detected with ``detect``)."""
    b = cache.self_v.shape[1]
    dev = cache.self_v.device
    lang_tokens = lang_tokens.to(device=dev, dtype=torch.int32)
    if detect:
        detected = detect_language(params, cfg, cache, compute)
        lang_tokens = torch.where(lang_tokens < 0, detected, lang_tokens)
    task_token = {"transcribe": cfg.transcribe_token, "translate": cfg.translate_token}[task]
    full = lambda v: torch.full((b,), v, dtype=torch.int32, device=dev)
    prompt = torch.stack(
        [full(SOT), lang_tokens, full(task_token), full(cfg.no_timestamps_token)], dim=1
    ).long()
    logits = prefill(params, cfg, prompt, cache, compute)
    logits[:, EOT] = float("-inf")  # sample #0: EOT always suppressed
    return logits, lang_tokens


def greedy_decode(
    params: dict,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    lang_tokens: torch.Tensor,
    compute: Compute,
    *,
    detect: bool = False,
    max_tokens: int = MAX_TOKENS,
    task: str = "transcribe",
) -> GreedyResult:
    """Transcribe mel ``[B, n_mels, 3000]`` to token ids, on mel's device.

    ``lang_tokens: int [B]``; with ``detect=True`` entries ``< 0`` are
    auto-detected.
    """
    b = mel.shape[0]
    cache = encode_and_fill(params, cfg, mel, compute, max_tokens, "greedy_decode")
    with record_function("greedy_decode.prefill"):
        logits, lang_tokens = prompt_logits(params, cfg, cache, lang_tokens, compute, detect=detect, task=task)
        cur = logits.argmax(dim=-1)
        tokens = torch.full((b, max_tokens), EOT, dtype=torch.int32, device=mel.device)
        tokens[:, 0] = cur.to(torch.int32)
        done = torch.zeros(b, dtype=torch.bool, device=mel.device)

    with record_function("greedy_decode.decode"):
        for k in range(1, max_tokens):
            if k % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            logits = decode_step(params, cfg, cur, PROMPT_LEN + k - 1, cache, compute)
            if k < MIN_TOKENS:
                logits[:, EOT] = float("-inf")
            nxt = torch.where(done, EOT, logits.argmax(dim=-1))
            tokens[:, k] = nxt.to(torch.int32)
            done |= nxt == EOT
            cur = nxt
        n_gen = (tokens != EOT).sum(dim=-1).to(torch.int32)
    return GreedyResult(tokens, n_gen, lang_tokens)
