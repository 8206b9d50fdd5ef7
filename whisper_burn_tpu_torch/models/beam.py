"""Batched beam-search decoding.

Port of ``whisper_burn_tpu/models/beam.py``, the same scheme:

* hypotheses live in the batch axis: ``B`` utterances x ``W`` beams are
  ``B*W`` decode streams; the self caches repeat W-fold after the prompt,
  the cross cache stays at one entry per utterance and the decode step
  shares it among the utterance's W streams (``batch_groups=W``);
* banked hypotheses (the HF/fairseq scheme): per step the top ``2W``
  candidates of each utterance are taken; EOT candidates ranked below W
  are banked into a per-utterance pool (score normalized by
  ``(k+1)**length_penalty``, k+1 counting the EOT) and the W live slots
  refill with the best non-EOT candidates; the self caches follow their
  parents by a gather along the stream axis;
* an utterance is done when its pool holds W hypotheses and (with
  ``early_stopping=False``) the best running score normalized at the
  current length cannot beat the worst banked one; done utterances freeze;
* at the token cap the still-live beams are banked at their final length
  and the best normalized hypothesis wins.

Every selection breaks ties towards the lower index, as ``jax.lax.top_k``
does: the pool keeps an existing hypothesis over a new one of equal score
because the pool comes first in the candidates it ranks.

As ``greedy_decode``, the loop makes no host sync per token: whether every
utterance is done is read once every ``DONE_CHECK_EVERY`` steps, and the
cache position is a device int32 advanced in place, which the kernels read
there. The loop runs eagerly: its cache reorder reallocates the self
caches, which a captured graph could not follow. Done
utterances are frozen, so the steps run past the moment they were all
done change nothing that the final selection reads. Stages run inside
``torch.profiler.record_function`` ranges named ``beam_decode.<stage>``
(encode, cross_fill, prefill, decode), and each step's reorder of the
live rows and self caches inside ``beam_decode.reorder``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from whisper_burn_tpu_torch.models.config import EOT, MAX_TOKENS, MIN_TOKENS, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import KVCache, decode_step
from whisper_burn_tpu_torch.models.whisper import (
    DONE_CHECK_EVERY,
    PROMPT_LEN,
    check_positions,
    encode_and_fill,
    prompt_logits,
)
from whisper_burn_tpu_torch.ops.compute import Compute

NEG_INF = -1e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # int32 [B, max_tokens] best hypothesis, EOT-filled
    n_generated: torch.Tensor  # int32 [B]
    scores: torch.Tensor  # f32 [B] length-normalized log-prob of the best hypothesis
    lang_tokens: torch.Tensor  # int32 [B]


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """The reference's formula: logits carry -inf (EOT, padded vocab)."""
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, descending, ties to the lower
    index (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _length_norm(n: int, length_penalty: float) -> float:
    """``n ** length_penalty`` in f32, as the reference computes it."""
    return float(np.float32(n) ** np.float32(length_penalty))


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows [B, N, T]`` at ``idx [B, K]`` along N -> ``[B, K, T]``."""
    return torch.gather(rows, 1, idx[..., None].expand(-1, -1, rows.shape[-1]))


def reorder_self_cache(cache: KVCache, src: torch.Tensor) -> None:
    """Stream ``i`` of the self caches takes stream ``src[i]``'s rows and
    scales (the streams follow their parent beams): any cache dtype (int8,
    uint8 int4 pairs, float) and any scale-lane count."""
    cache.self_k = cache.self_k.index_select(1, src)
    cache.self_v = cache.self_v.index_select(1, src)
    if cache.self_kv_scale is not None:
        cache.self_kv_scale = cache.self_kv_scale.index_select(1, src)


def beam_decode(
    params: dict,
    cfg: WhisperConfig,
    mel: torch.Tensor,
    lang_tokens: torch.Tensor,
    compute: Compute,
    *,
    beam_width: int = 5,
    detect: bool = False,
    max_tokens: int = MAX_TOKENS,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    task: str = "transcribe",
) -> BeamResult:
    """Beam-search transcription of mel ``[B, n_mels, 3000]``, on mel's device.

    ``early_stopping``: True stops an utterance as soon as W hypotheses
    are banked; False (default) also requires that no running beam can
    still beat the worst banked hypothesis (the HF heuristic).
    """
    b, w = mel.shape[0], beam_width
    bw = b * w
    dev = mel.device
    cache = encode_and_fill(params, cfg, mel, compute, max_tokens, "beam_decode")
    with record_function("beam_decode.prefill"):
        logits, lang_tokens = prompt_logits(params, cfg, cache, lang_tokens, compute, detect=detect, task=task)
        # the top-W first tokens seed the beams (EOT is suppressed at sample
        # #0, so no hypothesis finishes at the seed step)
        seed_logp, seed_tok = _top_k(_log_softmax(logits), w)  # [B, W]
        # self caches to the B*W streams, beams of an utterance adjacent
        # (a float self cache has no scales)
        rep = lambda c: None if c is None else c.repeat_interleave(w, dim=1)
        cache = dataclasses.replace(
            cache, self_k=rep(cache.self_k), self_v=rep(cache.self_v), self_kv_scale=rep(cache.self_kv_scale)
        )
        cur = seed_tok.reshape(bw)
        tokens = torch.full((bw, max_tokens), EOT, dtype=torch.int32, device=dev)
        tokens[:, 0] = cur.to(torch.int32)
        scores = seed_logp.reshape(bw)  # raw log-prob sums of the live beams
        pool_scores = torch.full((b, w), NEG_INF, dtype=torch.float32, device=dev)  # normalized
        pool_tokens = torch.full((b, w, max_tokens), EOT, dtype=torch.int32, device=dev)
        pool_ngen = torch.zeros((b, w), dtype=torch.int32, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        rank = torch.arange(2 * w, device=dev)[None, :]
        own = torch.arange(w, device=dev)[None, :]
        first = torch.arange(b, device=dev)[:, None] * w  # each utterance's first stream
        check_positions(cache.self_k.shape[2], max_tokens)
        pos = torch.full((), PROMPT_LEN, dtype=torch.int32, device=dev)  # the slot of the token fed

    with record_function("beam_decode.decode"):
        k = 1  # samples generated so far: the live beams hold k tokens
        while k < max_tokens:
            if k % DONE_CHECK_EVERY == 0 and bool(done.all()):
                break
            logits = decode_step(params, cfg, cur, pos, cache, compute, batch_groups=w)
            pos += 1
            if k < MIN_TOKENS:
                logits[:, EOT] = float("-inf")
            logp = _log_softmax(logits)  # [BW, Vp]
            vp = logp.shape[-1]
            sc2, idx2 = _top_k((scores[:, None] + logp).reshape(b, w * vp), 2 * w)  # [B, 2W]
            parent = idx2 // vp  # parent beam within the utterance
            tok = idx2 % vp
            eos = tok == EOT

            # bank the EOT candidates ranked below W; the normalized score
            # counts the EOT: generated length k + 1
            norm = _length_norm(k + 1, length_penalty)
            bank_sc = torch.where(eos & (rank < w) & ~done[:, None], sc2 / norm, NEG_INF)
            cand_rows = _take_rows(tokens.reshape(b, w, max_tokens), parent)
            # the pool first: on ties an existing hypothesis wins
            all_sc = torch.cat([pool_scores, bank_sc], dim=1)  # [B, 3W]
            all_rows = torch.cat([pool_tokens, cand_rows], dim=1)
            all_ng = torch.cat([pool_ngen, torch.full((b, 2 * w), k, dtype=torch.int32, device=dev)], dim=1)
            new_pool_sc, keep = _top_k(all_sc, w)
            new_pool_rows = _take_rows(all_rows, keep)
            new_pool_ng = torch.gather(all_ng, 1, keep)

            # refill the live slots with the best non-EOT candidates, in
            # rank order; the rest go to a dump column W (at least W of the
            # 2W are not EOT: EOT is one vocab id)
            live = ~eos
            slot = torch.cumsum(live.int(), dim=1) - 1
            tgt = torch.where(live & (slot < w), slot, w)

            def refill(vals, fill):
                out = torch.full((b, w + 1), fill, dtype=vals.dtype, device=dev)
                return out.scatter_(1, tgt, vals)[:, :w]

            new_scores = refill(sc2, NEG_INF)
            new_tok = refill(tok, EOT)
            new_parent = refill(parent, 0)

            # done utterances freeze: their live state keeps its (unused)
            # rows and the cache gather is the identity for them
            frozen = done[:, None]
            new_scores = torch.where(frozen, scores.reshape(b, w), new_scores)
            new_tok = torch.where(frozen, cur.reshape(b, w), new_tok)
            new_parent = torch.where(frozen, own, new_parent)
            pool_scores = torch.where(frozen, pool_scores, new_pool_sc)
            pool_tokens = torch.where(frozen[..., None], pool_tokens, new_pool_rows)
            pool_ngen = torch.where(frozen, pool_ngen, new_pool_ng)

            with record_function("beam_decode.reorder"):  # streams follow their parents
                src = (first + new_parent).reshape(bw)
                tokens = tokens.index_select(0, src)
                tokens[:, k] = new_tok.reshape(bw).to(torch.int32)
                reorder_self_cache(cache, src)

            # an utterance is done when its pool is full and (the heuristic)
            # its best running candidate, normalized at the current length,
            # cannot beat the worst banked score
            now_done = (pool_scores > NEG_INF / 2).sum(dim=1) >= w
            if not early_stopping:
                now_done &= pool_scores.amin(dim=1) >= sc2[:, 0] / norm
            done = done | now_done
            cur, scores = new_tok.reshape(bw), new_scores.reshape(bw)
            k += 1

        # bank the live beams of the utterances not done at their final
        # length (no EOT counted: generated length k), then take the best
        live_sc = torch.where(
            done[:, None], NEG_INF, scores.reshape(b, w) / _length_norm(max(k, 1), length_penalty)
        )
        all_sc = torch.cat([pool_scores, live_sc], dim=1)  # [B, 2W]
        all_rows = torch.cat([pool_tokens, tokens.reshape(b, w, max_tokens)], dim=1)
        all_ng = torch.cat([pool_ngen, torch.full((b, w), k, dtype=torch.int32, device=dev)], dim=1)
        best_sc, best = _top_k(all_sc, 1)  # [B, 1]
        best_rows = _take_rows(all_rows, best)[:, 0]
        best_ng = torch.gather(all_ng, 1, best)
        # EOT past the hypothesis' length: banked rows may carry their
        # parent's later tokens
        col = torch.arange(max_tokens, device=dev)[None, :]
        best_rows = torch.where(col < best_ng, best_rows, EOT)
    return BeamResult(best_rows, best_ng[:, 0], best_sc[:, 0], lang_tokens)
