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

The loop is the JAX package's ``lax.while_loop``, as ``greedy_decode``'s
is: its body, :func:`beam_step`, is one function of the device state
:class:`BeamState`, which it updates in place and reads nothing of on the
host (the position, the EOT suppression below ``MIN_TOKENS`` and the
length normalization come from the device ``k``). The self caches are a
pair of buffers: step ``k`` reads the rows of the buffer that step
``k - 1`` wrote and kernel F's beam form writes the other, the slot and
the gather by parent beam in one pass over the rows up to the position
(:func:`reorder_self_cache`), so no step reallocates a cache and the
buffer a step reads follows from the parity of ``k``, which the host
knows. A :class:`BeamRunner` owns the state for one shape: on the card it
runs a request's first step eagerly, captures the step from each buffer
as a CUDA graph and replays the one of each step's parity, for this
request and every later one; on the CPU the same body runs eagerly.
Whether every utterance is done is read on the host once every
``DONE_CHECK_EVERY`` steps. Done utterances are frozen, so the steps run
past the moment they were all done change nothing that the final
selection reads. Stages run inside the recorder's spans
(``utils/profiling.py``) named ``beam_decode.<stage>`` (encode,
cross_fill, prefill, decode; ``detect`` inside prefill), counted as
greedy's are, and each step's reorder of the live rows and self caches
inside ``beam_decode.reorder``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from whisper_burn_tpu_torch.models.config import EOT, MAX_TOKENS, MIN_TOKENS, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import SELF_FIELDS, KVCache, decode_step, init_cache, init_self_cache
from whisper_burn_tpu_torch.models.whisper import (
    DONE_CHECK_EVERY,
    PROMPT_LEN,
    GraphRunner,
    cached_runner,
    check_capturable,
    check_positions,
    encode_and_fill,
    prompt_logits,
    self_cache_len,
)
from whisper_burn_tpu_torch.ops.cache import write_cache_slots_beam
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.utils.profiling import span

NEG_INF = -1e30


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # int32 [B, max_tokens] best hypothesis, EOT-filled
    n_generated: torch.Tensor  # int32 [B]
    scores: torch.Tensor  # f32 [B] length-normalized log-prob of the best hypothesis
    lang_tokens: torch.Tensor  # int32 [B]


@dataclasses.dataclass
class BeamState:
    """The beam loop's device state (the JAX package's ``State``), updated
    in place by :func:`beam_step`. The cache position of step ``k`` is
    ``PROMPT_LEN + k - 1``, computed from ``k`` on the device."""

    k: torch.Tensor  # int32 0-d: samples generated so far (the live beams hold k tokens)
    cur: torch.Tensor  # int64 [BW]: each live beam's last token
    tokens: torch.Tensor  # int32 [BW, max_tokens]: the live hypotheses
    scores: torch.Tensor  # f32 [BW]: raw log-prob sums of the live beams
    pool_scores: torch.Tensor  # f32 [B, W]: banked, normalized; NEG_INF an empty slot
    pool_tokens: torch.Tensor  # int32 [B, W, max_tokens]
    pool_ngen: torch.Tensor  # int32 [B, W]
    done: torch.Tensor  # bool [B]: the utterance is finished
    prompt_cache: KVCache  # B streams: the prompt's self rows, and the cross cache
    caches: tuple[KVCache, KVCache]  # the self-cache pair of the BW streams, over the same cross cache


def new_beam_state(cfg: WhisperConfig, compute: Compute, batch: int, beam_width: int, ctx: int, max_tokens: int,
                   device) -> BeamState:
    b, w = batch, beam_width
    prompt_cache = init_cache(cfg, b, compute, ctx, device)
    pair = tuple(dataclasses.replace(prompt_cache, **init_self_cache(cfg, b * w, compute, ctx, device))
                 for _ in range(2))
    full = lambda shape, v, dtype: torch.full(shape, v, dtype=dtype, device=device)
    return BeamState(
        k=full((), 1, torch.int32), cur=full((b * w,), 0, torch.long),
        tokens=full((b * w, max_tokens), EOT, torch.int32), scores=full((b * w,), 0.0, torch.float32),
        pool_scores=full((b, w), NEG_INF, torch.float32), pool_tokens=full((b, w, max_tokens), EOT, torch.int32),
        pool_ngen=full((b, w), 0, torch.int32), done=full((b,), False, torch.bool),
        prompt_cache=prompt_cache, caches=pair,
    )


def _log_softmax(logits: torch.Tensor) -> torch.Tensor:
    """The reference's formula: logits carry -inf (EOT, padded vocab)."""
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest along the last axis, descending, ties to the lower
    index (``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take_rows(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows [B, N, T]`` at ``idx [B, K]`` along N -> ``[B, K, T]``."""
    return torch.gather(rows, 1, idx[..., None].expand(-1, -1, rows.shape[-1]))


def reorder_self_cache(dst: KVCache, cache: KVCache, rows: tuple, src: torch.Tensor, pos: torch.Tensor) -> None:
    """Stream ``i`` of ``dst``'s self caches takes stream ``src[i]``'s rows
    of ``cache`` below ``pos`` and its new row ``rows`` at ``pos`` (the
    streams follow their parent beams; kernel F's beam form, one launch):
    any cache dtype (int8, uint8 int4 pairs, float) and any scale-lane
    count. ``rows`` is :func:`~whisper_burn_tpu_torch.models.decoder.decode_step`'s
    ``(k, v, scales)`` with ``defer_slot``; ``src`` int32 ``[BW]``."""
    write_cache_slots_beam(
        [(getattr(dst, name), getattr(cache, name), r) for name, r in zip(SELF_FIELDS, rows) if r is not None],
        src, pos,
    )


def start_beam_request(
    params: dict, cfg: WhisperConfig, mel: torch.Tensor, lang_tokens: torch.Tensor, compute: Compute,
    state: BeamState, *, detect: bool, task: str,
) -> torch.Tensor:
    """Encode ``mel``, fill the cross cache, prefill the prompt, seed the
    beams with sample #0's top W and copy the prompt's self rows W-fold
    into the first buffer of the pair: ``state`` is then at ``k = 1``,
    ready for the loop. Returns the language tokens used."""
    b, w = state.pool_scores.shape
    max_tokens = state.tokens.shape[1]
    encode_and_fill(params, cfg, mel, compute, max_tokens, "beam_decode", cache=state.prompt_cache)
    with span("beam_decode.prefill", device=mel.is_cuda):
        logits, lang_tokens = prompt_logits(
            params, cfg, state.prompt_cache, lang_tokens, compute, detect=detect, task=task, stage="beam_decode"
        )
        # the top-W first tokens seed the beams (EOT is suppressed at sample
        # #0, so no hypothesis finishes at the seed step)
        seed_logp, seed_tok = _top_k(_log_softmax(logits), w)  # [B, W]
        # the prompt's self rows to the B*W streams, beams of an utterance
        # adjacent (the rows past the prompt are never read below pos)
        for name in SELF_FIELDS:
            rows = getattr(state.prompt_cache, name)
            if rows is not None:
                getattr(state.caches[0], name)[:, :, :PROMPT_LEN] = rows[:, :, :PROMPT_LEN].repeat_interleave(w, dim=1)
        state.k.fill_(1)
        state.cur.copy_(seed_tok.reshape(b * w))
        state.tokens.fill_(EOT)
        state.tokens[:, 0] = state.cur
        state.scores.copy_(seed_logp.reshape(b * w))
        state.pool_scores.fill_(NEG_INF)
        state.pool_tokens.fill_(EOT)
        state.pool_ngen.zero_()
        state.done.zero_()
    return lang_tokens


def beam_step(params: dict, cfg: WhisperConfig, state: BeamState, compute: Compute, source: int, *,
              length_penalty: float, early_stopping: bool) -> None:
    """The loop body (the JAX package's ``body``, its beam.py:161-252):
    feed ``state.cur`` at cache position ``PROMPT_LEN + k - 1`` over the
    self caches ``state.caches[source]``, take the top 2W candidates of
    each utterance, bank the finished ones, refill the live beams, move
    the self caches (with the step's new rows) into the other buffer by
    parent beam and advance ``k``: all on the device and in place."""
    b, w = state.pool_scores.shape
    bw, max_tokens = b * w, state.tokens.shape[1]
    dev = state.k.device
    cache, other = state.caches[source], state.caches[1 - source]
    pos = state.k + (PROMPT_LEN - 1)  # the cache slot of the token fed
    logits, rows = decode_step(params, cfg, state.cur, pos, cache, compute, batch_groups=w, defer_slot=True)
    logits[:, EOT] = torch.where(state.k < MIN_TOKENS, float("-inf"), logits[:, EOT])
    logp = _log_softmax(logits)  # [BW, Vp]
    vp = logp.shape[-1]
    sc2, idx2 = _top_k((state.scores[:, None] + logp).reshape(b, w * vp), 2 * w)  # [B, 2W]
    parent = idx2 // vp  # parent beam within the utterance
    tok = idx2 % vp
    eos = tok == EOT
    rank = torch.arange(2 * w, device=dev)[None, :]

    # bank the EOT candidates ranked below W; the normalized score
    # counts the EOT: generated length k + 1, normalized in f32 on the
    # device as the reference computes it
    norm = (state.k.float() + 1.0) ** length_penalty
    bank_sc = torch.where(eos & (rank < w) & ~state.done[:, None], sc2 / norm, NEG_INF)
    cand_rows = _take_rows(state.tokens.reshape(b, w, max_tokens), parent)
    # the pool first: on ties an existing hypothesis wins
    all_sc = torch.cat([state.pool_scores, bank_sc], dim=1)  # [B, 3W]
    all_rows = torch.cat([state.pool_tokens, cand_rows], dim=1)
    all_ng = torch.cat([state.pool_ngen, state.k.expand(b, 2 * w)], dim=1)
    new_pool_sc, keep = _top_k(all_sc, w)
    new_pool_rows = _take_rows(all_rows, keep)
    new_pool_ng = torch.gather(all_ng, 1, keep)

    # refill the live slots with the best non-EOT candidates, in rank
    # order; the rest go to a dump column W (at least W of the 2W are not
    # EOT: EOT is one vocab id)
    live = ~eos
    slot = torch.cumsum(live.int(), dim=1) - 1
    tgt = torch.where(live & (slot < w), slot, w)

    def refill(vals, fill):
        out = torch.full((b, w + 1), fill, dtype=vals.dtype, device=dev)
        return out.scatter_(1, tgt, vals)[:, :w]

    new_scores = refill(sc2, NEG_INF)
    new_tok = refill(tok, EOT)
    new_parent = refill(parent, 0)

    # done utterances freeze: their live state keeps its (unused) rows and
    # the cache gather is the identity for them
    frozen = state.done[:, None]
    new_scores = torch.where(frozen, state.scores.reshape(b, w), new_scores)
    new_tok = torch.where(frozen, state.cur.reshape(b, w), new_tok)
    new_parent = torch.where(frozen, torch.arange(w, device=dev)[None, :], new_parent)
    state.pool_scores.copy_(torch.where(frozen, state.pool_scores, new_pool_sc))
    state.pool_tokens.copy_(torch.where(frozen[..., None], state.pool_tokens, new_pool_rows))
    state.pool_ngen.copy_(torch.where(frozen, state.pool_ngen, new_pool_ng))

    with span("beam_decode.reorder"):  # streams follow their parents
        src = (torch.arange(b, device=dev)[:, None] * w + new_parent).reshape(bw)
        tokens = state.tokens.index_select(0, src)
        tokens.index_copy_(1, state.k.reshape(1).long(), new_tok.reshape(bw, 1).to(torch.int32))
        state.tokens.copy_(tokens)
        reorder_self_cache(other, cache, rows, src.to(torch.int32), pos)

    # an utterance is done when its pool is full and (the heuristic) its
    # best running candidate, normalized at the current length, cannot
    # beat the worst banked score
    now_done = (state.pool_scores > NEG_INF / 2).sum(dim=1) >= w
    if not early_stopping:
        now_done &= state.pool_scores.amin(dim=1) >= sc2[:, 0] / norm
    state.done |= now_done
    state.cur.copy_(new_tok.reshape(bw))
    state.scores.copy_(new_scores.reshape(bw))
    state.k += 1


def select_best(state: BeamState, length_penalty: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bank the live beams of the utterances not done at their final
    length (no EOT counted: generated length k), then take the best:
    tokens (EOT past its length), lengths and normalized scores, new
    tensors."""
    b, w = state.pool_scores.shape
    max_tokens = state.tokens.shape[1]
    live_sc = torch.where(
        state.done[:, None], NEG_INF,
        state.scores.reshape(b, w) / state.k.float().clamp_min(1.0) ** length_penalty,
    )
    all_sc = torch.cat([state.pool_scores, live_sc], dim=1)  # [B, 2W]
    all_rows = torch.cat([state.pool_tokens, state.tokens.reshape(b, w, max_tokens)], dim=1)
    all_ng = torch.cat([state.pool_ngen, state.k.expand(b, w)], dim=1)
    best_sc, best = _top_k(all_sc, 1)  # [B, 1]
    best_rows = _take_rows(all_rows, best)[:, 0]
    best_ng = torch.gather(all_ng, 1, best)
    # EOT past the hypothesis' length: banked rows may carry their
    # parent's later tokens
    col = torch.arange(max_tokens, device=state.k.device)[None, :]
    return torch.where(col < best_ng, best_rows, EOT), best_ng[:, 0], best_sc[:, 0]


class BeamRunner(GraphRunner):
    """The beam loop of one shape: ``params``, ``cfg``, ``compute``,
    ``batch`` utterances of ``beam_width`` beams, a self cache of ``ctx``,
    ``max_tokens`` samples, ``length_penalty`` and ``early_stopping``
    (which the step's graph fixes). Owns the loop state and its caches,
    which each request fills in place (:func:`start_beam_request`);
    :meth:`step` takes sample #k through :class:`GraphRunner`, with the
    step's two variants the two buffers it can read. The runner holds
    ``params``: the graphs read their memory."""

    variants = 2

    def __init__(self, params: dict, cfg: WhisperConfig, compute: Compute, batch: int, beam_width: int, ctx: int,
                 max_tokens: int, length_penalty: float, early_stopping: bool, device: torch.device):
        check_capturable(compute, device)
        super().__init__(device)
        self.params, self.cfg, self.compute = params, cfg, compute
        self.batch, self.beam_width, self.ctx, self.max_tokens = batch, beam_width, ctx, max_tokens
        self.length_penalty, self.early_stopping = length_penalty, early_stopping
        self.state = new_beam_state(cfg, compute, batch, beam_width, ctx, max_tokens, device)

    def _body(self, variant: int) -> None:
        beam_step(self.params, self.cfg, self.state, self.compute, variant,
                  length_penalty=self.length_penalty, early_stopping=self.early_stopping)

    def step(self, k: int) -> None:
        """Take sample #k (``k >= 1``, the state's ``k``): step k reads the
        buffer that step k - 1 wrote, the first after the prompt."""
        self._step((k - 1) % 2)


def beam_runner(params: dict, cfg: WhisperConfig, compute: Compute, batch: int, beam_width: int, max_tokens: int,
                length_penalty: float, early_stopping: bool, device: torch.device) -> BeamRunner:
    """The cached runner of this shape, among the greedy runners
    (``models/whisper.py``), keyed as theirs plus the beam width, the
    length penalty and ``early_stopping``."""
    device = torch.device(device)
    return cached_runner(
        ("beam", id(params), cfg, compute, batch, max_tokens, device, beam_width, length_penalty, early_stopping),
        lambda: BeamRunner(params, cfg, compute, batch, beam_width, self_cache_len(cfg, max_tokens), max_tokens,
                           length_penalty, early_stopping, device),
    )


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
    """Beam-search transcription of mel ``[B, n_mels, 3000]``, on mel's
    device, through the cached :class:`BeamRunner` of its shape.

    ``early_stopping``: True stops an utterance as soon as W hypotheses
    are banked; False (default) also requires that no running beam can
    still beat the worst banked hypothesis (the HF heuristic).
    """
    check_positions(self_cache_len(cfg, max_tokens), max_tokens)
    runner = beam_runner(params, cfg, compute, mel.shape[0], beam_width, max_tokens, length_penalty, early_stopping,
                         mel.device)
    with runner.lock:  # the runner's state serves one request at a time
        state = runner.state
        lang_tokens = start_beam_request(params, cfg, mel, lang_tokens, compute, state, detect=detect, task=task)
        with span("beam_decode.decode", device=mel.is_cuda):
            for k in range(1, max_tokens):
                if k % DONE_CHECK_EVERY == 0 and bool(state.done.all()):
                    break
                runner.step(k)
            tokens, n_gen, scores = select_best(state, length_penalty)
    return BeamResult(tokens, n_gen, scores, lang_tokens)
