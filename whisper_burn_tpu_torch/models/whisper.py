"""Greedy transcription: encode -> cross-KV fill -> prompt prefill -> decode loop.

Port of ``whisper_burn_tpu/models/whisper.py``.

* prompt ``[SOT, lang, TRANSCRIBE or TRANSLATE, NO_TIMESTAMPS]``
* EOT suppressed on the first sample and while fewer than MIN_TOKENS exist
* greedy argmax over the full vocab; EOT-filled after a stream stops;
  the loop ends when every stream is done or at ``max_tokens``
* language auto-detect: argmax of a ``[SOT]`` pass over the language rows

The decode loop is the JAX package's ``lax.while_loop``: its body,
:func:`greedy_step`, is one function of the device state
:class:`GreedyState` (the JAX ``State``: ``k``, ``cur``, ``tokens``,
``done`` and the cache). The position ``PROMPT_LEN + k - 1`` is computed on
the device and read there by the kernels, EOT is suppressed while ``k <
MIN_TOKENS`` by a device ``where``, the token lands at column ``k`` by an
in-place index copy and ``k`` advances on the device, so the step reads
nothing on the host and is the same launches at every position. A
:class:`GreedyRunner` owns that state and the KV cache for one shape: on
the card it runs the request's first step eagerly (the kernels' build,
load and one-time launch settings happen there), captures the step once
as a CUDA graph and replays it once per token, for this request and every
later one of the same shape (:class:`GraphRunner`, which beam search's
runner shares). On the CPU the same body runs eagerly, step by step.
Under tensor parallelism the step's all-reduces are captured with it:
its eager first step also starts the NCCL communicator, which a capture
cannot; a group that a graph cannot capture (gloo) is refused on the card
(:func:`check_capturable`).
Whether every stream is done is read on the host once every
``DONE_CHECK_EVERY`` steps; finished streams emit EOT either way, so the
tokens are the same as stopping at once.

Each stage runs inside a span of the recorder (``utils/profiling.py``:
a ``torch.profiler.record_function`` range, and while the launch log is
on a span with device events) named ``greedy_decode.<stage>`` (encode,
cross_fill, prefill, decode), so a profiler trace of a request splits its
time by stage on the host and on the device; the language pass is the
recorder's span ``greedy_decode.detect`` inside prefill. The encode span
counts its ``rows``, and the decode span the loop's ``steps`` and, on the
card, its graph ``replays`` and the host ns of their launches
(``launch_ns``). :func:`encode_and_fill` and :func:`prompt_logits` are
the stages that beam search (``models/beam.py``) shares.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import NamedTuple

import torch

from whisper_burn_tpu_torch.models.config import EOT, MAX_TOKENS, MIN_TOKENS, SOT, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import (
    KVCache,
    decode_step,
    fill_cross_cache,
    init_cache,
    prefill,
)
from whisper_burn_tpu_torch.models.encoder import encode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute, set_fp32_precision
from whisper_burn_tpu_torch.utils.profiling import count, span

PROMPT_LEN = 4
DONE_CHECK_EVERY = 16
RUNNERS_KEPT = 8  # runners cached at once, the least recently used dropped first


class GreedyResult(NamedTuple):
    tokens: torch.Tensor  # int32 [B, max_tokens]; EOT-filled after stop
    n_generated: torch.Tensor  # int32 [B]; non-EOT token count per stream
    lang_tokens: torch.Tensor  # int32 [B]; the language token used


@dataclasses.dataclass
class GreedyState:
    """The decode loop's device state (the JAX package's ``State``),
    updated in place by :func:`greedy_step`."""

    k: torch.Tensor  # int32 0-d: samples taken so far
    cur: torch.Tensor  # int64 [B]: the last sampled token
    tokens: torch.Tensor  # int32 [B, max_tokens]: EOT past the samples taken
    done: torch.Tensor  # bool [B]: the stream has emitted EOT
    cache: KVCache


def self_cache_len(cfg: WhisperConfig, max_tokens: int) -> int:
    """The self cache's ``ctx``: prompt + max_tokens, 64-aligned (256 for
    224 tokens), at most ``n_text_ctx``."""
    return min(cfg.n_text_ctx, max(64, -(-(PROMPT_LEN + max_tokens) // 64) * 64))


def new_state(cache: KVCache, max_tokens: int) -> GreedyState:
    b, dev = cache.self_v.shape[1], cache.self_v.device
    return GreedyState(
        k=torch.ones((), dtype=torch.int32, device=dev),
        cur=torch.zeros(b, dtype=torch.long, device=dev),
        tokens=torch.full((b, max_tokens), EOT, dtype=torch.int32, device=dev),
        done=torch.zeros(b, dtype=torch.bool, device=dev),
        cache=cache,
    )


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
    params: dict, cfg: WhisperConfig, mel: torch.Tensor, compute: Compute, max_tokens: int, stage: str,
    cache: KVCache | None = None,
) -> KVCache:
    """Encode mel ``[B, n_mels, 3000]`` and fill the cross K/V of ``cache``
    (a fresh one when None), in the ranges ``<stage>.encode`` and
    ``<stage>.cross_fill``. The fill rewrites every cross entry, pad
    columns and scales included, so a reused cache ends as a fresh one
    would. The self cache is allocated once at the full ``ctx``
    (:func:`self_cache_len`); the JAX package grows it in two phases, but
    the decode kernels read only keys below ``pos``, so the tokens are the
    same."""
    set_fp32_precision(compute)
    with span(f"{stage}.encode", device=mel.is_cuda):
        count(rows=mel.shape[0])
        enc_out = encode(params, mel, cfg, compute)
    with span(f"{stage}.cross_fill", device=mel.is_cuda):
        if cache is None:
            cache = init_cache(cfg, mel.shape[0], compute, self_cache_len(cfg, max_tokens), mel.device)
        fill_cross_cache(params, cfg, enc_out, cache, compute)
    return cache


def prompt_tokens(cfg: WhisperConfig, lang_tokens: torch.Tensor, task: str = "transcribe") -> torch.Tensor:
    """The prompt ``[SOT, lang, TRANSCRIBE or TRANSLATE, NO_TIMESTAMPS]``
    per stream, int64 ``[B, 4]`` on the language tokens' device."""
    task_token = {"transcribe": cfg.transcribe_token, "translate": cfg.translate_token}[task]
    full = lambda v: torch.full_like(lang_tokens, v)
    return torch.stack([full(SOT), lang_tokens, full(task_token), full(cfg.no_timestamps_token)], dim=1).long()


def prompt_logits(
    params: dict, cfg: WhisperConfig, cache: KVCache, lang_tokens: torch.Tensor, compute: Compute,
    *, detect: bool, task: str, stage: str = "greedy_decode",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefill the prompt ``[SOT, lang, task, NO_TIMESTAMPS]`` into
    ``cache``; returns sample #0's logits (EOT suppressed) and the
    language tokens (entries ``< 0`` auto-detected with ``detect``, in the
    span ``<stage>.detect``)."""
    lang_tokens = lang_tokens.to(device=cache.self_v.device, dtype=torch.int32)
    if detect:
        with span(f"{stage}.detect", profiler_range=False):
            detected = detect_language(params, cfg, cache, compute)
        lang_tokens = torch.where(lang_tokens < 0, detected, lang_tokens)
    logits = prefill(params, cfg, prompt_tokens(cfg, lang_tokens, task), cache, compute)
    logits[:, EOT] = float("-inf")  # sample #0: EOT always suppressed
    return logits, lang_tokens


def start_request(
    params: dict, cfg: WhisperConfig, mel: torch.Tensor, lang_tokens: torch.Tensor, compute: Compute,
    state: GreedyState, *, detect: bool, task: str,
) -> torch.Tensor:
    """Encode ``mel``, fill ``state.cache``, prefill the prompt and take
    sample #0: ``state`` is then at ``k = 1``, ready for the loop. Returns
    the language tokens used."""
    max_tokens = state.tokens.shape[1]
    encode_and_fill(params, cfg, mel, compute, max_tokens, "greedy_decode", cache=state.cache)
    with span("greedy_decode.prefill", device=mel.is_cuda):
        logits, lang_tokens = prompt_logits(params, cfg, state.cache, lang_tokens, compute, detect=detect, task=task)
        first = logits.argmax(dim=-1)
        state.k.fill_(1)
        state.cur.copy_(first)
        state.tokens.fill_(EOT)
        state.tokens[:, 0] = first
        state.done.zero_()
    return lang_tokens


def greedy_step(params: dict, cfg: WhisperConfig, state: GreedyState, compute: Compute) -> torch.Tensor:
    """The loop body (the JAX package's ``body``): feed ``state.cur`` at
    cache position ``PROMPT_LEN + k - 1``, take sample #k into column ``k``
    of ``state.tokens`` and advance ``k``, all on the device and in place.
    Returns the step's logits ``[B, Vp]`` f32 (EOT suppressed while ``k <
    MIN_TOKENS``)."""
    pos = state.k + (PROMPT_LEN - 1)  # the cache slot of the token fed
    logits = decode_step(params, cfg, state.cur, pos, state.cache, compute)
    # EOT suppressed while fewer than MIN_TOKENS samples exist
    logits[:, EOT] = torch.where(state.k < MIN_TOKENS, float("-inf"), logits[:, EOT])
    nxt = torch.where(state.done, EOT, logits.argmax(dim=-1))
    state.tokens.index_copy_(1, state.k.reshape(1).long(), nxt[:, None].to(torch.int32))
    state.done |= nxt == EOT
    state.cur.copy_(nxt)
    state.k += 1
    return logits


def capture_graph(fn, stream: torch.cuda.Stream):
    """Capture ``fn()`` on ``stream`` as a CUDA graph: its work is recorded,
    not run. Returns the graph, ``fn``'s output (tensors of the graph's
    pool that each replay rewrites) and the hand-written kernels' launches
    it recorded (``_build.LaunchTally``, counted at each replay). Raises if
    ``fn`` does what a capture cannot hold, such as reading a device value
    on the host. The capture binds this thread only ("thread_local"), so
    other threads' device work (a request's copy to the card and its mel,
    results read back) goes on while it lasts and does not void it."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), _build.recording_launches() as recorded:
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass  # the failed step invalidated the capture: its error is the one to raise
            raise
        graph.capture_end()
    return graph, out, _build.LaunchTally(recorded)


def check_capturable(compute: Compute, device: torch.device) -> None:
    """A CUDA graph of the step captures its all-reduces only over NCCL:
    on the card a model group of another backend (gloo, which goes
    through the host) raises here, at the runner, rather than run the
    loop eagerly. Such a group serves the loop body driven step by step
    (:func:`greedy_step`, ``models/beam.beam_step``)."""
    import torch.distributed as dist

    group = compute.tp_group
    if device.type == "cuda" and group is not None and dist.get_backend(group) != "nccl":
        raise ValueError(
            f"a CUDA graph captures NCCL collectives only, and the model ranks' group is "
            f"{dist.get_backend(group)}: use NCCL, or drive the loop body step by step"
        )


class GraphRunner:
    """A decode loop's step over state that the runner owns: on a CUDA
    device the first step runs eagerly on the runner's stream, then each
    of the step's ``variants`` (forms whose launches differ, such as the
    buffer a step reads) is captured as a CUDA graph, and every later step,
    of this request and of every later one, replays the graph of its
    variant (a capture or a replay that fails raises). Elsewhere each step
    runs eagerly. ``graphs`` holds ``(graph, output, launch tally)`` by
    variant and ``capture_s`` the captures' wall."""

    variants = 1

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.graphs = []
        self.capture_s = None
        # one request at a time: held from the request's start until its
        # results are copied out of the runner's buffers
        self.lock = threading.Lock()

    def _body(self, variant: int):
        raise NotImplementedError

    def _step(self, variant: int = 0):
        """Run the step's ``variant``; returns its output (on the card a
        replay returns the graph's output tensor, rewritten by the next
        replay)."""
        if self.stream is None:
            out = self._body(variant)
            count(steps=1)
            return out
        if not self.graphs:
            main = torch.cuda.current_stream(self.stream.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                out = self._body(variant)
            if out is not None:
                out.record_stream(main)
            t0 = time.perf_counter()
            self.graphs = [capture_graph(lambda v=v: self._body(v), self.stream) for v in range(self.variants)]
            self.capture_s = time.perf_counter() - t0
            main.wait_stream(self.stream)
            count(steps=1)
            return out
        graph, out, tally = self.graphs[variant]
        if _build.LAUNCH_LOG is None:
            graph.replay()
        else:  # recording: the host's launch of the replay
            t0 = time.perf_counter_ns()
            graph.replay()
            count(steps=1, replays=1, launch_ns=time.perf_counter_ns() - t0)
        _build.add_launches(tally)
        return out


class GreedyRunner(GraphRunner):
    """The greedy loop of one shape: ``params``, ``cfg``, ``compute``,
    ``batch`` streams, a self cache of ``ctx`` and ``max_tokens`` samples.

    Owns the loop state and the KV cache, which each request fills in
    place (:func:`start_request`); :meth:`step` then takes one sample
    through :class:`GraphRunner`. The runner holds ``params``: the graph
    reads their memory."""

    def __init__(self, params: dict, cfg: WhisperConfig, compute: Compute, batch: int, ctx: int,
                 max_tokens: int, device: torch.device):
        check_capturable(compute, device)
        super().__init__(device)
        self.params, self.cfg, self.compute = params, cfg, compute
        self.batch, self.ctx, self.max_tokens = batch, ctx, max_tokens
        self.state = new_state(init_cache(cfg, batch, compute, ctx, device), max_tokens)
        self.logits = None  # the last step's logits

    def _body(self, variant: int) -> torch.Tensor:
        return greedy_step(self.params, self.cfg, self.state, self.compute)

    def step(self) -> torch.Tensor:
        """Take one sample; returns the step's logits."""
        self.logits = self._step()
        return self.logits


_RUNNERS: collections.OrderedDict = collections.OrderedDict()
_RUNNERS_LOCK = threading.Lock()


def cached_runner(key: tuple, make) -> GraphRunner:
    """The cached runner of ``key``, made by ``make()`` on first use; at
    most ``RUNNERS_KEPT`` runners are kept, greedy and beam together, the
    least recently used dropped first. Safe from several threads: a runner
    dropped while a thread still holds it finishes that thread's request."""
    with _RUNNERS_LOCK:
        runner = _RUNNERS.pop(key, None)
        if runner is None:
            runner = make()
        _RUNNERS[key] = runner
        while len(_RUNNERS) > RUNNERS_KEPT:
            _RUNNERS.popitem(last=False)
        return runner


def greedy_runner(params: dict, cfg: WhisperConfig, compute: Compute, batch: int, max_tokens: int,
                  device: torch.device) -> GreedyRunner:
    """The cached runner of this shape. Runners are keyed by what fixes
    the graph's addresses and shapes: the params (the runner holds them,
    so their ``id`` is not reused while it lives), ``cfg``, ``compute``,
    the batch, ``max_tokens`` (and so ``ctx``) and the device."""
    device = torch.device(device)
    return cached_runner(
        ("greedy", id(params), cfg, compute, batch, max_tokens, device),
        lambda: GreedyRunner(params, cfg, compute, batch, self_cache_len(cfg, max_tokens), max_tokens, device),
    )


def cached_runners() -> list[GraphRunner]:
    with _RUNNERS_LOCK:
        return list(_RUNNERS.values())


def clear_runners() -> None:
    """Drop every cached runner, its caches and graphs."""
    with _RUNNERS_LOCK:
        _RUNNERS.clear()


def check_positions(ctx: int, max_tokens: int) -> None:
    """The loop's last step writes at ``PROMPT_LEN + max_tokens - 2``,
    which must lie in the self cache: checked once per request, on the
    host, since the step never reads its position there."""
    if PROMPT_LEN + max_tokens - 2 >= ctx:
        raise ValueError(f"{max_tokens} tokens after a {PROMPT_LEN}-token prompt overrun a self cache of {ctx}")


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
    """Transcribe mel ``[B, n_mels, 3000]`` to token ids, on mel's device,
    through the cached :class:`GreedyRunner` of its shape.

    ``lang_tokens: int [B]``; with ``detect=True`` entries ``< 0`` are
    auto-detected.
    """
    check_positions(self_cache_len(cfg, max_tokens), max_tokens)
    runner = greedy_runner(params, cfg, compute, mel.shape[0], max_tokens, mel.device)
    with runner.lock:  # the runner's state serves one request at a time
        state = runner.state
        lang_tokens = start_request(params, cfg, mel, lang_tokens, compute, state, detect=detect, task=task)
        with span("greedy_decode.decode", device=mel.is_cuda):
            for k in range(1, max_tokens):
                if k % DONE_CHECK_EVERY == 0 and bool(state.done.all()):
                    break
                runner.step()
            tokens = state.tokens.clone()  # the runner's buffer serves the next request
            n_gen = (tokens != EOT).sum(dim=-1).to(torch.int32)
    return GreedyResult(tokens, n_gen, lang_tokens)
