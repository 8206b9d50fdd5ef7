"""Whisper as a model family of the benchmark: the port's
``WhisperPipeline``, and everything of Whisper that the harness reaches.

It binds Whisper's own files, which stay where they are: the shapes of a
configuration (``model_config.py``), the weights drawn from the seed
(``weights.py``), what the program says of its answers (``observe.py``),
the plain reference and its judgement (``reference.py``) and the model's
operation counts (``flops.py``). It holds what the harness did for
Whisper itself: the program's build and release, a calibration's lowered
logits table, the faults planted underneath a run and the decode loop's
step count.
"""

from __future__ import annotations

import torch

from benchmark import flops, model_config, reference
from benchmark.model_config import EOT, MIN_TOKENS, PROMPT_LEN
from benchmark.observe import Observer
from benchmark.weights import make_weights

DONE_CHECK_EVERY = 16  # the decode loops read "all done" every 16 steps (models/whisper.py)
FAULTS = ("token", "half", "stuck", "parent")

shape = model_config.model_shape
weights = make_weights


# -- the program -----------------------------------------------------------


def program_compute(ctx):
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


def lower(ctx, pipe) -> None:
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
        dec["tok_emb"].copy_(reference.to_float8(dec["tok_emb"].float()).to(dec["tok_emb"].dtype))
    else:
        raise ValueError(f"unknown logits control {kind!r}")


def build(ctx):
    """The port's ``WhisperPipeline`` over the benchmark's weights (drawn
    on the device from the seed), its kernels built or loaded."""
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    if ctx.device.type == "cuda":
        from whisper_burn_tpu_torch.ops import _build

        _build.build_all()
    p, s = ctx.params, ctx.shape
    cfg = WhisperConfig(n_mels=s.n_mels, n_audio_ctx=s.n_audio_ctx, n_audio_state=s.d_model, n_audio_head=s.heads,
                        n_audio_layer=s.encoder_layers, n_text_ctx=s.n_text_ctx, n_text_state=s.d_model,
                        n_text_head=s.heads, n_text_layer=s.decoder_layers, n_vocab=s.n_vocab, n_lang=s.n_lang)
    pipe = WhisperPipeline((cfg, weights(s, ctx.seed, ctx.device)), compute=program_compute(ctx),
                           max_tokens=p["max_tokens"], beam_width=p["beam_width"], device=ctx.device)
    lower(ctx, pipe)
    return pipe


def free() -> None:
    """Drop the program's runners, caches and graphs."""
    from whisper_burn_tpu_torch.models.whisper import clear_runners

    clear_runners()


def observe(pipe, params: dict) -> Observer:
    return Observer(pipe, params["max_tokens"])


def served(clip, result, params: dict) -> reference.Served:
    """What the program served for one request of the traffic."""
    return reference.Served(clip.samples, clip.rate, result.lang_token, params["language"] == "auto",
                            result.tokens.tolist(), params["max_tokens"], result.observed)


# -- the check -------------------------------------------------------------


def judge(ctx, sample: list, keep: bool = False) -> dict:
    """The reference's readings of the requests ``sample``, over the
    weights drawn again from the seed. Where the run's control is the
    reference's (``{"reference": "float8_e4m3fn"}``: the reference
    computed a precision step below the configuration), the control's
    readings over the same requests come as well, under ``control_``."""
    w, numerics = weights(ctx.shape, ctx.seed, ctx.device), reference.Numerics.of(ctx.config["compute"])
    lowered = (ctx.control or {}).get("reference")
    if lowered not in (None, "float8_e4m3fn"):
        raise ValueError(f"unknown reference control {lowered!r}")
    control = reference.Reference(ctx.shape, w, numerics, lowered=True) if lowered else None
    return reference.judge(reference.Reference(ctx.shape, w, numerics), sample, ctx.device, keep, control)


# -- the traced run's counts -----------------------------------------------


request_flops = flops.request_flops


def positions(s: model_config.ModelShape, log: list, position: str | None) -> list:
    """The cache position of each launch of one kernel in one batch's
    decode, from its order (``position``: a kernel bound's ``POSITION``,
    ``"layer"`` for one launch a decoder layer a step, ``"step"`` for one a
    step, None where the bound takes none): step k (from 1) writes at
    ``PROMPT_LEN + k - 1``."""
    if position is None:
        return [None] * len(log)
    per_step = s.decoder_layers if position == "layer" else 1
    return [PROMPT_LEN + i // per_step for i in range(len(log))]


def kernel_dims(s: model_config.ModelShape) -> dict:
    """The model's sizes that the kernels' bounds (``kernels/*.py``) read
    beside a launch's logged shape: the attention heads, the encoder's real
    frames (the keys an encoder or cross attention reads) and the width of
    kernel A's one product with f32 out (the int8 logits, over the vocab
    padded to 512)."""
    return {"heads": s.heads, "audio_ctx": s.n_audio_ctx, "logits_n": -(-s.n_vocab // 512) * 512}


def entry(beam_width: int) -> str:
    """The prefix of the model step's spans (``<entry>.encode``, ...)."""
    return "beam_decode" if beam_width > 1 else "greedy_decode"


def decode_steps(samples: list[int], max_tokens: int) -> int:
    """Steps the decode loop ran for a batch whose streams took ``samples``:
    one a sample after the first, until every stream is done, read every
    ``DONE_CHECK_EVERY`` steps, or the cap."""
    done_at = max(max(samples), MIN_TOKENS)
    steps = 0
    for k in range(1, max_tokens):
        if k % DONE_CHECK_EVERY == 0 and k >= done_at:
            break
        steps += 1
    return steps


# -- faults ----------------------------------------------------------------


def _broken_result(decode, fault):
    def wrapped(*args, **kwargs):
        result = decode(*args, **kwargs)
        tokens, n_gen = result.tokens.clone(), result.n_generated.clone()
        b = tokens.shape[0]
        if fault == "token":
            tokens[0, : int(n_gen[0])] = 100
        else:
            tokens[b // 2 :] = EOT
            n_gen[b // 2 :] = 0
        return result._replace(tokens=tokens, n_generated=n_gen)

    return wrapped


def faults(fault: str, beam_width: int = 1) -> list:
    """``(module, name, replacement)`` for each attribute ``fault`` replaces:

    - ``token``: the first stream's answer altered where it is produced;
    - ``half``: the second half of the batch never decoded (empty answers);
    - ``stuck``: the decode loop's step returns its state unchanged;
    - ``parent``: beam search's reorder moves each stream's self cache from
      the wrong parent (the next beam of its utterance), its tokens and
      scores as they were.
    """
    from whisper_burn_tpu_torch import transcribe
    from whisper_burn_tpu_torch.models import beam, whisper

    if fault in ("token", "half"):
        return [(transcribe, n, _broken_result(getattr(transcribe, n), fault)) for n in ("greedy_decode", "beam_decode")]
    if fault == "stuck":
        def greedy_step(params, cfg, state, compute):
            return torch.zeros(state.cur.shape[0], cfg.n_vocab_padded, device=state.cur.device)

        return [(whisper, "greedy_step", greedy_step), (beam, "beam_step", lambda *args, **kwargs: None)]
    if fault == "parent":
        reorder, w = beam.reorder_self_cache, beam_width

        def reorder_from_next_beam(dst, cache, rows, src, pos):
            return reorder(dst, cache, rows, (src // w) * w + (src % w + 1) % w, pos)

        return [(beam, "reorder_self_cache", reorder_from_next_beam)]
    raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
