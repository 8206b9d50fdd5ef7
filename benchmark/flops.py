"""Model operations of one request, counted from the configuration's
shapes, for the step's share of the chip's peak (``step.mfu_pct.*``).

A multiply-add is two operations. What is counted is the model's own
work at its real sizes: the 1500 encoder frames (not the 1536 the port
pads to), the self-attention over the positions filled so far, the
cross-attention over 1500 keys, the logits over the real vocabulary.
Nothing the port adds is counted (padding rows, quantization, the
language rows of a batch that did not ask for detection), and a padding
row of a batch counts for nothing. Imports nothing of the program."""

from __future__ import annotations

from benchmark.model_config import PROMPT_LEN, ModelShape


def encoder_flops(s: ModelShape) -> float:
    t, d, f = s.n_audio_ctx, s.d_model, s.ffn_dim
    stem = 2.0 * (2 * t) * s.n_mels * 3 * d + 2.0 * t * d * 3 * d
    per_layer = 2.0 * t * d * 4 * d + 4.0 * t * t * d + 4.0 * t * d * f
    return stem + s.encoder_layers * per_layer


def cross_fill_flops(s: ModelShape) -> float:
    return s.decoder_layers * 2.0 * s.n_audio_ctx * s.d_model * 2 * s.d_model


def decoder_token_flops(s: ModelShape, pos: int, logits: bool) -> float:
    """One token at position ``pos`` (attending to ``pos + 1`` keys)."""
    d, f, t = s.d_model, s.ffn_dim, s.n_audio_ctx
    per_layer = (2.0 * d * 3 * d + 4.0 * (pos + 1) * d + 2.0 * d * d  # self-attention
                 + 2.0 * d * d + 4.0 * t * d + 2.0 * d * d  # cross-attention
                 + 4.0 * d * f)  # FFN
    return s.decoder_layers * per_layer + (2.0 * d * s.n_vocab if logits else 0.0)


def request_flops(s: ModelShape, samples: int, beam_width: int = 1, detect: bool = False) -> float:
    """One utterance: the encoder, the cross fill, the language pass when
    detected, the prompt (logits at its last position), then one decode
    step per sample after the first (``samples`` counts the served tokens
    and the EOT that ended the stream), each over ``beam_width`` streams."""
    total = encoder_flops(s) + cross_fill_flops(s)
    if detect:
        total += decoder_token_flops(s, 0, False) + 2.0 * s.d_model * s.n_lang
    total += sum(decoder_token_flops(s, p, p == PROMPT_LEN - 1) for p in range(PROMPT_LEN))
    for k in range(1, samples):
        total += beam_width * decoder_token_flops(s, PROMPT_LEN + k - 1, True)
    return total
