"""HuggingFace Whisper -> Q4_0 GGUF conversion.

Port of ``whisper_burn_tpu/gguf/convert.py``, through the port's
:class:`GgufWriter` (byte for byte the JAX writer's):

* tensor names follow the GGUF convention (``encoder.blocks.{i}.attn.query``,
  ``mlp.0``/``mlp.2``, ``cross_attn``, ...); ``proj_out`` is dropped (tied)
* quantization policy: Q4_0 only for 2-D matrices with min(shape) >= 256,
  excluding biases, layer norms, embeddings, and convs — everything else F32
* GGUF v3, little-endian, reversed dims, 32-byte-aligned tensor offsets

:func:`convert_hf_model` imports ``transformers`` when it is called, and
reads a local checkpoint directory or a name already in the local
HuggingFace cache (``local_files_only``); the CLI's ``convert`` wraps it.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

import numpy as np

from whisper_burn_tpu_torch.gguf.writer import GgufWriter

# HF parameter-path fragments -> GGUF fragments, applied in order.
_RENAMES: tuple[tuple[str, str], ...] = (
    (r"^model\.", ""),
    (r"^encoder\.layers\.", "encoder.blocks."),
    (r"^decoder\.layers\.", "decoder.blocks."),
    (r"^encoder\.layer_norm\.", "encoder.ln_post."),
    (r"^decoder\.layer_norm\.", "decoder.ln."),
    (r"^encoder\.embed_positions\.weight$", "encoder.positional_embedding"),
    (r"^decoder\.embed_positions\.weight$", "decoder.positional_embedding"),
    (r"^decoder\.embed_tokens\.weight$", "decoder.token_embedding.weight"),
    (r"\.self_attn_layer_norm\.", ".attn_ln."),
    (r"\.encoder_attn_layer_norm\.", ".cross_attn_ln."),
    (r"\.final_layer_norm\.", ".mlp_ln."),
    (r"\.self_attn\.", ".attn."),
    (r"\.encoder_attn\.", ".cross_attn."),
    (r"\.q_proj\.", ".query."),
    (r"\.k_proj\.", ".key."),
    (r"\.v_proj\.", ".value."),
    (r"\.out_proj\.", ".out."),
    (r"\.fc1\.", ".mlp.0."),
    (r"\.fc2\.", ".mlp.2."),
)


def hf_name_to_gguf(hf_name: str) -> str | None:
    """Map an HF parameter name to the GGUF convention; None = skip."""
    if hf_name.startswith("proj_out."):
        return None  # tied to token_embedding, not stored
    name = hf_name
    for pattern, repl in _RENAMES:
        name = re.sub(pattern, repl, name)
    if not (name.startswith("encoder.") or name.startswith("decoder.")):
        return None
    return name


def should_quantize(name: str, shape: tuple[int, ...]) -> bool:
    """The Q4_0 policy: 2-D matrices of min(shape) >= 256 that are not
    biases, LayerNorms, embeddings or convs."""
    if len(shape) != 2 or min(shape) < 256:
        return False
    excluded = ("bias", "ln", "layer_norm", "positional_embedding", "token_embedding", "conv")
    return not any(tok in name for tok in excluded)


def convert_state_dict(
    state_dict: Mapping[str, np.ndarray],
    *,
    model_name: str = "whisper",
    n_lang: int | None = None,
    extra_metadata: Iterable[tuple[str, int]] = (),
) -> GgufWriter:
    """Build a GGUF writer from an HF-style state dict (numpy values)."""
    tensor_map: dict[str, np.ndarray] = {}
    for hf_name, value in state_dict.items():
        gguf_name = hf_name_to_gguf(hf_name)
        if gguf_name is not None:
            tensor_map[gguf_name] = np.asarray(value, dtype=np.float32)

    w = GgufWriter()
    w.add_string("general.architecture", "whisper")
    w.add_string("general.name", model_name)
    enc_layers = len({n.split(".")[2] for n in tensor_map if n.startswith("encoder.blocks.")})
    dec_layers = len({n.split(".")[2] for n in tensor_map if n.startswith("decoder.blocks.")})
    w.add_u32("whisper.encoder.layer_count", enc_layers)
    w.add_u32("whisper.decoder.layer_count", dec_layers)
    if n_lang is not None:
        w.add_u32("whisper.n_lang", n_lang)
    for key, value in extra_metadata:
        w.add_u32(key, value)

    for name in sorted(tensor_map):
        arr = tensor_map[name]
        w.add_tensor(name, arr, quantize=should_quantize(name, arr.shape))
    return w


def convert_hf_model(model_name: str, output_path: str) -> None:
    """Load a HF Whisper checkpoint (a local directory, or a name in the
    local HuggingFace cache; nothing is fetched) and write a Q4_0 GGUF."""
    from transformers import WhisperForConditionalGeneration

    model = WhisperForConditionalGeneration.from_pretrained(model_name, torch_dtype="auto", local_files_only=True)
    state = {k: v.float().numpy() for k, v in model.state_dict().items()}
    # large-v3 family carries 100 language tokens, earlier models 99
    n_lang = 100 if model.config.num_mel_bins >= 128 else 99
    writer = convert_state_dict(state, model_name=model_name, n_lang=n_lang)
    writer.write(output_path)
