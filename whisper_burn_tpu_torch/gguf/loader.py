"""GGUF checkpoint -> the port's parameter dict (numpy leaves).

Port of ``whisper_burn_tpu/gguf/loader.py`` (the port's own copy). It walks
the GGUF tensor names (``encoder.blocks.{i}.attn.query.weight`` and so on,
as the converter writes them) into the structure of ``models/params.py``:
Q4_0 weights repacked to ``{qw, scales}`` (``gguf/repack.py``), F32 and F16
weights transposed from the checkpoint's ``[N, K]`` to a dense ``{w: [K,
N]}``, each bias optional. The leaves stay numpy arrays, as the JAX
loader's do; ``params_to_torch`` or ``WhisperPipeline`` puts them on a
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

from whisper_burn_tpu_torch.gguf.reader import GgmlDtype, GgufReader
from whisper_burn_tpu_torch.gguf.repack import repack_q4_0
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import Params, stack_layers


@dataclass
class LoadedModel:
    config: WhisperConfig
    params: Params  # numpy leaves


def _linear(r: GgufReader, prefix: str) -> Params:
    """``{prefix}.weight`` (and ``.bias`` where present) as a linear."""
    info = r.tensor_info(f"{prefix}.weight")
    n_out, k_in = info.shape
    if info.dtype is GgmlDtype.Q4_0:
        qt = repack_q4_0(r.tensor_data(info.name), n_out, k_in)
        p: Params = {"qw": qt.qw, "scales": qt.scales}
    else:
        p = {"w": np.ascontiguousarray(r.tensor_f32(info.name).T)}
    bias_name = f"{prefix}.bias"
    if bias_name in r.tensors:
        p["b"] = r.tensor_f32(bias_name)
    return p


def _ln(r: GgufReader, prefix: str) -> Params:
    return {"g": r.tensor_f32(f"{prefix}.weight"), "b": r.tensor_f32(f"{prefix}.bias")}


def _attn(r: GgufReader, prefix: str, tag: str) -> Params:
    return {
        f"{tag}_q": _linear(r, f"{prefix}.query"),
        f"{tag}_k": _linear(r, f"{prefix}.key"),
        f"{tag}_v": _linear(r, f"{prefix}.value"),
        f"{tag}_o": _linear(r, f"{prefix}.out"),
    }


def _block(r: GgufReader, prefix: str, cross: bool) -> Params:
    p: Params = {
        "attn_ln": _ln(r, f"{prefix}.attn_ln"),
        **_attn(r, f"{prefix}.attn", "attn"),
        "mlp_ln": _ln(r, f"{prefix}.mlp_ln"),
        "fc1": _linear(r, f"{prefix}.mlp.0"),
        "fc2": _linear(r, f"{prefix}.mlp.2"),
    }
    if cross:
        p["xattn_ln"] = _ln(r, f"{prefix}.cross_attn_ln")
        p.update(_attn(r, f"{prefix}.cross_attn", "xattn"))
    return p


def _count_blocks(r: GgufReader, side: str) -> int:
    n = 0
    while f"{side}.blocks.{n}.attn_ln.weight" in r.tensors:
        n += 1
    return n


def infer_config(r: GgufReader) -> WhisperConfig:
    """The architecture from the tensor shapes and the metadata: widths,
    mel bins and contexts from the shapes (64-wide heads across the
    family), the layer counts from ``whisper.{encoder,decoder}.layer_count``
    or else by counting blocks, and ``n_lang`` from ``whisper.n_lang`` or
    else from the mel bins (100 at 128, 99 below)."""
    n_vocab, d = r.tensor_info("decoder.token_embedding.weight").shape
    n_mels = r.tensor_info("encoder.conv1.weight").shape[1]
    meta = r.metadata
    return WhisperConfig(
        n_mels=n_mels,
        n_audio_ctx=r.tensor_info("encoder.positional_embedding").shape[0],
        n_audio_state=d,
        n_audio_head=d // 64,
        n_audio_layer=int(meta.get("whisper.encoder.layer_count", 0)) or _count_blocks(r, "encoder"),
        n_text_ctx=r.tensor_info("decoder.positional_embedding").shape[0],
        n_text_state=d,
        n_text_head=d // 64,
        n_text_layer=int(meta.get("whisper.decoder.layer_count", 0)) or _count_blocks(r, "decoder"),
        n_vocab=n_vocab,
        n_lang=int(meta.get("whisper.n_lang", 100 if n_mels >= 128 else 99)),
    )


def load_whisper_from_gguf(source: str | Path | bytes) -> LoadedModel:
    """A GGUF checkpoint (a file path or the container's bytes) parsed into
    its config and parameters."""
    r = GgufReader.from_bytes(source) if isinstance(source, bytes) else GgufReader.open(source)
    cfg = infer_config(r)

    enc_blocks = [_block(r, f"encoder.blocks.{i}", cross=False) for i in range(cfg.n_audio_layer)]
    dec_blocks = [_block(r, f"decoder.blocks.{i}", cross=True) for i in range(cfg.n_text_layer)]

    padded = np.zeros((cfg.n_vocab_padded, cfg.n_text_state), np.float32)
    padded[: cfg.n_vocab] = r.tensor_f32("decoder.token_embedding.weight")

    params: Params = {
        "encoder": {
            "conv1": {"w": r.tensor_f32("encoder.conv1.weight"), "b": r.tensor_f32("encoder.conv1.bias")},
            "conv2": {"w": r.tensor_f32("encoder.conv2.weight"), "b": r.tensor_f32("encoder.conv2.bias")},
            "pos": r.tensor_f32("encoder.positional_embedding"),
            "blocks": stack_layers(enc_blocks),
            "ln_post": _ln(r, "encoder.ln_post"),
        },
        "decoder": {
            "tok_emb": padded,
            "pos": r.tensor_f32("decoder.positional_embedding"),
            "blocks": stack_layers(dec_blocks),
            "ln": _ln(r, "decoder.ln"),
        },
    }
    return LoadedModel(config=cfg, params=params)
