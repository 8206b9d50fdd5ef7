"""Whisper audio encoder (port of models/encoder.py).

``[B, n_mels, 3000]`` -> conv1(k=3, s=1, p=1) -> GELU -> conv2(k=3, s=2,
p=1) -> GELU -> transpose -> + positions -> L pre-norm blocks (LN ->
non-causal self-attention -> residual; LN -> FFN -> residual) -> final LN
-> ``[B, 1500, D]``. T is padded to a multiple of 128 once for the whole
stack (1500 -> 1536) with the pad keys masked in attention (kernel D).
Under tensor parallelism (``compute.tp > 1``) each rank holds
``n_audio_head // tp`` heads of q/k/v and a K shard of attn_o and fc2,
whose partial sums ``ops/linear`` adds over the model ranks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.layers import conv1d, gelu, layer_norm
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.encoder_attention import encoder_attention
from whisper_burn_tpu_torch.ops.linear import apply_ffn, apply_reduce_linear, qkv_proj

PAD_MULTIPLE = 128


def encoder_block(
    x: torch.Tensor, blocks: dict, layer: int, cfg: WhisperConfig, compute: Compute, valid: int
) -> torch.Tensor:
    """Layer ``layer`` of the stacked encoder blocks; ``valid`` real rows."""
    ln = lambda name: (blocks[name]["g"][layer], blocks[name]["b"][layer])
    h = layer_norm(x, *ln("attn_ln"))
    q, k, v = qkv_proj(blocks, h, compute, layer=layer)
    a = encoder_attention(q, k, v, cfg.n_audio_head // compute.tp, valid=valid)
    # the projection is a temporary: held past the norm, it would stay alive through the FFN's peak
    x, h = layer_norm(x, *ln("mlp_ln"), residual=apply_reduce_linear(blocks["attn_o"], a, compute, layer=layer))
    return x + apply_ffn(blocks, h, cfg.gelu, compute, layer=layer)


def encode(params: dict, mel: torch.Tensor, cfg: WhisperConfig, compute: Compute) -> torch.Tensor:
    """Mel ``[B, n_mels, T_mel]`` -> hidden states ``[B, T_mel/2, D]``."""
    enc = params["encoder"]
    x = gelu(conv1d(mel, enc["conv1"]["w"], enc["conv1"]["b"], stride=1, padding=1, compute=compute), cfg.gelu)
    x = gelu(conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2, padding=1, compute=compute), cfg.gelu)
    x = x.transpose(1, 2)  # [B, T, D]
    seq = x.shape[1]
    x = x + enc["pos"][:seq].to(x.dtype)[None]
    tp = -(-seq // PAD_MULTIPLE) * PAD_MULTIPLE
    x = F.pad(x, (0, 0, 0, tp - seq)).contiguous()
    for layer in range(cfg.n_audio_layer):
        x = encoder_block(x, enc["blocks"], layer, cfg, compute, valid=seq)
    return layer_norm(x[:, :seq], enc["ln_post"]["g"], enc["ln_post"]["b"])
