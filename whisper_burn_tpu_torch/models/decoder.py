"""Whisper text decoder with a preallocated, quantized KV cache.

Port of ``whisper_burn_tpu/models/decoder.py`` for the serving modes:
int4-packed cross-KV with per-channel scales and int8 per-token self-KV.

* token embedding + learned positions by absolute position
* pre-norm blocks: self-attention (causal) -> cross-attention -> FFN
* cross K/V computed once per utterance from the encoder output
* output projection = tied token-embedding transpose (int8 copy with
  ``compute.quantized_logits``), padded vocab masked to -inf

The decode step follows the JAX package's flash path (``_decode_step_flash``).
Per layer, kernel A serves the four projections and the FFN (by layer
index, no weight copy) and kernel C the cross-attention (per-channel K
scales folded into the query, V scales into the output; with
``batch_groups=G`` the G streams of an utterance share its cross cache).
The self-attention takes one of two branches, by ``batch_groups``:

* ``1`` (greedy): kernel B, the current token's raw K/V merged into the
  softmax and its quantized row and scales stored at ``pos`` in place.
  The JAX package takes this store-in-kernel branch only when ctx is one
  key tile and its deferred branch otherwise; kernel B computes the same
  function at any ctx, so the port always takes it here.
* ``> 1`` (beam search): the deferred-write branch. Kernel E attends over
  the cached keys, unnormalized, :func:`flash_merge_extra_key` merges the
  current token's raw K/V; after the layer loop the new rows of every
  layer are quantized per token, kernel F writes them at ``pos`` and a
  slice assignment the scales.

The caches are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from whisper_burn_tpu_torch.models.attention import attention, attention_kt, causal_mask, length_mask
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.layers import layer_norm
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.cache import write_cache_slot
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer,
    decode_cross_attention,
    decode_self_attention,
    flash_merge_extra_key,
    unpack_int4,
)
from whisper_burn_tpu_torch.ops.linear import (
    apply_ffn,
    apply_linear,
    apply_reduce_linear,
    cross_kv_proj,
    qkv_proj,
)
from whisper_burn_tpu_torch.ops.q4_matmul import q4_matmul


@dataclasses.dataclass
class KVCache:
    """Preallocated decoder cache, updated in place.

    Cross keys are int4 pairs packed along D, stored ``[L, B, D/2, T]``;
    cross values packed along T, stored ``[L, B, T/2, D]``; both biased by
    8, with per-(layer, channel) f32 scales ``[L, D]``. Self K/V are int8
    ``[L, B, ctx, D]`` with per-token absmax/127 scales ``[L, B, ctx, 2]``
    (K in lane 0, V in lane 1).
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    self_kv_scale: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor
    cross_v_scale: torch.Tensor


def check_supported(compute: Compute) -> None:
    """The decode path of this port needs the serving cache modes."""
    if not compute.kv_packed:
        raise NotImplementedError(
            "only the int4 cross-KV cache is ported (Compute.fastest(kv_bits=4)); the "
            "int8/bf16 cross cache needs _kt_kernel's other branches: ROADMAP Queue 2, K3"
        )
    if not compute.quantized_self_kv:
        raise NotImplementedError(
            "only the int8 self-KV cache is ported; the unquantized self cache needs the "
            "general decode kernel's unscaled form: ROADMAP Queue 2, K8"
        )


def cross_cache_len(cfg: WhisperConfig) -> int:
    """Logical cross-cache length: 1500 -> 1536 (pad keys masked); below
    512 a multiple of 8. Even, as int4 packs two positions per byte."""
    t = cfg.n_audio_ctx
    align = 512 if t >= 512 else 8
    return -(-t // align) * align


def init_cache(cfg: WhisperConfig, batch: int, compute: Compute, ctx: int, device) -> KVCache:
    check_supported(compute)
    l, d, t = cfg.n_text_layer, cfg.n_text_state, cross_cache_len(cfg)
    return KVCache(
        self_k=torch.zeros((l, batch, ctx, d), dtype=torch.int8, device=device),
        self_v=torch.zeros((l, batch, ctx, d), dtype=torch.int8, device=device),
        self_kv_scale=torch.zeros((l, batch, ctx, 2), dtype=torch.float32, device=device),
        cross_k=torch.zeros((l, batch, d // 2, t), dtype=torch.uint8, device=device),
        cross_v=torch.zeros((l, batch, t // 2, d), dtype=torch.uint8, device=device),
        cross_k_scale=torch.ones((l, d), dtype=torch.float32, device=device),
        cross_v_scale=torch.ones((l, d), dtype=torch.float32, device=device),
    )


def _embed(dec: dict, tokens: torch.Tensor, start: int, compute: Compute) -> torch.Tensor:
    """tokens [B, T] at absolute positions [start, start + T) -> [B, T, D].
    The positions are a slice (a view), so a step copies nothing from the
    host."""
    pos = dec["pos"][start : start + tokens.shape[1]]
    return (dec["tok_emb"][tokens] + pos[None]).to(compute.dtype)


def _logits(
    dec: dict, x: torch.Tensor, cfg: WhisperConfig, compute: Compute,
    rows: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Final LN + tied-embedding projection: ``[B, D] -> [B, n_vocab_padded]``
    f32 with the padded vocab at -inf; ``rows=(start, end)`` projects onto
    that embedding slice only (language detection)."""
    x = layer_norm(x, dec["ln"]["g"], dec["ln"]["b"]).to(compute.dtype)
    if rows is not None:
        emb = dec["tok_emb"][rows[0] : rows[1]].to(compute.dtype)
        return x.float() @ emb.float().T
    if compute.quantized_logits:
        q = dec.get("tok_emb_q")
        if q is None:
            raise ValueError(
                "compute.quantized_logits needs params prepared with "
                "transcribe.prepare_params (missing decoder.tok_emb_q)"
            )
        logits = q4_matmul(x, q["qw"], q["scales"], compute, out_dtype=torch.float32)
        logits = logits[..., : cfg.n_vocab_padded]
    else:
        logits = x.float() @ dec["tok_emb"].to(compute.dtype).float().T
    return logits.masked_fill(torch.arange(logits.shape[-1], device=x.device) >= cfg.n_vocab, float("-inf"))


def _quantize_tokens(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 over channels: ``[..., D]`` -> (int8, f32 [..., 1])."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    return torch.round(xf / scale).to(torch.int8), scale


def pack_int4(q4: torch.Tensor, dim: int) -> torch.Tensor:
    """int8 values in [-8, 7] -> biased-nibble uint8 pairs along ``dim``:
    element j pairs with j + size/2 (low nibble, high nibble)."""
    lo, hi = (q4 + 8).to(torch.uint8).chunk(2, dim=dim)
    return lo | (hi << 4)


def _quantize_kv_layer4(x: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel int4 of one layer's ``[B, T, D]``, packed along ``dim``.
    The absmax runs over batch and time together, so an utterance's cache
    depends on its batch mates, as in the JAX package."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=(0, 1)), 1e-8) / 7.0
    q = torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int8)
    return pack_int4(q, dim), scale


def fill_cross_cache(
    params: dict, cfg: WhisperConfig, enc_out: torch.Tensor, cache: KVCache, compute: Compute
) -> KVCache:
    """Project the encoder output to cross K/V layer by layer and store
    them int4-packed with per-channel scales."""
    blocks = params["decoder"]["blocks"]
    enc = enc_out.to(compute.dtype)
    t = enc.shape[1]
    pad_to = cache.cross_v.shape[2] * 2
    for layer in range(cfg.n_text_layer):
        ck, cv = cross_kv_proj(blocks, enc, compute, layer=layer)
        ck = torch.nn.functional.pad(ck, (0, 0, 0, pad_to - t))
        cv = torch.nn.functional.pad(cv, (0, 0, 0, pad_to - t))
        ck_q, ks = _quantize_kv_layer4(ck, dim=2)  # [B, T, D/2]
        cv_q, vs = _quantize_kv_layer4(cv, dim=1)  # [B, T/2, D]
        cache.cross_k[layer] = ck_q.transpose(1, 2)
        cache.cross_v[layer] = cv_q
        cache.cross_k_scale[layer] = ks
        cache.cross_v_scale[layer] = vs
    return cache


def _ln(blocks: dict, name: str, layer: int):
    return blocks[name]["g"][layer], blocks[name]["b"][layer]


def prefill(
    params: dict,
    cfg: WhisperConfig,
    tokens: torch.Tensor,
    cache: KVCache,
    compute: Compute,
    logit_rows: tuple[int, int] | None = None,
    write_cache: bool = True,
) -> torch.Tensor:
    """Prompt pass over ``tokens [B, T]`` at cache positions ``[0, T)``;
    returns the last position's logits.
    Writes the quantized self K/V into ``cache`` unless ``write_cache`` is
    False (language detection, with ``logit_rows``). Its linears run at
    M = B*T through kernel A; its attentions are plain PyTorch over the
    dequantized cross cache, as the JAX package leaves them to XLA."""
    dec = params["decoder"]
    blocks = dec["blocks"]
    b, t = tokens.shape
    dev = tokens.device
    n_heads = cfg.n_text_head
    x = _embed(dec, tokens, 0, compute)
    mask = causal_mask(t, t, device=dev)
    cross_t = cache.cross_v.shape[2] * 2
    cross_mask = length_mask(cfg.n_audio_ctx, cross_t, device=dev) if cross_t != cfg.n_audio_ctx else None
    new_kv = []
    for layer in range(cfg.n_text_layer):
        h = layer_norm(x, *_ln(blocks, "attn_ln", layer))
        q, k, v = qkv_proj(blocks, h, compute, layer=layer)
        a = attention(q, k, v, n_heads, mask=mask, compute=compute)
        x = x + apply_reduce_linear(blocks["attn_o"], a, compute, layer=layer)

        ck = unpack_int4(cache.cross_k[layer], 1, compute.dtype) * cache.cross_k_scale[layer].to(compute.dtype)[None, :, None]
        cv = unpack_int4(cache.cross_v[layer], 1, compute.dtype) * cache.cross_v_scale[layer].to(compute.dtype)[None, None, :]
        h = layer_norm(x, *_ln(blocks, "xattn_ln", layer))
        qx = apply_linear(blocks["xattn_q"], h, compute, layer=layer)
        a = attention_kt(qx, ck, cv, n_heads, mask=cross_mask, compute=compute)
        x = x + apply_reduce_linear(blocks["xattn_o"], a, compute, layer=layer)

        h = layer_norm(x, *_ln(blocks, "mlp_ln", layer))
        x = x + apply_ffn(blocks, h, cfg.gelu, compute, layer=layer)
        new_kv.append((k, v))

    if write_cache:
        for layer, (k, v) in enumerate(new_kv):
            kq, ksc = _quantize_tokens(k)
            vq, vsc = _quantize_tokens(v)
            cache.self_k[layer, :, :t] = kq
            cache.self_v[layer, :, :t] = vq
            cache.self_kv_scale[layer, :, :t] = torch.cat([ksc, vsc], dim=-1)
    return _logits(dec, x[:, -1], cfg, compute, rows=logit_rows)


def decode_step(
    params: dict, cfg: WhisperConfig, token: torch.Tensor, pos: int, cache: KVCache,
    compute: Compute, batch_groups: int = 1,
) -> torch.Tensor:
    """One step for ``token [B]`` at cache position ``pos`` (a host int:
    the loop knows it without a device sync). Returns logits ``[B, Vp]``
    f32; the cache gains row ``pos`` in place. ``batch_groups=G > 1``
    (beam search) shares each cross-cache entry among G consecutive
    streams: the self cache holds B streams, the cross cache B / G."""
    check_supported(compute)
    b = token.shape[0]
    if batch_groups < 1 or cache.self_k.shape[1] != b or cache.cross_k.shape[1] * batch_groups != b:
        raise ValueError(
            f"decode_step: {b} streams, self cache of {cache.self_k.shape[1]}, cross cache of "
            f"{cache.cross_k.shape[1]} x batch_groups {batch_groups}"
        )
    deferred = batch_groups > 1
    dec = params["decoder"]
    blocks = dec["blocks"]
    n_heads = cfg.n_text_head
    x = _embed(dec, token[:, None], pos, compute)  # [B, 1, D]
    new_k, new_v = [], []
    for layer in range(cfg.n_text_layer):
        h = layer_norm(x, *_ln(blocks, "attn_ln", layer))
        q, k_new, v_new = qkv_proj(blocks, h, compute, layer=layer)
        if deferred:
            state = decode_attention_layer(
                q, cache.self_k, cache.self_v, cache.self_kv_scale, layer, pos, n_heads
            )
            a = flash_merge_extra_key(*state, q, k_new, v_new, n_heads)
            new_k.append(k_new)
            new_v.append(v_new)
        else:
            kq, ksc = _quantize_tokens(k_new)
            vq, vsc = _quantize_tokens(v_new)
            a = decode_self_attention(
                q, cache.self_k, cache.self_v, cache.self_kv_scale, layer, pos, n_heads,
                k_new, v_new, kq, vq, torch.cat([ksc, vsc], dim=-1),
            )
        x = x + apply_reduce_linear(blocks["attn_o"], a.to(compute.dtype), compute, layer=layer)

        h = layer_norm(x, *_ln(blocks, "xattn_ln", layer))
        qx = apply_linear(blocks["xattn_q"], h, compute, layer=layer)
        qx = qx * cache.cross_k_scale[layer].to(qx.dtype)
        a = decode_cross_attention(
            qx, cache.cross_k, cache.cross_v, layer, cfg.n_audio_ctx, n_heads, batch_groups
        )
        a = a * cache.cross_v_scale[layer]
        x = x + apply_reduce_linear(blocks["xattn_o"], a.to(compute.dtype), compute, layer=layer)

        h = layer_norm(x, *_ln(blocks, "mlp_ln", layer))
        x = x + apply_ffn(blocks, h, cfg.gelu, compute, layer=layer)
    if deferred:  # one slot across all layers: [L, B, 1, D] rows, [L, B, 1, 1] scales
        kq, ksc = _quantize_tokens(torch.stack(new_k))
        vq, vsc = _quantize_tokens(torch.stack(new_v))
        write_cache_slot(cache.self_k, kq, pos)
        write_cache_slot(cache.self_v, vq, pos)
        cache.self_kv_scale[:, :, pos] = torch.cat([ksc, vsc], dim=-1)[:, :, 0]
    return _logits(dec, x[:, 0], cfg, compute)
