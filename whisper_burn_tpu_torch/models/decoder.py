"""Whisper text decoder with a preallocated KV cache.

Port of ``whisper_burn_tpu/models/decoder.py``, in each cache mode the
``Compute`` presets give: the cross cache int4 pairs (``fastest(kv_bits=4)``)
or int8 (``fastest()``), both with per-channel scales, or unquantized in the
compute dtype (``parity()``, ``fast()``); the self cache int8 with per-token
scales (``fastest``), int4 keys and values with per-token, per-channel-group
scales (``self_kv_bits=4``), int8 keys and int4 values (``self_kv_vbits=4``,
the mixed mode), or unquantized.

* token embedding + learned positions by absolute position
* pre-norm blocks: self-attention (causal) -> cross-attention -> FFN
* cross K/V computed once per utterance from the encoder output
* output projection = tied token-embedding transpose (int8 copy with
  ``compute.quantized_logits``), padded vocab masked to -inf

The cross keys are stored transposed, ``[L, B, D, T]``, in every mode. The
JAX package keeps that layout where its TPU kernel's block fits (int4,
int8, and bf16 at Large-V3) and the natural one otherwise (f32 at
Large-V3, served by its general kernel); layouts do not bind the port, the
values do, so it keeps one layout and one cross kernel.

The decode step follows the JAX package's flash path (``_decode_step_flash``).
Per layer, kernel A serves the four projections and kernel I the FFN
(both by layer index, no weight copy; fc2's bias after the rounding, as
the JAX step adds it to K4's sum) and kernel C the cross-attention (C over int4, C'
over int8 or float caches; per-channel K scales folded into the query, V
scales into the output; with ``batch_groups=G`` the G streams of an
utterance share its cross cache). The self-attention takes one of these
branches, by ``batch_groups`` and the self cache's mode:

* ``1`` (greedy), int8: kernel B, the current token's raw K/V merged into
  the softmax and its quantized row and scales stored at ``pos`` in place.
  The JAX package takes this store-in-kernel branch only when ctx is one
  key tile and its deferred branch otherwise; kernel B computes the same
  function at any ctx, so the port always takes it here.
* ``1``, float: kernel B', the same merge without scales and without the
  store; the rows are written after the layer loop as below.
* ``1``, int4 or mixed (uint8 values): kernel G, the merge of B' over the
  packed cache with its group scales, without the store
  (``merged_store_ok`` is false for a uint8 cache). The JAX package serves
  it in-kernel only where ctx is one key tile and unpacks in XLA
  otherwise, the same function; the port takes kernel G at every ctx.
* ``> 1`` (beam search): the deferred-write branch. Kernel E (int8), E'
  (float) or H (int4 or mixed) attends over the cached keys,
  unnormalized, and :func:`flash_merge_extra_key` merges the current
  token's raw K/V.

Where the row is not stored in the kernel, the new rows of every layer are
written at ``pos`` after the layer loop by kernel F's slot form, K, V and
the scale row in one launch: quantized per token first for a quantized
cache (int8, or int4 groups packed by :func:`_quantize_tokens4`), cast to
the cache's dtype otherwise. With ``defer_slot`` the step takes the
deferred branch and returns those rows unwritten: beam search writes
them with kernel F's beam form, fused with its gather by parent beam
(``models/beam.py``).

Under tensor parallelism (``compute.tp > 1``) a rank holds
``n_text_head // tp`` heads: its caches are ``D / tp`` channels wide (the
int4 self cache pairs channels j and j + D/(2 tp) inside the shard, its
scale groups from that width), its per-token and per-channel scales are
this shard's absmax, and the row-parallel linears sum over the model
ranks; the embedding, the residual stream and the logits are replicated.
The int4 cross cache keeps the JAX layout at every head count: at an odd
count a rank (5 heads at Large-V3 over 4 ranks) kernel C serves one head
a block (``ops/decode_attention``).

The caches are updated in place. The decode step's position is a 0-d
int32 tensor on the device, read there by the kernels and by index ops,
never on the host: the step is one fixed sequence of launches at every
position, which the greedy loop captures once as a CUDA graph and replays
(``models/whisper.py``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from whisper_burn_tpu_torch.models.attention import attention, attention_kt, causal_mask, length_mask
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.layers import layer_norm
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.cache import write_cache_slots
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer,
    decode_attention_layer_int4,
    decode_attention_merged,
    decode_attention_merged_int4,
    decode_cross_attention,
    decode_self_attention,
    flash_merge_extra_key,
    unpack_int4,
)
from whisper_burn_tpu_torch.ops.ffn_kernel import K4_MAX_ROWS
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

    Cross keys are stored transposed, ``[L, B, D, T]``, values ``[L, B, T, D]``:
    int4 pairs biased by 8 (uint8, keys packed along D as ``[L, B, D/2, T]``,
    values along T as ``[L, B, T/2, D]``), int8 codes, or values in the
    compute dtype. A quantized cross cache has per-(layer, channel) f32
    scales ``[L, D]``. Self K/V are ``[L, B, ctx, D]``, int8 with per-token
    absmax/127 scales ``[L, B, ctx, 2]`` (K in lane 0, V in lane 1), or in
    the compute dtype with no scales. An int4 side is ``[L, B, ctx, D/2]``
    uint8 (channels j and j + D/2 in one byte) and takes
    :func:`self_kv_groups` scale lanes instead of one: ``[L, B, ctx,
    kw + vw]``, K lanes first.
    """

    self_k: torch.Tensor
    self_v: torch.Tensor
    self_kv_scale: torch.Tensor | None
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: torch.Tensor | None
    cross_v_scale: torch.Tensor | None


def cross_cache_len(cfg: WhisperConfig) -> int:
    """Logical cross-cache length: 1500 -> 1536 (pad keys masked); below
    512 a multiple of 8. Even, as int4 packs two positions per byte."""
    t = cfg.n_audio_ctx
    align = 512 if t >= 512 else 8
    return -(-t // align) * align


SELF_FIELDS = ("self_k", "self_v", "self_kv_scale")


def init_self_cache(cfg: WhisperConfig, streams: int, compute: Compute, ctx: int, device) -> dict:
    """The self fields of a zeroed :class:`KVCache` of ``streams`` streams,
    by name (``self_kv_scale`` None for an unquantized self cache); ``D / tp``
    channels wide."""
    l, d = cfg.n_text_layer, cfg.n_text_state // compute.tp
    kw = self_kv_groups(d) if compute.self_kv_packed else 1  # scale lanes of the keys
    vw = self_kv_groups(d) if compute.self_v_packed else 1
    zeros = lambda *shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return dict(
        self_k=zeros(l, streams, ctx, d // 2 if compute.self_kv_packed else d, dtype=compute.self_kv_storage_dtype),
        self_v=zeros(l, streams, ctx, d // 2 if compute.self_v_packed else d, dtype=compute.self_v_storage_dtype),
        self_kv_scale=zeros(l, streams, ctx, kw + vw, dtype=torch.float32) if compute.quantized_self_kv else None,
    )


def init_cache(cfg: WhisperConfig, batch: int, compute: Compute, ctx: int, device) -> KVCache:
    l, d, t = cfg.n_text_layer, cfg.n_text_state // compute.tp, cross_cache_len(cfg)
    zeros = lambda *shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    kv_dt = compute.cross_kv_dtype
    if compute.kv_packed:
        cross_k, cross_v = zeros(l, batch, d // 2, t, dtype=kv_dt), zeros(l, batch, t // 2, d, dtype=kv_dt)
    else:
        cross_k, cross_v = zeros(l, batch, d, t, dtype=kv_dt), zeros(l, batch, t, d, dtype=kv_dt)
    scale = lambda: torch.ones((l, d), dtype=torch.float32, device=device) if compute.quantized_kv else None
    return KVCache(
        **init_self_cache(cfg, batch, compute, ctx, device),
        cross_k=cross_k,
        cross_v=cross_v,
        cross_k_scale=scale(),
        cross_v_scale=scale(),
    )


def _embed(dec: dict, tokens: torch.Tensor, start: int | torch.Tensor, compute: Compute) -> torch.Tensor:
    """tokens [B, T] at absolute positions [start, start + T) -> [B, T, D].
    ``start`` is a host int (the prompt) or a 0-d device tensor (a decode
    step, T = 1), whose row is gathered on the device."""
    if isinstance(start, torch.Tensor):
        pos = dec["pos"].index_select(0, start.reshape(1))
    else:
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
    elif x.is_cuda and x.dtype == torch.bfloat16:
        # bf16 product with f32 output, as the JAX package asks of XLA: no
        # f32 copy of the [Vp, D] embedding per step
        logits = torch.mm(x, dec["tok_emb"].to(torch.bfloat16).T, out_dtype=torch.float32)
    else:
        # the CPU build of PyTorch has no mm with out_dtype: f32 product
        logits = x.float() @ dec["tok_emb"].to(compute.dtype).float().T
    return logits.masked_fill(torch.arange(logits.shape[-1], device=x.device) >= cfg.n_vocab, float("-inf"))


def _quantize_tokens(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 over channels: ``[..., D]`` -> (int8, f32 [..., 1])."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    return torch.round(xf / scale).to(torch.int8), scale


def self_kv_group_size(d: int) -> int:
    """Channel-group width of the int4 self-KV scales: the largest power of
    two <= 128 dividing the nibble-half width D/2 (a group never spans the
    two halves)."""
    d2 = d // 2
    for gsz in (128, 64, 32, 16, 8, 4, 2, 1):
        if d2 % gsz == 0:
            return gsz
    return max(d2, 1)


def self_kv_groups(d: int) -> int:
    """Number of int4 self-KV scale groups for channel width ``d``: even,
    ``ng/2`` over each nibble half."""
    return 2 * max(1, (d // 2) // self_kv_group_size(d))


def _quantize_tokens4(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token, per-channel-group int4: ``[..., D]`` -> (uint8 ``[..., D/2]``
    biased-nibble pairs by :func:`pack_int4`, f32 scales ``[..., ng]`` =
    group absmax / 7). Groups run in natural channel order: the first
    ``ng/2`` cover the low-nibble channels ``[0, D/2)``."""
    d = x.shape[-1]
    gsz, ng = self_kv_group_size(d), self_kv_groups(d)
    xg = x.float().reshape(*x.shape[:-1], ng, gsz)
    scale = torch.clamp_min(xg.abs().amax(dim=-1), 1e-8) / 7.0
    q = torch.clamp(torch.round(xg / scale[..., None]), -8, 7).reshape(x.shape).to(torch.int8)
    return pack_int4(q, -1), scale


def _quantize_self(x: torch.Tensor, packed: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows of a quantized self cache: int4 groups when ``packed``, else int8."""
    return _quantize_tokens4(x) if packed else _quantize_tokens(x)


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


def _quantize_kv_layer(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 of one layer's ``[B, T, D]``: absmax/127
    over batch and time together, as :func:`_quantize_kv_layer4`."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=(0, 1)), 1e-8) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8), scale


def fill_cross_cache(
    params: dict, cfg: WhisperConfig, enc_out: torch.Tensor, cache: KVCache, compute: Compute
) -> KVCache:
    """Project the encoder output to cross K/V layer by layer, zero-pad T to
    the cache length and store them in the cache's mode: int4-packed or
    int8 with per-channel scales, or cast to the cache dtype. Keys are
    stored transposed."""
    blocks = params["decoder"]["blocks"]
    enc = enc_out.to(compute.dtype)
    t = enc.shape[1]
    pad_to = cache.cross_k.shape[-1]
    for layer in range(cfg.n_text_layer):
        ck, cv = cross_kv_proj(blocks, enc, compute, layer=layer)
        ck = torch.nn.functional.pad(ck, (0, 0, 0, pad_to - t))
        cv = torch.nn.functional.pad(cv, (0, 0, 0, pad_to - t))
        if cache.cross_k.dtype == torch.uint8:
            ck, ks = _quantize_kv_layer4(ck, dim=2)  # [B, T, D/2]
            cv, vs = _quantize_kv_layer4(cv, dim=1)  # [B, T/2, D]
        elif cache.cross_k_scale is not None:
            ck, ks = _quantize_kv_layer(ck)
            cv, vs = _quantize_kv_layer(cv)
        if cache.cross_k_scale is not None:
            cache.cross_k_scale[layer] = ks
            cache.cross_v_scale[layer] = vs
        cache.cross_k[layer] = ck.transpose(1, 2)
        cache.cross_v[layer] = cv
    return cache


def _cross_layer(cache: KVCache, layer: int, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """One layer of the cross cache in ``dtype``, dequantized: keys
    ``[B, D, T]``, values ``[B, T, D]``."""
    ck, cv = cache.cross_k[layer], cache.cross_v[layer]
    if ck.dtype == torch.uint8:
        ck, cv = unpack_int4(ck, 1, dtype), unpack_int4(cv, 1, dtype)
    if cache.cross_k_scale is None:
        return ck, cv
    ks = cache.cross_k_scale[layer].to(dtype)[None, :, None]
    return ck.to(dtype) * ks, cv.to(dtype) * cache.cross_v_scale[layer].to(dtype)[None, None, :]


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
    Writes the self K/V into ``cache`` (quantized per token for an int8 or
    int4 cache) unless ``write_cache`` is False (language detection, with
    ``logit_rows``). Its linears run at M = B*T through kernel A and its FFN
    through kernel I (fc2's bias in K7's order); its
    attentions are plain PyTorch over the dequantized cross cache, as the
    JAX package leaves them to XLA."""
    dec = params["decoder"]
    blocks = dec["blocks"]
    b, t = tokens.shape
    dev = tokens.device
    n_heads = cfg.n_text_head // compute.tp
    x = _embed(dec, tokens, 0, compute)
    mask = causal_mask(t, t, device=dev)
    cross_t = cache.cross_k.shape[-1]
    cross_mask = length_mask(cfg.n_audio_ctx, cross_t, device=dev) if cross_t != cfg.n_audio_ctx else None
    new_kv = []
    for layer in range(cfg.n_text_layer):
        h = layer_norm(x, *_ln(blocks, "attn_ln", layer))
        q, k, v = qkv_proj(blocks, h, compute, layer=layer)
        a = attention(q, k, v, n_heads, mask=mask, compute=compute)
        x = x + apply_reduce_linear(blocks["attn_o"], a, compute, layer=layer)

        ck, cv = _cross_layer(cache, layer, compute.dtype)
        h = layer_norm(x, *_ln(blocks, "xattn_ln", layer))
        qx = apply_linear(blocks["xattn_q"], h, compute, layer=layer)
        a = attention_kt(qx, ck, cv, n_heads, mask=cross_mask, compute=compute)
        x = x + apply_reduce_linear(blocks["xattn_o"], a, compute, layer=layer)

        h = layer_norm(x, *_ln(blocks, "mlp_ln", layer))
        x = x + apply_ffn(blocks, h, cfg.gelu, compute, layer=layer)
        new_kv.append((k, v))

    if write_cache:
        for layer, (k, v) in enumerate(new_kv):
            if cache.self_kv_scale is not None:
                k, ksc = _quantize_self(k, cache.self_k.dtype == torch.uint8)
                v, vsc = _quantize_self(v, cache.self_v.dtype == torch.uint8)
                cache.self_kv_scale[layer, :, :t] = torch.cat([ksc, vsc], dim=-1)
            cache.self_k[layer, :, :t] = k
            cache.self_v[layer, :, :t] = v
    return _logits(dec, x[:, -1], cfg, compute, rows=logit_rows)


def decode_step(
    params: dict, cfg: WhisperConfig, token: torch.Tensor, pos: torch.Tensor, cache: KVCache,
    compute: Compute, batch_groups: int = 1, defer_slot: bool = False,
):
    """One step for ``token [B]`` at cache position ``pos``, a 0-d int32
    tensor on the token's device (``0 <= pos < ctx``, which the caller
    checks: nothing here reads it on the host). Returns logits ``[B, Vp]``
    f32; the cache gains row ``pos`` in place. ``batch_groups=G > 1``
    (beam search) shares each cross-cache entry among G consecutive
    streams: the self cache holds B streams, the cross cache B / G. With
    ``defer_slot`` the step takes the deferred branch, leaves the cache
    as it was and returns ``(logits, rows)``: the rows of ``pos`` across
    all layers in the self cache's storage, ``(k, v, scales)`` as
    ``[L, B, 1, W]`` (``scales`` None for an unquantized self cache)."""
    b = token.shape[0]
    if batch_groups < 1 or cache.self_k.shape[1] != b or cache.cross_k.shape[1] * batch_groups != b:
        raise ValueError(
            f"decode_step: {b} streams, self cache of {cache.self_k.shape[1]}, cross cache of "
            f"{cache.cross_k.shape[1]} x batch_groups {batch_groups}"
        )
    deferred = batch_groups > 1 or defer_slot
    quantized_self = cache.self_kv_scale is not None
    k_packed, v_packed = cache.self_k.dtype == torch.uint8, cache.self_v.dtype == torch.uint8
    store_in_kernel = quantized_self and not v_packed and not deferred  # kernel B
    dec = params["decoder"]
    blocks = dec["blocks"]
    n_heads = cfg.n_text_head // compute.tp
    x = _embed(dec, token[:, None], pos, compute)  # [B, 1, D]
    new_k, new_v = [], []
    for layer in range(cfg.n_text_layer):
        h = layer_norm(x, *_ln(blocks, "attn_ln", layer))
        q, k_new, v_new = qkv_proj(blocks, h, compute, layer=layer)
        self_cache = (q, cache.self_k, cache.self_v, cache.self_kv_scale, layer, pos, n_heads)
        if deferred:
            attend = decode_attention_layer_int4 if v_packed else decode_attention_layer
            a = flash_merge_extra_key(*attend(*self_cache), q, k_new, v_new, n_heads)
        elif store_in_kernel:
            kq, ksc = _quantize_tokens(k_new)
            vq, vsc = _quantize_tokens(v_new)
            a = decode_self_attention(*self_cache, k_new, v_new, kq, vq, torch.cat([ksc, vsc], dim=-1))
        elif v_packed:
            a = decode_attention_merged_int4(*self_cache, k_new, v_new)
        else:
            a = decode_attention_merged(q, cache.self_k, cache.self_v, layer, pos, n_heads, k_new, v_new)
        if not store_in_kernel:
            new_k.append(k_new)
            new_v.append(v_new)
        x = x + apply_reduce_linear(blocks["attn_o"], a.to(compute.dtype), compute, layer=layer)

        h = layer_norm(x, *_ln(blocks, "xattn_ln", layer))
        qx = apply_linear(blocks["xattn_q"], h, compute, layer=layer)
        if cache.cross_k_scale is not None:
            qx = qx * cache.cross_k_scale[layer].to(qx.dtype)
        a = decode_cross_attention(
            qx, cache.cross_k, cache.cross_v, layer, cfg.n_audio_ctx, n_heads, batch_groups
        )
        if cache.cross_v_scale is not None:
            a = a * cache.cross_v_scale[layer]
        x = x + apply_reduce_linear(blocks["xattn_o"], a.to(compute.dtype), compute, layer=layer)

        h = layer_norm(x, *_ln(blocks, "mlp_ln", layer))
        x = x + apply_ffn(blocks, h, cfg.gelu, compute, layer=layer, bias_after_round=b <= K4_MAX_ROWS)
    rows = None
    if new_k:  # one slot across all layers: [L, B, 1, D(/2)] rows, [L, B, 1, kw + vw] scales
        ks, vs = torch.stack(new_k), torch.stack(new_v)
        scales = None
        if quantized_self:
            (ks, ksc), (vs, vsc) = _quantize_self(ks, k_packed), _quantize_self(vs, v_packed)
            scales = torch.cat([ksc, vsc], dim=-1)
        rows = (ks.to(cache.self_k.dtype), vs.to(cache.self_v.dtype), scales)
        if not defer_slot:
            write_cache_slots([(getattr(cache, n), r) for n, r in zip(SELF_FIELDS, rows) if r is not None], pos)
    with record_function("decode_step.logits"):
        logits = _logits(dec, x[:, 0], cfg, compute)
    return (logits, rows) if defer_slot else logits
