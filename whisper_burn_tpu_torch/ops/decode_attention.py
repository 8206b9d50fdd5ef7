"""Kernels B, B', C, C', E, E', G and H: decode attention over the caches.

Counterpart of ``whisper_burn_tpu/ops/pallas_attention.py``; source
``csrc/decode_attention.cu``.

* :func:`decode_self_attention` (kernel B) replaces ``_kernel`` in its
  merged + store form over the int8 self cache
  (``decode_attention_merged(kq=, vq=)``, K2).
* :func:`decode_attention_merged` (kernel B') replaces the same form over a
  float self cache, without scales and without the store
  (``decode_attention_merged`` without ``kq``/``vq``, K2).
* :func:`decode_attention_layer` replaces ``_kernel`` in its general,
  unnormalized form (``decode_attention_layer``, K8): kernel E over the
  int8 self cache with per-token scales, kernel E' over a float cache
  without them; the XLA epilogues that follow it there,
  :func:`flash_merge_extra_key` and :func:`normalize`, are plain PyTorch
  here too.
* :func:`decode_attention_merged_int4` (kernel G) replaces ``_kernel``'s
  int4 self-KV branches (K11) in the merged form without the store
  (``decode_attention_merged`` over a uint8 cache,
  ``pallas_attention.py:522``): int4 keys and values, or int8 keys and
  int4 values (the mixed mode), with the current token's raw K/V merged.
* :func:`decode_attention_layer_int4` (kernel H) replaces the same
  branches in the general, unnormalized form (``decode_attention_layer``
  over a uint8 cache, ``pallas_attention.py:426``), as kernel E.
* :func:`decode_cross_attention` replaces ``_kt_kernel`` with
  ``normalized=True`` (K3), ``batch_groups`` query streams per cache
  entry: kernel C over the int4 cross cache, kernel C' over an int8 or
  float one.

Each reads one layer of a stacked cache by index, so no slice is copied,
and each is bound on the H100 by the cache bytes it reads (see the source
note for how each design keeps every byte read once: G and H run one block
per head pair, the two heads that share each packed byte, and one block a
head where the head count is odd (a tensor-parallel shard's) or a scale
group narrower than a head; C and C' split
the keys over a thread block cluster that serves every stream of its
cache entry, C's cluster a head pair, or one head at an odd head count). The self-attention kernels (B, B', E, E', G, H) share one
loop that reads 16 bytes a lane, and C and C' copy 16-byte chunks, so the
caches must be 16-byte aligned. CPU tensors take the plain versions; CUDA
tensors launch the kernel or raise.

The self-attention kernels take the position (``pos``, or ``valid``) as a
0-d int32 tensor on the inputs' device, which the kernel reads from device
memory, as the Pallas kernels take it by scalar prefetch: the decode loop
keeps it on the card and replays a captured CUDA graph of its step, whose
launch arguments are fixed. Nothing here reads it on the host, so nothing
range-checks it there: the loop checks its last position against the
cache once per request, and the kernels clamp it into the cache. The plain
versions mask the keys at and past it over the whole cache.

The int4 self cache (``models/decoder._quantize_tokens4``) packs channel
``j`` and ``j + D/2`` of a token into one byte, low nibble first, biased by
8. Its per-token scales ``[L, B, ctx, sw]`` f32 hold K lanes first, then V
lanes: ``sw = 2·ng`` (int4 keys and values, ``ng`` channel groups a side
in natural channel order), ``1 + ng`` (mixed: the int8 keys' scalar in
lane 0), or ``2`` (one scalar a side); an int4 cache may also come without
scales. :func:`int4_lanes` reads that layout, or raises where it is not
one (a mixed cache without scales, a scale row of another width), as the
JAX package's ``_packed_scales_ok`` does: any head count, and groups of
any width that divides the half row.
"""

from __future__ import annotations

import ctypes
import math

import torch

from whisper_burn_tpu_torch.ops import _build

NAME = "decode_attention"
SELF, LAYER, CROSS = "decode_self_attention", "decode_attention_layer", "decode_cross_attention"
MERGED, LAYER_U = "decode_attention_merged", "decode_attention_layer_unscaled"
CROSS_U = "decode_cross_attention_unpacked"
MERGED4, LAYER4 = "decode_attention_merged_int4", "decode_attention_layer_int4"
FLOATS = (torch.float32, torch.bfloat16)
HEAD_DIM = 64
NEG_BIG = -1e30
CROSS_MAX_ROWS = 8192  # keys (int4: packed value rows) a cluster of C/C' takes: 16 blocks of 512
_FNS: dict[str, object] = {}


def _fn(fn: str):
    if fn not in _FNS:
        p, i = ctypes.c_void_p, ctypes.c_int
        args = {  # the position after the layer is a device pointer
            SELF: [p, i, p, p, p, p, p, p, p, p, p, i, p, i, i, i, i, p],
            MERGED: [p, i, p, p, p, p, p, i, p, i, i, i, i, p],
            LAYER: [p, i, p, p, p, p, p, p, i, p, i, i, i, i, p],
            LAYER_U: [p, i, p, p, p, p, p, i, p, i, i, i, i, p],
            CROSS: [p, i, p, p, p, i, i, i, i, i, i, i, p],
            CROSS_U: [p, i, i, p, p, p, i, i, i, i, i, i, i, p],
            MERGED4: [p, i, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, i, i, p],
            LAYER4: [p, i, p, p, p, p, p, p, i, p, i, i, i, i, i, i, i, i, i, p],
        }[fn]
        _FNS[fn] = _build.declare(_build.library(NAME), fn, args)
    return _FNS[fn]


def _check_heads(d: int, n_heads: int) -> None:
    if d != n_heads * HEAD_DIM:
        raise ValueError(f"decode attention needs 64-wide heads, got D={d}, H={n_heads}")


def decode_attention_layer_plain(q, k_cache, v_cache, kv_scale, layer, valid, n_heads):
    """Over the whole cache, the keys at and past ``valid`` (a 0-d tensor)
    masked: their ``p`` is 0 and the max is taken without them."""
    b, _, d = q.shape
    ctx = k_cache.shape[2]
    dh = d // n_heads
    keep = torch.arange(ctx, device=q.device) < valid  # [ctx]
    qf = q.float().reshape(b, n_heads, dh)
    kf = k_cache[layer].float().reshape(b, ctx, n_heads, dh)
    vf = v_cache[layer].float().reshape(b, ctx, n_heads, dh)
    s = torch.einsum("bhd,bthd->bht", qf, kf) * (1.0 / math.sqrt(dh))
    if kv_scale is not None:
        s = s * kv_scale[layer, :, :, 0][:, None, :]
    s = torch.where(keep, s, NEG_BIG)
    m = torch.maximum(torch.full((b, n_heads), NEG_BIG, device=q.device), s.amax(dim=-1))
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    pv = p if kv_scale is None else p * kv_scale[layer, :, :, 1][:, None, :]
    acc = torch.einsum("bht,bthd->bhd", pv, vf)
    return acc.reshape(b, 1, d), m[:, None], p.sum(dim=-1)[:, None]


def _check_self_cache(fn: str, q, k_cache, v_cache, kv_scale, layer: int, pos) -> None:
    b, _, d = q.shape
    l_dim, kb, ctx, kd = k_cache.shape
    if (kb, kd) != (b, d) or v_cache.shape != k_cache.shape or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"{fn}: cache shapes do not match the query")
    if kv_scale is not None and kv_scale.shape != (l_dim, b, ctx, 2):
        raise ValueError(f"{fn}: kv_scale must be [L, B, ctx, 2]")
    if not 0 <= layer < l_dim:
        raise ValueError(f"{fn}: layer {layer} out of range")
    _build.check_position(fn, pos, q.device)


def _check_aligned(fn: str, *caches) -> None:
    """The kernels read cache rows 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in caches):
        raise ValueError(f"{fn}: caches must be 16-byte aligned")


def _check_float_cache(fn: str, q, k_cache) -> None:
    """A float cache takes a query of its own dtype, f32 or bf16."""
    if q.dtype not in FLOATS or k_cache.dtype != q.dtype:
        raise ValueError(f"{fn}: a float cache takes a query of its dtype, f32 or bf16; got {q.dtype}, {k_cache.dtype}")


def decode_attention_layer(
    q: torch.Tensor,  # [B, 1, D] compute dtype
    k_cache: torch.Tensor,  # int8 or float [L, B, ctx, D]
    v_cache: torch.Tensor,
    kv_scale: torch.Tensor | None,  # f32 [L, B, ctx, 2] for an int8 cache: K in lane 0, V in lane 1
    layer: int,
    valid: torch.Tensor,  # 0-d int32 on q's device
    n_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention of one query per stream over the cached keys ``t < valid``
    of ``layer``, unnormalized: ``acc [B, 1, D]`` f32 is the sum of
    ``p[t] * sv[t] * v[t]`` with ``p[t] = exp(s[t] - m)`` and scores
    ``s[t] = (q . k[t]) / sqrt(dh) * sk[t]``; ``m [B, 1, H]`` is their max
    and ``l [B, 1, H]`` the sum of ``p[t]`` (the V scale left out). An int8
    cache takes its per-token scales ``kv_scale`` (kernel E); a float cache
    (f32 or bf16, of the query's dtype) none, ``sk = sv = 1`` (kernel E')."""
    b, _, d = q.shape
    ctx = k_cache.shape[2]
    _check_self_cache("decode_attention_layer", q, k_cache, v_cache, kv_scale, layer, valid)
    if q.device.type == "cpu":
        return decode_attention_layer_plain(q, k_cache, v_cache, kv_scale, layer, valid, n_heads)
    _check_heads(d, n_heads)
    q = q.contiguous()
    scaled = kv_scale is not None
    _build.require_cuda(q, k_cache, v_cache, *([kv_scale] if scaled else []))
    if q.dtype not in FLOATS:
        raise ValueError("decode_attention_layer: f32 or bf16 query")
    if scaled and (k_cache.dtype != torch.int8 or kv_scale.dtype != torch.float32):
        raise ValueError("decode_attention_layer: scales go with int8 caches and are f32")
    if not scaled:
        _check_float_cache("decode_attention_layer", q, k_cache)
    _check_aligned("decode_attention_layer", k_cache, v_cache)
    acc = torch.empty((b, 1, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, 1, n_heads), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    fn = LAYER if scaled else LAYER_U
    args = (q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(), v_cache.data_ptr())
    args += (kv_scale.data_ptr(),) if scaled else ()
    err = _fn(fn)(
        *args, acc.data_ptr(), m.data_ptr(), l.data_ptr(), layer, valid.data_ptr(), b, ctx, d, n_heads,
        _build.stream_ptr(q.device),
    )
    _build.check(err, fn)
    _build.count_launch(fn, (b, ctx, d))
    return acc, m, l


def normalize(acc: torch.Tensor, l: torch.Tensor, n_heads: int) -> torch.Tensor:
    """``acc [B, 1, D] / l [B, 1, H]``, each head's normalizer over its
    channels."""
    return acc / l.repeat_interleave(acc.shape[-1] // n_heads, dim=-1)


def flash_merge_extra_key(acc, m, l, q, k_new, v_new, n_heads: int) -> torch.Tensor:
    """Merge one more key, the current token's raw ``k_new``/``v_new``
    ``[B, 1, D]``, into the unnormalized state of
    :func:`decode_attention_layer` and normalize: the f32 attention output
    ``[B, 1, D]`` over the cached keys and the current token."""
    b, _, d = q.shape
    dh = d // n_heads
    qf = q.float().reshape(b, n_heads, dh)
    kf = k_new.float().reshape(b, n_heads, dh)
    s_e = (qf * kf).sum(dim=-1)[:, None, :] * (1.0 / math.sqrt(dh))  # [B, 1, H]
    m2 = torch.maximum(m, s_e)
    alpha = torch.exp(m - m2)  # rescales the cached keys' state
    beta = torch.exp(s_e - m2)  # the current token's weight
    rep = lambda x: x.repeat_interleave(dh, dim=-1)
    return normalize(acc * rep(alpha) + rep(beta) * v_new.float(), l * alpha + beta, n_heads)


def decode_self_attention_plain(
    q, k_cache, v_cache, kv_scale, layer, pos, n_heads, k_new, v_new, kq, vq, new_scale
):
    state = decode_attention_layer_plain(q, k_cache, v_cache, kv_scale, layer, pos, n_heads)
    out = flash_merge_extra_key(*state, q, k_new, v_new, n_heads)
    slot = pos.reshape(1).long()
    k_cache[layer].index_copy_(1, slot, kq)
    v_cache[layer].index_copy_(1, slot, vq)
    kv_scale[layer].index_copy_(1, slot, new_scale)
    return out


def decode_self_attention(
    q: torch.Tensor,  # [B, 1, D] compute dtype
    k_cache: torch.Tensor,  # int8 [L, B, ctx, D], updated in place
    v_cache: torch.Tensor,
    kv_scale: torch.Tensor,  # f32 [L, B, ctx, 2], updated in place
    layer: int,
    pos: torch.Tensor,  # 0-d int32 on q's device
    n_heads: int,
    k_new: torch.Tensor,  # [B, 1, D] the current token's raw K
    v_new: torch.Tensor,
    kq: torch.Tensor,  # int8 [B, 1, D] the current token's quantized K
    vq: torch.Tensor,
    new_scale: torch.Tensor,  # f32 [B, 1, 2] its per-token K/V scales
) -> torch.Tensor:
    """Attention of one query per stream over cached keys ``t < pos`` of
    ``layer`` plus the current token, merged into one softmax; returns the
    normalized f32 ``[B, 1, D]``. Stores ``kq``/``vq`` and ``new_scale`` at
    ``pos`` of ``layer`` in place."""
    b, _, d = q.shape
    ctx = k_cache.shape[2]
    _check_self_cache("decode_self_attention", q, k_cache, v_cache, kv_scale, layer, pos)
    for t in (k_new, v_new, kq, vq):
        if t.shape != (b, 1, d):
            raise ValueError("decode_self_attention: current-token rows must be [B, 1, D]")
    if new_scale.shape != (b, 1, 2):
        raise ValueError("decode_self_attention: new_scale must be [B, 1, 2]")
    if q.device.type == "cpu":
        return decode_self_attention_plain(
            q, k_cache, v_cache, kv_scale, layer, pos, n_heads, k_new, v_new, kq, vq, new_scale
        )
    _check_heads(d, n_heads)
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    kq, vq, new_scale = kq.contiguous(), vq.contiguous(), new_scale.contiguous()
    _build.require_cuda(q, k_cache, v_cache, kv_scale, k_new, v_new, kq, vq, new_scale)
    if q.dtype not in FLOATS or k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("decode_self_attention: q, k_new, v_new must share f32 or bf16")
    if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8 or kq.dtype != torch.int8 or vq.dtype != torch.int8:
        raise ValueError("decode_self_attention: int8 caches and rows")
    if kv_scale.dtype != torch.float32 or new_scale.dtype != torch.float32:
        raise ValueError("decode_self_attention: f32 scales")
    _check_aligned("decode_self_attention", k_cache, v_cache)
    out = torch.empty((b, 1, d), dtype=torch.float32, device=q.device)
    err = _fn(SELF)(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_scale.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), kq.data_ptr(), vq.data_ptr(),
        new_scale.data_ptr(), out.data_ptr(), layer, pos.data_ptr(), b, ctx, d, n_heads,
        _build.stream_ptr(q.device),
    )
    _build.check(err, SELF)
    _build.count_launch(SELF, (b, ctx, d))
    return out


def decode_attention_merged_plain(q, k_cache, v_cache, layer, pos, n_heads, k_new, v_new):
    state = decode_attention_layer_plain(q, k_cache, v_cache, None, layer, pos, n_heads)
    return flash_merge_extra_key(*state, q, k_new, v_new, n_heads)


def decode_attention_merged(
    q: torch.Tensor,  # [B, 1, D] f32 or bf16
    k_cache: torch.Tensor,  # [L, B, ctx, D] of q's dtype
    v_cache: torch.Tensor,
    layer: int,
    pos: torch.Tensor,  # 0-d int32 on q's device
    n_heads: int,
    k_new: torch.Tensor,  # [B, 1, D] the current token's K, not yet cached
    v_new: torch.Tensor,
) -> torch.Tensor:
    """Attention of one query per stream over the float cache's keys
    ``t < pos`` of ``layer`` plus the current token, merged into one
    softmax; returns the normalized f32 ``[B, 1, D]``. Stores nothing: the
    caller writes the token's row after its layer loop."""
    b, _, d = q.shape
    ctx = k_cache.shape[2]
    _check_self_cache("decode_attention_merged", q, k_cache, v_cache, None, layer, pos)
    if k_new.shape != (b, 1, d) or v_new.shape != (b, 1, d):
        raise ValueError("decode_attention_merged: current-token rows must be [B, 1, D]")
    if q.device.type == "cpu":
        return decode_attention_merged_plain(q, k_cache, v_cache, layer, pos, n_heads, k_new, v_new)
    _check_heads(d, n_heads)
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    _build.require_cuda(q, k_cache, v_cache, k_new, v_new)
    _check_float_cache("decode_attention_merged", q, k_cache)
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("decode_attention_merged: q, k_new, v_new must share a dtype")
    _check_aligned("decode_attention_merged", k_cache, v_cache)
    out = torch.empty((b, 1, d), dtype=torch.float32, device=q.device)
    err = _fn(MERGED)(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(), v_cache.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), layer, pos.data_ptr(), b, ctx, d, n_heads,
        _build.stream_ptr(q.device),
    )
    _build.check(err, MERGED)
    _build.count_launch(MERGED, (b, ctx, d))
    return out


def packed_scales_ok(kv_scale, ds_k: int, ds_v: int, k_packed: bool, v_packed: bool) -> bool:
    """Counterpart of ``pallas_attention._packed_scales_ok``: the scale
    row's width must match the cache dtypes, 2 (a scalar a side), ``2·ng``
    (int4 keys and values, ``ng/2`` groups dividing the stored half width)
    or ``1 + ng`` (mixed: the int8 keys' scalar, then the values' groups)."""
    sw = kv_scale.shape[-1]
    if k_packed and v_packed:
        if sw == 2:
            return True
        ng = sw // 2
        return sw % 2 == 0 and ng % 2 == 0 and ds_k % (ng // 2) == 0
    if v_packed:
        ng = sw - 1
        return sw >= 3 and ng % 2 == 0 and ds_v % (ng // 2) == 0
    return sw == 2


def int4_lanes(fn: str, q, k_cache, v_cache, kv_scale, n_heads: int) -> tuple[int, int, int, int, int]:
    """The layout of a uint8-valued self cache, as kernels G and H take it:
    ``(k_int4, sw, kgs, vgs, voff)``. Keys are int4 pairs (``k_int4``) or
    int8; ``sw`` is the scale row's width (0 without scales); the key scale
    of channel ``c`` sits in lane ``c // kgs`` (``kgs`` channels a group)
    or lane 0 with ``kgs = 0``, the value scale in lane ``voff + c // vgs``
    or ``voff``. Raises ``ValueError`` for a layout the kernels do not
    serve: a mixed cache without scales, a scale row whose width fits no
    form. Odd head counts and groups narrower than a head are served (by
    the one-head form of G and H on the card)."""
    b, _, d = q.shape
    if v_cache.dtype != torch.uint8 or k_cache.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"{fn}: uint8 values with uint8 or int8 keys, got {k_cache.dtype}, {v_cache.dtype}")
    k4 = k_cache.dtype == torch.uint8
    l_dim, kb, ctx, ds_k = k_cache.shape
    if (kb, ds_k) != (b, d // 2 if k4 else d) or v_cache.shape != (l_dim, b, ctx, d // 2):
        raise ValueError(f"{fn}: cache shapes do not match the query")
    if kv_scale is None:
        if not k4:
            raise ValueError(f"{fn}: int8 keys with int4 values carry scales")
        return 1, 0, 0, 0, 0
    sw = kv_scale.shape[-1]
    if kv_scale.shape != (l_dim, b, ctx, sw) or not packed_scales_ok(kv_scale, ds_k, d // 2, k4, True):
        raise ValueError(f"{fn}: scales {tuple(kv_scale.shape)} do not fit the cache")
    if k4 and sw == 2:
        return 1, 2, 0, 0, 1
    ng = sw // 2 if k4 else sw - 1
    gs = d // ng
    return (1, sw, gs, gs, ng) if k4 else (0, sw, 0, gs, 1)


def dequantize_self_rows(k, v, scales, lanes) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows ``[..., D/2]`` (int4) or ``[..., D]`` (int8) of a uint8-valued
    self cache and their scales ``[..., sw]`` (None without scales) ->
    keys and values ``[..., D]`` f32 by the layout of :func:`int4_lanes`:
    channel ``c`` is ``code · scale[off + c // gs]``."""
    k_int4, sw, kgs, vgs, voff = lanes
    kf = unpack_int4(k, -1, torch.float32) if k_int4 else k.float()
    vf = unpack_int4(v, -1, torch.float32)
    if not sw:
        return kf, vf

    def expand(off, gs):
        if not gs:
            return scales[..., off : off + 1]
        return scales[..., off : off + kf.shape[-1] // gs].repeat_interleave(gs, dim=-1)

    return kf * expand(0, kgs), vf * expand(voff, vgs)


def decode_attention_layer_int4_plain(q, k_cache, v_cache, kv_scale, layer, valid, n_heads):
    lanes = int4_lanes(LAYER4, q, k_cache, v_cache, kv_scale, n_heads)
    sc = None if kv_scale is None else kv_scale[layer]
    kf, vf = dequantize_self_rows(k_cache[layer], v_cache[layer], sc, lanes)
    return decode_attention_layer_plain(q, kf[None], vf[None], None, 0, valid, n_heads)


def decode_attention_merged_int4_plain(q, k_cache, v_cache, kv_scale, layer, pos, n_heads, k_new, v_new):
    state = decode_attention_layer_int4_plain(q, k_cache, v_cache, kv_scale, layer, pos, n_heads)
    return flash_merge_extra_key(*state, q, k_new, v_new, n_heads)


def _int4_call(fn, q, k_cache, v_cache, kv_scale, layer, valid, n_heads, extra):
    """Check the inputs of kernel G (``fn = MERGED4``, ``extra = (k_new,
    v_new)``) or H (``LAYER4``, ``extra = ()``) and launch it; returns its
    outputs, or None for CPU tensors (the caller takes the plain version)."""
    b, _, d = q.shape
    l_dim, _, ctx, _ = k_cache.shape
    lanes = int4_lanes(fn, q, k_cache, v_cache, kv_scale, n_heads)
    if not 0 <= layer < l_dim:
        raise ValueError(f"{fn}: layer {layer} out of range")
    _build.check_position(fn, valid, q.device)
    if any(t.shape != (b, 1, d) for t in extra):
        raise ValueError(f"{fn}: current-token rows must be [B, 1, D]")
    if q.device.type == "cpu":
        return None
    _check_heads(d, n_heads)
    if any(gs % 16 for gs in lanes[2:4]):
        raise ValueError(f"{fn}: the kernel takes scale groups of a multiple of 16 channels, got {lanes[2:4]}")
    q, extra = q.contiguous(), tuple(t.contiguous() for t in extra)
    scales = () if kv_scale is None else (kv_scale,)
    _build.require_cuda(q, k_cache, v_cache, *scales, *extra)
    if q.dtype not in FLOATS or any(t.dtype != q.dtype for t in extra):
        raise ValueError(f"{fn}: q (and k_new, v_new) f32 or bf16, of one dtype")
    if scales and kv_scale.dtype != torch.float32:
        raise ValueError(f"{fn}: f32 scales")
    _check_aligned(fn, k_cache, v_cache)
    f32 = lambda *shape: torch.empty(shape, dtype=torch.float32, device=q.device)
    # G: the normalized output; H: acc, m, l
    outs = (f32(b, 1, d),) if extra else (f32(b, 1, d), f32(b, 1, n_heads), f32(b, 1, n_heads))
    err = _fn(fn)(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_scale.data_ptr() if scales else None, *(t.data_ptr() for t in extra + outs),
        layer, valid.data_ptr(), b, ctx, d, n_heads, *lanes, _build.stream_ptr(q.device),
    )
    _build.check(err, fn)
    _build.count_launch(fn, (b, ctx, d, lanes[1]))
    return outs


def decode_attention_layer_int4(
    q: torch.Tensor,  # [B, 1, D] compute dtype
    k_cache: torch.Tensor,  # uint8 [L, B, ctx, D/2] int4 pairs, or int8 [L, B, ctx, D] (mixed)
    v_cache: torch.Tensor,  # uint8 [L, B, ctx, D/2]
    kv_scale: torch.Tensor | None,  # f32 [L, B, ctx, sw], K lanes then V lanes (int4_lanes)
    layer: int,
    valid: torch.Tensor,  # 0-d int32 on q's device
    n_heads: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_layer` over a uint8-valued self cache (kernel
    H): the unnormalized ``(acc, m, l)`` over keys ``t < valid``, with the
    values' scales in ``acc`` and left out of ``l``."""
    outs = _int4_call(LAYER4, q, k_cache, v_cache, kv_scale, layer, valid, n_heads, ())
    if outs is None:
        return decode_attention_layer_int4_plain(q, k_cache, v_cache, kv_scale, layer, valid, n_heads)
    return outs


def decode_attention_merged_int4(
    q: torch.Tensor,  # [B, 1, D] compute dtype
    k_cache: torch.Tensor,  # uint8 [L, B, ctx, D/2] or int8 [L, B, ctx, D]
    v_cache: torch.Tensor,  # uint8 [L, B, ctx, D/2]
    kv_scale: torch.Tensor | None,  # f32 [L, B, ctx, sw]
    layer: int,
    pos: torch.Tensor,  # 0-d int32 on q's device
    n_heads: int,
    k_new: torch.Tensor,  # [B, 1, D] the current token's raw K, not yet cached
    v_new: torch.Tensor,
) -> torch.Tensor:
    """:func:`decode_attention_merged` over a uint8-valued self cache
    (kernel G): keys ``t < pos`` and the current token's raw K/V in one
    softmax, the normalized f32 ``[B, 1, D]``. Stores nothing: the caller
    quantizes and writes the token's row after its layer loop."""
    outs = _int4_call(MERGED4, q, k_cache, v_cache, kv_scale, layer, pos, n_heads, (k_new, v_new))
    if outs is None:
        return decode_attention_merged_int4_plain(q, k_cache, v_cache, kv_scale, layer, pos, n_heads, k_new, v_new)
    return outs[0]


def unpack_int4(p: torch.Tensor, dim: int, dtype: torch.dtype) -> torch.Tensor:
    """Biased-nibble pairs -> values in [-8, 7]; element j pairs with
    j + size/2 along ``dim`` (low nibble first half)."""
    lo = (p & 15).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=dim).to(dtype)


def _cross_parts(q, kT, v, layer, valid, n_heads, batch_groups):
    """K3's arithmetic up to the value product: unnormalized ``p [B, H, 1,
    T]`` f32 (0 at ``t >= valid``), ``l [B, H, 1, 1]``, the values ``[B, H,
    T, dh]`` as the product takes them, and whether the int4 bias is
    folded out afterwards."""
    b, _, d = q.shape
    dh = d // n_heads
    entry = torch.arange(b, device=q.device) // batch_groups  # each stream's cache entry
    fold = kT.dtype == torch.uint8 and q.dtype != torch.float32
    bias = 8.0 if fold else 0.0
    if kT.dtype == torch.uint8:
        k = unpack_int4(kT[layer], 1, torch.float32)[entry] + bias  # [B, D, T]
        vv = unpack_int4(v[layer], 1, torch.float32)[entry] + bias  # [B, T, D]
    else:
        k, vv = kT[layer].float()[entry], v[layer].float()[entry]
    t = k.shape[-1]
    qh = q.float().reshape(b, n_heads, 1, dh)
    s = qh @ k.reshape(b, n_heads, dh, t)  # [B, H, 1, T]
    if fold:
        s = s - bias * qh.sum(dim=-1, keepdim=True)
    s = (s / math.sqrt(dh)).masked_fill(torch.arange(t, device=q.device) >= valid, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True), vv.reshape(b, t, n_heads, dh).transpose(1, 2), fold


def decode_cross_attention_plain(q, kT, v, layer, valid, n_heads, batch_groups=1):
    """K3's arithmetic in the query's dtype: f32 scores, m and ``l = sum(p)``
    in f32, the value product on ``p`` rounded to the query's dtype, then
    divided by ``l``. In bf16 the int4 codes' bias is folded out as K3
    does, from the scores as ``q . nibble - 8 * sum(q)`` and from the values
    as ``sum(round(p) * nibble) - 8 * l`` (``pallas_attention.py:690,701,711``),
    so each ``p`` rounds where K3's does; in f32, where ``p`` is not
    rounded, both sums are taken on the unbiased codes."""
    b, _, d = q.shape
    p, l, vv, fold = _cross_parts(q, kT, v, layer, valid, n_heads, batch_groups)
    pv = p.to(q.dtype).float() @ vv  # [B, H, 1, dh]
    if fold:
        pv = pv - 8.0 * l
    return (pv / l).transpose(1, 2).reshape(b, 1, d)


def decode_cross_attention_ties(q, kT, v, layer, valid, n_heads, batch_groups=1, ulps=32):
    """How far each output of :func:`decode_cross_attention_plain` moves,
    at most, if every ``p`` within ``ulps`` f32 steps of a rounding tie of
    bf16 rounds the other way: for each output the sum over such keys of
    one bf16 step of ``p`` times ``|value| / l``.
    Two versions whose scores differ in the last bits of f32 (another
    order of summation) round such a ``p`` apart; ``[B*G, 1, D]`` f32,
    zero for an f32 query (``p`` is not rounded)."""
    b, _, d = q.shape
    if q.dtype == torch.float32:
        return torch.zeros((b, 1, d), device=q.device)
    p, l, vv, _ = _cross_parts(q, kT, v, layer, valid, n_heads, batch_groups)
    low = p.view(torch.int32) & 0xFFFF  # the f32 bits bf16 drops; a tie at 0x8000
    near = ((low - 0x8000).abs() <= ulps) & (p > 0)
    step = torch.exp2(torch.floor(torch.log2(p.clamp_min(1e-30))) - 7)  # bf16 keeps 7 bits
    return ((near * step / l) @ vv.abs()).transpose(1, 2).reshape(b, 1, d)


def decode_cross_attention(
    q: torch.Tensor,  # [B*G, 1, D], K scales already folded in
    kT: torch.Tensor,  # keys: uint8 [L, B, D/2, T] packed along D, or int8/float [L, B, D, T]
    v: torch.Tensor,  # values: uint8 [L, B, T/2, D] packed along T, or int8/float [L, B, T, D]
    layer: int,
    valid: int,
    n_heads: int,
    batch_groups: int = 1,
) -> torch.Tensor:
    """One-query cross-attention over ``layer`` of the cross cache; keys
    ``t >= valid`` masked; returns the normalized f32 ``[B*G, 1, D]`` (the
    per-channel scales of a quantized cache are applied by the caller).
    A uint8 cache holds int4 pairs (kernel C); an int8 cache or a float
    cache of the query's dtype is unpacked (kernel C'). ``batch_groups=G``
    query streams share each cache entry: stream ``b`` reads entry
    ``b // G`` (beam search's W beams of one utterance)."""
    b, _, d = q.shape
    l_dim, kb, dk, t = kT.shape
    packed = kT.dtype == torch.uint8
    if batch_groups < 1 or (kb * batch_groups, dk * (2 if packed else 1)) != (b, d):
        raise ValueError(f"decode_cross_attention: {b} query streams for {kb} cache entries x {batch_groups}")
    v_shape = (l_dim, kb, t // 2, d) if packed else (l_dim, kb, t, d)
    if v.shape != v_shape or v.dtype != kT.dtype or t % (2 if packed else 4) or d % n_heads:
        raise ValueError("decode_cross_attention: cache shapes do not match the query")
    if not (0 < valid <= t and 0 <= layer < l_dim):
        raise ValueError(f"decode_cross_attention: valid {valid} / layer {layer} out of range")
    if q.device.type == "cpu":
        return decode_cross_attention_plain(q, kT, v, layer, valid, n_heads, batch_groups)
    _check_heads(d, n_heads)
    q = q.contiguous()
    _build.require_cuda(q, kT, v)
    if q.dtype not in FLOATS:
        raise ValueError("decode_cross_attention: f32 or bf16 query")
    if not packed and kT.dtype not in (torch.int8, q.dtype):
        raise ValueError(f"decode_cross_attention: a {kT.dtype} cache for a {q.dtype} query")
    if batch_groups > 8:
        raise ValueError(f"decode_cross_attention: at most 8 streams a cache entry, got {batch_groups}")
    if t % 32 if packed else t * kT.element_size() % 16:
        raise ValueError(f"decode_cross_attention: T {t} must fill whole 16-byte key chunks")
    if (min(t // 2, valid) if packed else valid) > CROSS_MAX_ROWS:
        raise ValueError(f"decode_cross_attention: {valid} keys exceed a cluster's {CROSS_MAX_ROWS} rows")
    _check_aligned("decode_cross_attention", kT, v)
    out = torch.empty((b, 1, d), dtype=torch.float32, device=q.device)
    bf16 = int(q.dtype == torch.bfloat16)
    tail = (out.data_ptr(), layer, valid, b, batch_groups, d, t, n_heads, _build.stream_ptr(q.device))
    if packed:
        fn, shape = CROSS, (b, t, d, batch_groups)
        err = _fn(fn)(q.data_ptr(), bf16, kT.data_ptr(), v.data_ptr(), *tail)
    else:
        fn, shape = CROSS_U, (b, t, d, batch_groups, kT.element_size())
        err = _fn(fn)(q.data_ptr(), bf16, int(kT.dtype == torch.int8), kT.data_ptr(), v.data_ptr(), *tail)
    _build.check(err, fn)
    _build.count_launch(fn, shape)
    return out
