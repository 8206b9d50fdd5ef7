"""Kernels D and D': whole-sequence encoder attention, and their plain versions.

Counterpart of ``whisper_burn_tpu/ops/pallas_encoder_attention.py``;
source ``csrc/encoder_attention.cu``.

* :func:`encoder_attention` (kernel D) replaces ``_packed_kernel`` (K6, via
  ``encoder_attention_packed``) together with
  ``whisper_burn_tpu/ops/flash_prefill.prefill_attention``, which routes
  the encoder to it: non-causal attention on the packed ``[B, T, D]``
  layout with 64-wide heads as slices of D; keys ``t >= valid`` are masked
  (the encoder pads T once for its whole stack).
* :func:`encoder_attention_heads` (kernel D') replaces ``_kernel`` (K10,
  via ``pallas_encoder_attention.encoder_attention``), the head-blocked
  form: q and k head-major ``[B, H, Tp, 64]``, v and the output transposed
  ``[B, H, 64, Tp]``, T padded to a multiple of 128 and the pad keys
  masked. No model path reaches it, in the JAX package as here: the
  encoder's ``prefill_attention`` tries K6 first on every shape K10's gate
  :func:`supported` accepts. It is an op of its own, as there.

On the H100 both are bound by operations; the kernel is a flash loop that
never materializes the ``[T, T]`` scores, on tensor cores for bf16 and on
CUDA cores for f32 (source note). The plain versions round the
unnormalized ``exp(s - max)`` to the input dtype before the value product
and divide by the f32 row sum after it, as K6 and K10 do. CPU tensors take
the plain versions; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from whisper_burn_tpu_torch.ops import _build

NAME = "encoder_attention"
HEADS = "encoder_attention_heads"
HEAD_DIM = 64
_MAX_T = 2048  # the JAX kernel's limit (its f32 [T, T] score block in VMEM)
_FNS: dict[str, object] = {}


def _softmax_parts(s, valid, dtype):
    """Scores ``[..., T, T]`` (f32) with keys ``t >= valid`` masked -> the
    unnormalized ``exp(s - max)`` rounded to ``dtype`` (as K6 and K10 round
    ``p`` to the value dtype before the value product) and the f32 row sums
    of the unrounded values."""
    s = s.masked_fill(torch.arange(s.shape[-1], device=s.device) >= valid, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p.to(dtype).float(), p.sum(dim=-1, keepdim=True)


def encoder_attention_plain(q, k, v, n_heads, valid):
    b, t, d = q.shape
    dh = d // n_heads
    split = lambda x: x.float().reshape(b, t, n_heads, dh).transpose(1, 2)
    s = split(q) @ split(k).transpose(-1, -2) / math.sqrt(dh)  # [B, H, T, T]
    p, l = _softmax_parts(s, valid, v.dtype)
    out = (p @ split(v)) / l
    return out.transpose(1, 2).reshape(b, t, d).to(q.dtype)


def _fn(fn: str = NAME):
    if fn not in _FNS:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FNS[fn] = _build.declare(_build.library(NAME), fn, [p, p, p, p, i, i, i, i, i, i, p])
    return _FNS[fn]


def encoder_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int, *, valid: int | None = None
) -> torch.Tensor:
    """``q/k/v: [B, T, D]`` (f32 or bf16) -> ``[B, T, D]`` in q's dtype."""
    b, t, d = q.shape
    valid = t if valid is None else valid
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("encoder_attention: q, k, v must share [B, T, D]")
    if not 0 < valid <= t:
        raise ValueError(f"encoder_attention: valid {valid} out of (0, {t}]")
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, n_heads, valid)
    if d != n_heads * HEAD_DIM:
        raise ValueError(f"encoder_attention: the kernel takes 64-wide heads, got D={d}, H={n_heads}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _build.require_cuda(q, k, v)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("encoder_attention: q, k, v must share f32 or bf16")
    out = torch.empty_like(q)
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
        b, t, d, n_heads, valid, _build.stream_ptr(q.device),
    )
    _build.check(err, NAME)
    _build.count_launch(NAME, (b, t, d))
    return out


def _pick_dgrp(t: int, d: int, n_heads: int, itemsize: int) -> int | None:
    """Counterpart of ``pallas_encoder_attention._pick_dgrp``: the widest
    head group (a multiple of 128 lanes, or all of D) whose four
    double-buffered ``[1, T, dgrp]`` blocks stay under 24 MB of VMEM. The
    kernels here do not use it; :func:`supported` answers as the JAX gate
    does through it."""
    dh = d // n_heads
    budget = 24 * 1024 * 1024
    for cand in range(n_heads, 0, -1):
        dgrp = cand * dh
        if n_heads % cand == 0 and (dgrp % 128 == 0 or dgrp == d) and 8 * t * dgrp * itemsize < budget:
            return dgrp
    return None


def supported(t: int, d: int, n_heads: int, itemsize: int = 4) -> bool:
    """Counterpart of ``pallas_encoder_attention.supported``: 64-multiple
    heads, T padded to 128 within [128, 2048], and a head group that fits."""
    if d % n_heads:
        return False
    dh = d // n_heads
    tp = -(-t // 128) * 128
    if not (dh % 64 == 0 and 128 <= tp <= _MAX_T):
        return False
    return _pick_dgrp(tp, d, n_heads, itemsize) is not None


def encoder_attention_heads_plain(q, k, vT, valid):
    """Head-major q, k ``[B, H, Tp, dh]``, vT ``[B, H, dh, Tp]`` ->
    ``[B, H, dh, Tp]`` in q's dtype; keys ``t >= valid`` masked."""
    s = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])  # [B, H, Tp, Tp]
    p, l = _softmax_parts(s, valid, vT.dtype)
    return ((vT.float() @ p.transpose(-1, -2)) / l.transpose(-1, -2)).to(q.dtype)


def encoder_attention_heads_kernel(q: torch.Tensor, k: torch.Tensor, vT: torch.Tensor, valid: int) -> torch.Tensor:
    """Kernel D' on its own layout: q, k ``[B, H, Tp, dh]``, vT
    ``[B, H, dh, Tp]`` (f32 or bf16) -> ``[B, H, dh, Tp]`` in q's dtype.
    The kernel takes 64-wide heads; the plain version (CPU tensors) any
    width :func:`supported` admits, as the JAX kernel does."""
    b, h, tp, dh = q.shape
    if k.shape != q.shape or vT.shape != (b, h, dh, tp):
        raise ValueError(f"{HEADS}: q, k [B, H, Tp, dh] and vT [B, H, dh, Tp], got {tuple(q.shape)}, {tuple(vT.shape)}")
    if not 0 < valid <= tp:
        raise ValueError(f"{HEADS}: valid {valid} out of (0, {tp}]")
    if q.device.type == "cpu":
        return encoder_attention_heads_plain(q, k, vT, valid)
    if dh != HEAD_DIM:
        raise ValueError(f"{HEADS}: the kernel takes 64-wide heads, got {dh}")
    if tp % 8:
        raise ValueError(f"{HEADS}: the kernel takes Tp a multiple of 8 (16-byte rows of vT), got {tp}")
    q, k, vT = q.contiguous(), k.contiguous(), vT.contiguous()
    _build.require_cuda(q, k, vT)
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or vT.dtype != q.dtype:
        raise ValueError(f"{HEADS}: q, k, vT must share f32 or bf16")
    out = torch.empty_like(vT)
    err = _fn(HEADS)(
        q.data_ptr(), k.data_ptr(), vT.data_ptr(), out.data_ptr(), int(q.dtype == torch.bfloat16),
        b, tp, h * dh, h, valid, _build.stream_ptr(q.device),
    )
    _build.check(err, HEADS)
    _build.count_launch(HEADS, (b, tp, h * dh))
    return out


def encoder_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int) -> torch.Tensor | None:
    """Counterpart of ``pallas_encoder_attention.encoder_attention``:
    non-causal attention of ``q/k/v [B, T, D]`` -> ``[B, T, D]`` in q's
    dtype through kernel D', or None where the JAX function declines the
    shape (:func:`supported`). Lays q and k out head-major and v
    transposed, padded to a multiple of 128 with the pad keys masked, as
    the JAX wrapper does."""
    b, t, d = q.shape
    if not supported(t, d, n_heads):
        return None
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{HEADS}: q, k, v must share [B, T, D]")
    dh = d // n_heads
    tp = -(-t // 128) * 128
    heads = lambda x: x.reshape(b, t, n_heads, dh).transpose(1, 2)  # [B, H, T, dh]
    pad = lambda x: torch.nn.functional.pad(x, (0, 0, 0, tp - t))
    vT = torch.nn.functional.pad(heads(v).transpose(2, 3), (0, tp - t))  # [B, H, dh, Tp]
    oT = encoder_attention_heads_kernel(pad(heads(q)), pad(heads(k)), vT, t)
    return oT[..., :t].permute(0, 3, 1, 2).reshape(b, t, d)
