"""Linear layers over parameter dicts (port of ops/linear.py).

A linear's params are a plain dict:

* quantized: ``{"qw": int8 [K, N], "scales": f32 [K/32, N], "b"?: f32 [N]}``
* W8A8 (``models/params.attach_w8a8``): ``{"qw8": int8 [K, N], "s8": f32 [N], "b"?}``
* dense: ``{"w": [K, N], "b"?}``

Each takes an optional ``layer`` that indexes stacked ``[L, ...]`` params
(a view: nothing is copied).

Tensor parallelism (the Megatron layout, ``parallel/sharding.py``):
column-parallel linears (q/k/v, fc1) need no communication; a
row-parallel one (attn_o, xattn_o, fc2) holds a K shard, so its product
is a partial sum that :func:`apply_reduce_linear` sums over
``compute.tp_group`` (``ops/collectives.all_reduce``, in the compute
dtype) before its bias is added once. At ``tp = 1`` it is
:func:`apply_linear`.
"""

from __future__ import annotations

import torch

from whisper_burn_tpu_torch.ops.collectives import all_reduce
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.ffn_kernel import fused_ffn, gelu
from whisper_burn_tpu_torch.ops.q4_matmul import LARGE_M, q4_matmul, rows


def _at(params: dict, layer: int | None) -> dict:
    return params if layer is None else {k: v[layer] for k, v in params.items()}


def w8a8_matmul(x: torch.Tensor, qw8: torch.Tensor, s8: torch.Tensor, compute: Compute) -> torch.Tensor:
    """``x [..., K] @ int8 [K, N]``: activations quantize per row
    (absmax/127), the product runs int8 x int8 -> int32 (``torch._int_mm``),
    and the rank-1 dequant ``row_scale * s8`` applies after."""
    k, n = qw8.shape
    xf = x.float()
    xs = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0
    xq = torch.round(xf / xs).to(torch.int8)
    yi = torch._int_mm(xq.reshape(-1, k), qw8).reshape(*x.shape[:-1], n)
    return (yi.float() * xs * s8.float()).to(compute.dtype)


def _matmul(params: dict, x: torch.Tensor, compute: Compute, layer: int | None, bias: bool) -> torch.Tensor:
    """The product in the compute dtype, and with ``bias`` the bias added
    in it after the rounding, as the JAX package does."""
    p = params
    if "qw8" in p and ("qw" not in p or (compute.w8a8 and rows(x) >= LARGE_M)):
        p = _at(p, layer)
        y = w8a8_matmul(x, p["qw8"], p["s8"], compute)
    elif "qw" in p:
        return q4_matmul(x, p["qw"], p["scales"], compute, layer=layer, bias=p.get("b") if bias else None)
    else:
        p = _at(p, layer)
        y = (x.to(compute.dtype) @ p["w"].to(compute.dtype)).to(compute.dtype)
    if bias and "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def apply_linear(params: dict, x: torch.Tensor, compute: Compute, *, layer: int | None = None) -> torch.Tensor:
    """``y = x @ W (+ b)``: the product rounded to the compute dtype, then
    the bias added in it, as the JAX package does."""
    return _matmul(params, x, compute, layer, bias=True)


def _add_bias(y: torch.Tensor, params: dict, layer: int | None) -> torch.Tensor:
    b = params.get("b")
    if b is None:
        return y
    return y + (b if layer is None else b[layer]).to(y.dtype)


def apply_reduce_linear(params: dict, x: torch.Tensor, compute: Compute, *, layer: int | None = None) -> torch.Tensor:
    """A row-parallel linear: the product of this rank's K shard, summed
    over the model ranks, then the bias (replicated) added once. Under
    W8A8 the input's per-row scale is this shard's absmax, as in the JAX
    package's shard_map body."""
    if compute.tp_group is None:
        return apply_linear(params, x, compute, layer=layer)
    y = all_reduce(_matmul(params, x, compute, layer, bias=False), compute.tp_group)
    return _add_bias(y, params, layer)


def qkv_proj(bp: dict, x: torch.Tensor, compute: Compute, layer: int | None = None):
    """Self-attention q/k/v; one fused ``[K, 3D]`` matmul when the params
    carry ``attn_qkv``."""
    if "attn_qkv" in bp:
        y = apply_linear(bp["attn_qkv"], x, compute, layer=layer)
        return y.chunk(3, dim=-1)
    return tuple(apply_linear(bp[n], x, compute, layer=layer) for n in ("attn_q", "attn_k", "attn_v"))


def cross_kv_proj(bp: dict, enc: torch.Tensor, compute: Compute, layer: int | None = None):
    """Cross-attention k/v from the encoder output (``xattn_kv`` aware)."""
    if "xattn_kv" in bp:
        return apply_linear(bp["xattn_kv"], enc, compute, layer=layer).chunk(2, dim=-1)
    return (
        apply_linear(bp["xattn_k"], enc, compute, layer=layer),
        apply_linear(bp["xattn_v"], enc, compute, layer=layer),
    )


def fusable(fc1: dict, fc2: dict) -> bool:
    """Whether the JAX package fuses this FFN (``pallas_ffn.fused_ffn_pallas``
    and its stacked form): Q4 codes and biases in both linears, and an F
    its f-tiles divide (``ffn_bf``: a multiple of 512)."""
    if not all(k in p for p in (fc1, fc2) for k in ("qw", "scales", "b")):
        return False
    d, f = fc1["qw"].shape[-2:]
    return f % 512 == 0 and tuple(fc2["qw"].shape[-2:]) == (f, d)


def apply_ffn(
    bp: dict, x: torch.Tensor, gelu_kind: str, compute: Compute, layer: int | None = None,
    bias_after_round: bool = False,
) -> torch.Tensor:
    """fc1 -> GELU -> fc2. Where the JAX package fuses it (Q4 weights,
    :func:`fusable`, below ``LARGE_M`` rows) this is one launch of kernel I
    (``ops/ffn_kernel.py``), fc2's bias in K4's order with
    ``bias_after_round`` (the decode step) and K7's without; elsewhere the
    two linears, GELU on fc1's rounded output, as the JAX package's
    unfused path. Under tensor parallelism kernel I runs on this rank's F
    shard without fc2's bias (a zero bias), the output is summed over the
    model ranks and the bias added once (the JAX package's TP branch)."""
    fc1, fc2 = bp["fc1"], bp["fc2"]
    if rows(x) < LARGE_M and fusable(fc1, fc2):
        x = x.to(compute.dtype)
        if compute.tp_group is None:
            return fused_ffn(x, fc1, fc2, gelu_kind, layer=layer, bias_after_round=bias_after_round)
        unbiased = {k: v for k, v in fc2.items() if k != "b"}
        y = fused_ffn(x, fc1, unbiased, gelu_kind, layer=layer, bias_after_round=bias_after_round)
        return _add_bias(all_reduce(y, compute.tp_group), fc2, layer)
    h = gelu(apply_linear(fc1, x, compute, layer=layer), gelu_kind)
    return apply_reduce_linear(fc2, h, compute, layer=layer)
