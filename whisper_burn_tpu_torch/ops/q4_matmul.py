"""Quantized matmul dispatch: ``y[..., N] = x[..., K] @ dequant(W)[K, N]``.

Port of ``whisper_burn_tpu/ops/q4_matmul.py``. Weights are Q4 codes
``qw: int8 [K, N]`` (``nibble - 8``) with f16-exact block scales
``scales: f32 [K/32, N]``. Below ``LARGE_M`` rows the fused kernel A
(ops/q4_kernel.py) reads one byte per weight; at and above it the weight
is dequantized once and the product goes to ``torch.matmul``, as the JAX
package leaves it to XLA there.
"""

from __future__ import annotations

import torch

from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.q4_kernel import dequant_weight
from whisper_burn_tpu_torch.ops.q4_kernel import q4_matmul as q4_kernel

LARGE_M = 4096


def rows(x: torch.Tensor) -> int:
    m = 1
    for s in x.shape[:-1]:
        m *= s
    return m


def q4_matmul(
    x: torch.Tensor,
    qw: torch.Tensor,
    scales: torch.Tensor,
    compute: Compute,
    *,
    layer: int | None = None,
    bias: torch.Tensor | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x [..., K] -> [..., N]`` in ``out_dtype`` (default compute dtype),
    with an optional ``+ bias`` in ``out_dtype`` after the rounding;
    ``layer`` indexes stacked weights."""
    out_dtype = out_dtype or compute.dtype
    if rows(x) < LARGE_M:
        return q4_kernel(x.to(compute.dtype), qw, scales, layer=layer, bias=bias, out_dtype=out_dtype)
    if layer is not None:
        qw, scales = qw[layer], scales[layer]
        bias = None if bias is None else bias[layer]
    y = (x.to(compute.dtype) @ dequant_weight(qw, scales, compute.dtype)).to(out_dtype)
    return y + bias.to(y.dtype) if bias is not None else y
