"""Kernel A: the quantized matmul with a fused epilogue, and its plain version.

Counterpart of ``whisper_burn_tpu/ops/pallas_q4.py`` (``_kernel`` K5,
``_kernel_stacked`` K1); source ``csrc/q4_matmul.cu``. The fused FFN of
``pallas_ffn.py`` is kernel I (``ops/ffn_kernel.py``).

``y = x @ (qw[layer] * scales[layer])`` with f32 accumulation, then
optionally ``+ bias[layer]`` and GELU. ``layer`` indexes stacked
``[L, K, N]`` / ``[L, K/32, N]`` / ``[L, N]`` tensors by pointer offset, so
no slice is copied. Weights round as the Pallas kernels round them: for
bf16 x each is ``bf16(code x bf16(scale))``, for f32 x the f32 product
(:func:`dequant_weight`). The bias is added in the output dtype to the
sum rounded to it, as the JAX package adds it to the kernel's result.

One launch per call, in one of two regimes the C entry point picks from M
and x's dtype (:func:`regime`): the weight-read regime (f32 x, and bf16 x
below 64 rows: the decode shapes, bound by the weight read) splits K over
a thread block cluster and reads each weight byte from HBM once whatever
M, its products in f32 for f32 x and on tensor cores for bf16 x; the
tensor-core regime (bf16 x of 64 rows and more: the encoder and cross
fill, bound by operations) dequantizes to bf16 into 128 x 128
``mma.sync`` tiles. The source note says how each meets its bound. Two
calls on the same inputs give the same bits (no float atomics). CPU
tensors take :func:`q4_matmul_plain`; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_burn_tpu_torch.models.layers import gelu as _gelu
from whisper_burn_tpu_torch.ops import _build

NAME = "q4_matmul"
Q4_BLOCK = 32
REGIMES = ("weight_read", "tensor_core")
_EPILOGUE = {None: 1, "tanh": 2, "erf": 3}
_FN = None


def dequant_weight(qw: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Materialize ``W [K, N]`` in ``dtype``: codes and scales cast to it and
    multiplied there, as the Pallas kernels and the JAX package do (in bf16
    each weight is ``bf16(code x bf16(scale))``)."""
    k, n = qw.shape
    w = qw.reshape(k // Q4_BLOCK, Q4_BLOCK, n).to(dtype) * scales.to(dtype)[:, None, :]
    return w.reshape(k, n)


def q4_matmul_plain(
    x2: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
    bias: torch.Tensor | None, gelu: str | None, out_dtype: torch.dtype,
) -> torch.Tensor:
    """Dequantize in x's dtype, then an f32 matmul; ``x2: [M, K]``,
    ``qw: [K, N]``. The bias is added in ``out_dtype`` after the rounding."""
    w = dequant_weight(qw, scales, torch.bfloat16 if x2.dtype == torch.bfloat16 else torch.float32)
    y = x2.float() @ w.float()
    if bias is not None:
        y = (y.to(out_dtype) + bias.to(out_dtype)).float()
    if gelu is not None:
        y = _gelu(y, gelu)
    return y.to(out_dtype)


def _fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = _build.declare(
            _build.library(NAME), NAME, [p, i, p, p, p, p, i, i, i, i, i, p]
        )
    return _FN


def regime(m: int, x_dtype: torch.dtype) -> str:
    """The regime a launch of ``m`` rows of ``x_dtype`` takes on the card,
    as the C entry point picks it."""
    lib = _build.library(NAME)
    pick = _build.declare(lib, "q4_matmul_regime", [ctypes.c_int, ctypes.c_int])
    return REGIMES[pick(m, int(x_dtype == torch.bfloat16))]


def q4_matmul(
    x: torch.Tensor,
    qw: torch.Tensor,
    scales: torch.Tensor,
    *,
    layer: int | None = None,
    bias: torch.Tensor | None = None,
    gelu: str | None = None,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """``x [..., K] -> [..., N]`` in ``out_dtype`` (default: x's dtype).

    ``qw: int8 [K, N]`` or ``[L, K, N]`` with ``layer``; ``scales`` f32
    alike; ``bias`` f32 ``[N]`` or ``[L, N]``; ``gelu`` "tanh" or "erf"
    (needs ``bias``)."""
    if layer is not None:
        qw, scales = qw[layer], scales[layer]
        if bias is not None:
            bias = bias[layer]
    k, n = qw.shape
    if x.shape[-1] != k or scales.shape != (k // 32, n) or k % 32:
        raise ValueError(f"q4_matmul shapes: x {tuple(x.shape)}, qw {tuple(qw.shape)}, scales {tuple(scales.shape)}")
    if gelu is not None and bias is None:
        raise ValueError("the GELU epilogue follows the bias add: pass bias")
    out_dtype = out_dtype or x.dtype
    batch = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x.device.type == "cpu":
        return q4_matmul_plain(x2, qw, scales, bias, gelu, out_dtype).reshape(*batch, n)

    x2 = x2.contiguous()
    _build.require_cuda(x2, qw, scales, *([bias] if bias is not None else []))
    if qw.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("q4_matmul takes int8 codes and f32 scales")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (n,)):
        raise ValueError("q4_matmul takes an f32 bias of shape [N]")
    if x2.dtype not in (torch.float32, torch.bfloat16) or out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("q4_matmul takes and gives f32 or bf16")
    if n % 4:
        raise ValueError(f"q4_matmul needs N % 4 == 0, got N={n}")
    if x2.data_ptr() % 16 or qw.data_ptr() % 16 or scales.data_ptr() % 16:
        raise ValueError("q4_matmul copies x, codes and scales in 16-byte pieces: pass aligned tensors")
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m:
        epi = 0 if bias is None else _EPILOGUE[gelu]
        err = _fn()(
            x2.data_ptr(), int(x2.dtype == torch.bfloat16), qw.data_ptr(), scales.data_ptr(),
            bias.data_ptr() if bias is not None else None, y.data_ptr(),
            int(out_dtype == torch.bfloat16), m, k, n, epi, _build.stream_ptr(x.device),
        )
        _build.check(err, NAME)
        _build.count_launch(NAME, (m, k, n, epi))
    return y.reshape(*batch, n)
