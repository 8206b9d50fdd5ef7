"""Kernel I: the fused Q4 FFN ``fc2(GELU(fc1(x)))`` in one launch, and its plain version.

Counterpart of ``whisper_burn_tpu/ops/pallas_ffn.py`` (``_kernel`` K7 and
``_kernel_stacked`` K4); source ``csrc/ffn.cu``. ``h = x @ W1 + b1`` and
``g = gelu(h)`` stay in registers and shared memory, never in device
memory. Numbers as in K4 and K7: weights ``bf16(code x bf16(scale))`` for
bf16 x (f32 for f32 x), ``h`` in f32, ``g`` rounded to x's dtype, the fc2
sum in f32; then fc2's bias in K7's order (in the f32 sum, one rounding)
or, with ``bias_after_round``, in K4's (the decode step rounds the sum and
adds the bias in the compute dtype). GELU is the tanh form or, for "erf",
K4's Abramowitz & Stegun erf (:func:`gelu`).

``layer`` indexes stacked weights by pointer offset, so no slice is
copied. Each shape's workspace and arrival counters are made once per
(device, shape) at its first launch, which must not be inside a CUDA
graph's capture (a greedy runner's eager first step makes them). CPU
tensors take :func:`fused_ffn_plain`; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import math

import torch

from whisper_burn_tpu_torch.models.layers import gelu as _gelu
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.q4_kernel import dequant_weight

NAME = "fused_ffn"
LIB = "ffn"  # csrc/ffn.cu
# the decode step takes K4 (fc2's bias after the rounding) up to this many
# rows, as whisper_burn_tpu's stacked FFN does (pallas_ffn.BM_MAX)
K4_MAX_ROWS = 256
_FN = None
_PLAN = None
_PLANS: dict = {}  # (device, M, D, F, bf16) -> (splits, workspace, counters)


def _erf_as(x: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 (max abs error about 3e-6), as K4's."""
    t = 1.0 / (1.0 + 0.3275911 * x.abs())
    p = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t - 0.284496736) * t + 0.254829592)
    return torch.sign(x) * (1.0 - p * t * torch.exp(-x * x))


def gelu(x: torch.Tensor, kind: str) -> torch.Tensor:
    """pallas_ffn.py's GELU: "erf" in f32 with the A&S erf, cast back to
    x's dtype; "tanh" in x's dtype."""
    if kind == "erf":
        x32 = x.float()
        return (0.5 * x32 * (1.0 + _erf_as(x32 * (1.0 / math.sqrt(2.0))))).to(x.dtype)
    return _gelu(x, "tanh")


def fused_ffn_plain(
    x2: torch.Tensor, qw1: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
    qw2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor, kind: str, bias_after_round: bool,
) -> torch.Tensor:
    """``x2 [M, D] -> [M, D]`` in x2's dtype, the arithmetic of K4 / K7."""
    dt = x2.dtype
    h = x2.float() @ dequant_weight(qw1, s1, dt).float() + b1.float()
    g = gelu(h, kind).to(dt)
    y = g.float() @ dequant_weight(qw2, s2, dt).float()
    if bias_after_round:
        return y.to(dt) + b2.to(dt)
    return (y + b2.float()).to(dt)


def _fn():
    global _FN
    if _FN is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _FN = _build.declare(
            _build.library(LIB), NAME,
            [p, i, p, p, p, p, p, p, p, p, ll, p, i, i, i, i, i, i, p],
        )
    return _FN


def _plan(device: torch.device, m: int, d: int, f: int, bf16: bool):
    """The launch's splits of F, its workspace and its zeroed counters,
    made once per (device, shape)."""
    global _PLAN
    key = (device, m, d, f, bf16)
    if key not in _PLANS:
        if _PLAN is None:
            _PLAN = _build.declare(_build.library(LIB), "ffn_plan",
                                   [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        plan = (ctypes.c_longlong * 5)()
        _build.check(_PLAN(m, d, f, int(bf16), ctypes.addressof(plan)), "ffn_plan")
        cs, nsplit, tiles, _, ws_floats = plan
        ws = torch.empty((max(ws_floats, 4),), dtype=torch.float32, device=device)
        counters = torch.zeros((tiles * cs,), dtype=torch.int32, device=device)
        _PLANS[key] = (nsplit, ws, counters)
    return _PLANS[key]


def fused_ffn(
    x: torch.Tensor, fc1: dict, fc2: dict, kind: str, *,
    layer: int | None = None, bias_after_round: bool = False,
) -> torch.Tensor:
    """``x [..., D] -> [..., D]`` in x's dtype (f32 or bf16). ``fc1``:
    ``qw`` int8 ``[D, F]``, ``scales`` f32 ``[D/32, F]``, ``b`` f32 ``[F]``;
    ``fc2`` the same at ``[F, D]``; each stacked ``[L, ...]`` with
    ``layer``. ``kind``: "tanh" or "erf"."""
    qw1, s1, b1, qw2, s2, b2 = fc1["qw"], fc1["scales"], fc1["b"], fc2["qw"], fc2["scales"], fc2["b"]
    if layer is not None:
        qw1, s1, b1, qw2, s2, b2 = (a[layer] for a in (qw1, s1, b1, qw2, s2, b2))
    d, f = qw1.shape
    if (x.shape[-1] != d or d % 32 or f % 32 or s1.shape != (d // 32, f) or b1.shape != (f,)
            or qw2.shape != (f, d) or s2.shape != (f // 32, d) or b2.shape != (d,)):
        raise ValueError(f"fused_ffn shapes: x {tuple(x.shape)}, fc1 {tuple(qw1.shape)}, fc2 {tuple(qw2.shape)}")
    if kind not in ("tanh", "erf"):
        raise ValueError(f"fused_ffn: GELU 'tanh' or 'erf', got {kind!r}")
    batch = x.shape[:-1]
    x2 = x.reshape(-1, d)
    if x.device.type == "cpu":
        return fused_ffn_plain(x2, qw1, s1, b1, qw2, s2, b2, kind, bias_after_round).reshape(*batch, d)

    x2 = x2.contiguous()
    tensors = (x2, qw1, s1, b1, qw2, s2, b2)
    _build.require_cuda(*tensors)
    if qw1.dtype != torch.int8 or qw2.dtype != torch.int8 or any(a.dtype != torch.float32 for a in (s1, b1, s2, b2)):
        raise ValueError("fused_ffn takes int8 codes and f32 scales and biases")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("fused_ffn takes and gives f32 or bf16")
    if any(a.data_ptr() % 16 for a in tensors):
        raise ValueError("fused_ffn copies in 16-byte pieces: pass aligned tensors")
    m = x2.shape[0]
    out = torch.empty((m, d), dtype=x2.dtype, device=x.device)
    if m:
        bf16 = x2.dtype == torch.bfloat16
        nsplit, ws, counters = _plan(x.device, m, d, f, bf16)
        err = _fn()(
            x2.data_ptr(), int(bf16), qw1.data_ptr(), s1.data_ptr(), b1.data_ptr(), qw2.data_ptr(),
            s2.data_ptr(), b2.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), counters.data_ptr(),
            m, d, f, nsplit, int(kind == "erf"), int(bias_after_round), _build.stream_ptr(x.device),
        )
        _build.check(err, NAME)
        _build.count_launch(NAME, (m, d, f, int(bias_after_round)))
    return out.reshape(*batch, d)
