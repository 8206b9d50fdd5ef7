"""Kernel I: the fused Q4 FFN ``fc2(GELU(fc1(x)))`` in one launch, and its plain version.

Counterpart of ``whisper_burn_tpu/ops/pallas_ffn.py`` (``_kernel`` K7 and
``_kernel_stacked`` K4); source ``csrc/ffn.cu``. Numbers as in K4 and K7:
weights ``bf16(code x bf16(scale))`` for bf16 x (f32 for f32 x), ``h`` in
f32, ``g = gelu(h)`` rounded to x's dtype, the fc2 sum in f32; then fc2's
bias in K7's order (in the f32 sum, one rounding) or, with
``bias_after_round``, in K4's (the decode step rounds the sum and adds the
bias in the compute dtype). GELU is the tanh form or, for "erf", K4's
Abramowitz & Stegun erf (:func:`gelu`).

One cooperative launch a call, in one of two regimes (``csrc/ffn.cu``):
below 64 rows of bf16 (and for f32) one block to an SM holds its share of
both weights in shared memory, bulk-copied from its first instruction out
of a second copy of the weights in 16-column units (:func:`unit_layout`,
each unit one contiguous run); from 64 rows of bf16 persistent blocks run
the two products as 128 x 128 ``wgmma`` tiles on the ``[K, N]`` weights.
In both, ``g`` passes through a scratch ``[M, F]`` in x's dtype (it stays
in L2), read after one grid-wide barrier by blocks that each own whole
output columns, so every sum runs in a fixed order.

``layer`` indexes stacked weights by pointer offset, so no slice is
copied. The unit copy is made once per stacked weight tensor (kept while
that tensor lives; the weights are not changed in place), and each shape's
scratch and barrier word once per (device, shape), at the first launch,
which must not be inside a CUDA graph's capture (a greedy runner's eager
first step makes them); the kernel leaves the barrier ready for the next
launch or replay. CPU tensors take :func:`fused_ffn_plain`; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
import weakref

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
_PLANS: dict = {}  # (device, M, D, F, bf16) -> (plan, scratch, barrier)
_UNITS: dict = {}  # id(stacked codes) -> (weakref to them, their pointers, the unit copy)
_CHECKED: dict = {}  # ids of the six weight tensors -> (weakrefs to them, what _checked found)
# ffn_plan's fields, in order
PLAN_FIELDS = ("regime", "blocks", "scratch", "smem", "C", "e", "parts", "cooperative", "threads")


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
    qw2: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor | None, kind: str, bias_after_round: bool,
) -> torch.Tensor:
    """``x2 [M, D] -> [M, D]`` in x2's dtype, the arithmetic of K4 / K7;
    ``b2`` None adds a zero bias."""
    dt = x2.dtype
    h = x2.float() @ dequant_weight(qw1, s1, dt).float() + b1.float()
    g = gelu(h, kind).to(dt)
    y = g.float() @ dequant_weight(qw2, s2, dt).float()
    if b2 is None:
        b2 = y.new_zeros(y.shape[-1])
    if bias_after_round:
        return y.to(dt) + b2.to(dt)
    return (y + b2.float()).to(dt)


def unit_layout(qw: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Q4 codes ``[..., K, N]`` and scales ``[..., K/32, N]`` as kernel I's
    decode regime reads them: bytes ``[..., N/16, K/32, 576]``, each
    16-column unit contiguous, each 32-row block its 512 codes then its 16
    f32 scales. Lane ``4g + t`` of a warp finds at ``16 (4g + t)`` its codes
    of rows ``8t..8t+7`` at columns ``2g, 2g+1`` (byte ``4q + 2p + c`` is
    row ``8t + 2q + p``, column ``2g + c``)."""
    *lead, k, n = qw.shape
    nl = len(lead)
    # [..., kb, t, q, p, unit, g, c] -> [..., unit, kb, g, t, q, p, c]
    codes = qw.reshape(*lead, k // 32, 4, 4, 2, n // 16, 8, 2)
    codes = codes.permute(*range(nl), nl + 4, nl, nl + 5, nl + 1, nl + 2, nl + 3, nl + 6)
    codes = codes.reshape(*lead, n // 16, k // 32, 512).view(torch.uint8)
    sc = scales.reshape(*lead, k // 32, n // 16, 16).transpose(-3, -2).contiguous().view(torch.uint8)
    return torch.cat([codes, sc], dim=-1)


def _units(qw: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """:func:`unit_layout` of stacked weights, made once while they live."""
    key, ptrs = id(qw), (qw.data_ptr(), scales.data_ptr())
    hit = _UNITS.get(key)
    if hit is None or hit[0]() is not qw or hit[1] != ptrs:
        def drop(ref, key=key):
            if _UNITS.get(key, (None,))[0] is ref:
                del _UNITS[key]
        hit = _UNITS[key] = (weakref.ref(qw, drop), ptrs, unit_layout(qw, scales))
    return hit[2]


def _at(a: torch.Tensor, layer: int | None) -> int:
    """The address of ``a`` (of its ``layer`` when stacked), without a view."""
    return a.data_ptr() if layer is None else a.data_ptr() + layer * a.stride(0) * a.element_size()


def _fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = _build.declare(
            _build.library(LIB), NAME,
            [p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p],
        )
    return _FN


def _plan(device: torch.device, m: int, d: int, f: int, bf16: bool):
    """The launch's plan (a dict of :data:`PLAN_FIELDS`), its scratch for
    ``g`` and its zeroed barrier count, made once per (device, shape)."""
    global _PLAN
    key = (device, m, d, f, bf16)
    if key not in _PLANS:
        if _PLAN is None:
            _PLAN = _build.declare(_build.library(LIB), "ffn_plan",
                                   [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        plan = (ctypes.c_longlong * len(PLAN_FIELDS))()
        _build.check(_PLAN(m, d, f, int(bf16), ctypes.addressof(plan)), "ffn_plan")
        fields = dict(zip(PLAN_FIELDS, plan))
        scratch = torch.empty((fields["scratch"],), dtype=torch.bfloat16 if bf16 else torch.float32, device=device)
        barrier = torch.zeros((1,), dtype=torch.int64, device=device)
        _PLANS[key] = (fields, scratch, barrier)
    return _PLANS[key]


def _checked(ws: tuple, stacked: bool, device: torch.device) -> tuple:
    """``(d, f, [(address, layer stride in bytes)] x 6)`` of the six weight
    tensors (fc2's bias may be None: address 0), checked once per set of
    tensors (while they live): shapes, int8 codes and f32 scales and
    biases, contiguous, 16-byte aligned, on ``device``."""
    key = (*map(id, ws), stacked, device)
    hit = _CHECKED.get(key)
    if hit is not None and all(r() is a for r, a in zip(hit[0], ws)):
        return hit[1]
    given = [a for a in ws if a is not None]
    qw1, s1, b1, qw2, s2, b2 = (None if a is None else a.shape[int(stacked):] for a in ws)
    d, f = qw1
    if (d % 32 or f % 32 or s1 != (d // 32, f) or b1 != (f,) or qw2 != (f, d) or s2 != (f // 32, d)
            or b2 not in (None, (d,)) or (stacked and any(a.shape[0] != ws[0].shape[0] for a in given))):
        raise ValueError(f"fused_ffn shapes: fc1 {[tuple(a.shape) for a in ws[:3]]}, "
                         f"fc2 {[None if a is None else tuple(a.shape) for a in ws[3:]]}")
    if device.type != "cpu":
        _build.require_cuda(*given)
        if any(a.device != device for a in given):
            raise ValueError(f"fused_ffn: weights on {ws[0].device}, x on {device}")
        if (ws[0].dtype != torch.int8 or ws[3].dtype != torch.int8
                or any(ws[i].dtype != torch.float32 for i in (1, 2, 4, 5) if ws[i] is not None)):
            raise ValueError("fused_ffn takes int8 codes and f32 scales and biases")
        if any(a.data_ptr() % 16 or (stacked and a.stride(0) * a.element_size() % 16) for a in given):
            raise ValueError("fused_ffn copies in 16-byte pieces: pass aligned tensors")
    out = (d, f, [(0, 0) if a is None else (a.data_ptr(), a.stride(0) * a.element_size() if stacked else 0)
                  for a in ws])
    _CHECKED[key] = ([(lambda: None) if a is None else weakref.ref(a) for a in ws], out)
    return out


def fused_ffn(
    x: torch.Tensor, fc1: dict, fc2: dict, kind: str, *,
    layer: int | None = None, bias_after_round: bool = False,
) -> torch.Tensor:
    """``x [..., D] -> [..., D]`` in x's dtype (f32 or bf16). ``fc1``:
    ``qw`` int8 ``[D, F]``, ``scales`` f32 ``[D/32, F]``, ``b`` f32 ``[F]``;
    ``fc2`` the same at ``[F, D]``, or without ``b`` (a zero bias: a
    tensor-parallel shard's, whose bias is added after the sum); each
    stacked ``[L, ...]`` with ``layer``. ``kind``: "tanh" or "erf"."""
    ws = (fc1["qw"], fc1["scales"], fc1["b"], fc2["qw"], fc2["scales"], fc2.get("b"))
    if layer is not None:
        if not -ws[0].shape[0] <= layer < ws[0].shape[0]:
            raise IndexError(f"fused_ffn: layer {layer} of {ws[0].shape[0]} stacked")
        layer %= ws[0].shape[0]
    d, f, addr = _checked(ws, layer is not None, x.device)
    if x.shape[-1] != d:
        raise ValueError(f"fused_ffn shapes: x {tuple(x.shape)}, fc1 {tuple(ws[0].shape)}")
    if kind not in ("tanh", "erf"):
        raise ValueError(f"fused_ffn: GELU 'tanh' or 'erf', got {kind!r}")
    batch = x.shape[:-1]
    x2 = x.reshape(-1, d)
    if x.device.type == "cpu":
        one = ws if layer is None else [None if a is None else a[layer] for a in ws]
        return fused_ffn_plain(x2, *one, kind, bias_after_round).reshape(*batch, d)

    x2 = x2.contiguous()
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("fused_ffn takes and gives f32 or bf16")
    if x2.data_ptr() % 16:
        raise ValueError("fused_ffn copies in 16-byte pieces: pass aligned tensors")
    m = x2.shape[0]
    out = torch.empty((m, d), dtype=x2.dtype, device=x.device)
    if m:
        bf16 = x2.dtype == torch.bfloat16
        plan, scratch, barrier = _plan(x.device, m, d, f, bf16)
        units = [None, None]
        if plan["regime"] == 0:
            units = [_at(_units(ws[0], ws[1]), layer), _at(_units(ws[3], ws[4]), layer)]
        lay = layer or 0
        err = _fn()(
            x2.data_ptr(), int(bf16), *(base + lay * stride for base, stride in addr), *units,
            out.data_ptr(), scratch.data_ptr(), barrier.data_ptr(),
            m, d, f, int(kind == "erf"), int(bias_after_round), _build.stream_ptr(x.device),
        )
        _build.check(err, NAME)
        _build.count_launch(NAME, (m, d, f, int(bias_after_round)))
    return out.reshape(*batch, d)
