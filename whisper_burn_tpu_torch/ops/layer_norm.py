"""Kernel J: the LayerNorm, with the residual add before it folded in.

Source ``csrc/layer_norm.cu``. No TPU kernel's counterpart: the JAX
package's ``models/layers.layer_norm`` is left to XLA, which fuses it; the
port's plain version, :func:`layer_norm_plain`, is eleven PyTorch launches
a call. :func:`layer_norm` normalizes ``x [..., D]`` (bf16 or f32) over its
last dim with f32 ``g`` and ``b``, and with ``residual`` it returns ``(s,
LN(s))`` for ``s = x + residual`` from one pass. The arithmetic is the
plain version's: an f32 mean, the two-pass variance, ``rsqrt(var +
1e-5)``, then ``* g`` and ``+ b`` each rounded on its own, and one rounding
to x's dtype; only the order of the row sums differs.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. The launch is counted in ``_build.LAUNCHES`` under ``layer_norm``
and kept out of ``_build.LAUNCH_LOG`` (``_build.UNLOGGED``).
"""

from __future__ import annotations

import ctypes

import torch

from whisper_burn_tpu_torch.ops import _build

NAME = "layer_norm"  # the library and the launch counter
LN_EPS = 1e-5
MAX_D = {torch.bfloat16: 2560, torch.float32: 1280}  # 10 vectors of 16 bytes a lane
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_L] * 4 + [_I, ctypes.c_float, _P]  # the C interface of csrc/layer_norm.cu
_FN: list = []


def _fn():
    if not _FN:
        _FN.append(_build.declare(_build.library(NAME), "layer_norm", _ARGTYPES))
    return _FN[0]


def layer_norm_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * g + b over the last axis, in f32."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    normed = centered * torch.rsqrt(var + LN_EPS)
    return (normed * g.float() + b.float()).to(x.dtype)


def gap_allowance(s: torch.Tensor, g: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """How far kernel J's LayerNorm of rows ``s`` may lie from the plain
    version's, ``want``: one step of want's dtype at want, plus 2^-22 of
    the row's largest term ``max|s| * rsqrt(var + eps) * |g|``. The second
    part covers the two row sums' other order where the output cancels
    to near zero (``normed * g`` against ``b``), and one step there is
    far below the terms' own rounding."""
    s32 = s.float()
    mean = s32.mean(dim=-1, keepdim=True)
    var = ((s32 - mean) * (s32 - mean)).mean(dim=-1, keepdim=True)
    term = s32.abs().amax(dim=-1, keepdim=True) * torch.rsqrt(var + LN_EPS) * g.float().abs()
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-126)))) * torch.finfo(want.dtype).eps
    return step + 2.0**-22 * term


def _split(t: torch.Tensor) -> tuple[int, int] | None:
    """``t [..., D]``'s leading dims merged into ``(outer, inner)`` where
    their strides allow two; else None."""
    dims = []
    for n, st in zip(t.shape[:-1], t.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * st:
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > 2:
        return None
    return tuple(n for n, _ in [(1, 0)] * (2 - len(dims)) + dims)


def _strides(t: torch.Tensor, outer: int, inner: int) -> tuple[int, int] | None:
    """The element strides of ``t``'s rows as ``[outer, inner, D]``, where a
    view gives them with the last dim contiguous and every row on 16
    bytes; else None."""
    try:
        so, si, sd = t.view(outer, inner, t.shape[-1]).stride()
    except RuntimeError:
        return None
    size = t.element_size()
    if sd != 1 or t.data_ptr() % 16 or (so * size) % 16 or (si * size) % 16:
        return None
    return so, si


def layer_norm(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, residual: torch.Tensor | None = None
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """LayerNorm of ``x [..., D]`` over its last dim, in x's dtype; with
    ``residual`` (x's shape and dtype) ``(s, LN(s))`` for ``s = x +
    residual`` rounded to x's dtype, as PyTorch's add rounds it. ``g``,
    ``b``: ``[D]``, read in f32. On the card ``x`` is bf16 or f32, D a
    multiple of 8 up to ``MAX_D``; its rows may be strided (the last dim
    contiguous). The outputs are new contiguous tensors."""
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError(f"layer_norm: residual {residual.dtype} {tuple(residual.shape)} is not x's "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        if residual is None:
            return layer_norm_plain(x, g, b)
        s = x + residual
        return s, layer_norm_plain(s, g, b)
    d = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layer_norm: x is {x.dtype}; the kernel takes bfloat16 or float32")
    if d % 8 or not 0 < d <= MAX_D[x.dtype]:
        raise ValueError(f"layer_norm: D = {d}; the kernel takes a multiple of 8 up to {MAX_D[x.dtype]}")
    if g.shape != (d,) or b.shape != (d,):
        raise ValueError(f"layer_norm: g {tuple(g.shape)} and b {tuple(b.shape)} must be [{d}]")
    if any(t.device != x.device for t in (g, b) + ((residual,) if residual is not None else ())):
        raise ValueError("layer_norm: x, g, b and the residual must be on one device")
    g, b = g.float().contiguous(), b.float().contiguous()
    split = _split(x)
    x_st = split and _strides(x, *split)
    if not x_st:
        x = x.contiguous()
        split = (1, x.numel() // d)
        x_st = _strides(x, *split)
    r_st = (0, 0)
    if residual is not None:
        r_st = _strides(residual, *split)
        if not r_st:
            residual = residual.contiguous()
            r_st = _strides(residual, *split)
    _build.require_cuda(g, b)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    s = torch.empty_like(y) if residual is not None else None
    outer, inner = split
    if outer * inner:
        err = _fn()(x.data_ptr(), None if residual is None else residual.data_ptr(),
                    None if s is None else s.data_ptr(), y.data_ptr(), g.data_ptr(), b.data_ptr(),
                    outer, inner, d, *x_st, *r_st, _DTYPE_CODE[x.dtype], LN_EPS,
                    _build.stream_ptr(x.device))
        _build.check(err, "layer_norm")
        _build.count_launch(NAME, (outer * inner, d, x.element_size(), int(residual is not None)))
    return y if residual is None else (s, y)
