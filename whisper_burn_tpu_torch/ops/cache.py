"""Kernel F: the self-cache slot writer.

Counterpart of ``whisper_burn_tpu/ops/pallas_cache.py`` (``_kernel`` via
``write_cache_slot``, K9); source ``csrc/cache_slot.cu``. It writes one
token position of a stacked cache across all layers and streams, in
place: the deferred cache write of a beam-search decode step. Only the row
``pos`` of each (layer, stream) is written; the TPU kernel's 8-row
read-modify-write exists for its tiling alone. ``pos`` is a 0-d int32
tensor on the cache's device that the kernel reads from device memory (the
decode loop keeps the position on the card and replays a captured CUDA
graph of its step); the kernel writes nothing for a position outside the
cache. CPU tensors take the plain version; CUDA tensors launch the kernel
or raise.
"""

from __future__ import annotations

import ctypes

import torch

from whisper_burn_tpu_torch.ops import _build

NAME = "cache_slot"
FN = "write_cache_slot"
_FN = None


def _fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = _build.declare(_build.library(NAME), FN, [p, p, i, i, p, i, p])
    return _FN


def write_cache_slot_plain(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    cache.index_copy_(2, pos.reshape(1).long(), new)


def write_cache_slot(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``cache[:, :, pos] = new[:, :, 0]`` in place; ``cache [L, B, T, W]``,
    ``new [L, B, 1, W]`` of the same dtype, ``pos`` a 0-d int32 tensor on
    the cache's device, ``0 <= pos < T``."""
    if cache.ndim != 4 or new.shape != (*cache.shape[:2], 1, cache.shape[3]):
        raise ValueError(f"write_cache_slot: new {tuple(new.shape)} does not fit cache {tuple(cache.shape)}")
    if new.dtype != cache.dtype:
        raise ValueError(f"write_cache_slot: new is {new.dtype}, cache {cache.dtype}")
    l_dim, b, t, w = cache.shape
    _build.check_position("write_cache_slot", pos, cache.device)
    if cache.device.type == "cpu":
        return write_cache_slot_plain(cache, new, pos)
    new = new.contiguous()
    _build.require_cuda(cache, new)
    err = _fn()(
        cache.data_ptr(), new.data_ptr(), l_dim * b, t, pos.data_ptr(), w * cache.element_size(),
        _build.stream_ptr(cache.device),
    )
    _build.check(err, FN)
    _build.count_launch(FN, (l_dim, b, t, w, cache.element_size()))
