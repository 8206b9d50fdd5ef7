"""Kernel F: the self-cache slot writer, in two forms.

Counterpart of ``whisper_burn_tpu/ops/pallas_cache.py`` (``_kernel`` via
``write_cache_slot``, K9); source ``csrc/cache_slot.cu``. Only the rows
that change are written; the TPU kernel's 8-row read-modify-write exists
for its tiling alone.

* The slot form, :func:`write_cache_slots`: one token position of up to
  three stacked caches ``[L, B, T, W]`` across all layers and streams, in
  place and in one launch: the deferred cache write of a decode step (the
  self K and V rows and the scale row beside them).
* The beam form, :func:`write_cache_slots_beam`: the beam step's whole
  self-cache update in one launch, the slot write followed by the gather
  of the streams by their parent beams (the JAX package's ``jnp.take``),
  from one buffer of a pair into the other, moving only the rows up to
  the position.

``pos`` (and the beam form's parents) are int32 tensors on the caches'
device that the kernels read from device memory (the decode loops keep
them on the card and replay captured CUDA graphs of their steps); a
position outside the cache writes nothing. CPU tensors take the plain
versions; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from whisper_burn_tpu_torch.ops import _build

NAME = "cache_slot"
FN = "write_cache_slot"  # the slot form's launch counter
BEAM_FN = "write_cache_slot_beam"  # the beam form's
PAIRS = 3  # K, V and the scale row
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {  # the C interface of csrc/cache_slot.cu
    "write_cache_slots": [_P, _P, _I] * PAIRS + [_I, _I, _P, _P],
    "write_cache_slots_beam": [_P, _P, _P, _I] * PAIRS + [_I, _I, _I, _P, _P, _P],
}
_FNS: dict = {}


def _fn(symbol: str):
    if symbol not in _FNS:
        _FNS[symbol] = _build.declare(_build.library(NAME), symbol, _ARGTYPES[symbol])
    return _FNS[symbol]


def write_cache_slot_plain(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    cache.index_copy_(2, pos.reshape(1).long(), new)


def write_cache_slots_plain(pairs: Sequence[tuple[torch.Tensor, torch.Tensor]], pos: torch.Tensor) -> None:
    for cache, new in pairs:
        write_cache_slot_plain(cache, new, pos)


def write_cache_slots_beam_plain(
    triples: Sequence[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], src: torch.Tensor, pos: torch.Tensor
) -> None:
    """K9 into ``x``, then the gather into ``y``, as the JAX package takes
    them (every row of ``y`` is written; ``x`` gains the slot)."""
    for y, x, new in triples:
        write_cache_slot_plain(x, new, pos)
        torch.index_select(x, 1, src.long(), out=y)


def _check_pair(fn: str, cache: torch.Tensor, new: torch.Tensor) -> None:
    if cache.ndim != 4 or new.shape != (*cache.shape[:2], 1, cache.shape[3]):
        raise ValueError(f"{fn}: new {tuple(new.shape)} does not fit cache {tuple(cache.shape)}")
    if new.dtype != cache.dtype:
        raise ValueError(f"{fn}: new is {new.dtype}, cache {cache.dtype}")


def _row_bytes(t: torch.Tensor) -> int:
    return t.shape[3] * t.element_size()


def write_cache_slots(pairs: Sequence[tuple[torch.Tensor, torch.Tensor]], pos: torch.Tensor) -> None:
    """``cache[:, :, pos] = new[:, :, 0]`` in place for each ``(cache,
    new)`` of ``pairs`` (one to three), in one launch; ``cache [L, B, T,
    W]`` with its own width and dtype, ``new [L, B, 1, W]`` of the same
    dtype; every cache of the same ``[L, B, T]``; ``pos`` a 0-d int32
    tensor on the caches' device, ``0 <= pos < T``."""
    if not 1 <= len(pairs) <= PAIRS:
        raise ValueError(f"write_cache_slots: {len(pairs)} pairs, at most {PAIRS}")
    for cache, new in pairs:
        _check_pair("write_cache_slots", cache, new)
    l_dim, b, t, _ = pairs[0][0].shape
    if any(cache.shape[:3] != (l_dim, b, t) for cache, _ in pairs):
        raise ValueError(f"write_cache_slots: caches of {[tuple(c.shape) for c, _ in pairs]} differ in [L, B, T]")
    dev = pairs[0][0].device
    _build.check_position("write_cache_slots", pos, dev)
    if dev.type == "cpu":
        return write_cache_slots_plain(pairs, pos)
    pairs = [(cache, new.contiguous()) for cache, new in pairs]
    _build.require_cuda(*(t for pair in pairs for t in pair))
    args = []
    for k in range(PAIRS):
        cache, new = pairs[k] if k < len(pairs) else (None, None)
        args += [None, None, 0] if cache is None else [cache.data_ptr(), new.data_ptr(), _row_bytes(cache)]
    err = _fn("write_cache_slots")(*args, l_dim * b, t, pos.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "write_cache_slots")
    _build.count_launch(FN, (l_dim, b, t, *(_row_bytes(cache) for cache, _ in pairs)))


def write_cache_slot(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """:func:`write_cache_slots` of one cache."""
    write_cache_slots([(cache, new)], pos)


def write_cache_slots_beam(
    triples: Sequence[tuple[torch.Tensor, torch.Tensor, torch.Tensor]], src: torch.Tensor, pos: torch.Tensor
) -> None:
    """For each ``(y, x, new)`` of ``triples`` (one to three), in one
    launch: ``y[:, i, t] = x[:, src[i], t]`` for ``t < pos`` and ``y[:, i,
    pos] = new[:, src[i], 0]``; ``x`` and ``y`` two buffers ``[L, BW, T,
    W]`` of one dtype and width, ``new [L, BW, 1, W]``; every buffer of the
    same ``[L, BW, T]``; ``src`` int32 ``[BW]`` in ``[0, BW)`` and ``pos``
    a 0-d int32 tensor, ``0 <= pos < T``, both on the buffers' device. On
    the card ``x`` is read only and ``y``'s rows past ``pos`` stay as they
    were; the plain version (CPU tensors) writes the slot into ``x`` and
    every row of ``y``."""
    if not 1 <= len(triples) <= PAIRS:
        raise ValueError(f"write_cache_slots_beam: {len(triples)} triples, at most {PAIRS}")
    for y, x, new in triples:
        _check_pair("write_cache_slots_beam", x, new)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"write_cache_slots_beam: y {y.dtype} {tuple(y.shape)} is not x's {x.dtype} {tuple(x.shape)}")
        if y.data_ptr() == x.data_ptr():
            raise ValueError("write_cache_slots_beam: y and x are one buffer")
    l_dim, bw, t, _ = triples[0][1].shape
    if any(x.shape[:3] != (l_dim, bw, t) for _, x, _ in triples):
        raise ValueError(f"write_cache_slots_beam: buffers of {[tuple(x.shape) for _, x, _ in triples]} differ in [L, BW, T]")
    dev = triples[0][1].device
    _build.check_position("write_cache_slots_beam", pos, dev)
    if not (src.dtype == torch.int32 and src.shape == (bw,) and src.device == dev):
        raise ValueError(f"write_cache_slots_beam: src must be int32 [{bw}] on {dev}, got {src.dtype} "
                         f"{tuple(src.shape)} on {src.device}")
    if dev.type == "cpu":
        return write_cache_slots_beam_plain(triples, src, pos)
    triples = [(y, x, new.contiguous()) for y, x, new in triples]
    _build.require_cuda(src, *(t for triple in triples for t in triple))
    args = []
    for k in range(PAIRS):
        y, x, new = triples[k] if k < len(triples) else (None, None, None)
        args += [None, None, None, 0] if y is None else [y.data_ptr(), x.data_ptr(), new.data_ptr(), _row_bytes(x)]
    err = _fn("write_cache_slots_beam")(*args, l_dim, bw, t, src.data_ptr(), pos.data_ptr(), _build.stream_ptr(dev))
    _build.check(err, "write_cache_slots_beam")
    _build.count_launch(BEAM_FN, (l_dim, bw, t, *(_row_bytes(x) for _, x, _ in triples)))
