"""Q4_0 block quantization in vectorized numpy.

Port of ``whisper_burn_tpu/gguf/quant.py`` (the port's own copy):

* 32 float values per block -> 18 bytes: an IEEE f16 little-endian scale
  ``d = absmax / 7``, then 16 nibble bytes; byte ``i`` holds element ``i``
  in its low nibble and element ``i + 16`` in its high nibble;
* quantize: ``q = round(v / d) + 8`` (round half to even; the division
  takes the full-precision ``d``, the stored scale is rounded to f16);
* dequantize: ``v = (q - 8) * float32(f16(d))``.
"""

from __future__ import annotations

import numpy as np

Q4_BLOCK_SIZE = 32
Q4_BLOCK_BYTES = 18  # 2-byte f16 scale + 16 nibble bytes


def q4_0_nbytes(n_elements: int) -> int:
    """Byte size of a Q4_0 buffer holding ``n_elements`` values."""
    if n_elements % Q4_BLOCK_SIZE != 0:
        raise ValueError(f"Q4_0 element count {n_elements} not divisible by {Q4_BLOCK_SIZE}")
    return (n_elements // Q4_BLOCK_SIZE) * Q4_BLOCK_BYTES


def quantize_q4_0(values: np.ndarray) -> bytes:
    """Quantize a float array to Q4_0 bytes (row-major flattening). The
    element count must be a multiple of 32."""
    flat = np.ascontiguousarray(values, dtype=np.float32).reshape(-1)
    n_blocks = q4_0_nbytes(flat.size) // Q4_BLOCK_BYTES  # validates divisibility

    blocks = flat.reshape(n_blocks, Q4_BLOCK_SIZE).astype(np.float64)
    amax = np.max(np.abs(blocks), axis=1)
    d = np.where(amax > 0, amax / 7.0, 0.0)  # full-precision scale
    safe_d = np.where(d > 0, d, 1.0)
    q = np.where((d > 0)[:, None], np.round(blocks / safe_d[:, None]), 0.0).astype(np.int64)
    q = (q + 8) & 0x0F  # 4-bit wraparound, as the converter's `int(...) & 0x0F`

    out = np.empty((n_blocks, Q4_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(n_blocks, 2)  # f16 LE scale
    out[:, 2:] = q[:, :16].astype(np.uint8) | (q[:, 16:].astype(np.uint8) << 4)
    return out.tobytes()


def unpack_q4_0(raw: bytes | np.ndarray, n_elements: int) -> tuple[np.ndarray, np.ndarray]:
    """Q4_0 bytes -> ``(q int8[n_elements], d float32[n_elements // 32])``:
    the centered codes ``nibble - 8`` in [-8, 7] and the f16 block scales
    widened exactly to f32."""
    nbytes = q4_0_nbytes(n_elements)
    buf = raw[:nbytes] if isinstance(raw, np.ndarray) else np.frombuffer(raw, dtype=np.uint8, count=nbytes)
    n_blocks = n_elements // Q4_BLOCK_SIZE
    blocks = buf.reshape(n_blocks, Q4_BLOCK_BYTES)

    d = blocks[:, :2].copy().view(np.float16).reshape(n_blocks).astype(np.float32)
    nib = blocks[:, 2:]
    lo = (nib & 0x0F).astype(np.int8) - 8
    hi = (nib >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1).reshape(-1), d  # element i, then i + 16


def dequantize_q4_0(raw: bytes | np.ndarray, n_elements: int) -> np.ndarray:
    """Q4_0 bytes -> float32 ``(nibble - 8) * d``."""
    q, d = unpack_q4_0(raw, n_elements)
    return (q.reshape(-1, Q4_BLOCK_SIZE).astype(np.float32) * d[:, None]).reshape(-1)
