"""Repack Q4_0 blocks into the layout the port's kernels read.

Port of ``whisper_burn_tpu/gguf/repack.py`` (its numpy path; the port's own
copy). GGUF's 18-byte blocks (an f16 scale, then nibbles) hold a quantized
``[N, K]`` weight (N out features, K in features) with its 32-blocks along
K. Once at load time each becomes two dense arrays for ``x[M, K] @ W[K, N]``:

* ``qw: int8[K, N]``: the centered codes ``nibble - 8`` in [-8, 7];
* ``scales: float32[K // 32, N]``: each 32-block's scale, f16-exact, so
  that ``qw * repeat(scales, 32, axis=0)`` is exactly ``(nibble - 8) * d``.

The transpose is done on the packed nibble bytes (half the bytes of the
codes), each nibble then unpacked straight into its row of ``qw``: about
1.5 ns a weight on one host core, a few seconds for Large-V3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from whisper_burn_tpu_torch.gguf.quant import Q4_BLOCK_BYTES, Q4_BLOCK_SIZE, q4_0_nbytes, quantize_q4_0


@dataclass
class QuantizedTensor:
    """A repacked Q4_0 weight of a linear ``y = x @ W^T``:
    ``qw[k, n] * scales[k // 32, n]`` is ``W^T[k, n]`` exactly."""

    qw: np.ndarray  # int8 [K, N]
    scales: np.ndarray  # float32 [K // 32, N]

    @property
    def k(self) -> int:
        return self.qw.shape[0]

    @property
    def n(self) -> int:
        return self.qw.shape[1]

    def dequantize(self) -> np.ndarray:
        """float32 ``W^T[K, N]`` (a test oracle)."""
        return self.qw.astype(np.float32) * np.repeat(self.scales, Q4_BLOCK_SIZE, axis=0)


def repack_q4_0(raw: bytes | np.ndarray, n_out: int, k_in: int) -> QuantizedTensor:
    """Repack a GGUF Q4_0 tensor of row-major shape ``[n_out, k_in]`` (its
    32-blocks along K, so K must divide by 32)."""
    if k_in % Q4_BLOCK_SIZE != 0:
        raise ValueError(f"K={k_in} not divisible by {Q4_BLOCK_SIZE}")
    nbytes = q4_0_nbytes(n_out * k_in)
    buf = raw[:nbytes] if isinstance(raw, np.ndarray) else np.frombuffer(raw, dtype=np.uint8, count=nbytes)
    nb = k_in // Q4_BLOCK_SIZE
    blocks = buf.reshape(n_out, nb, Q4_BLOCK_BYTES)
    # byte j of block b holds K rows 32b + j (low nibble) and 32b + 16 + j (high)
    nib = np.ascontiguousarray(blocks[:, :, 2:].reshape(n_out, nb * 16).T).reshape(nb, 16, n_out)
    qw = np.empty((nb, 2, 16, n_out), np.int8)
    lo, hi = qw[:, 0].view(np.uint8), qw[:, 1].view(np.uint8)
    np.bitwise_and(nib, 0x0F, out=lo)
    np.right_shift(nib, 4, out=hi)
    qw -= 8
    scales = np.ascontiguousarray(np.ascontiguousarray(blocks[:, :, :2]).view("<f2").reshape(n_out, nb).T,
                                  dtype=np.float32)
    return QuantizedTensor(qw=qw.reshape(k_in, n_out), scales=scales)


def repack_f32(weight: np.ndarray) -> QuantizedTensor:
    """Quantize and repack a float ``[N, K]`` weight (a fixture helper)."""
    n_out, k_in = weight.shape
    return repack_q4_0(quantize_q4_0(weight), n_out, k_in)
