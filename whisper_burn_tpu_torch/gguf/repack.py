"""Repack Q4_0 blocks into the layout the port's kernels read.

Port of ``whisper_burn_tpu/gguf/repack.py`` (its numpy path; the port's own
copy). GGUF's 18-byte blocks (an f16 scale, then nibbles) hold a quantized
``[N, K]`` weight (N out features, K in features) with its 32-blocks along
K. Once at load time each becomes two dense arrays for ``x[M, K] @ W[K, N]``:

* ``qw: int8[K, N]``: the centered codes ``nibble - 8`` in [-8, 7];
* ``scales: float32[K // 32, N]``: each 32-block's scale, f16-exact, so
  that ``qw * repeat(scales, 32, axis=0)`` is exactly ``(nibble - 8) * d``.

The C++ host library (``native_host``) repacks on every host core; with
``WHISPER_TPU_NATIVE=0`` the numpy path below does it on one, the
transpose done on the packed nibble bytes (half the bytes of the codes),
each nibble then unpacked straight into its row of ``qw``: about 1.5 ns a
weight, a few seconds for Large-V3. Both give the same arrays bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from whisper_burn_tpu_torch import native_host
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
    if native_host.enabled():
        return QuantizedTensor(*native_host.repack_q4_0(raw, n_out, k_in))
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


def _f16_nearest(d: torch.Tensor) -> torch.Tensor:
    """float64 ``d >= 0`` rounded once to the nearest f16, ties to even,
    as numpy's ``astype(np.float16)`` rounds. PyTorch converts through f32,
    which can round twice and land one f16 step off; that step's two
    neighbours are the other candidates, and their distances to ``d`` are
    exact in float64 (Sterbenz), so the pick is exact."""
    bits = d.float().half().view(torch.int16).to(torch.int32)
    cands = torch.stack([bits - 1, bits, bits + 1]).clamp_min(0)
    vals = cands.to(torch.int16).view(torch.float16).double()
    err = (vals - d).abs()
    nearest = err == err.min(dim=0).values
    pick = (nearest.int() * 2 + (cands % 2 == 0).int()).argmax(dim=0, keepdim=True)
    return vals.gather(0, pick)[0].half()


def repack_f32_tensor(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`repack_f32` on the tensor's device, for ``[..., N, K]``
    float weights (a leading layer axis allowed): ``(qw int8 [..., K, N],
    scales f32 [..., K/32, N])``, bit for bit what ``repack_f32`` gives
    for each matrix. The arithmetic is :func:`quantize_q4_0`'s: float64
    blocks, ``d = absmax / 7``, codes ``round(v / d)`` half to even, the
    stored scale ``d`` rounded to f16."""
    *lead, n_out, k_in = weight.shape
    if k_in % Q4_BLOCK_SIZE != 0:
        raise ValueError(f"K={k_in} not divisible by {Q4_BLOCK_SIZE}")
    blocks = weight.float().double().reshape(*lead, n_out, k_in // Q4_BLOCK_SIZE, Q4_BLOCK_SIZE)
    d = blocks.abs().amax(dim=-1) / 7.0
    live = d > 0
    q = torch.where(live[..., None], torch.round(blocks / torch.where(live, d, 1.0)[..., None]), 0.0)
    qw = q.to(torch.int8).reshape(*lead, n_out, k_in).transpose(-1, -2).contiguous()
    scales = _f16_nearest(d).float().transpose(-1, -2).contiguous()
    return qw, scales
