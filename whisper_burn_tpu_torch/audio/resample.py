"""Sample-rate conversion to Whisper's 16 kHz (host-side).

The reference uses rubato's FFT resampler in 1024-sample chunks
(src/audio/resample.rs:16-46). Here: scipy polyphase resampling
(``resample_poly``), which gives equivalent anti-aliased quality in one
vectorized pass — resampler choice is not part of the numerical parity
contract (the parity fixture test.wav is already 16 kHz).

Copy of ``whisper_burn_tpu/audio/resample.py``: the C++ host library's
polyphase resampler (``native_host.resample_poly``, scipy's filter design,
within 2e-3 of scipy), or with ``WHISPER_TPU_NATIVE=0`` scipy's.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.signal import resample_poly

from whisper_burn_tpu_torch import native_host
from whisper_burn_tpu_torch.audio.io import AudioBuffer

WHISPER_SAMPLE_RATE = 16_000


def resample(audio: AudioBuffer, target_rate: int) -> AudioBuffer:
    """Resample to ``target_rate`` via polyphase filtering."""
    if audio.sample_rate == target_rate:
        return audio
    g = math.gcd(audio.sample_rate, target_rate)
    up, down = target_rate // g, audio.sample_rate // g
    if native_host.enabled():
        return AudioBuffer(samples=native_host.resample_poly(audio.samples, up, down), sample_rate=target_rate)
    out = resample_poly(audio.samples.astype(np.float64), up, down).astype(np.float32)
    return AudioBuffer(samples=out, sample_rate=target_rate)


def resample_to_16k(audio: AudioBuffer) -> AudioBuffer:
    """Any rate -> 16 kHz (reference: src/audio/resample.rs:11-13)."""
    return resample(audio, WHISPER_SAMPLE_RATE)
