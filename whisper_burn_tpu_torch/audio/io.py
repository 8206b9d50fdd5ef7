"""WAV file I/O (host-side, stdlib ``wave`` + numpy).

Copy of ``whisper_burn_tpu/audio/io.py`` (the port imports nothing of the
JAX package). Loading goes through the C++ host library's RIFF parser
(``native_host.load_wav``, the same samples bit for bit on PCM); with
``WHISPER_TPU_NATIVE=0``, through stdlib ``wave`` and numpy.

Behavioral contract from the reference (src/audio/io.rs):

* load: integer PCM of any bit depth or float32, any channel count;
  channels are downmixed to mono by per-frame mean (:92-104); integer
  samples normalize to [-1, 1] by the type's max magnitude (:84-90)
* save: 16-bit PCM mono with clamping to [-1, 1] (:117-137)
"""

from __future__ import annotations

import wave
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from whisper_burn_tpu_torch import native_host


@dataclass
class AudioBuffer:
    """Mono float32 samples + sample rate (reference: src/audio/io.rs:11-16)."""

    samples: np.ndarray  # float32 [n]
    sample_rate: int

    @property
    def duration_s(self) -> float:
        return len(self.samples) / self.sample_rate


def load_wav(path: str | Path) -> AudioBuffer:
    """Load a WAV file as mono float32 in [-1, 1].

    Supports 8/16/24/32-bit integer PCM and 32-bit float (format 3).
    Multi-channel input is downmixed by channel mean
    (src/audio/io.rs:75-114).
    """
    path = Path(path)
    if native_host.enabled():
        samples, rate = native_host.load_wav(path)
        return AudioBuffer(samples=samples, sample_rate=rate)
    with wave.open(str(path), "rb") as w:
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        framerate = w.getframerate()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)
        # stdlib wave exposes the compression type; "NONE" covers both
        # integer PCM (fmt 1) and — on some writers — float PCM (fmt 3).
        comp = w.getcomptype()

    if sampwidth == 1:
        # 8-bit WAV is unsigned
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
        data = (data - 128.0) / 128.0
    elif sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        as_i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        as_i32 = np.where(as_i32 >= 1 << 23, as_i32 - (1 << 24), as_i32)
        data = as_i32.astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        if comp == "NONE":
            ints = np.frombuffer(raw, dtype="<i4")
            # Heuristic: float32 WAVs read as i4 look like huge magnitudes;
            # genuine i32 PCM uses the full integer range. Try float first.
            as_f32 = np.frombuffer(raw, dtype="<f4")
            if np.all(np.isfinite(as_f32)) and (as_f32.size == 0 or np.abs(as_f32).max() <= 16.0):
                data = as_f32.astype(np.float32)
            else:
                data = ints.astype(np.float32) / float(1 << 31)
        else:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth}")

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return AudioBuffer(samples=np.ascontiguousarray(data, dtype=np.float32), sample_rate=framerate)


def save_wav(path: str | Path, audio: AudioBuffer) -> None:
    """Save mono float32 samples as 16-bit PCM (src/audio/io.rs:117-137)."""
    clipped = np.clip(audio.samples, -1.0, 1.0)
    pcm = np.round(clipped * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(audio.sample_rate)
        w.writeframes(pcm.tobytes())
