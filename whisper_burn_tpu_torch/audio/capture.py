"""Microphone capture with a drainable sample buffer.

Port of ``whisper_burn_tpu/audio/capture.py``: a backend's callback thread
appends mono-downmixed float32 samples to a locked buffer, and the app
drains it with ``take_samples``.

The backend is ``sounddevice`` where it imports (probed when a
:class:`SounddeviceBackend` is made, never at import); tests and headless
hosts use :class:`FakeCaptureBackend`, which replays a fixed array as if
a microphone produced it.
"""

from __future__ import annotations

import threading

import numpy as np


class CaptureBackendUnavailable(RuntimeError):
    """No microphone backend importable on this host."""


class FakeCaptureBackend:
    """Replays ``samples`` through the capture callback (tests/headless)."""

    def __init__(self, samples: np.ndarray, sample_rate: int = 16_000, chunk: int = 1024):
        self._samples = np.asarray(samples, np.float32).reshape(-1, 1)
        self.sample_rate = sample_rate
        self._chunk = chunk
        self._cb = None

    def start(self, callback) -> None:
        self._cb = callback
        for i in range(0, len(self._samples), self._chunk):
            callback(self._samples[i : i + self._chunk])

    def stop(self) -> None:
        self._cb = None


class SounddeviceBackend:
    """Real microphone via the ``sounddevice`` PortAudio bindings.

    Prefers 16 kHz and falls back to the device's default rate (the
    pipeline resamples downstream either way).
    """

    def __init__(self) -> None:
        try:
            import sounddevice  # noqa: F401 — optional, probed lazily
        except ImportError as e:
            raise CaptureBackendUnavailable(
                "sounddevice is not installed; pass a backend explicitly "
                "(e.g. FakeCaptureBackend) or record to a WAV file instead"
            ) from e
        self._sd = sounddevice
        self._stream = None
        self.sample_rate = 16_000

    def start(self, callback) -> None:
        sd = self._sd
        try:
            self._stream = sd.InputStream(
                samplerate=16_000, channels=1, dtype="float32",
                callback=lambda data, *_: callback(data),
            )
        except Exception:
            self.sample_rate = int(sd.query_devices(kind="input")["default_samplerate"])
            self._stream = sd.InputStream(
                samplerate=self.sample_rate, channels=1, dtype="float32",
                callback=lambda data, *_: callback(data),
            )
        self._stream.start()

    def stop(self) -> None:
        if self._stream is not None:
            self._stream.stop()
            self._stream.close()
            self._stream = None


class AudioCapture:
    """Accumulates mono samples from a backend callback; drain as you go."""

    def __init__(self, backend=None) -> None:
        self._backend = backend if backend is not None else SounddeviceBackend()
        self._lock = threading.Lock()
        self._buf: list[np.ndarray] = []
        self.recording = False

    @property
    def sample_rate(self) -> int:
        return self._backend.sample_rate

    def _on_audio(self, data) -> None:
        mono = np.asarray(data, np.float32)
        if mono.ndim > 1:  # downmix by channel mean
            mono = mono.mean(axis=1)
        with self._lock:
            self._buf.append(mono.copy())

    def start(self) -> None:
        with self._lock:
            self._buf.clear()
        self.recording = True
        self._backend.start(self._on_audio)

    def take_samples(self) -> np.ndarray:
        """Drain everything captured since the last call."""
        with self._lock:
            chunks, self._buf = self._buf, []
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)

    def stop(self) -> np.ndarray:
        self._backend.stop()
        self.recording = False
        return self.take_samples()
