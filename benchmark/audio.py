"""Seeded audio for the traffic: what each request carries.

``utterance`` is a frozen copy of ``chip_smoke.py:1549-1555``: seeded
noise (standard normal x 0.1) or a tone. Here the kind is given, not
drawn, so that every seed makes the same set of clips in another order.
Imports nothing of the program."""

from __future__ import annotations

import dataclasses

import numpy as np

WHISPER_RATE = 16_000


def utterance(rng: np.random.Generator, seconds: float, rate: int, tone: bool) -> np.ndarray:
    """Seeded noise (standard normal x 0.1) or a tone, ``seconds`` long."""
    n = int(seconds * rate)
    if not tone:
        return (rng.standard_normal(n) * 0.1).astype(np.float32)
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 1000) * np.arange(n) / rate)).astype(np.float32)


@dataclasses.dataclass
class Clip:
    """One request's audio: mono samples at ``rate`` (a stereo clip is
    sent as the mean of its two channels, as a WAV reader downmixes it)."""

    samples: np.ndarray
    rate: int
    stereo: bool

    @property
    def seconds(self) -> float:
        return len(self.samples) / self.rate


def make_clip(rng: np.random.Generator, seconds: float, rate: int, stereo: bool, tone: bool) -> Clip:
    if not stereo:
        return Clip(utterance(rng, seconds, rate, tone), rate, False)
    left, right = utterance(rng, seconds, rate, tone), utterance(rng, seconds, rate, tone)
    return Clip(((left + right) * 0.5).astype(np.float32), rate, True)


def spread(values: list, rng: np.random.Generator) -> list:
    """``values`` in an order drawn from ``rng``."""
    return [values[i] for i in rng.permutation(len(values))]
