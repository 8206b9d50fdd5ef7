"""Stage timers and throughput counters for the pipeline.

Copy of ``whisper_burn_tpu/utils/profiling.py`` for PyTorch:

* :class:`StageTimer` — named wall-clock stages, logged through the
  standard ``logging`` module; with ``sync=True`` on a CUDA device a stage
  ends with ``torch.cuda.synchronize()``, so its time covers the device
  work it queued;
* :class:`ThroughputMeter` — audio-seconds/s and token/s counters.

The JAX module's ``trace`` (an XPlane trace around a block) waits for
ROADMAP Queue 1, item 13; ``torch.profiler`` is its counterpart.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field

import torch

logger = logging.getLogger("whisper_burn_tpu_torch")


class StageTimer:
    """Accumulates wall-clock time per named stage.

    ``sync=True`` waits for ``device``'s queued work at the end of each
    stage when it is a CUDA device, so stage boundaries are honest
    (PyTorch's CUDA work is asynchronous).
    """

    def __init__(self, sync: bool = True, device: torch.device | str | None = None):
        self.sync = sync
        self.device = None if device is None else torch.device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            logger.debug("stage %s: %.1f ms", name, dt * 1e3)

    def report(self) -> str:
        lines = [
            f"{name}: {total * 1e3:.1f} ms total, "
            f"{total / self.counts[name] * 1e3:.1f} ms avg x{self.counts[name]}"
            for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@dataclass
class ThroughputMeter:
    """Audio-seconds/s and tokens/s over a measurement window."""

    audio_seconds: float = 0.0
    tokens: int = 0
    wall_seconds: float = 0.0
    _start: float | None = field(default=None, repr=False)

    def begin(self) -> None:
        self._start = time.perf_counter()

    def end(self, audio_seconds: float, tokens: int = 0) -> None:
        assert self._start is not None, "begin() not called"
        self.wall_seconds += time.perf_counter() - self._start
        self.audio_seconds += audio_seconds
        self.tokens += tokens
        self._start = None

    @property
    def audio_s_per_s(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.wall_seconds, 1e-9)
