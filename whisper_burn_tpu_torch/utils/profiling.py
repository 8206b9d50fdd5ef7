"""Stage timers and throughput counters for the pipeline.

Copy of ``whisper_burn_tpu/utils/profiling.py`` for PyTorch:

* :class:`StageTimer` — named wall-clock stages, logged through the
  standard ``logging`` module; with ``sync=True`` on a CUDA device a stage
  ends with ``torch.cuda.synchronize()``, so its time covers the device
  work it queued;
* :class:`ThroughputMeter` — audio-seconds/s and token/s counters;
* :func:`trace` — ``torch.profiler`` around a block, written as a Chrome
  trace (viewable in Perfetto or ``chrome://tracing``), the counterpart of
  the JAX module's XPlane trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

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


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile everything inside the block with ``torch.profiler`` (host
    ranges, and the device's kernels, copies and fills by name where a
    CUDA device is present) and write it on exit as a Chrome trace,
    ``<log_dir>/trace-<pid>-<n>.json``. Yields the path it will write."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    n = sum(1 for _ in log_dir.glob(f"trace-{os.getpid()}-*.json"))
    path = log_dir / f"trace-{os.getpid()}-{n}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's device work ends inside the trace
    prof.export_chrome_trace(str(path))
