"""Spans and counters of the port's layers, and throughput counters.

Each layer boundary of the port (serving, pipeline, model step, decode
loop) runs inside a :class:`span`. The model step's spans open the
``torch.profiler.record_function`` ranges of their names, so a profiler
trace of the thread that started the profiler splits its time as before;
the others open none, and leave the trace's ranges as they were.

**The switch.** While ``ops/_build.LAUNCH_LOG`` is a list (the launch
log is on), every span is also kept in memory, from every thread, in the
current :class:`Recording`: its name, its thread, its start and end on
``time.perf_counter_ns``, the ids it was given (``request``, ``batch``,
and ``parent``, the batch a request's span belongs to) and the counters
added to it (:func:`count`). A span opened with ``device=True`` also
records a pair of CUDA timing events on the current stream; they are
resolved into ``device_ms`` by :func:`resolve` once the device has passed
them (the pipeline calls it after a batch's own read-back), never by a
synchronize of the recorder's. A new list in ``LAUNCH_LOG`` starts a new
recording; the last one stays readable (:func:`current_recording`) after
the log is turned off. With the log off a span costs its
``record_function``, if it has one, and one attribute check. :func:`record` turns the log
on for a block; so do ``transcribe --profile`` and ``transcribe --trace``.

**The clock.** A recording takes one anchor pair, ``time.time_ns()`` and
``time.perf_counter_ns()``, when it starts, and so gives each span on the
unix clock, which is the clock of ``torch.profiler``'s trace (an exported
trace's ``ts`` plus its ``baseTimeNanoseconds`` / 1000 is unix time in
µs). :func:`trace` writes the spans of every thread into the profiler's
Chrome trace, beside its own ranges.

* :class:`ThroughputMeter` — audio-seconds/s and token/s counters.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
from torch.profiler import record_function

from whisper_burn_tpu_torch.ops import _build

SPAN_CATEGORY = "program_span"  # the category of the recorder's spans in an exported trace


class Span:
    """One span of a recording. ``thread`` is the native thread id,
    ``start_ns`` / ``end_ns`` are on ``time.perf_counter_ns``, ``device_ms``
    is the device time between its events (None until resolved, or
    without ``device=True``)."""

    __slots__ = ("name", "thread", "start_ns", "end_ns", "ids", "counters", "device_ms", "events")

    def __init__(self, name: str, ids: dict, start_ns: int = 0, end_ns: int | None = None, thread: int | None = None):
        self.name, self.ids, self.counters = name, ids, {}
        self.thread = threading.get_native_id() if thread is None else thread
        self.start_ns, self.end_ns = start_ns, end_ns
        self.device_ms = None
        self.events = None  # (start, end) CUDA events until resolved

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recording:
    """The spans finished while one launch log was on, in the order they
    ended, with the anchor pair that puts them on the unix clock."""

    def __init__(self, log: list | None = None):
        self.log = log
        self.unix_ns, self.perf_ns = time.time_ns(), time.perf_counter_ns()
        self.spans: list[Span] = []
        self._pending: list[Span] = []  # spans whose device events are not resolved yet
        self._lock = threading.Lock()

    def add(self, s: Span) -> None:
        with self._lock:
            self.spans.append(s)
            if s.events is not None:
                self._pending.append(s)

    def to_unix_ns(self, perf_ns: int) -> int:
        return self.unix_ns + perf_ns - self.perf_ns

    def resolve(self) -> None:
        """``device_ms`` of each span whose end event the device has passed
        (``Event.query``, which does not wait)."""
        with self._lock:
            pending, self._pending = self._pending, []
            for s in pending:
                start, end = s.events
                if end.query():
                    s.device_ms, s.events = start.elapsed_time(end), None
                else:
                    self._pending.append(s)

    def named(self, *names: str) -> list[Span]:
        """The finished spans of these names, device times resolved where
        the device has passed them."""
        self.resolve()
        with self._lock:
            return [s for s in self.spans if s.name in names]


_RECORDING: Recording | None = None
_RECORDING_LOCK = threading.Lock()
_OPEN = threading.local()  # this thread's open spans, innermost last


def _active() -> Recording | None:
    """The recording of the launch log that is on, started at its first
    use; None while the log is off."""
    global _RECORDING
    log = _build.LAUNCH_LOG
    if log is None:
        return None
    rec = _RECORDING
    if rec is None or rec.log is not log:
        with _RECORDING_LOCK:
            if _RECORDING is None or _RECORDING.log is not log:
                _RECORDING = Recording(log)
            rec = _RECORDING
    return rec


def current_recording() -> Recording | None:
    """The recording of the launch log that is on, else the last one."""
    return _active() or _RECORDING


def _open_spans() -> list:
    spans = getattr(_OPEN, "spans", None)
    if spans is None:
        spans = _OPEN.spans = []
    return spans


class span:
    """``with span(name, device=False, **ids) as s``: the profiler range
    ``name`` around the block (unless ``profiler_range`` is false); while
    the launch log is on also a :class:`Span` of the current recording
    (``s``; None while it is off), with device events when ``device`` is
    true.

    Only the model step's stages open profiler ranges. The profiler links
    each kernel to the innermost range open at its launch, so a range
    nested inside another takes its kernels out of the outer range's
    device span (the benchmark's ``bench.decode_batch`` around
    ``decode_batch``, ``*.prefill`` around the language pass): the
    serving, pipeline and ``*.detect`` spans are the recorder's alone, and
    reach a trace through :func:`trace`."""

    __slots__ = ("_range", "_rec", "_span", "_device")

    def __init__(self, name: str, *, device: bool = False, profiler_range: bool = True, **ids):
        self._range = record_function(name) if profiler_range else None
        self._rec = _active() if _build.LAUNCH_LOG is not None else None
        self._span = Span(name, ids) if self._rec is not None else None
        self._device = device

    def __enter__(self) -> Span | None:
        s = self._span
        if s is not None:
            _open_spans().append(s)
            if self._device:
                s.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                s.events[0].record()
            s.start_ns = time.perf_counter_ns()  # before the range opens: spans in a row tile the time
        if self._range is not None:
            self._range.__enter__()
        return s

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
        s = self._span
        if s is not None:
            if s.events is not None:
                s.events[1].record()
            _open_spans().pop()
            s.end_ns = time.perf_counter_ns()
            self._rec.add(s)


def count(**counters: int) -> None:
    """Add ``counters`` to this thread's innermost open span (while the
    launch log is on)."""
    if _build.LAUNCH_LOG is None:
        return
    spans = _open_spans()
    if spans:
        c = spans[-1].counters
        for key, n in counters.items():
            c[key] = c.get(key, 0) + n


def add_span(name: str, start_ns: int, end_ns: int, **ids) -> None:
    """A span of this thread's whose start was stamped elsewhere (a
    request's time in the queue, from its submit): kept only if it started
    inside the recording."""
    rec = _active()
    if rec is not None and start_ns >= rec.perf_ns:
        rec.add(Span(name, ids, start_ns, end_ns))


def resolve() -> None:
    """Resolve the current recording's device events that the device has
    passed (call after a read-back of the work they bracket)."""
    rec = _RECORDING
    if rec is not None and rec._pending:
        rec.resolve()


@contextlib.contextmanager
def record():
    """The launch log on for the block, and so a new recording, unless it
    is on already (the block then joins that recording). Yields the
    recording."""
    if _build.LAUNCH_LOG is not None:
        yield _active()
        return
    log = _build.LAUNCH_LOG = []
    try:
        yield _active()
    finally:
        if _build.LAUNCH_LOG is log:
            _build.LAUNCH_LOG = None


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


def _chrome_events(rec: Recording, base_ns: int) -> list[dict]:
    """The recording's spans as Chrome trace complete events on a trace
    whose ``baseTimeNanoseconds`` is ``base_ns``: category
    ``program_span``, this process, each span's thread, its ids, counters
    and device ms as arguments."""
    pid, out = os.getpid(), []
    rec.resolve()
    for s in list(rec.spans):
        args = {**s.ids, **s.counters}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        out.append({"ph": "X", "cat": SPAN_CATEGORY, "name": s.name, "pid": pid, "tid": s.thread,
                    "ts": (rec.to_unix_ns(s.start_ns) - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile everything inside the block with ``torch.profiler`` (host
    ranges of this thread, and the device's kernels, copies and fills by
    name where a CUDA device is present) with the launch log on, and write
    it on exit as a Chrome trace, ``<log_dir>/trace-<pid>-<n>.json``
    (viewable in Perfetto or ``chrome://tracing``), with the recorder's
    spans of every thread as complete events of category ``program_span``
    on the trace's clock. Yields the path it will write."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    n = sum(1 for _ in log_dir.glob(f"trace-{os.getpid()}-*.json"))
    path = log_dir / f"trace-{os.getpid()}-{n}.json"
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with record() as rec, profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the block's device work ends inside the trace
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    data["traceEvents"] += _chrome_events(rec, int(data.get("baseTimeNanoseconds", 0)))
    path.write_text(json.dumps(data))
