"""Not a metric: what the readers of the program's spans share
(``serving.queue_wait_ms``, ``serving.idle_pct``, ``step.encode_ms.serve``,
``loop.launch_ms``).

A run's record names the part whose spans they read as ``recorded``:
its start and end on ``time.perf_counter_ns``. The readers read no run
without it, and only spans that lie whole inside it, so work recorded
after the part (a server draining its queue) is left out."""


def spans(record: dict, *names):
    """The program's spans of these names that lie whole inside the
    record's ``recorded`` part, from its recorder's current recording;
    none where the record names no part or the program has no recorder."""
    part = record.get("recorded")
    if part is None:
        return []
    try:
        from whisper_burn_tpu_torch.utils import profiling

        rec = profiling.current_recording()
    except (ImportError, AttributeError):
        return []
    lo, hi = part
    return [s for s in rec.named(*names) if lo <= s.start_ns and s.end_ns <= hi] if rec is not None else []
