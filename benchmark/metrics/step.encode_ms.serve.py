"""Device ms an utterance (a padded row) in the serving worker's batches
of the run's recorded part (``program_spans``): the device time between
the program's events of each ``greedy_decode.encode`` span and the
``greedy_decode.cross_fill`` span after it, on the threads that ran
``serving.wait``, over the rows the encode spans counted."""

from benchmark.metrics.program_spans import spans


def read(record, ctx):
    recorded = spans(record, "serving.wait", "greedy_decode.encode", "greedy_decode.cross_fill")
    workers = {s.thread for s in recorded if s.name == "serving.wait"}
    ms = rows = 0
    for enc in (s for s in recorded if s.name == "greedy_decode.encode" and s.thread in workers):
        fill = min((s for s in recorded if s.name == "greedy_decode.cross_fill" and s.thread == enc.thread
                    and s.start_ns >= enc.end_ns), key=lambda s: s.start_ns, default=None)
        if enc.device_ms is not None and fill is not None and fill.device_ms is not None:
            ms += enc.device_ms + fill.device_ms
            rows += enc.counters.get("rows", 0)
    return ms / rows if rows else None
