"""The share of the serving worker's time in which it waits for a batch's
first request (``serving.wait``) or for its company (``serving.collect``),
in percent, over its whole cycles in the run's recorded part
(``program_spans``; a cycle runs from one ``serving.wait`` start to the
next on the same thread): the device idle that the batcher, not the
host's work, causes."""

from benchmark.metrics.program_spans import spans


def read(record, ctx):
    recorded = spans(record, "serving.wait", "serving.collect")
    idle = total = 0
    for thread in {s.thread for s in recorded}:
        mine = sorted((s for s in recorded if s.thread == thread), key=lambda s: s.start_ns)
        starts = [s.start_ns for s in mine if s.name == "serving.wait"]
        for a, b in zip(starts, starts[1:]):
            total += b - a
            idle += sum(s.end_ns - s.start_ns for s in mine if a <= s.start_ns < b)
    return 100.0 * idle / total if total else None
