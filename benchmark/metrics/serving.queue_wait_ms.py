"""Mean ms a request waited in the serving queue in the run's recorded
part (``program_spans``): the program's ``serving.queued`` spans, each
from the request's submit to its batch's closing (``serving.py``), of
the requests submitted and batched inside the part."""

from benchmark.metrics.program_spans import spans


def read(record, ctx):
    queued = spans(record, "serving.queued")
    return sum(s.end_ns - s.start_ns for s in queued) / len(queued) / 1e6 if queued else None
