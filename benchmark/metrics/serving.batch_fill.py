"""Real requests a batch over the window: the deltas of the
transcriber's own counters (``ServingStats.batched_requests`` over
``batches``) between the window's start and close."""


def read(record, ctx):
    return record["batched_requests"] / record["batches"] if record.get("batches") else None
