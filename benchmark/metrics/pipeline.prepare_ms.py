"""Host ms of ``WhisperPipeline.prepare_batch`` a batch (resampling,
padding, the language check), timed by the benchmark's own wrapper
around the pipeline instance's method, over the batches that started in
the window."""


def read(record, ctx):
    ms = record.get("prepare_ms")
    return sum(ms) / len(ms) if ms else None
