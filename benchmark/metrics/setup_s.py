"""From the process's start to the first timed request: interpreter,
imports, the kernels' build or load, the weights, the pipeline and its
tables, the warm-up batch and its graph capture."""


def read(record, ctx):
    return ctx.setup_s
