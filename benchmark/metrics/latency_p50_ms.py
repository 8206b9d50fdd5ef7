"""The median (nearest rank) of result time minus due time over every
request due in the window; a failed or refused request is infinitely
late."""

import math

from benchmark.harness import percentile


def read(record, ctx):
    value = percentile(record["latencies_ms"], 0.50)
    return value if math.isfinite(value) else None
