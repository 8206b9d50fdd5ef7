"""Kernel F's slot form (``csrc/cache_slot.cu``), logged as ``(layers,
streams, ctx, row bytes...)``: the step's new row of every stream and
layer read once and written at ``pos``."""

POSITION = None


def bound(shape, pos, dims):
    layers, streams, _, *row_bytes = shape
    return 2 * layers * streams * sum(row_bytes), 0.0
