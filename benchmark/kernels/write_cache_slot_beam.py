"""Kernel F's beam form (``csrc/cache_slot.cu``), logged as ``(layers,
streams, ctx, row bytes...)``: each stream of the other buffer takes its
parent's rows below ``pos`` and the step's new row at ``pos``. Counted:
every row written, the new rows read, and the parents' rows read as if
one stream were every stream's parent (the least the gather can read)."""

POSITION = "step"  # one launch a step, all layers


def bound(shape, pos, dims):
    layers, streams, _, *row_bytes = shape
    per_row = sum(row_bytes)
    return layers * per_row * (streams * (pos + 1) + streams + pos), 0.0
