"""Kernel E (``csrc/decode_attention.cu``), logged as ``(streams, ctx,
d)``: beam search's self-attention, one query a stream over the int8
cache rows below ``pos`` and their scales, out the unnormalized f32
accumulator and its max and sum a head. As chip_smoke.py:360-365
(``layer_attention_bound``), at the step's own position."""

POSITION = "layer"


def bound(shape, pos, dims):
    b, _, d = shape
    nbytes = b * (d * 2 + 2 * pos * d + pos * 8 + d * 4 + 2 * dims["heads"] * 4)
    return nbytes, 4.0 * b * pos * d
