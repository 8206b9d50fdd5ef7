"""Kernel C' (``csrc/decode_attention.cu``), logged as ``(b, t, d, groups,
element bytes)``: one bf16 query a stream over the int8 (or float) cross
cache, the 1500 real keys and values read once, f32 out."""

POSITION = None


def bound(shape, pos, dims):
    b, _, d, groups, elem = shape
    entries, valid = b // groups, dims["audio_ctx"]
    nbytes = b * d * 2 + 2 * entries * d * valid * elem + b * d * 4
    return nbytes, 4.0 * b * valid * d
