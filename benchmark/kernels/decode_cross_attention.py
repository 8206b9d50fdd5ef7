"""Kernel C (``csrc/decode_attention.cu``), logged as ``(b, t, d, groups)``:
one bf16 query a stream over the int4 cross cache (keys packed along D,
values along T; ``groups`` streams share an entry), the 1500 real keys
read once, f32 out."""

POSITION = None


def bound(shape, pos, dims):
    b, _, d, groups = shape
    entries, valid = b // groups, dims["audio_ctx"]
    nbytes = b * d * 2 + entries * (d // 2) * valid + entries * (valid // 2) * d + b * d * 4
    return nbytes, 4.0 * b * valid * d
