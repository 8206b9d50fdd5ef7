"""Kernel B (``csrc/decode_attention.cu``), logged as ``(b, ctx, d)``: one
query a stream over the int8 self cache below ``pos`` with its f32
scales, the step's raw k/v (bf16), their int8 codes and scales stored at
``pos``, f32 out. Bytes and operations as chip_smoke.py:352-357
(``self_attention_bound``), at the step's own position."""

POSITION = "layer"  # one launch a layer a step


def bound(shape, pos, dims):
    b, _, d = shape
    nbytes = b * (d * 2 + 2 * pos * d + pos * 8 + 2 * d * 2 + 2 * d + 8 + d * 4 + 2 * d + 8)
    return nbytes, 4.0 * b * (pos + 1) * d
