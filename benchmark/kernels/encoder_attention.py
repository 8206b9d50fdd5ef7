"""Kernel D (``csrc/encoder_attention.cu``), logged as ``(b, t, d)``:
the encoder's self-attention over the 1500 real frames of a 1536-row
block, q, k, v and out bf16. Operations count the 1500 x 1500 real
scores and value products only."""

POSITION = None


def bound(shape, pos, dims):
    b, _, d = shape
    valid = dims["audio_ctx"]
    return 4 * b * valid * d * 2, 4.0 * b * valid * valid * d
