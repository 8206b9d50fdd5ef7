"""Kernel I (``csrc/ffn.cu``), logged as ``(m, d, f, bias order)``: the
whole FFN, ``x [m, d]`` bf16 through fc1 (Q4 ``[d, f]``, f32 scales and
bias), GELU, fc2 (Q4 ``[f, d]``), out bf16; the hidden ``g`` never leaves
the chip in the ideal."""

POSITION = None


def bound(shape, pos, dims):
    m, d, f, _ = shape
    weights = 2 * d * f + (d // 32) * f * 4 + (f // 32) * d * 4 + f * 4 + d * 4
    return 2 * m * d * 2 + weights, 4.0 * m * d * f
