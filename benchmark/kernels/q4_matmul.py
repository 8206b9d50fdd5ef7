"""Kernel A (``csrc/q4_matmul.cu``), logged as ``(m, k, n, epilogue)``:
``x [m, k]`` bf16 times Q4 codes (one int8 byte a weight) with f32 scales
a 32-row block, plus an f32 bias when the epilogue has one, out bf16, or
f32 for the int8 logits (``n`` the vocab padded to 512). Byte counts as
chip_smoke.py:478 (q4_rows)."""

POSITION = None


def bound(shape, pos, dims):
    m, k, n, epi = shape
    out_bytes = 4 if n == dims["logits_n"] else 2
    nbytes = m * k * 2 + k * n + (k // 32) * n * 4 + (n * 4 if epi else 0) + m * n * out_bytes
    return nbytes, 2.0 * m * k * n
