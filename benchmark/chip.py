"""The chip's peaks that the readers divide by: one NVIDIA H100 SXM at its
700 W limit, dense rates without sparsity (NVIDIA's data sheet; the same
values as ``chip_smoke.py:232-233``). Imports nothing."""

BF16_FLOP_PER_S = 989e12  # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
