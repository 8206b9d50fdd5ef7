"""The model operations of the real requests in the traced batches (the
family's ``request_flops``, Whisper's in ``benchmark/flops.py``; padding
rows count for nothing) over the model steps' device walls (each
``decode_batch``'s device span) times the H100's dense bf16 peak
(``benchmark/chip.py``), in percent."""

from benchmark.chip import BF16_FLOP_PER_S


def read(record, ctx):
    t = record.get("trace")
    if not t or not t["step_s"]:
        return None
    return 100.0 * t["model_flops"] / (t["step_s"] * BF16_FLOP_PER_S)
