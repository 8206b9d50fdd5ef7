"""The hand-written kernels' share of their roofline in the traced
batches: the sum of each launch's bound (the larger of its bytes over
3.35 TB/s and its operations over 989 TFLOP/s, ``benchmark/kernels/``)
over the sum of the launches' device time, in percent."""


def read(record, ctx):
    t = record.get("trace")
    if not t or not t["roofline"]["time_s"]:
        return None
    return 100.0 * t["roofline"]["bound_s"] / t["roofline"]["time_s"]
