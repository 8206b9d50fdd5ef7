"""Device ms a decode step: the program's ``*.decode`` ranges (the
replayed graphs of the greedy or beam loop) over the steps they ran,
summed over the traced batches."""


def read(record, ctx):
    t = record.get("trace")
    if not t or not t["decode_steps"] or "decode" not in t["stage_ms"]:
        return None
    return t["stage_ms"]["decode"] / t["decode_steps"]
