"""The share of the traced window in which no kernel, copy or fill runs
on the device, in percent."""


def read(record, ctx):
    t = record.get("trace")
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
