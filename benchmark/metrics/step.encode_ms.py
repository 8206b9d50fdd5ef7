"""Device ms an utterance (a padded row) inside the program's
``*.encode`` and ``*.cross_fill`` ranges, over the traced batches."""


def read(record, ctx):
    t = record.get("trace")
    if not t or not t["rows"] or "encode" not in t["stage_ms"]:
        return None
    return (t["stage_ms"]["encode"] + t["stage_ms"].get("cross_fill", 0.0)) / t["rows"]
