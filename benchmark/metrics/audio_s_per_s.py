"""Real (unpadded) audio seconds of every request completed in the
window, over the window's seconds: all the work over all the time."""


def read(record, ctx):
    return record["audio_s"] / record["window_s"]
