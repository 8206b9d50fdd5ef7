"""Host ms of a replayed decode step's launch in the run's recorded
part (``program_spans``): the host ns the program's decode loop spent in
``graph.replay()``, over the replays, both counted on the model step's
``<entry>.decode`` spans (the family's ``entry``: Whisper's
``greedy_decode`` or ``beam_decode``; ``GraphRunner._step``)."""

from benchmark.metrics.program_spans import spans


def read(record, ctx):
    loops = spans(record, f"{ctx.family.entry(ctx.params['beam_width'])}.decode")
    replays = sum(s.counters.get("replays", 0) for s in loops)
    return sum(s.counters.get("launch_ns", 0) for s in loops) / replays / 1e6 if replays else None
