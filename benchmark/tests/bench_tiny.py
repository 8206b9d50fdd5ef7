"""Runs of the benchmark's cells at ``WhisperConfig.tiny_test()`` sizes on
the CPU, for the benchmark's own tests."""

from __future__ import annotations

import copy

from benchmark import harness, model_config
from benchmark.run import run_cell


# the check's limits at tiny sizes, from the readings there (seed 2**31 + 901): the program's widest
# log-probability gap 0.0047-0.0054 and mean 0.0012-0.0023, its widest beam score gap 0.0038; the
# beam's wrong-parent fault 0.077, Large-V3's int4-logits control 0.038 / 0.030 (beam 0.072)
TINY_LIMITS = {"max_logit_err": 0.02, "mean_logit_err": 0.01, "max_score_err": 0.01, "max_lang_err": 0.002}


def tiny_workload(name: str) -> dict:
    """Cell ``name``'s workload cut to what a CPU test holds: 8 tokens,
    batches of 2, clips of a second, and the check's limits set from the
    tiny model's own readings."""
    w = copy.deepcopy(harness.load_workload(name))
    w["correct_limits"] = {k: v for k, v in TINY_LIMITS.items() if k in w["correct_limits"]}
    t = w["traffic"]
    t.update(max_tokens=8)
    if t["kind"] == "offline_batches":
        t.update(batch=2, pool=4, clip_seconds=1)
    else:
        t.update(rate=6.0, batch=2, pool=6, clip_seconds=[0.5, 1.5])
    return w


def tiny_run(name: str, seed: int, seconds: float = 1.0, control: bool = False) -> dict:
    return run_cell(name, seed, seconds, False, "cpu", workload=tiny_workload(name),
                    shape=model_config.tiny_shape(), control=control)
