"""The four cells read, at tiny sizes on the CPU, exactly what the harness
read before it reached Whisper through ``families/``: the numbers the
check compares, the whole of the reference's readings, the requests
attempted and the served token and language ids, bit for bit.

The constants were recorded from the harness as it stood before that
change, at ``bench_tiny.tiny_workload`` sizes and one seed, with two
changes that make a run's work independent of the host's speed: the
offline cells read a clock that moves 0.25 s a reading (so their window
holds three batches whatever the CPU), and the open loop's batcher waits
a minute for a batch's second request (so its batches are the same pairs
of requests). A torch build whose CPU kernels sum in another order reads
other last digits: record them again from the commit before a harness
change, never after it.
"""

import pytest

from benchmark import model_config
from benchmark.run import run_cell
from benchmark.tests.bench_tiny import tiny_workload
from benchmark.traffic import offline_batches

SEED = 2**31 + 2023
EN, DETECTED = 50259, 50323

PARENT = {
    "large-v3.offline-greedy": {
        "compared": {"max_logit_err": 0.013160943984985352, "mean_logit_err": 0.006261429438988368},
        "readings": {"requests_judged": 6, "flipped": 0, "max_lp_err": 0.013159017354785973,
                     "mean_lp_err": 0.006260434064480329, "max_logit_err": 0.013160943984985352,
                     "mean_logit_err": 0.006261429438988368, "max_margin_err": 0.008886992931365967,
                     "mean_margin_err": 0.0052748676389455795, "max_lang_err": None, "max_score_err": None,
                     "mean_score_err": None, "tokens_judged": 48},
        "tokens": [[45] * 8] * 6, "langs": [EN] * 6,
    },
    "turbo.serve-poisson": {
        "compared": {"max_logit_err": 0.007323145866394043, "mean_logit_err": 0.0031668953597545624,
                     "max_lang_err": 0.00012105069597900808},
        "readings": {"requests_judged": 6, "flipped": 0, "max_lp_err": 0.007322290396700737,
                     "mean_lp_err": 0.0031672204366374394, "max_logit_err": 0.007323145866394043,
                     "mean_logit_err": 0.0031668953597545624, "max_margin_err": 0.009676694869995117,
                     "mean_margin_err": 0.003838459374728026, "max_lang_err": 0.00012105069597900808,
                     "max_score_err": None, "mean_score_err": None, "tokens_judged": 54},
        "tokens": [[45] * 8] * 6, "langs": [DETECTED] * 6,
    },
    "large-v3.offline-beam5": {
        "compared": {"max_score_err": 0.006232501132284796},
        "readings": {"requests_judged": 6, "flipped": 6, "max_lp_err": None, "mean_lp_err": None,
                     "max_logit_err": None, "mean_logit_err": None, "max_margin_err": None,
                     "mean_margin_err": None, "max_lang_err": None, "max_score_err": 0.006232501132284796,
                     "mean_score_err": 0.004055464660670675, "tokens_judged": 0},
        "tokens": [[36] * 8] * 6, "langs": [EN] * 6,
    },
    "turbo.offline-greedy": {
        "compared": {"max_logit_err": 0.005403280258178711, "mean_logit_err": 0.0028744935989379883},
        "readings": {"requests_judged": 6, "flipped": 0, "max_lp_err": 0.005402893658418506,
                     "mean_lp_err": 0.0028741569046180824, "max_logit_err": 0.005403280258178711,
                     "mean_logit_err": 0.0028744935989379883, "max_margin_err": 0.009605824947357178,
                     "mean_margin_err": 0.0035570599138736725, "max_lang_err": None, "max_score_err": None,
                     "mean_score_err": None, "tokens_judged": 48},
        "tokens": [[45] * 8] * 6, "langs": [EN] * 6,
    },
}


class SteppedClock:
    """``time`` for the offline traffic: each reading 0.25 s on."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 0.25
        return self.now


@pytest.mark.parametrize("cell", list(PARENT))
def test_the_readings_are_the_parents(cell, monkeypatch):
    workload = tiny_workload(cell)
    if workload["traffic"]["kind"] == "offline_batches":
        monkeypatch.setattr(offline_batches, "time", SteppedClock())
    else:
        workload["traffic"]["max_wait_ms"] = 60_000.0
    out = run_cell(cell, SEED, 1.0, False, "cpu", workload=workload, shape=model_config.tiny_shape())
    result, want = out["result"], PARENT[cell]
    assert result["correct"] and result["attempted"] == 6 and result["failed"] == 0
    assert {k: c["value"] for k, c in result["compared"].items()} == want["compared"]
    assert out["readings"] == want["readings"]
    assert [s.tokens for s in out["record"]["served"]] == want["tokens"]
    assert [s.lang_token for s in out["record"]["served"]] == want["langs"]
