"""A second model family reaches the harness through new files alone: a
configuration that names ``"family": "toy"``, the family's module and a
workload of the harness's own offline traffic, in a directory of their
own (``toy_family/``, handed to the run as ``bench_dir``). The cell runs
whole on the CPU and comes out correct, and not correct when the toy's
program alters one served token."""

from pathlib import Path

from benchmark import faults, harness
from benchmark.run import run_cell

TOY = Path(__file__).resolve().parent / "toy_family"
SEED = 2**31 + 7117


def test_the_configuration_names_its_family():
    assert harness.load_config("toy", TOY)["family"] == "toy"
    for cfg in (harness.HERE / "configs").glob("*.json"):
        assert harness.load_config(cfg.stem)["family"] == "whisper"
    assert harness.family_module("whisper").__name__ == "benchmark.families.whisper"


def test_a_second_family_runs_from_new_files_only():
    out = run_cell("toy.offline", SEED, 0.2, False, "cpu", bench_dir=TOY)
    result = out["result"]
    assert out["ctx"].family.__file__ == str(TOY / "families" / "toy.py")
    assert result["correct"] and result["attempted"] > 0 and result["failed"] == 0, result
    assert 0 <= result["compared"]["max_logit_err"]["value"] < 1e-4
    assert set(result["metrics"]) == {"setup_s"}


def test_an_altered_token_of_the_second_family_is_not_correct():
    with faults.planted(harness.family_module("toy", TOY), "token"):
        out = run_cell("toy.offline", SEED, 0.2, False, "cpu", bench_dir=TOY)
    assert not out["result"]["correct"], out["result"]["compared"]
    assert out["result"]["compared"]["max_logit_err"]["value"] > 0.1
