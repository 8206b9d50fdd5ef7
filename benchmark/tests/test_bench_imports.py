"""What a run and what the reference import, each in a fresh interpreter,
compared by whole top-level module names: ``jax``, ``jaxlib``, ``flax``
and the JAX package ``whisper_burn_tpu`` nowhere, and nothing of the port
``whisper_burn_tpu_torch`` in the reference."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
JAX_SIDE = {"jax", "jaxlib", "flax", "whisper_burn_tpu"}
RUN = ["benchmark.run", "benchmark.harness", "benchmark.program_trace", "benchmark.trace", "benchmark.calibrate",
       "benchmark.observe", "benchmark.faults",
       "benchmark.traffic.offline_batches", "benchmark.traffic.open_loop_poisson",
       # what run_cell loads of the port on its way through a cell
       "whisper_burn_tpu_torch.transcribe", "whisper_burn_tpu_torch.serving", "whisper_burn_tpu_torch.ops._build",
       "whisper_burn_tpu_torch.audio.io"]
REFERENCE = ["benchmark.reference", "benchmark.weights", "benchmark.model_config", "benchmark.flops", "benchmark.audio"]


def top_level_after(modules: list[str]) -> set[str]:
    code = (f"import importlib, json, sys\nfor m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_imports_nothing_of_jax():
    loaded = top_level_after(RUN)
    assert "whisper_burn_tpu_torch" in loaded and not loaded & JAX_SIDE


def test_the_reference_imports_neither_jax_nor_the_port():
    loaded = top_level_after(REFERENCE)
    assert not loaded & (JAX_SIDE | {"whisper_burn_tpu_torch"})


def test_the_check_compares_whole_top_level_names():
    from benchmark import harness

    assert harness.forbidden_modules(["whisper_burn_tpu_torch.ops._build", "jax_fake", "numpy"]) == []
    assert harness.forbidden_modules(["whisper_burn_tpu.models", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "whisper_burn_tpu"]
