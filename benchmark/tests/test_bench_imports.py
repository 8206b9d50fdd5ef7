"""What a run and what the reference import, each in a fresh interpreter,
compared by whole top-level module names: ``jax``, ``jaxlib``, ``flax``
and the JAX package ``whisper_burn_tpu`` nowhere, and nothing of the port
``whisper_burn_tpu_torch`` in the reference. The harness's generic parts
import nothing of Whisper, in their sources or when loaded: only
``families/`` binds a model."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

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


# the harness's generic parts: they reach a model only through its family (``families/``)
BENCH = ROOT / "benchmark"
GENERIC = sorted([BENCH / "run.py", BENCH / "harness.py", BENCH / "trace.py", BENCH / "program_trace.py",
                  BENCH / "calibrate.py", BENCH / "faults.py", BENCH / "chip.py",
                  *(BENCH / "traffic").glob("*.py"), *(BENCH / "metrics").glob("*.py")])
WHISPER_SIDE = ("benchmark.reference", "benchmark.weights", "benchmark.observe", "benchmark.model_config",
                "benchmark.flops", "benchmark.families", "whisper_burn_tpu_torch.models",
                "whisper_burn_tpu_torch.transcribe")


def imported_names(path: Path) -> set[str]:
    """Every module a file imports, anywhere in it, as dotted names (``from
    a import b`` gives ``a`` and ``a.b``), each name it imports, and each
    name and attribute its code uses."""
    import ast

    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names} | {a.name for a in node.names}
        elif isinstance(node, (ast.Name, ast.Attribute)):
            names.add(node.id if isinstance(node, ast.Name) else node.attr)
    return names


def whisper_side(name: str) -> bool:
    return name == "WhisperPipeline" or any(name == w or name.startswith(w + ".") for w in WHISPER_SIDE)


@pytest.mark.parametrize("path", GENERIC, ids=lambda p: str(p.relative_to(BENCH)))
def test_a_generic_part_imports_nothing_of_whisper(path):
    found = sorted(n for n in imported_names(path) if whisper_side(n))
    assert not found, f"{path.relative_to(BENCH)} imports {found}: reach the model through its family"


def test_loading_the_generic_parts_loads_nothing_of_whisper():
    modules = [f"benchmark.{p.relative_to(BENCH).with_suffix('').as_posix().replace('/', '.')}" for p in GENERIC
               if p.parent.name != "metrics"]
    code = (f"import importlib, json, sys\nfor m in {modules!r}: importlib.import_module(m)\n"
            "from benchmark import harness\n"
            "for p in (harness.HERE / 'metrics').glob('*.py'): harness.metric_module(p.stem)\n"
            "print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert not [n for n in loaded if whisper_side(n)]


def test_the_toy_family_imports_nothing_of_whisper_or_the_port():
    toy = Path(__file__).resolve().parent / "toy_family" / "families" / "toy.py"
    assert not [n for n in imported_names(toy) if n.split(".")[0] in {"benchmark", "whisper_burn_tpu_torch"}]


SHAPE_FIELDS = {"decoder_layers", "encoder_layers", "heads", "d_model", "n_mels", "n_audio_ctx", "n_text_ctx",
                "n_vocab", "n_lang", "PROMPT_LEN"}  # Whisper's shapes (``model_config.ModelShape``) and prompt
SPAN_PREFIXES = ("greedy_decode", "beam_decode")  # Whisper's model step, which the family's ``entry`` names


def whisper_words(path: Path) -> set[str]:
    """The Whisper shape fields a file's code reads as names or attributes,
    and the Whisper span names its strings hold outside docstrings."""
    import ast

    tree, found = ast.parse(path.read_text()), set()
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id in SHAPE_FIELDS:
            found.add(node.id)
        elif isinstance(node, ast.Attribute) and node.attr in SHAPE_FIELDS:
            found.add(node.attr)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            found |= {p for p in SPAN_PREFIXES if p in node.value}
    return found


@pytest.mark.parametrize("path", GENERIC + sorted((BENCH / "kernels").glob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_a_generic_part_reads_no_whisper_shape_or_span(path):
    """The kernels' bounds read the family's ``kernel_dims``, the roofline
    its ``positions``, and the span readers its ``entry``."""
    found = sorted(whisper_words(path))
    assert not found, f"{path.relative_to(BENCH)} reads {found}: take them from the family"
