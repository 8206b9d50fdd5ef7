"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, and CPU tensors
take the plain versions without launching a kernel."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.decoder import decode_step, init_cache
from whisper_burn_tpu_torch.models.params import (
    device_fabricated_params,
    fabricated_quantized_params,
    params_to_torch,
)
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute, resolve_device
from whisper_burn_tpu_torch.ops.q4_kernel import q4_matmul

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "whisper_burn_tpu_torch"


def test_package_imports_no_jax():
    """In a fresh interpreter, import every module of the port."""
    code = (
        "import importlib, pkgutil, sys, whisper_burn_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'whisper_burn_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'whisper_burn_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SCRIPTS = [ROOT / "chip_smoke.py", *(ROOT / "scripts" / f"torch_{n}.py" for n in ("request_walls", "cross_attention_times"))]


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in [*PACKAGE.rglob("*.py"), *SCRIPTS]))
def test_sources_import_no_jax(path):
    """Every import statement of the port and of its scripts, read with ast."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "whisper_burn_tpu"), (path, name)


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = WhisperConfig.tiny_test()
    for call in (
        lambda: resolve_device(None),
        lambda: fabricated_quantized_params(cfg, seed=0),
        lambda: device_fabricated_params(cfg, seed=0),
        lambda: params_to_torch({"x": __import__("numpy").zeros(2)}),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_cpu_tensors_take_plain_version_without_launch():
    _build.reset_launches()
    x = torch.randn(2, 64)
    qw = torch.randint(-8, 8, (64, 32), dtype=torch.int8)
    y = q4_matmul(x, qw, torch.full((2, 32), 0.01))
    assert y.shape == (2, 32)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize(
    "kw, item",
    [({"self_kv_bits": 4}, "K11"), ({"self_kv_vbits": 4}, "K11"), ({"tp": 2}, "item 15")],
)
def test_modes_outside_the_slice_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Compute.fastest(kv_bits=4).replace(**kw)


@pytest.mark.parametrize("compute, item", [(Compute.fastest(), "K3"), (Compute.fast(), "K3"), (Compute.fastest(kv_bits=4).replace(self_kv_dtype=None), "K8")])
def test_cache_modes_outside_the_slice_raise(compute, item):
    with pytest.raises(NotImplementedError, match=item):
        init_cache(WhisperConfig.tiny_test(), 1, compute, 64, "cpu")


def test_beam_groups_raise():
    """batch_groups must split the self cache's streams into the cross
    cache's utterances."""
    cfg = WhisperConfig.tiny_test()
    compute = Compute.fastest(kv_bits=4)
    cache = init_cache(cfg, 2, compute, 64, "cpu")
    for groups in (0, 2):  # 2 streams on 2 utterances: groups of 1 only
        with pytest.raises(ValueError, match="batch_groups"):
            decode_step({}, cfg, torch.zeros(2, dtype=torch.long), 4, cache, compute, batch_groups=groups)
