"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, CPU tensors
take the plain versions without launching a kernel, and the cache modes
allocate as the JAX package's do."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from whisper_burn_tpu_torch import entry as entry_module
from whisper_burn_tpu_torch.entry import entry
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


SCRIPT_NAMES = ("request_walls", "cross_attention_times", "self_attention_times", "q4_matmul_times",
                "encoder_attention_times", "ffn_times", "ffn_phases", "ffn_variants", "cache_slot_times",
                "accuracy_sweep", "hf_realdims_parity", "native_host_times")
SCRIPTS = [ROOT / "chip_smoke.py", *(ROOT / "scripts" / f"torch_{n}.py" for n in SCRIPT_NAMES)]


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


def test_transformers_imported_inside_functions_only():
    """The card's machine has no ``transformers``: no module of the port
    imports it at module level (eval/hf_oracle.py imports it inside its
    functions), so every module imports there."""
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.parse(path.read_text()).body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            assert all(n.split(".")[0] != "transformers" for n in names), (path, names)
    oracle = ast.parse((PACKAGE / "eval" / "hf_oracle.py").read_text())
    inner = [n for f in oracle.body if isinstance(f, ast.FunctionDef) for n in ast.walk(f)
             if isinstance(n, ast.Import) and any(a.name == "transformers" for a in n.names)]
    assert inner, "hf_oracle imports transformers in its functions"


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


@pytest.mark.parametrize("kw, item", [({"tp": 2}, "process group")])
def test_modes_outside_the_slice_raise(kw, item):
    """Tensor parallelism needs the model ranks' group (parallel/sharded.tp_compute)."""
    with pytest.raises(ValueError, match=item):
        Compute.fastest(kv_bits=4).replace(**kw)


@pytest.mark.parametrize("kw, keys, values", [
    ({"self_kv_bits": 4}, torch.uint8, torch.uint8),
    ({"self_kv_vbits": 4}, torch.int8, torch.uint8),
    ({"self_kv_bits": 4, "self_kv_vbits": 4}, torch.uint8, torch.uint8),
])
def test_int4_self_modes_construct(kw, keys, values):
    """The int4 self-KV modes construct, with the JAX package's storage dtypes."""
    compute = Compute.fastest(kv_bits=4).replace(**kw)
    assert (compute.self_kv_storage_dtype, compute.self_v_storage_dtype) == (keys, values)
    assert compute.self_v_packed and compute.self_kv_packed == (keys == torch.uint8)


def test_int4_keys_with_int8_values_raise():
    with pytest.raises(ValueError, match="self_kv_vbits"):
        Compute.fastest(kv_bits=4).replace(self_kv_bits=4, self_kv_vbits=8)


@pytest.mark.parametrize("compute, cross, self_kv, lanes", [
    (Compute.fast(), torch.bfloat16, (torch.bfloat16, torch.bfloat16), 0),
    (Compute.fastest(), torch.int8, (torch.int8, torch.int8), 2),
    (Compute.fastest(kv_bits=4), torch.uint8, (torch.int8, torch.int8), 2),
    (Compute.fastest(kv_bits=4).replace(self_kv_bits=4), torch.uint8, (torch.uint8, torch.uint8), 4),
    (Compute.fastest(kv_bits=4).replace(self_kv_vbits=4), torch.uint8, (torch.int8, torch.uint8), 3),
], ids=["fast", "fastest", "fastest-kv4", "int4self", "mixed"])
def test_init_cache_allocates_each_mode(compute, cross, self_kv, lanes):
    """Cross keys transposed [L, B, D, T] (int4: D/2 packed), values
    [L, B, T, D] (int4: T/2); self K/V [L, B, ctx, D] (int4: D/2 packed);
    scales only for quantized caches, a self side's lanes 1 (int8) or its
    groups (int4: 2 at D = 64)."""
    cfg = WhisperConfig.tiny_test()
    l, d, t = cfg.n_text_layer, cfg.n_text_state, 16  # n_audio_ctx 12, 8-aligned
    cache = init_cache(cfg, 2, compute, 64, "cpu")
    packed = cross == torch.uint8
    assert (cache.cross_k.dtype, cache.cross_v.dtype) == (cross, cross)
    assert cache.cross_k.shape == (l, 2, d // 2 if packed else d, t)
    assert cache.cross_v.shape == (l, 2, t // 2 if packed else t, d)
    assert (cache.self_k.dtype, cache.self_v.dtype) == self_kv
    width = lambda dt: d // 2 if dt == torch.uint8 else d
    assert cache.self_k.shape == (l, 2, 64, width(self_kv[0]))
    assert cache.self_v.shape == (l, 2, 64, width(self_kv[1]))
    quantized = cross != torch.bfloat16
    for scale in (cache.cross_k_scale, cache.cross_v_scale):
        assert (scale is not None) == quantized
        assert scale is None or (scale.shape, scale.dtype) == ((l, d), torch.float32)
    if lanes:
        assert (cache.self_kv_scale.shape, cache.self_kv_scale.dtype) == ((l, 2, 64, lanes), torch.float32)
    else:
        assert cache.self_kv_scale is None


def test_entry_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_entry_mel_is_the_seeded_draw(monkeypatch):
    """entry(device="cpu") feeds numpy's default_rng(0) standard normal mel
    [1, 128, 3000] and one Large-V3 language token; the Large-V3 weights are
    swapped for the tiny config's here (fabricating them takes the host
    minutes)."""
    tiny = fabricated_quantized_params
    monkeypatch.setattr(entry_module, "fabricated_quantized_params",
                        lambda cfg, seed, device: tiny(WhisperConfig.tiny_test(), seed, device=device))
    fn, (params, mel, lang) = entry(device="cpu")
    assert callable(fn) and mel.device.type == "cpu" and mel.dtype == torch.float32
    ref = np.random.default_rng(0).standard_normal((1, 128, 3000)).astype(np.float32)  # as __graft_entry__ casts it
    np.testing.assert_array_equal(mel.numpy(), ref)
    assert lang.tolist() == [WhisperConfig.large_v3().lang_token_start]
    assert params["decoder"]["tok_emb"].dtype == torch.bfloat16 and "attn_qkv" in params["decoder"]["blocks"]


def test_beam_groups_raise():
    """batch_groups must split the self cache's streams into the cross
    cache's utterances."""
    cfg = WhisperConfig.tiny_test()
    compute = Compute.fastest(kv_bits=4)
    cache = init_cache(cfg, 2, compute, 64, "cpu")
    for groups in (0, 2):  # 2 streams on 2 utterances: groups of 1 only
        with pytest.raises(ValueError, match="batch_groups"):
            decode_step({}, cfg, torch.zeros(2, dtype=torch.long), torch.tensor(4, dtype=torch.int32), cache, compute,
                        batch_groups=groups)
