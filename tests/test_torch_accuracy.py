"""The port's accuracy tooling against the JAX package's, on the CPU, at
``tiny_test()`` sizes (``n_audio_ctx`` 16, ``n_text_ctx`` 64, 24 steps, 4
streams), and the committed card sweep against the floors.

* ``models/params.structured_params`` is the JAX fixture bit for bit; the
  device quantizer (``gguf/repack.repack_f32_tensor``) is ``repack_f32``
  bit for bit, so the Q4 member of a matched pair made from its f32
  member (``quantize_linears``) is the numpy fixture's Q4 member.
* ``eval/quant_accuracy.forced_logits`` against the JAX one in f32: the
  parity reference and every serving variant with its caches, at 1e-4 of
  max|logit|. The JAX side runs the quantized self caches through its
  Pallas kernels in interpret mode: the port's decode step follows their
  merge of the raw current key (the JAX XLA step attends over its
  quantized row).
* ``reference_run``'s tokens and ``compare_variant``'s numbers against
  the JAX ones on the same inputs; the small floors of
  ``tests/test_accuracy.py`` in the port's own variants (bf16, the plain
  versions), and the peaked fixture's weight row.
* The floors are the JAX test's, and ``ACCURACY_TORCH.json`` (the card
  sweep, ``scripts/torch_accuracy_sweep.py``) meets them.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.eval.quant_accuracy import compare_variant as j_compare_variant
from whisper_burn_tpu.eval.quant_accuracy import forced_logits as j_forced_logits
from whisper_burn_tpu.eval.quant_accuracy import reference_run as j_reference_run
from whisper_burn_tpu.gguf.repack import repack_f32 as j_repack_f32
from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.params import attach_w8a8 as j_attach_w8a8
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.models.params import structured_params as j_structured_params
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.transcribe import quantize_logit_embedding as j_quantize_logit_embedding

from whisper_burn_tpu_torch.eval import quant_accuracy as qa
from whisper_burn_tpu_torch.gguf.repack import repack_f32_tensor
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import (
    device_random_params,
    quantize_linears,
    random_params,
    structured_params,
)
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import prepare_params

ACCURACY_TORCH = Path(__file__).resolve().parents[1] / "ACCURACY_TORCH.json"
JAX_FLOORS_TEST = Path(__file__).resolve().parent / "test_accuracy.py"
SMALL = dict(n_audio_ctx=16, n_text_ctx=64)  # n_text_ctx covers PROMPT_LEN + STEPS
JCFG, CFG = JConfig.tiny_test().replace(**SMALL), WhisperConfig.tiny_test().replace(**SMALL)
STEPS, BATCH = 24, 4
_F32 = dict(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS)
_J4 = JCompute.fastest(kv_bits=4)
# each serving variant in f32 compute on both sides (as the mode tests
# hold them): JAX compute, port compute
F32_VARIANTS = {
    "q4_int8kv": (JCompute.fastest(kv_bits=8), qa.VARIANTS["q4_int8kv"]),
    "q4_int4kv": (_J4, qa.VARIANTS["q4_int4kv"]),
    "q4_int4kv_q8log": (_J4.replace(quantized_logits=True), qa.VARIANTS["q4_int4kv_q8log"]),
    "q4_w8a8": (_J4.replace(w8a8=True), qa.VARIANTS["q4_w8a8"]),
    "q4_int4selfkv": (_J4.replace(self_kv_bits=4), qa.VARIANTS["q4_int4selfkv"]),
    "q4_selfv4": (_J4.replace(self_kv_vbits=4), qa.VARIANTS["q4_selfv4"]),
}
LOGIT_REL = 1e-4  # of max|logit|


def _inputs(seed: int):
    """``tests/test_accuracy.py``'s mel and language draws."""
    rng = np.random.default_rng(100 + seed)
    mel = rng.standard_normal((BATCH, CFG.n_mels, CFG.n_audio_ctx * 2)).astype(np.float32)
    langs = rng.integers(CFG.lang_token_start, CFG.lang_token_end, size=BATCH).astype(np.int32)
    return mel, langs


def _jax_params(params: dict, compute) -> dict:
    """The side tables a JAX variant's flags need."""
    if compute.w8a8:
        params = j_attach_w8a8(params)
    if compute.quantized_logits:
        dec = params["decoder"]
        params = {**params, "decoder": {**dec, "tok_emb_q": j_quantize_logit_embedding(dec["tok_emb"])}}
    return params


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted.
    The port runs on one CPU thread: its ops here are small, and the
    tests' parallel workers would otherwise oversubscribe the host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _build.reset_launches()
    try:
        yield
        assert sum(_build.LAUNCHES.values()) == 0
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference():
    """Seed 0's Q4 weights and inputs, and the JAX reference run on them
    (f32, XLA, as ``tests/test_accuracy.py`` runs it)."""
    jparams = j_random_params(JCFG, seed=0, quantized=True)
    params = random_params(CFG, seed=0, device="cpu")
    mel, langs = _inputs(0)
    jref = j_reference_run(jparams, JCFG, jnp.asarray(mel), jnp.asarray(langs),
                           JCompute.parity().replace(backend=KernelBackend.XLA), STEPS)
    return jparams, params, mel, langs, tuple(np.asarray(x) for x in jref)


# ---------------------------------------------------------------------------
# fixtures


@pytest.mark.parametrize("quantized", [True, False], ids=["q4", "f32"])
def test_structured_params_bit_equal_to_jax(quantized):
    ours = structured_params(CFG, seed=3, quantized=quantized, device="cpu")
    theirs = j_structured_params(JCFG, seed=3, quantized=quantized)

    def walk(a, b, path=()):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + (k,))
            else:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]), err_msg=str(path + (k,)))

    walk(ours, theirs)


@pytest.mark.parametrize("scale", [0.05, 0.05 / np.sqrt(32), 1e-3, 3.0])
def test_device_quantizer_equals_repack_f32(scale):
    """Codes and f16-exact scales bit for bit, a zero block included, also
    with a leading layer axis. Converting the float64 scale to f16 through
    f32 (PyTorch's own conversion) misses a few hundred of five million."""
    rng = np.random.default_rng(11)
    w = rng.standard_normal((3, 192, 640)).astype(np.float32) * np.float32(scale)
    w[1, 5, 32:64] = 0.0
    qw, scales = repack_f32_tensor(torch.from_numpy(w))
    for layer in range(3):
        ref = j_repack_f32(w[layer])
        np.testing.assert_array_equal(qw[layer].numpy(), ref.qw)
        np.testing.assert_array_equal(scales[layer].numpy(), ref.scales)


def test_quantize_linears_makes_the_numpy_q4_member():
    """The Q4 member of the matched pair from the f32 member equals the
    numpy fixture's ``quantized=True`` member, for both fixtures; the
    device generator's pair is matched the same way."""
    for draw in (random_params, structured_params):
        q4 = quantize_linears(draw(CFG, seed=2, quantized=False, device="cpu"))
        ref = draw(CFG, seed=2, quantized=True, device="cpu")
        for side in ("encoder", "decoder"):
            for name, p in ref[side]["blocks"].items():
                for key, v in p.items():
                    assert torch.equal(q4[side]["blocks"][name][key], v), (draw.__name__, side, name, key)
    for structured in (False, True):
        f32 = device_random_params(CFG, seed=5, quantized=False, structured=structured, device="cpu")
        q4 = device_random_params(CFG, seed=5, quantized=True, structured=structured, device="cpu")
        blocks = q4["decoder"]["blocks"]
        assert blocks["fc1"]["qw"].dtype == torch.int8 and "w" not in blocks["fc1"]
        assert torch.equal(quantize_linears(f32)["decoder"]["blocks"]["fc1"]["qw"], blocks["fc1"]["qw"])
        emb = q4["decoder"]["tok_emb"][: CFG.n_vocab].norm(dim=1)
        if structured:  # 64 anchor rows at 20x the tail's norm
            assert 19 < float(emb[:64].mean() / emb[64:].mean()) < 21
        assert torch.all(q4["decoder"]["tok_emb"][CFG.n_vocab :] == 0)


# ---------------------------------------------------------------------------
# the measurement core against the JAX package


def test_forced_logits_parity_matches_jax(reference):
    jparams, params, mel, langs, (jtokens, _, _) = reference
    ref = np.asarray(j_forced_logits(jparams, JCFG, jnp.asarray(mel), jnp.asarray(langs), jnp.asarray(jtokens),
                                     JCompute.parity().replace(backend=KernelBackend.XLA), STEPS))
    ours = qa.forced_logits(params, CFG, torch.from_numpy(mel), torch.from_numpy(langs), torch.from_numpy(jtokens),
                            Compute.parity(), STEPS).numpy()
    assert ours.shape == (STEPS, BATCH, CFG.n_vocab_padded)
    live = np.isfinite(ref)
    assert np.array_equal(np.isfinite(ours), live)
    gap = float(np.abs(ours[live] - ref[live]).max())
    assert gap <= LOGIT_REL * float(np.abs(ref[live]).max()), gap


@pytest.mark.parametrize("name", sorted(F32_VARIANTS))
def test_forced_logits_variants_match_jax(reference, name):
    """Each serving variant in f32 compute, caches as served, through
    ``prepare_params`` on the port's side."""
    jparams, params, mel, langs, (jtokens, _, _) = reference
    jc, tc = F32_VARIANTS[name]
    jc, tc = jc.replace(**_F32), tc.replace(dtype=torch.float32)
    ref = np.asarray(j_forced_logits(_jax_params(jparams, jc), JCFG, jnp.asarray(mel), jnp.asarray(langs),
                                     jnp.asarray(jtokens), jc, STEPS))
    ours = qa.forced_logits(prepare_params(params, tc), CFG, torch.from_numpy(mel), torch.from_numpy(langs),
                            torch.from_numpy(jtokens), tc, STEPS).numpy()
    live = np.isfinite(ref)
    assert np.array_equal(np.isfinite(ours), live)
    gap = float(np.abs(ours[live] - ref[live]).max())
    print(f"{name}: max abs logit gap {gap:.3g} (max |logit| {np.abs(ref[live]).max():.3g})")
    assert gap <= LOGIT_REL * float(np.abs(ref[live]).max()), gap


def test_reference_run_matches_jax(reference):
    _, params, mel, langs, (jtokens, jlogits, jvalid) = reference
    tokens, logits, valid = qa.reference_run(params, CFG, torch.from_numpy(mel), torch.from_numpy(langs),
                                             Compute.parity(), STEPS)
    np.testing.assert_array_equal(tokens.numpy(), jtokens)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0, atol=LOGIT_REL * float(np.abs(jlogits).max()))


def test_compare_variant_matches_jax(reference):
    """The same reference, weights and variant (int8 caches in f32): the
    same agreement, and drifts within the logits' tolerance."""
    jparams, params, mel, langs, (jtokens, jlogits, jvalid) = reference
    jc, tc = F32_VARIANTS["q4_int8kv"]
    jc, tc = jc.replace(**_F32), tc.replace(dtype=torch.float32)
    theirs = j_compare_variant(jlogits, jvalid, jparams, JCFG, jnp.asarray(mel), jnp.asarray(langs),
                               jnp.asarray(jtokens), jc, STEPS)
    ours = qa.compare_variant(torch.from_numpy(jlogits), torch.from_numpy(jvalid), params, CFG,
                              torch.from_numpy(mel), torch.from_numpy(langs), torch.from_numpy(jtokens), tc, STEPS)
    print(ours, theirs)
    assert set(ours) == set(theirs)
    assert ours["token_agreement"] == theirs["token_agreement"]
    tol = LOGIT_REL * float(np.abs(jlogits).max())
    for key in ("max_logit_drift", "mean_logit_drift"):
        assert abs(ours[key] - theirs[key]) <= tol, key
    assert abs(ours["norm_drift"] - theirs["norm_drift"]) <= tol / float(jlogits[jvalid].std())


# ---------------------------------------------------------------------------
# the small sweeps of tests/test_accuracy.py, in the port's variants


def test_kv_quantization_floors_small():
    """Cache and compute quantization alone (the same Q4 weights at f32
    compute as the reference) keep the mean agreement over 3 seeds above
    the JAX test's small floors, in the port's serving variants (bf16,
    the plain versions)."""
    small_floors = {"q4_bf16": 0.95, "q4_int8kv": 0.95, "q4_int4kv": 0.90, "q4_int4kv_q8log": 0.90,
                    "q4_int4selfkv": 0.85}
    agreements = {k: [] for k in small_floors}
    for seed in range(3):
        params = random_params(CFG, seed=seed, device="cpu")
        mel, langs = (torch.from_numpy(x) for x in _inputs(seed))
        ref_tokens, ref_lg, valid = qa.reference_run(prepare_params(params, Compute.parity()), CFG, mel, langs,
                                                     Compute.parity(), STEPS)
        for name in small_floors:
            comp = qa.VARIANTS[name]
            row = qa.compare_variant(ref_lg, valid, prepare_params(params, comp), CFG, mel, langs, ref_tokens,
                                     comp, STEPS)
            agreements[name].append(row["token_agreement"])
    for name, floor in small_floors.items():
        mean = float(np.mean(agreements[name]))
        assert mean >= floor, f"{name}: mean agreement {mean:.4f} below {floor} (per seed {agreements[name]})"


def test_weight_q4_agreement_on_structured_fixture():
    """Q4_0 against f32 weights at f32 compute on the peaked fixture keep
    a mean agreement of at least 0.95 over 3 seeds, with finite drift."""
    agreements = []
    for seed in range(3):
        pf = structured_params(CFG, seed=seed, quantized=False, device="cpu")
        pq = structured_params(CFG, seed=seed, quantized=True, device="cpu")
        mel, langs = (torch.from_numpy(x) for x in _inputs(seed))
        ref_tokens, ref_lg, valid = qa.reference_run(pf, CFG, mel, langs, Compute.parity(), STEPS)
        row = qa.compare_variant(ref_lg, valid, pq, CFG, mel, langs, ref_tokens, Compute.parity(), STEPS)
        assert np.isfinite(row["norm_drift"]), row
        agreements.append(row["token_agreement"])
    assert float(np.mean(agreements)) >= 0.95, agreements


# ---------------------------------------------------------------------------
# the floors and the committed card sweep


def test_floors_are_the_jax_tests():
    """FLOORS, OPT_FLOORS and STRUCT_FLOORS as tests/test_accuracy.py
    assigns them (read from its source)."""
    theirs = {
        node.targets[0].id: ast.literal_eval(node.value)
        for node in ast.parse(JAX_FLOORS_TEST.read_text()).body
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
        and node.targets[0].id in ("FLOORS", "OPT_FLOORS", "STRUCT_FLOORS")
    }
    assert theirs == {"FLOORS": qa.FLOORS, "OPT_FLOORS": qa.OPT_FLOORS, "STRUCT_FLOORS": qa.STRUCT_FLOORS}


def test_committed_accuracy_torch_meets_floors():
    """The committed card sweep (Large-V3, ACCURACY.json's protocol, host
    fixtures) meets every floor, its FLOORS rows drift at most
    NORM_DRIFT_MAX, its iid weight row at most 3.0 and its peaked weight
    row agrees at least 0.90. Fails where the file is missing."""
    data = json.loads(ACCURACY_TORCH.read_text())
    assert (data["config"], data["steps"], data["batch"], data["fixture"]) == ("large_v3", 64, 4, "host")
    assert data["seeds"] >= 2 and "H100" in data["card"]
    variants = data["variants"]
    for name, floor in {**qa.FLOORS, **qa.OPT_FLOORS, **qa.STRUCT_FLOORS}.items():
        assert variants[name]["token_agreement_mean"] >= floor, (name, variants[name])
    for name in qa.FLOORS:
        assert variants[name]["norm_drift_max"] <= qa.NORM_DRIFT_MAX, (name, variants[name])
    assert variants["weight_q4"]["norm_drift_max"] <= 3.0, variants["weight_q4"]
    assert variants["weight_q4_struct"]["token_agreement_mean"] >= 0.90, variants["weight_q4_struct"]
