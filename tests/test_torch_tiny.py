"""``WhisperConfig.tiny_test()`` (32-wide heads) decodes on the CPU in the
PyTorch port, token for token as in the JAX package, in f32.

The port's kernels take 64-wide heads; on CPU tensors every attention op
takes its plain version, which serves any head width, as the JAX package
does. The computes: ``Compute.parity()`` (unquantized caches), the int4
cross / int8 self compute of tests/test_torch_slice.py (W8A8 off), and that
compute with int4 self keys and values or int8 keys and int4 values (the
int4 self modes' plain forms and their scale-group rule at 32-wide heads),
the JAX side on its Pallas kernels in interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.beam import beam_decode as j_beam
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.models.whisper import greedy_decode as j_greedy
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models.beam import beam_decode
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.decode_attention import decode_attention_layer, decode_cross_attention
from whisper_burn_tpu_torch.ops.encoder_attention import encoder_attention
from whisper_burn_tpu_torch.transcribe import prepare_params

JCFG, CFG = JConfig.tiny_test(), WhisperConfig.tiny_test()
_F32 = dict(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS)
COMPUTES = {  # name: (JAX compute, port compute), both in f32
    "parity": (JCompute.parity().replace(backend=KernelBackend.PALLAS), Compute.parity()),
    "int4_cross_int8_self": (
        JCompute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=False, **_F32),
        Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=False, dtype=torch.float32),
    ),
}
COMPUTES["int4_self"] = tuple(c.replace(self_kv_bits=4) for c in COMPUTES["int4_cross_int8_self"])
COMPUTES["mixed_self"] = tuple(c.replace(self_kv_vbits=4) for c in COMPUTES["int4_cross_int8_self"])
B, TOKENS = 2, 12


def test_tiny_config_has_narrow_heads():
    assert CFG.n_text_state // CFG.n_text_head == 32
    assert CFG.n_audio_state // CFG.n_audio_head == 32


@pytest.mark.parametrize("mode", sorted(COMPUTES))
def test_tiny_greedy_matches_jax(mode):
    jc, tc = COMPUTES[mode]
    mel = np.random.default_rng(3).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    lang = np.full(B, CFG.lang_token_start, np.int32)
    jparams = j_prepare(j_random_params(JCFG, seed=0), jc)
    params = prepare_params(random_params(CFG, seed=0, device="cpu"), tc)
    ref = j_greedy(jparams, JCFG, jnp.asarray(mel), jnp.asarray(lang), jc, max_tokens=TOKENS)
    _build.reset_launches()
    out = greedy_decode(params, CFG, torch.from_numpy(mel), torch.from_numpy(lang), tc, max_tokens=TOKENS)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))


@pytest.mark.parametrize("decode", ["greedy", "beam"])
@pytest.mark.parametrize("case", ["translate", "mixed_detect_erf"])
def test_tiny_task_and_detect_match_jax(decode, case):
    """``task="translate"`` with explicit languages, and ``detect=True`` on a
    batch of one explicit and one auto-detected language (entry < 0) with
    the exact GELU form, through ``greedy_decode`` and ``beam_decode`` (3
    beams) in ``Compute.parity()``: the tokens, the token counts and the
    language tokens used equal the JAX package's (beam scores within 1e-5)."""
    jc, tc = COMPUTES["parity"]
    jcfg, cfg = (JCFG, CFG) if case == "translate" else (JCFG.replace(gelu="erf"), CFG.replace(gelu="erf"))
    mel = np.random.default_rng(4).standard_normal((B, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    if case == "translate":
        lang, kw = np.array([cfg.lang_token_start, cfg.lang_token_start + 1], np.int32), dict(task="translate")
    else:
        lang, kw = np.array([cfg.lang_token_start + 2, -1], np.int32), dict(detect=True)
    if decode == "beam":
        kw["beam_width"] = 3
    jparams = j_prepare(j_random_params(jcfg, seed=0), jc)
    params = prepare_params(random_params(cfg, seed=0, device="cpu"), tc)
    j_fn, fn = (j_greedy, greedy_decode) if decode == "greedy" else (j_beam, beam_decode)
    ref = j_fn(jparams, jcfg, jnp.asarray(mel), jnp.asarray(lang), jc, max_tokens=TOKENS, **kw)
    out = fn(params, cfg, torch.from_numpy(mel), torch.from_numpy(lang), tc, max_tokens=TOKENS, **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
    np.testing.assert_array_equal(out.lang_tokens.numpy(), np.asarray(ref.lang_tokens))
    if case != "translate":
        assert out.lang_tokens[0] == lang[0] and out.lang_tokens[1] >= cfg.lang_token_start
    if decode == "beam":
        np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-5)


def test_narrow_heads_refused_on_cuda_tensors_only():
    """The head-width rule belongs to the kernels: a CPU tensor of 32-wide
    heads takes the plain version, and the check that guards the kernels
    still refuses it (here reached through a meta tensor, which is not on
    the CPU and needs no card)."""
    d, h = CFG.n_text_state, CFG.n_text_head
    q = torch.zeros((B, 1, d))
    cache = torch.zeros((1, B, 8, d))
    acc, m, l = decode_attention_layer(q, cache, cache, None, 0, torch.tensor(4, dtype=torch.int32), h)
    assert acc.shape == (B, 1, d) and m.shape == (B, 1, h) and l.shape == (B, 1, h)
    kT = torch.zeros((1, B, d, 8))
    assert decode_cross_attention(q, kT, cache, 0, 8, h).shape == (B, 1, d)
    x = torch.zeros((B, 8, d))
    assert encoder_attention(x, x, x, h, valid=6).shape == (B, 8, d)
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="64-wide heads"):
        decode_attention_layer(meta(q), meta(cache), meta(cache), None, 0, meta(torch.tensor(4, dtype=torch.int32)), h)
    with pytest.raises(ValueError, match="64-wide heads"):
        encoder_attention(meta(x), meta(x), meta(x), h, valid=6)
