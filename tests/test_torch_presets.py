"""The shapes of Whisper Medium and Large-V3-Turbo in the PyTorch port,
against the JAX package, on the CPU in f32 at tiny widths.

* The presets equal the JAX package's field for field, with their derived
  token ids and widths.
* Turbo-shaped: unequal stacks (3 encoder layers and 1 decoder layer, and
  the reverse), so that nothing sized by one stack's depth serves the
  other.
* Medium-shaped: 80 mel bins, 99 languages, twice the heads of
  ``tiny_test()``.

Each config's teacher-forced logits (the encoder, the cross cache of the
decoder's stack, the prefill, then decode steps, within 1e-4) equal the
JAX package's in ``Compute.parity()`` and in the serving compute (int4
cross cache, int8 self cache, int8 logits; W8A8 off, as in
tests/test_torch_tiny.py): they reach every layer-indexed buffer. The
unequal stacks' greedy and beam tokens (beam scores within 1e-5) equal the
JAX package's in the serving compute, through the loops' own buffers (the
beam's self-cache pair and its reorder); the decode loops' bodies at equal
stacks are held in tests/test_torch_tiny.py and
tests/test_torch_beam_graph.py. The JAX side runs its Pallas kernels in
interpret mode."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.beam import beam_decode as j_beam
from whisper_burn_tpu.models.decoder import decode_step as j_decode_step
from whisper_burn_tpu.models.decoder import fill_cross_cache as j_fill
from whisper_burn_tpu.models.decoder import init_cache as j_init_cache
from whisper_burn_tpu.models.decoder import prefill as j_prefill
from whisper_burn_tpu.models.encoder import encode as j_encode
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.models.whisper import greedy_decode as j_greedy
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models.beam import beam_decode
from whisper_burn_tpu_torch.models.config import SOT, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import decode_step, fill_cross_cache, init_cache, prefill
from whisper_burn_tpu_torch.models.encoder import encode
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import prepare_params

_F32 = dict(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS)
COMPUTES = {  # name: (JAX compute, port compute), both in f32
    "parity": (JCompute.parity().replace(backend=KernelBackend.PALLAS), Compute.parity()),
    "serving": (
        JCompute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=False, **_F32),
        Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=False, dtype=torch.float32),
    ),
}
SHAPES = {  # name: the fields that tiny_test() changes
    "turbo_3_enc_1_dec": dict(n_audio_layer=3, n_text_layer=1),
    "turbo_1_enc_3_dec": dict(n_audio_layer=1, n_text_layer=3),
    "medium_80_mels_4_heads": dict(n_mels=80, n_lang=99, n_audio_state=128, n_text_state=128, n_audio_head=4,
                                   n_text_head=4),
}
B, TOKENS, BEAMS, CTX = 2, 10, 3, 16


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("preset", ["medium", "large_v3", "large_v3_turbo", "tiny_test"])
def test_presets_equal_jax(preset):
    ours, ref = getattr(WhisperConfig, preset)(), getattr(JConfig, preset)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for prop in ("transcribe_token", "translate_token", "no_timestamps_token", "lang_token_start", "lang_token_end",
                 "head_dim", "ffn_dim", "n_vocab_padded"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    if preset == "large_v3_turbo":
        assert (ours.n_audio_layer, ours.n_text_layer, ours.n_mels, ours.n_lang) == (32, 4, 128, 100)
    if preset == "medium":
        assert (ours.n_audio_state, ours.n_audio_head, ours.n_mels, ours.n_lang) == (1024, 16, 80, 99)


def _setup(shape: str, mode: str, seed: int = 0):
    jcfg, cfg = JConfig.tiny_test().replace(**SHAPES[shape]), WhisperConfig.tiny_test().replace(**SHAPES[shape])
    jc, tc = COMPUTES[mode]
    mel = np.random.default_rng(seed + 3).standard_normal((B, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    jparams = j_prepare(j_random_params(jcfg, seed=seed), jc)
    params = prepare_params(random_params(cfg, seed=seed, device="cpu"), tc)
    return jcfg, cfg, jc, tc, mel, jparams, params


@pytest.mark.parametrize("shape", [s for s in sorted(SHAPES) if s.startswith("turbo")])
@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_decode_matches_jax(decode, shape):
    jcfg, cfg, jc, tc, mel, jparams, params = _setup(shape, "serving")
    lang = np.full(B, cfg.lang_token_start + 1, np.int32)
    kw = dict(beam_width=BEAMS) if decode == "beam" else {}
    j_fn, fn = (j_greedy, greedy_decode) if decode == "greedy" else (j_beam, beam_decode)
    ref = j_fn(jparams, jcfg, jnp.asarray(mel), jnp.asarray(lang), jc, max_tokens=TOKENS, **kw)
    out = fn(params, cfg, torch.from_numpy(mel), torch.from_numpy(lang), tc, max_tokens=TOKENS, **kw)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
    if decode == "beam":
        np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", sorted(COMPUTES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_teacher_forced_logits_match_jax(shape, mode):
    """The encoder over its stack, the cross cache of the decoder's stack
    (``[n_text_layer, ...]``), the prefill and teacher-forced decode steps
    on a varied token sequence: logits within 1e-4."""
    jcfg, cfg, jc, tc, mel, jparams, params = _setup(shape, mode, seed=1)
    jenc = j_encode(jparams, jnp.asarray(mel), jcfg, jc)
    enc = encode(params, torch.from_numpy(mel), cfg, tc)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), rtol=1e-4, atol=1e-4)
    jcache = j_fill(jparams, jcfg, jenc, j_init_cache(jcfg, B, jc, ctx=CTX), jc)
    cache = fill_cross_cache(params, cfg, enc, init_cache(cfg, B, tc, CTX, "cpu"), tc)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        ours, ref = getattr(cache, name), getattr(jcache, name)
        assert tuple(ours.shape) == tuple(ref.shape) and ours.shape[0] == cfg.n_text_layer, name
    prompt = np.stack([np.full(B, SOT), np.full(B, cfg.lang_token_start), np.full(B, cfg.transcribe_token),
                       np.full(B, cfg.no_timestamps_token)], axis=1).astype(np.int32)
    jlogits, jcache = j_prefill(jparams, jcfg, jnp.asarray(prompt), jcache, jc)
    logits = prefill(params, cfg, torch.from_numpy(prompt).long(), cache, tc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
    forced = np.random.default_rng(9).integers(0, cfg.n_vocab, (4, B)).astype(np.int32)
    step = jax.jit(j_decode_step, static_argnums=(1, 5))
    for k, tokens in enumerate(forced):
        pos = 4 + k
        jlogits, jcache = step(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jcache, jc)
        logits = decode_step(params, cfg, torch.from_numpy(tokens).long(), torch.tensor(pos, dtype=torch.int32),
                             cache, tc)
        assert logits.shape[-1] == jlogits.shape[-1]
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
