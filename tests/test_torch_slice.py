"""The ported serving slice against the JAX package, stage by stage, on the
CPU in f32: mel -> encode -> fill_cross_cache -> prefill -> teacher-forced
decode steps -> greedy_decode, on the same numpy weights and audio.

The JAX side runs the serving configuration in f32 with its Pallas kernels
in interpret mode; the config is the smallest that every one of its seven
Pallas kernels serves (K = 256 clears pallas_q4's K % 256 gate).

W8A8 rounds each activation row to int8, so a one-ulp difference between
the two frameworks at a rounding tie moves a whole code step. The stages
are therefore held twice: with W8A8 off end to end at 1e-4, and with W8A8
on (the serving configuration) where each W8A8 linear gets identical
inputs (1e-5), the decoder stages start from the JAX side's own encoder
output (1e-4), and the encoder as a whole is held to limits set from the
measured spread of a tie."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.audio.mel import MelFrontend as JMel
from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.decoder import compute_cross_kv as j_cross_kv
from whisper_burn_tpu.models.decoder import decode_step as j_decode_step
from whisper_burn_tpu.models.decoder import fill_cross_cache as j_fill
from whisper_burn_tpu.models.decoder import init_cache as j_init_cache
from whisper_burn_tpu.models.decoder import prefill as j_prefill
from whisper_burn_tpu.models.encoder import encode as j_encode
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.models.whisper import detect_language as j_detect
from whisper_burn_tpu.models.whisper import greedy_decode as j_greedy
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.ops.linear import apply_linear as j_apply_linear
from whisper_burn_tpu.ops.linear import w8a8_matmul as j_w8a8
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.audio.mel import MelFrontend
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.decoder import decode_step, fill_cross_cache, init_cache, prefill
from whisper_burn_tpu_torch.models.encoder import encode
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.models.whisper import detect_language, greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.linear import apply_linear, w8a8_matmul
from whisper_burn_tpu_torch.transcribe import prepare_params

SMALL = dict(
    n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4,
    n_audio_ctx=128, n_text_ctx=64,
)
JCFG = JConfig.tiny_test().replace(**SMALL)
CFG = WhisperConfig.tiny_test().replace(**SMALL)
JC = JCompute.fastest(kv_bits=4).replace(
    quantized_logits=True, w8a8=False, dtype=jnp.float32,
    precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS,
)
TC = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=False, dtype=torch.float32)
JCW, TCW = JC.replace(w8a8=True), TC.replace(w8a8=True)  # the serving configuration
B, CTX, STEPS = 2, 64, 8
N_SAMPLES = 2 * CFG.n_audio_ctx * 160  # 256 mel frames


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


def _max_diff(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    live = np.isfinite(b)
    return float(np.abs(a[live] - b[live]).max())


@pytest.fixture(scope="module")
def setup():
    audio = (np.random.default_rng(7).standard_normal((B, N_SAMPLES)) * 0.1).astype(np.float32)
    jparams = j_prepare(j_random_params(JCFG, seed=0), JC)
    params = prepare_params(random_params(CFG, seed=0, device="cpu"), TC)
    mel = JMel(n_mels=CFG.n_mels)(jnp.asarray(audio))
    return audio, np.array(mel), jparams, params


@pytest.fixture(scope="module")
def caches(setup):
    """Both sides' encoder outputs and filled cross caches."""
    _, mel, jparams, params = setup
    jenc = j_encode(jparams, jnp.asarray(mel), JCFG, JC)
    enc = encode(params, torch.from_numpy(mel), CFG, TC)
    jcache = j_fill(jparams, JCFG, jenc, j_init_cache(JCFG, B, JC, ctx=CTX), JC)
    cache = fill_cross_cache(params, CFG, enc, init_cache(CFG, B, TC, CTX, "cpu"), TC)
    return jenc, enc, jcache, cache


@pytest.fixture(scope="module")
def w8a8_setup(setup):
    """Both sides' parameters prepared with W8A8 on, and the JAX side's
    W8A8 encoder output."""
    _, mel, _, _ = setup
    jparams = j_prepare(j_random_params(JCFG, seed=0), JCW)
    params = prepare_params(random_params(CFG, seed=0, device="cpu"), TCW)
    return jparams, params, j_encode(jparams, jnp.asarray(mel), JCFG, JCW)


@pytest.mark.parametrize("norm", ["slaney", None])
@pytest.mark.parametrize("n_mels", [80, 128])  # 128: Large-V3's front end
def test_mel_matches_jax(norm, n_mels):
    audio = (np.random.default_rng(8).standard_normal((2, 48000)) * 0.1).astype(np.float32)
    ref = JMel(n_mels=n_mels, norm=norm)(jnp.asarray(audio))
    out = MelFrontend(n_mels=n_mels, norm=norm)(torch.from_numpy(audio))
    assert out.shape == (2, n_mels, 300)
    # 128 bins: the narrowest filters span few FFT bins, so the two FFTs'
    # f32 rounding reaches the log less averaged (measured 1.3e-5 at most)
    _close(out, ref, 1e-5 if n_mels == 80 else 2e-5)


def test_encode_matches_jax(caches):
    jenc, enc, _, _ = caches
    assert enc.shape == (B, CFG.n_audio_ctx, CFG.n_audio_state)
    _close(enc, jenc, 1e-4)


def _codes(packed):
    """int4 codes in [-8, 7] from biased-nibble pairs along axis 2."""
    lo = (packed & 15).astype(np.float32) - 8
    hi = (packed >> 4).astype(np.float32) - 8
    return np.concatenate([lo, hi], axis=2)


def _assert_cross_cache_matches(jparams, jenc, jcache, cache, jcompute):
    _close(cache.cross_k_scale, jcache.cross_k_scale, 1e-4)
    _close(cache.cross_v_scale, jcache.cross_v_scale, 1e-4)
    # the JAX side's values before quantization: keys [L, B, D, T] (the
    # stored layout), values [L, B, T, D]; scales per channel
    jk, jv = (np.asarray(a, np.float32) for a in j_cross_kv(jparams, JCFG, jenc, jcompute))
    l_dim = jk.shape[0]
    for ours, ref, pre, scale in (
        (cache.cross_k, jcache.cross_k, np.swapaxes(jk, 2, 3), np.asarray(jcache.cross_k_scale).reshape(l_dim, 1, -1, 1)),
        (cache.cross_v, jcache.cross_v, jv, np.asarray(jcache.cross_v_scale).reshape(l_dim, 1, 1, -1)),
    ):
        a, r = _codes(ours.numpy()), _codes(np.asarray(ref))
        moved = a != r
        # a code moves by at most one step, only where the value lies within
        # 1e-5 (relative) of a rounding boundary, for at most 0.1% of entries
        assert np.abs(a - r).max() <= 1
        assert np.mean(moved) <= 1e-3
        units = pre / scale
        tie = np.abs(units - np.floor(units) - 0.5)
        assert np.all(tie[moved] <= 1e-5 * np.maximum(np.abs(units[moved]), 1.0))


def test_fill_cross_cache_matches_jax(setup, caches):
    _, _, jparams, _ = setup
    jenc, _, jcache, cache = caches
    _assert_cross_cache_matches(jparams, jenc, jcache, cache, JC)


def test_detect_language_matches_jax(setup, caches):
    _, _, jparams, params = setup
    _, _, jcache, cache = caches
    ref = j_detect(jparams, JCFG, jcache, JC)
    np.testing.assert_array_equal(detect_language(params, CFG, cache, TC).numpy(), np.asarray(ref))


def _prompt(b):
    return np.stack(
        [
            np.full(b, 50258), np.full(b, CFG.lang_token_start),
            np.full(b, CFG.transcribe_token), np.full(b, CFG.no_timestamps_token),
        ],
        axis=1,
    ).astype(np.int32)


def _assert_self_rows_agree(cache, jc, rows):
    """Self-cache rows: the int8 codes agree but for single steps at
    rounding ties (at most 0.1% of them); the scales to 1e-5."""
    for ours, ref in ((cache.self_k, jc.self_k), (cache.self_v, jc.self_v)):
        a = ours[:, :, rows].numpy().astype(np.int32)
        r = np.asarray(ref[:, :, rows]).astype(np.int32)
        assert np.abs(a - r).max() <= 1
        assert np.mean(a != r) <= 1e-3
    _close(cache.self_kv_scale[:, :, rows], jc.self_kv_scale[:, :, rows], 1e-5)


def _take_self_cache(cache, jc):
    for ours, ref in ((cache.self_k, jc.self_k), (cache.self_v, jc.self_v), (cache.self_kv_scale, jc.self_kv_scale)):
        ours.copy_(torch.from_numpy(np.array(ref)))


def _assert_prefill_and_decode_match(jparams, params, jcache, cache, jcompute, compute, resync=False):
    """Prefill logits, then STEPS teacher-forced decode steps, at 1e-4.
    With ``resync`` each step starts from the JAX side's self cache, and
    the rows both sides store are held to ``_assert_self_rows_agree``: one
    int8 code at a tie otherwise moves every later step's logits. Returns
    the largest logit difference of the prefill and of the steps."""
    prompt = _prompt(B)
    jlogits, jc = j_prefill(jparams, JCFG, jnp.asarray(prompt), jcache, jcompute)
    logits = prefill(params, CFG, torch.from_numpy(prompt).long(), cache, compute)
    _close(logits, jlogits, 1e-4)
    diffs = [_max_diff(logits, jlogits)]
    if resync:
        _assert_self_rows_agree(cache, jc, slice(0, 4))
        _take_self_cache(cache, jc)
    else:
        # self cache rows 0..3: the dequantized values agree
        _close(
            cache.self_k[:, :, :4].float() * cache.self_kv_scale[:, :, :4, :1],
            np.asarray(jc.self_k[:, :, :4], np.float32) * np.asarray(jc.self_kv_scale[:, :, :4, :1]),
            1e-4,
        )
    # random weights repeat one token, so force a varied sequence instead
    forced = np.random.default_rng(9).integers(0, CFG.n_vocab, (STEPS, B)).astype(np.int32)
    step = jax.jit(j_decode_step, static_argnums=(1, 5))
    for k in range(STEPS):
        pos = 4 + k
        jlogits, jc = step(jparams, JCFG, jnp.asarray(forced[k]), jnp.asarray(pos), jc, jcompute)
        logits = decode_step(params, CFG, torch.from_numpy(forced[k]).long(), torch.tensor(pos, dtype=torch.int32),
                             cache, compute)
        _close(logits, jlogits, 1e-4)
        diffs.append(_max_diff(logits, jlogits))
        if resync:
            _assert_self_rows_agree(cache, jc, slice(pos, pos + 1))
            _take_self_cache(cache, jc)
    return diffs[0], max(diffs[1:])


def test_prefill_and_teacher_forced_decode_match_jax(setup, caches):
    _, _, jparams, params = setup
    _, _, jcache, cache = caches
    pre, steps = _assert_prefill_and_decode_match(jparams, params, jcache, cache, JC, TC)
    print(f"stages: prefill {pre:.3g}, teacher-forced steps {steps:.3g}")


def test_grouped_decode_steps_match_jax(setup, caches):
    """Teacher-forced steps with batch_groups=G (beam search's branch of the
    decode step: kernel E and the flash merge for self-attention, grouped
    kernel C, the deferred slot write by kernel F) on the same prefilled
    self caches repeated G-fold, both sides' cross caches shared per
    utterance; logits at 1e-4. Each step starts from the JAX side's self
    cache and the rows both store are held to _assert_self_rows_agree, as
    int8 codes at rounding ties move later steps."""
    _, _, jparams, params = setup
    jenc, enc, _, _ = caches
    g = 3
    jcache = j_fill(jparams, JCFG, jenc, j_init_cache(JCFG, B, JC, ctx=CTX), JC)
    cache = fill_cross_cache(params, CFG, enc, init_cache(CFG, B, TC, CTX, "cpu"), TC)
    prompt = _prompt(B)
    _, jc = j_prefill(jparams, JCFG, jnp.asarray(prompt), jcache, JC)
    prefill(params, CFG, torch.from_numpy(prompt).long(), cache, TC)
    _assert_self_rows_agree(cache, jc, slice(0, 4))
    rep = lambda a: jnp.repeat(a, g, axis=1)
    jc = jc._replace(self_k=rep(jc.self_k), self_v=rep(jc.self_v), self_kv_scale=rep(jc.self_kv_scale))
    cache.self_k, cache.self_v, cache.self_kv_scale = (
        torch.from_numpy(np.array(a)) for a in (jc.self_k, jc.self_v, jc.self_kv_scale)
    )
    forced = np.random.default_rng(11).integers(0, CFG.n_vocab, (STEPS, B * g)).astype(np.int32)
    step = jax.jit(j_decode_step, static_argnums=(1, 5, 6))
    diffs = []
    _build.reset_launches()
    for k in range(STEPS):
        pos = 4 + k
        jlogits, jc = step(jparams, JCFG, jnp.asarray(forced[k]), jnp.asarray(pos), jc, JC, g)
        logits = decode_step(params, CFG, torch.from_numpy(forced[k]).long(), torch.tensor(pos, dtype=torch.int32),
                             cache, TC, batch_groups=g)
        assert logits.shape == (B * g, CFG.n_vocab_padded)
        _close(logits, jlogits, 1e-4)
        diffs.append(_max_diff(logits, jlogits))
        _assert_self_rows_agree(cache, jc, slice(pos, pos + 1))
        _take_self_cache(cache, jc)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    print(f"grouped teacher-forced steps: {max(diffs):.3g}")


def test_greedy_decode_matches_jax(setup):
    audio, mel, jparams, params = setup
    lang = np.full(B, CFG.lang_token_start, np.int32)
    ref = j_greedy(jparams, JCFG, jnp.asarray(mel), jnp.asarray(lang), JC, max_tokens=STEPS)
    _build.reset_launches()
    tmel = MelFrontend(n_mels=CFG.n_mels)(torch.from_numpy(audio))
    out = greedy_decode(params, CFG, tmel, torch.from_numpy(lang), TC, max_tokens=STEPS)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
    np.testing.assert_array_equal(out.lang_tokens.numpy(), np.asarray(ref.lang_tokens))


def test_w8a8_matmul_matches_jax():
    """On identical inputs the W8A8 product agrees to the last bits: the same
    per-row rounding, an exact int32 product and the same epilogue order."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((3, 40, 256)).astype(np.float32)
    qw8 = rng.integers(-127, 128, (256, 768), dtype=np.int8)
    s8 = rng.uniform(1e-4, 1e-3, 768).astype(np.float32)
    ref = j_w8a8(jnp.asarray(x), jnp.asarray(qw8), jnp.asarray(s8), JC)
    out = w8a8_matmul(torch.from_numpy(x), torch.from_numpy(qw8), torch.from_numpy(s8), TC)
    _close(out, ref, 1e-6)


W8A8_SITES = [("encoder", n) for n in ("attn_qkv", "attn_o", "fc1", "fc2")] + [("decoder", "xattn_kv")]


@pytest.mark.parametrize("side,name", W8A8_SITES)
def test_w8a8_linear_sites_match_jax(w8a8_setup, side, name):
    """Every linear that W8A8 serves, on each layer's prepared weights and
    identical inputs: the same int8 codes both ways, so 1e-5."""
    jparams, params, _ = w8a8_setup
    jlin, lin = jparams[side]["blocks"][name], params[side]["blocks"][name]
    assert "qw8" in lin and "qw" not in lin  # replace mode: W8A8 serves every M
    n_layers, k, _ = lin["qw8"].shape
    for layer in range(n_layers):
        x = np.random.default_rng(20 + layer).standard_normal((B, CFG.n_audio_ctx, k)).astype(np.float32)
        ref = j_apply_linear({n: a[layer] for n, a in jlin.items()}, jnp.asarray(x), JCW)
        out = apply_linear(lin, torch.from_numpy(x), TCW, layer=layer)
        print(f"{side}.{name}[{layer}] W8A8: max {_max_diff(out, ref):.3g}")
        _close(out, ref, 1e-5)


def test_encode_w8a8_matches_jax(setup, w8a8_setup):
    """The serving encoder as a whole. A one-ulp tie moves one int8 code,
    and attention spreads that over its utterance: measured 3.16e-2 max
    and 4.8e-7 median absolute difference (outputs up to 3.9). The limits,
    5e-2 max and 1e-5 median, fail a quantizer fault: s8 shifted by one
    column in attn_qkv or fc2 gives 0.40 / 0.065 and 0.61 / 0.072."""
    _, mel, _, _ = setup
    jparams, params, jenc = w8a8_setup
    diff = np.abs(encode(params, torch.from_numpy(mel), CFG, TCW).numpy() - np.asarray(jenc))
    print(f"encode W8A8: max {diff.max():.3g}, median {np.median(diff):.3g}")
    assert diff.max() <= 5e-2
    assert np.median(diff) <= 1e-5


def test_w8a8_stages_match_jax(w8a8_setup):
    """Cross-KV fill (W8A8), prefill and teacher-forced decode steps in the
    serving configuration, both sides fed the JAX side's encoder output.
    Here one prefill self-V code sits at a tie (measured: it moves the
    later steps' logits by up to 2.8e-4), so the steps resync."""
    jparams, params, jenc = w8a8_setup
    jcache = j_fill(jparams, JCFG, jenc, j_init_cache(JCFG, B, JCW, ctx=CTX), JCW)
    enc = torch.from_numpy(np.array(jenc))
    cache = fill_cross_cache(params, CFG, enc, init_cache(CFG, B, TCW, CTX, "cpu"), TCW)
    _assert_cross_cache_matches(jparams, jenc, jcache, cache, JCW)
    moved = [np.mean(_codes(a.numpy()) != _codes(np.asarray(r))) for a, r in
             ((cache.cross_k, jcache.cross_k), (cache.cross_v, jcache.cross_v))]
    pre, steps = _assert_prefill_and_decode_match(jparams, params, jcache, cache, JCW, TCW, resync=True)
    print(f"W8A8 stages: cross codes moved {moved}, prefill {pre:.3g}, teacher-forced steps {steps:.3g}")


def test_greedy_decode_w8a8_serving_matches_jax(setup, w8a8_setup):
    """The serving configuration as bench.py runs it, W8A8 included, in f32:
    the tokens must agree."""
    audio, mel, _, _ = setup
    jparams, params, _ = w8a8_setup
    lang = np.full(B, CFG.lang_token_start, np.int32)
    ref = j_greedy(jparams, JCFG, jnp.asarray(mel), jnp.asarray(lang), JCW, max_tokens=STEPS)
    out = greedy_decode(params, CFG, torch.from_numpy(mel.copy()), torch.from_numpy(lang), TCW, max_tokens=STEPS)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
