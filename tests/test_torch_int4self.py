"""The int4 self-KV modes of the PyTorch port against the JAX package, on
the CPU in f32, at the small config of tests/test_torch_slice.py.

* The plain versions of kernels G (merged self-attention over a uint8
  cache, no store) and H (unnormalized attention over it) against
  ``pallas_attention._kernel``'s int4 branches in interpret mode, at 1e-5
  of the output's scale:
  int4 keys and values with group scales, int8 keys with int4 values (the
  mixed mode), int4 with one scalar scale a side, and unscaled int4, at
  D = 256 and 640 (2 and 10 scale groups), and G at Large-V3's D = 1280
  (20 heads in pairs h, h + 10; 10 groups, one scale lane for two heads).
* ``_quantize_tokens4``, ``self_kv_groups`` and ``self_kv_group_size``:
  codes exactly, scales to 1e-7 relative.
* ``Compute.fastest(kv_bits=4)`` with ``self_kv_bits=4`` (int4self) and
  with ``self_kv_vbits=4`` (mixed), in f32 with W8A8 off, stage by stage:
  the caches' layouts, prefill and teacher-forced decode steps against
  the JAX package's flash path, grouped steps (beam search's branch), each
  at 1e-4; greedy tokens equal; beam tokens and lengths equal and scores to
  1e-4; the beam's reorder on uint8 caches and their scale lanes.

A self-cache code at a rounding tie of ``x / scale`` moves one step
between the two frameworks and then every later logit, so the stage
tests hold the rows both sides store to agree but for such single steps
and then take the JAX side's caches."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models import decoder as jdec
from whisper_burn_tpu.models.beam import beam_decode as j_beam
from whisper_burn_tpu.models.encoder import encode as j_encode
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.models.whisper import greedy_decode as j_greedy
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.ops.pallas_attention import decode_attention_layer as j_layer
from whisper_burn_tpu.ops.pallas_attention import decode_attention_merged as j_merged
from whisper_burn_tpu.ops.pallas_attention import flash_merge_extra_key as j_merge
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models import decoder
from whisper_burn_tpu_torch.models.beam import beam_decode, reorder_self_cache
from whisper_burn_tpu_torch.models.config import EOT, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import decode_step, fill_cross_cache, init_cache, prefill
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer_int4,
    decode_attention_merged_int4,
    dequantize_self_rows,
    flash_merge_extra_key,
    int4_lanes,
)
from whisper_burn_tpu_torch.transcribe import prepare_params

SMALL = dict(
    n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4,
    n_audio_ctx=128, n_text_ctx=64,
)
JCFG = JConfig.tiny_test().replace(**SMALL)
CFG = WhisperConfig.tiny_test().replace(**SMALL)
_F32 = dict(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS)
MODES = {  # name: (JAX compute, port compute), both in f32, W8A8 off
    "int4self": (
        JCompute.fastest(kv_bits=4).replace(self_kv_bits=4, quantized_logits=True, **_F32),
        Compute.fastest(kv_bits=4).replace(self_kv_bits=4, quantized_logits=True, dtype=torch.float32),
    ),
    "mixed": (
        JCompute.fastest(kv_bits=4).replace(self_kv_vbits=4, quantized_logits=True, **_F32),
        Compute.fastest(kv_bits=4).replace(self_kv_vbits=4, quantized_logits=True, dtype=torch.float32),
    ),
}
B, CTX, STEPS, G = 2, 64, 8, 3


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


def _close_to_scale(a, ref, tol):
    """``|a - ref| <= tol * max(1, max|ref|)``: the Pallas kernel's bias
    trick (biased codes summed, less 8 times the sum of their weights)
    cancels digits relative to the output's scale, not to each entry."""
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert np.abs(a - ref).max() <= tol * max(1.0, float(np.abs(ref).max()))


def _max_diff(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    live = np.isfinite(b)
    return float(np.abs(a[live] - b[live]).max())


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


# --------------------------------------------------------------------------
# the plain versions of kernels G and H against the Pallas kernel


def _self_cache(rng, fmt, l_dim, b, ctx, d):
    """A uint8-valued self cache in ``fmt`` with its scales (or None)."""
    ng = decoder.self_kv_groups(d)
    v = rng.integers(0, 256, (l_dim, b, ctx, d // 2), dtype=np.uint8)
    if fmt == "mixed":
        k = rng.integers(-127, 128, (l_dim, b, ctx, d), dtype=np.int8)
        sw = 1 + ng
    else:
        k = rng.integers(0, 256, (l_dim, b, ctx, d // 2), dtype=np.uint8)
        sw = {"groups": 2 * ng, "scalar": 2, "unscaled": 0}[fmt]
    sc = rng.uniform(0.01, 0.05, (l_dim, b, ctx, sw)).astype(np.float32) if sw else None
    if fmt == "mixed":
        sc[..., 0] *= 0.1  # an int8 key step, against int4 steps
    return k, v, sc


def _queries(rng, fmt, b, d):
    """q, k_new, v_new; q small for unscaled codes (keys up to 8), where the
    Pallas kernel's bias trick (sum of biased codes times q, less 8 sum q)
    would otherwise cancel away the last digits of its own scores."""
    q, kn, vn = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    return (q * 0.1 if fmt == "unscaled" else q), kn, vn


FORMATS = ["groups", "mixed", "scalar", "unscaled"]


@pytest.mark.parametrize("pos", [0, 37, 63])
@pytest.mark.parametrize("d,h", [(256, 4), (640, 10), (1280, 20)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_merged_attention_int4_matches_pallas(fmt, d, h, pos):
    """Kernel G (decode_attention_merged over a uint8 cache, nothing stored)."""
    rng = np.random.default_rng(21)
    l_dim, b, ctx, layer = 2, 2, 64, 1
    k, v, sc = _self_cache(rng, fmt, l_dim, b, ctx, d)
    q, kn, vn = _queries(rng, fmt, b, d)
    ref = j_merged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(pos), h,
        jnp.asarray(kn), jnp.asarray(vn), kv_scale4=None if sc is None else jnp.asarray(sc), interpret=True,
    )
    assert ref is not None
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    out = decode_attention_merged_int4(
        torch.from_numpy(q), tk, tv, None if sc is None else torch.from_numpy(sc), layer,
        torch.tensor(pos, dtype=torch.int32), h, torch.from_numpy(kn), torch.from_numpy(vn),
    )
    assert out.shape == (b, 1, d) and out.dtype == torch.float32
    _close_to_scale(out, ref, 1e-5)
    np.testing.assert_array_equal(tk.numpy(), k)  # nothing stored
    np.testing.assert_array_equal(tv.numpy(), v)


@pytest.mark.parametrize("valid", [0, 37, 63])
@pytest.mark.parametrize("d,h", [(256, 4), (640, 10)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_attention_layer_int4_matches_pallas(fmt, d, h, valid):
    """Kernel H (decode_attention_layer over a uint8 cache): the
    unnormalized (acc, m, l), then the flash merge of the current token."""
    rng = np.random.default_rng(22)
    l_dim, b, ctx, layer = 2, 3, 64, 1
    k, v, sc = _self_cache(rng, fmt, l_dim, b, ctx, d)
    q, kn, vn = _queries(rng, fmt, b, d)
    ref = j_layer(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(valid), h,
        kv_scale4=None if sc is None else jnp.asarray(sc), interpret=True,
    )
    assert ref is not None
    out = decode_attention_layer_int4(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), None if sc is None else torch.from_numpy(sc),
        layer, torch.tensor(valid, dtype=torch.int32), h,
    )
    assert [tuple(a.shape) for a in out] == [(b, 1, d), (b, 1, h), (b, 1, h)]
    for a, r in zip(out, ref):
        _close_to_scale(a, r, 1e-5)
    merged = flash_merge_extra_key(*out, torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), h)
    _close_to_scale(merged, j_merge(*ref, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), h), 1e-5)


@pytest.mark.parametrize("case", ["odd heads", "group splits a head", "mixed without scales", "scale width"])
def test_int4_layouts_the_kernels_do_not_serve_raise(case):
    """A uint8 self cache that is not one of the layouts raises ValueError
    on every device, never falls back. Odd head counts (a tensor-parallel
    shard's) and scale groups narrower than a head are layouts the JAX
    package serves, and so does the port since scale-out: those two cases
    give the attention over the dequantized rows."""
    rng = np.random.default_rng(23)
    d, h = 256, 4
    k, v, sc = (torch.from_numpy(a) for a in _self_cache(rng, "groups", 1, 2, 64, d))
    if case == "odd heads":
        d, h = 192, 3
        k, v, sc = (torch.from_numpy(a) for a in _self_cache(rng, "groups", 1, 2, 64, d))
    elif case == "group splits a head":
        sc = torch.rand((1, 2, 64, 16)) * 0.04 + 0.01  # 8 groups of 32 channels
    elif case == "mixed without scales":
        k, sc = torch.zeros((1, 2, 64, d), dtype=torch.int8), None
    else:
        sc = torch.ones((1, 2, 64, 5))
    q, pos = torch.from_numpy(rng.standard_normal((2, 1, d)).astype(np.float32)), torch.tensor(5, dtype=torch.int32)
    if case in ("odd heads", "group splits a head"):
        kf, vf = dequantize_self_rows(k[0], v[0], sc[0], int4_lanes("t", q, k, v, sc, h))
        want = decoder_attention_reference(q, kf, vf, pos, h)
        out = decode_attention_layer_int4(q, k, v, sc, 0, pos, h)
        for a, r in zip(out, want):
            np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-6, atol=1e-6)
        merged = decode_attention_merged_int4(q, k, v, sc, 0, pos, h, q, q)
        np.testing.assert_allclose(merged.numpy(), flash_merge_extra_key(*want, q, q, q, h).numpy(), rtol=1e-6,
                                   atol=1e-6)
        return
    with pytest.raises(ValueError):
        decode_attention_layer_int4(q, k, v, sc, 0, pos, h)
    with pytest.raises(ValueError):
        decode_attention_merged_int4(q, k, v, sc, 0, pos, h, q, q)


def decoder_attention_reference(q, kf, vf, pos, h):
    """(acc, m, l) over float rows ``[B, ctx, D]``: keys below ``pos``."""
    from whisper_burn_tpu_torch.ops.decode_attention import decode_attention_layer_plain

    return decode_attention_layer_plain(q, kf[None], vf[None], None, 0, pos, h)


@pytest.mark.parametrize("d", [64, 256, 640, 1024, 1280, 96])
def test_self_kv_groups_match_jax(d):
    assert decoder.self_kv_group_size(d) == jdec.self_kv_group_size(d)
    assert decoder.self_kv_groups(d) == jdec.self_kv_groups(d)


@pytest.mark.parametrize("d", [256, 640, 1280])
def test_quantize_tokens4_matches_jax(d):
    """Codes exactly, scales to 1e-7 relative; lanes in natural group order."""
    x = np.random.default_rng(24).standard_normal((3, 2, 5, d)).astype(np.float32) * 3
    q, s = decoder._quantize_tokens4(torch.from_numpy(x))
    jq, js = jdec._quantize_tokens4(jnp.asarray(x))
    assert q.dtype == torch.uint8 and tuple(q.shape) == jq.shape == (3, 2, 5, d // 2)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    # read back through the kernels' layout: within half a step of each value
    scales = torch.cat([s, s], -1)
    lanes = int4_lanes("test", torch.zeros((2, 1, d)), q, q, scales, d // 64)
    kf, _ = dequantize_self_rows(q, q, scales, lanes)
    np.testing.assert_allclose(kf.numpy(), x, rtol=0, atol=float(s.max()) * 0.5 + 1e-6)


# --------------------------------------------------------------------------
# the modes' stages and loops against the JAX package


@pytest.fixture(scope="module")
def setup():
    """Both sides' parameters and the JAX side's encoder output, by mode."""
    mel = np.random.default_rng(7).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    out = {}
    for name, (jc, tc) in MODES.items():
        jparams = j_prepare(j_random_params(JCFG, seed=0), jc)
        params = prepare_params(random_params(CFG, seed=0, device="cpu"), tc)
        out[name] = (jparams, params, j_encode(jparams, jnp.asarray(mel), JCFG, jc))
    return mel, out


def _codes(x):
    """Signed codes of a self- or cross-cache tensor: int8 as is, uint8
    nibble pairs unpacked along the last axis."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return np.concatenate([(x & 15).astype(np.int32) - 8, (x >> 4).astype(np.int32) - 8], axis=-1)
    return x.astype(np.int32)


def _assert_codes_agree(ours, ref):
    """Codes agree but for single steps at rounding ties (at most 0.1%)."""
    a, r = _codes(ours), _codes(ref)
    assert np.abs(a - r).max() <= 1
    assert np.mean(a != r) <= 1e-3


def _take(ours: torch.Tensor, ref) -> None:
    ours.copy_(torch.from_numpy(np.array(ref)))


def _caches(setup, mode):
    """Both sides' caches, the cross K/V filled from the JAX encoder output;
    the cross codes agree but for ties, and ours then take the JAX side's."""
    jparams, params, jenc = setup[1][mode]
    jc, tc = MODES[mode]
    jcache = jdec.fill_cross_cache(jparams, JCFG, jenc, jdec.init_cache(JCFG, B, jc, ctx=CTX), jc)
    enc = torch.from_numpy(np.array(jenc))
    cache = fill_cross_cache(params, CFG, enc, init_cache(CFG, B, tc, CTX, "cpu"), tc)
    for name in ("cross_k", "cross_v"):
        _assert_codes_agree(getattr(cache, name), getattr(jcache, name))
        _take(getattr(cache, name), getattr(jcache, name))
    for name in ("cross_k_scale", "cross_v_scale"):
        _close(getattr(cache, name), getattr(jcache, name), 1e-5)
        _take(getattr(cache, name), getattr(jcache, name))
    return jcache, cache


def _prompt(b):
    return np.stack(
        [np.full(b, 50258), np.full(b, CFG.lang_token_start), np.full(b, CFG.transcribe_token),
         np.full(b, CFG.no_timestamps_token)],
        axis=1,
    ).astype(np.int32)


def _self_rows_agree_then_resync(cache, jc, rows):
    """The rows both sides stored: codes but for ties, scales to 1e-5; then
    our self cache takes the JAX side's codes and scales."""
    for name in ("self_k", "self_v"):
        _assert_codes_agree(getattr(cache, name)[:, :, rows], np.asarray(getattr(jc, name))[:, :, rows])
    _close(cache.self_kv_scale[:, :, rows], np.asarray(jc.self_kv_scale)[:, :, rows], 1e-5)
    for name in ("self_k", "self_v", "self_kv_scale"):
        _take(getattr(cache, name), getattr(jc, name))


@pytest.mark.parametrize("mode", list(MODES))
def test_init_cache_matches_jax(mode):
    """The same dtypes, shapes and scale lanes: int4 sides [L, B, ctx, D/2]
    uint8, scales [L, B, ctx, kw + vw] (4 lanes int4self, 3 mixed here)."""
    jc, tc = MODES[mode]
    jcache, cache = jdec.init_cache(JCFG, B, jc, ctx=CTX), init_cache(CFG, B, tc, CTX, "cpu")
    for name in ("self_k", "self_v", "self_kv_scale", "cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
        ours, ref = getattr(cache, name), getattr(jcache, name)
        assert tuple(ours.shape) == ref.shape, name
        assert str(ours.dtype).split(".")[1] == str(ref.dtype), name
    assert cache.self_kv_scale.shape[-1] == {"int4self": 4, "mixed": 3}[mode]
    assert tc.self_kv_storage_dtype == {"int4self": torch.uint8, "mixed": torch.int8}[mode]
    assert tc.self_v_storage_dtype == torch.uint8


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_and_teacher_forced_decode_match_jax(setup, mode):
    """Prefill logits, then STEPS teacher-forced greedy-branch decode steps
    (kernel G, C, the deferred slot writes) against the JAX package's flash
    path, each at 1e-4, and the self-cache rows each writes."""
    jparams, params, _ = setup[1][mode]
    jcompute, compute = MODES[mode]
    jcache, cache = _caches(setup, mode)
    prompt = _prompt(B)
    jlogits, jc = jdec.prefill(jparams, JCFG, jnp.asarray(prompt), jcache, jcompute)
    logits = prefill(params, CFG, torch.from_numpy(prompt).long(), cache, compute)
    _close(logits, jlogits, 1e-4)
    diffs = [_max_diff(logits, jlogits)]
    _self_rows_agree_then_resync(cache, jc, slice(0, 4))
    assert jdec._flash_supported(JCFG, jc, jcompute)  # the JAX step is _decode_step_flash
    forced = np.random.default_rng(9).integers(0, CFG.n_vocab, (STEPS, B)).astype(np.int32)
    step = jax.jit(jdec.decode_step, static_argnums=(1, 5))
    for k in range(STEPS):
        pos = 4 + k
        jlogits, jc = step(jparams, JCFG, jnp.asarray(forced[k]), jnp.asarray(pos), jc, jcompute)
        logits = decode_step(params, CFG, torch.from_numpy(forced[k]).long(), torch.tensor(pos, dtype=torch.int32),
                             cache, compute)
        _close(logits, jlogits, 1e-4)
        diffs.append(_max_diff(logits, jlogits))
        _self_rows_agree_then_resync(cache, jc, slice(pos, pos + 1))
    print(f"{mode}: prefill {diffs[0]:.3g}, teacher-forced steps {max(diffs[1:]):.3g}")


@pytest.mark.parametrize("mode", list(MODES))
def test_grouped_decode_steps_match_jax(setup, mode):
    """Teacher-forced steps with batch_groups=G (beam search's branch:
    kernel H and the flash merge, grouped C, the deferred slot writes) on
    the prefilled self caches repeated G-fold; logits at 1e-4."""
    jparams, params, _ = setup[1][mode]
    jcompute, compute = MODES[mode]
    jcache, cache = _caches(setup, mode)
    prompt = _prompt(B)
    _, jc = jdec.prefill(jparams, JCFG, jnp.asarray(prompt), jcache, jcompute)
    prefill(params, CFG, torch.from_numpy(prompt).long(), cache, compute)
    rep = lambda a: jnp.repeat(a, G, axis=1)
    jc = jc._replace(self_k=rep(jc.self_k), self_v=rep(jc.self_v), self_kv_scale=rep(jc.self_kv_scale))
    cache.self_k, cache.self_v, cache.self_kv_scale = (
        torch.from_numpy(np.array(a)) for a in (jc.self_k, jc.self_v, jc.self_kv_scale)
    )
    forced = np.random.default_rng(11).integers(0, CFG.n_vocab, (STEPS, B * G)).astype(np.int32)
    step = jax.jit(jdec.decode_step, static_argnums=(1, 5, 6))
    diffs = []
    for k in range(STEPS):
        pos = 4 + k
        jlogits, jc = step(jparams, JCFG, jnp.asarray(forced[k]), jnp.asarray(pos), jc, jcompute, G)
        logits = decode_step(params, CFG, torch.from_numpy(forced[k]).long(), torch.tensor(pos, dtype=torch.int32),
                             cache, compute, batch_groups=G)
        assert logits.shape == (B * G, CFG.n_vocab_padded)
        _close(logits, jlogits, 1e-4)
        diffs.append(_max_diff(logits, jlogits))
        _self_rows_agree_then_resync(cache, jc, slice(pos, pos + 1))
    print(f"{mode}: grouped teacher-forced steps {max(diffs):.3g}")


@pytest.mark.parametrize("mode", list(MODES))
def test_greedy_decode_matches_jax(setup, mode):
    mel, by_mode = setup
    jparams, params, _ = by_mode[mode]
    jcompute, compute = MODES[mode]
    lang = np.full(B, CFG.lang_token_start, np.int32)
    ref = j_greedy(jparams, JCFG, jnp.asarray(mel), jnp.asarray(lang), jcompute, max_tokens=STEPS)
    out = greedy_decode(params, CFG, torch.from_numpy(mel.copy()), torch.from_numpy(lang), compute, max_tokens=STEPS)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))


@pytest.mark.parametrize("mode", list(MODES))
def test_beam_decode_matches_jax(mode):
    """Beam search, W=3, the EOT row scaled by 2.5 on both sides so
    hypotheses are banked before the cap (tests/test_torch_beam.py); tokens,
    lengths and language tokens equal, scores to 1e-4, the port on one CPU
    thread (tests/test_torch_beam.py says why)."""
    jcompute, compute = MODES[mode]
    mel = np.random.default_rng(1).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    lang = np.full(B, CFG.lang_token_start, np.int32)
    jparams = j_random_params(JCFG, seed=0)
    jparams["decoder"]["tok_emb"][EOT] *= 2.5
    params = random_params(CFG, seed=0, device="cpu")
    params["decoder"]["tok_emb"][EOT] *= 2.5
    kw = dict(beam_width=G, max_tokens=10)
    ref = j_beam(j_prepare(jparams, jcompute), JCFG, jnp.asarray(mel), jnp.asarray(lang), jcompute, **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = beam_decode(prepare_params(params, compute), CFG, torch.from_numpy(mel), torch.from_numpy(lang),
                          compute, **kw)
    finally:
        torch.set_num_threads(threads)
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
    np.testing.assert_array_equal(out.lang_tokens.numpy(), np.asarray(ref.lang_tokens))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-4)
    print(f"{mode} beam: tokens {out.n_generated.tolist()}, scores differ by "
          f"{np.abs(out.scores.numpy() - np.asarray(ref.scores)).max():.3g}")


@pytest.mark.parametrize("mode,lanes", [("int4self", 20), ("mixed", 11)])
def test_beam_reorder_carries_packed_caches(mode, lanes):
    """The beam's reorder (kernel F's beam form, plain version) gathers a
    uint8 self cache (int8 keys in the mixed mode) and its Large-V3 scale
    lanes (20 int4self, 11 mixed) whole into the other buffer of the pair:
    each stream takes its parent's rows below pos and its parent's new row
    at pos, dtypes and lanes unchanged."""
    _, compute = MODES[mode]
    cfg = WhisperConfig.large_v3().replace(n_text_layer=2)
    cache, other = (init_cache(cfg, 4, compute, 8, "cpu") for _ in range(2))
    assert cache.self_kv_scale.shape == (2, 4, 8, lanes)
    g = torch.Generator().manual_seed(0)
    for name in ("self_k", "self_v"):
        t = getattr(cache, name)
        t.copy_(torch.randint(0, 256, t.shape, generator=g).to(t.dtype))
    cache.self_kv_scale.copy_(torch.rand(cache.self_kv_scale.shape, generator=g))
    before = {n: getattr(cache, n).clone() for n in ("self_k", "self_v", "self_kv_scale")}
    rows = tuple(torch.randint(0, 256, (2, 4, 1, t.shape[-1]), generator=g).to(t.dtype) for t in before.values())
    src, pos = torch.tensor([1, 1, 3, 2]), 5
    reorder_self_cache(other, cache, rows, src.to(torch.int32), torch.tensor(pos, dtype=torch.int32))
    for (name, old), row in zip(before.items(), rows):
        new = getattr(other, name)
        assert new.dtype == old.dtype and new.shape == old.shape
        assert torch.equal(new[:, :, :pos], old[:, src, :pos])
        assert torch.equal(new[:, :, pos], row[:, src, 0])
