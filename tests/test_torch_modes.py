"""The unquantized and int8 cache modes of the PyTorch port against the JAX
package, on the CPU in f32, at the small config of tests/test_torch_slice.py.

* The plain versions of kernels B' (merged self-attention over a float
  cache, no store), E' (unnormalized attention over a float cache, no
  scales) and C' (cross-attention over an int8 or float cache in the
  transposed-key layout, grouped or not) against the Pallas kernels they
  replace, in interpret mode, at 1e-5.
* ``Compute.parity()`` (f32 caches) and ``Compute.fastest()`` (int8 cross
  cache with per-channel scales, int8 self cache) in f32, stage by stage:
  the cross-KV fill from the same encoder output, prefill and
  teacher-forced decode steps, grouped steps (beam search's branch), each
  at 1e-4; greedy tokens equal end to end.
* Beam search in ``parity()``: tokens and lengths equal, scores to 1e-4,
  the port on one CPU thread (tests/test_torch_beam.py says why).

An int8 self-cache code at a rounding tie moves one step between the two
frameworks and then every later logit, so the int8 mode's steps start
from the JAX side's self cache and hold the rows both sides store to
agree but for such single steps."""

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
from whisper_burn_tpu.ops.pallas_attention import decode_attention_kT
from whisper_burn_tpu.ops.pallas_attention import decode_attention_layer as j_layer
from whisper_burn_tpu.ops.pallas_attention import decode_attention_merged as j_merged
from whisper_burn_tpu.ops.pallas_attention import flash_merge_extra_key as j_merge
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models.beam import beam_decode
from whisper_burn_tpu_torch.models.config import EOT, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import decode_step, fill_cross_cache, init_cache, prefill
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer,
    decode_attention_merged,
    decode_cross_attention,
    flash_merge_extra_key,
)
from whisper_burn_tpu_torch.transcribe import prepare_params

SMALL = dict(
    n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4,
    n_audio_ctx=128, n_text_ctx=64,
)
JCFG = JConfig.tiny_test().replace(**SMALL)
CFG = WhisperConfig.tiny_test().replace(**SMALL)
_F32 = dict(dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS)
MODES = {  # name: (JAX compute, port compute), both in f32
    "parity": (JCompute.parity().replace(backend=KernelBackend.PALLAS), Compute.parity()),
    "int8": (JCompute.fastest(kv_bits=8).replace(**_F32), Compute.fastest().replace(dtype=torch.float32)),
}
B, CTX, STEPS, G = 2, 64, 8, 3


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


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
# the plain versions of the new kernel forms against the Pallas kernels


def _float_cache(rng, l_dim, b, ctx, d):
    return tuple(rng.standard_normal((l_dim, b, ctx, d)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("pos", [0, 37, 63])
def test_merged_attention_float_cache_matches_pallas(pos):
    """Kernel B' (decode_attention_merged without kq/vq or scales)."""
    rng = np.random.default_rng(12)
    l_dim, b, ctx, d, h, layer = 2, 2, 64, 256, 4, 1
    kc, vc = _float_cache(rng, l_dim, b, ctx, d)
    q, kn, vn = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    ref = j_merged(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(layer), jnp.asarray(pos), h,
        jnp.asarray(kn), jnp.asarray(vn), interpret=True,
    )
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = decode_attention_merged(
        torch.from_numpy(q), tk, tv, layer, torch.tensor(pos, dtype=torch.int32), h, torch.from_numpy(kn),
        torch.from_numpy(vn),
    )
    assert out.shape == (b, 1, d) and out.dtype == torch.float32
    _close(out, ref, 1e-5)
    np.testing.assert_array_equal(tk.numpy(), kc)  # nothing stored
    np.testing.assert_array_equal(tv.numpy(), vc)


# ctx 64 is one key tile of the Pallas kernel; ctx 96 is three 32-key tiles
@pytest.mark.parametrize("ctx,valid", [(64, 1), (64, 37), (64, 64), (96, 1), (96, 37), (96, 96)])
def test_attention_layer_unscaled_matches_pallas(ctx, valid):
    """Kernel E' (decode_attention_layer with kv_scale4=None): the
    unnormalized (acc, m, l), then the flash merge of the current token."""
    rng = np.random.default_rng(13)
    l_dim, b, d, h, layer = 2, 3, 256, 4, 1
    kc, vc = _float_cache(rng, l_dim, b, ctx, d)
    q, kn, vn = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    ref = j_layer(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(layer), jnp.asarray(valid), h,
                  interpret=True)
    out = decode_attention_layer(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc), None, layer,
        torch.tensor(valid, dtype=torch.int32), h,
    )
    assert [tuple(a.shape) for a in out] == [(b, 1, d), (b, 1, h), (b, 1, h)]
    for a, r in zip(out, ref):
        _close(a, r, 1e-5)
    merged = flash_merge_extra_key(*out, torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), h)
    _close(merged, j_merge(*ref, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), h), 1e-5)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("valid", [100, 128])
@pytest.mark.parametrize("cache", ["int8", "f32"])
def test_cross_attention_unpacked_matches_pallas(cache, valid, groups):
    """Kernel C' (_kt_kernel's unpacked branch, normalized): keys
    [L, B, D, T], values [L, B, T, D]; stream b reads entry b // groups."""
    rng = np.random.default_rng(14)
    l_dim, b, t, d, h, layer = 2, 2, 128, 256, 4, 1
    if cache == "int8":
        kT = rng.integers(-127, 128, (l_dim, b, d, t), dtype=np.int8)
        v = rng.integers(-127, 128, (l_dim, b, t, d), dtype=np.int8)
        q = (rng.standard_normal((b * groups, 1, d)) * 0.003).astype(np.float32)
    else:
        kT = rng.standard_normal((l_dim, b, d, t)).astype(np.float32)
        v = rng.standard_normal((l_dim, b, t, d)).astype(np.float32)
        q = rng.standard_normal((b * groups, 1, d)).astype(np.float32)
    ref, _, _ = decode_attention_kT(
        jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(valid), h,
        batch_groups=groups, interpret=True, normalized=True,
    )
    out = decode_cross_attention(
        torch.from_numpy(q), torch.from_numpy(kT), torch.from_numpy(v), layer, valid, h, batch_groups=groups
    )
    _close(out, ref, 1e-5)


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


def _caches(setup, mode):
    """Both sides' caches, the cross K/V filled from the JAX encoder output."""
    jparams, params, jenc = setup[1][mode]
    jc, tc = MODES[mode]
    jcache = j_fill(jparams, JCFG, jenc, j_init_cache(JCFG, B, jc, ctx=CTX), jc)
    enc = torch.from_numpy(np.array(jenc))
    cache = fill_cross_cache(params, CFG, enc, init_cache(CFG, B, tc, CTX, "cpu"), tc)
    return jcache, cache


def _prompt(b):
    return np.stack(
        [np.full(b, 50258), np.full(b, CFG.lang_token_start), np.full(b, CFG.transcribe_token),
         np.full(b, CFG.no_timestamps_token)],
        axis=1,
    ).astype(np.int32)


def _assert_self_rows_agree(cache, jc, rows):
    """Self-cache rows: float values to 1e-4; int8 codes agree but for
    single steps at rounding ties (at most 0.1% of them), scales to 1e-5."""
    if cache.self_kv_scale is None:
        _close(cache.self_k[:, :, rows], jc.self_k[:, :, rows], 1e-4)
        _close(cache.self_v[:, :, rows], jc.self_v[:, :, rows], 1e-4)
        return
    for ours, ref in ((cache.self_k, jc.self_k), (cache.self_v, jc.self_v)):
        a = ours[:, :, rows].numpy().astype(np.int32)
        r = np.asarray(ref[:, :, rows]).astype(np.int32)
        assert np.abs(a - r).max() <= 1
        assert np.mean(a != r) <= 1e-3
    _close(cache.self_kv_scale[:, :, rows], jc.self_kv_scale[:, :, rows], 1e-5)


def _resync(cache, jc):
    """An int8 self cache takes the JAX side's codes and scales."""
    if cache.self_kv_scale is not None:
        for ours, ref in ((cache.self_k, jc.self_k), (cache.self_v, jc.self_v), (cache.self_kv_scale, jc.self_kv_scale)):
            ours.copy_(torch.from_numpy(np.array(ref)))


@pytest.mark.parametrize("mode", list(MODES))
def test_init_and_fill_cross_cache_match_jax(setup, mode):
    """The same layouts and dtypes; int8 codes equal and scales to 1e-6,
    float values to 1e-4."""
    jcache, cache = _caches(setup, mode)
    for name in ("self_k", "self_v", "cross_k", "cross_v", "self_kv_scale", "cross_k_scale", "cross_v_scale"):
        ours, ref = getattr(cache, name), getattr(jcache, name)
        assert (ours is None) == (ref is None), name
        if ours is not None:
            assert tuple(ours.shape) == ref.shape, name
            assert str(ours.dtype).split(".")[1] == str(ref.dtype), name
    if cache.cross_k_scale is None:
        _close(cache.cross_k, jcache.cross_k, 1e-4)
        _close(cache.cross_v, jcache.cross_v, 1e-4)
    else:
        np.testing.assert_array_equal(cache.cross_k.numpy(), np.asarray(jcache.cross_k))
        np.testing.assert_array_equal(cache.cross_v.numpy(), np.asarray(jcache.cross_v))
        _close(cache.cross_k_scale, jcache.cross_k_scale, 1e-6)
        _close(cache.cross_v_scale, jcache.cross_v_scale, 1e-6)


@pytest.mark.parametrize("mode", list(MODES))
def test_prefill_and_teacher_forced_decode_match_jax(setup, mode):
    """Prefill logits, then STEPS teacher-forced greedy-branch decode steps
    (kernel B' or B, C', the deferred slot write of a float cache), each
    at 1e-4, and the self-cache rows each writes."""
    jparams, params, _ = setup[1][mode]
    jcompute, compute = MODES[mode]
    jcache, cache = _caches(setup, mode)
    prompt = _prompt(B)
    jlogits, jc = j_prefill(jparams, JCFG, jnp.asarray(prompt), jcache, jcompute)
    logits = prefill(params, CFG, torch.from_numpy(prompt).long(), cache, compute)
    _close(logits, jlogits, 1e-4)
    diffs = [_max_diff(logits, jlogits)]
    _assert_self_rows_agree(cache, jc, slice(0, 4))
    _resync(cache, jc)
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
        _assert_self_rows_agree(cache, jc, slice(pos, pos + 1))
        _resync(cache, jc)
    print(f"{mode}: prefill {diffs[0]:.3g}, teacher-forced steps {max(diffs[1:]):.3g}")


@pytest.mark.parametrize("mode", list(MODES))
def test_grouped_decode_steps_match_jax(setup, mode):
    """Teacher-forced steps with batch_groups=G (beam search's branch: kernel
    E' or E and the flash merge, grouped C', the deferred slot write) on the
    prefilled self caches repeated G-fold; logits at 1e-4."""
    jparams, params, _ = setup[1][mode]
    jcompute, compute = MODES[mode]
    jcache, cache = _caches(setup, mode)
    prompt = _prompt(B)
    _, jc = j_prefill(jparams, JCFG, jnp.asarray(prompt), jcache, jcompute)
    prefill(params, CFG, torch.from_numpy(prompt).long(), cache, compute)
    _assert_self_rows_agree(cache, jc, slice(0, 4))
    rep = lambda a: None if a is None else jnp.repeat(a, G, axis=1)
    jc = jc._replace(self_k=rep(jc.self_k), self_v=rep(jc.self_v), self_kv_scale=rep(jc.self_kv_scale))
    cache.self_k, cache.self_v = (torch.from_numpy(np.array(a)) for a in (jc.self_k, jc.self_v))
    if cache.self_kv_scale is not None:
        cache.self_kv_scale = torch.from_numpy(np.array(jc.self_kv_scale))
    forced = np.random.default_rng(11).integers(0, CFG.n_vocab, (STEPS, B * G)).astype(np.int32)
    step = jax.jit(j_decode_step, static_argnums=(1, 5, 6))
    diffs = []
    for k in range(STEPS):
        pos = 4 + k
        jlogits, jc = step(jparams, JCFG, jnp.asarray(forced[k]), jnp.asarray(pos), jc, jcompute, G)
        logits = decode_step(params, CFG, torch.from_numpy(forced[k]).long(), torch.tensor(pos, dtype=torch.int32),
                             cache, compute, batch_groups=G)
        assert logits.shape == (B * G, CFG.n_vocab_padded)
        _close(logits, jlogits, 1e-4)
        diffs.append(_max_diff(logits, jlogits))
        _assert_self_rows_agree(cache, jc, slice(pos, pos + 1))
        _resync(cache, jc)
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


def test_beam_decode_parity_matches_jax():
    """Beam search, W=3, over f32 caches: the EOT row scaled by 2.5 on both
    sides so hypotheses are banked before the cap (tests/test_torch_beam.py);
    tokens, lengths and language tokens equal, scores to 1e-4."""
    jcompute, compute = MODES["parity"]
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
    assert (out.n_generated < 10).all()  # banked hypotheses won, before the cap
    print(f"parity beam: tokens {out.n_generated.tolist()}, scores differ by "
          f"{np.abs(out.scores.numpy() - np.asarray(ref.scores)).max():.3g}")
