"""The greedy loop's body as a function of device state, against the JAX
package, on the CPU in f32, at the small config of tests/test_torch_slice.py.

``models/whisper.py`` runs greedy decoding as the JAX package's
``lax.while_loop`` does: :func:`greedy_step` is its body over
:class:`GreedyState` (``k``, ``cur``, ``tokens``, ``done``, the cache), with
the position a device int32 that the kernels (here their plain versions)
read. On the card a runner captures the step as a CUDA graph and replays
it (tests/test_torch_cuda.py holds the replay to the eager body); here the
same body runs eagerly.

* One step of the body in each greedy cache mode (parity, fastest int8,
  serving int4 cross, int4 self, mixed) at k = 1, 2, 3 (the MIN_TOKENS
  edge) and 9, from the JAX side's cache state: logits at 1e-4 against
  the JAX ``decode_step`` with the body's EOT suppression; ``k``,
  ``tokens``, ``done`` and ``cur`` exact against the JAX body's update;
  the row written at ``pos`` exactly what ``decode_step`` writes, within
  the mode tests' rule of the JAX side's row, and no other row touched.
* Two requests through one cached runner, its state and caches poisoned
  in between: the JAX package's tokens for each.
* The plain kernels B, B', G and F with a tensor position against the
  formulas they computed with a host int (sliced to the position).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
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

from whisper_burn_tpu_torch.models import whisper as w
from whisper_burn_tpu_torch.models.config import EOT, MIN_TOKENS, WhisperConfig
from whisper_burn_tpu_torch.models.decoder import (
    _quantize_tokens4,
    decode_step,
    init_cache,
)
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.cache import write_cache_slot_plain
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_merged_int4_plain,
    decode_attention_merged_plain,
    decode_self_attention_plain,
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
_SERVING = dict(quantized_logits=True, dtype=torch.float32)
MODES = {  # name: (JAX compute, port compute), both in f32, W8A8 off
    "parity": (JCompute.parity().replace(backend=KernelBackend.PALLAS), Compute.parity()),
    "int8": (JCompute.fastest(kv_bits=8).replace(**_F32), Compute.fastest().replace(dtype=torch.float32)),
    "serving": (
        JCompute.fastest(kv_bits=4).replace(quantized_logits=True, **_F32),
        Compute.fastest(kv_bits=4).replace(**_SERVING),
    ),
    "int4self": (
        JCompute.fastest(kv_bits=4).replace(self_kv_bits=4, quantized_logits=True, **_F32),
        Compute.fastest(kv_bits=4).replace(self_kv_bits=4, **_SERVING),
    ),
    "mixed": (
        JCompute.fastest(kv_bits=4).replace(self_kv_vbits=4, quantized_logits=True, **_F32),
        Compute.fastest(kv_bits=4).replace(self_kv_vbits=4, **_SERVING),
    ),
}
B, CTX, MAX_TOKENS = 2, 64, 12
CACHE_FIELDS = ("self_k", "self_v", "self_kv_scale", "cross_k", "cross_v", "cross_k_scale", "cross_v_scale")
STEP_KS = (1, 2, 3, 9)


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=tol, atol=tol)


def _pos(p: int) -> torch.Tensor:
    return torch.tensor(p, dtype=torch.int32)


def _take(ours: torch.Tensor, ref) -> None:
    ours.copy_(torch.from_numpy(np.array(ref)))


def _codes(x: np.ndarray) -> np.ndarray:
    """Signed codes: int8 as is, uint8 nibble pairs unpacked."""
    if x.dtype == np.uint8:
        return np.concatenate([(x & 15).astype(np.int32) - 8, (x >> 4).astype(np.int32) - 8], axis=-1)
    return x.astype(np.int32)


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


# --------------------------------------------------------------------------
# one step of the body against the JAX decode step and body


def _prompt(b):
    return np.stack(
        [np.full(b, 50258), np.full(b, CFG.lang_token_start), np.full(b, CFG.transcribe_token),
         np.full(b, CFG.no_timestamps_token)],
        axis=1,
    ).astype(np.int32)


@pytest.fixture(scope="module")
def trajectories():
    """By mode: both sides' parameters, a port cache of the JAX cache's
    layout, and the JAX side's teacher-forced trajectory: for each k of
    STEP_KS its cache before step k, and the step's logits and cache
    after it."""
    mel = np.random.default_rng(7).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
    forced = np.random.default_rng(9).integers(0, CFG.n_vocab, (max(STEP_KS) + 1, B)).astype(np.int32)
    out = {}
    for name, (jc, tc) in MODES.items():
        jparams = j_prepare(j_random_params(JCFG, seed=0), jc)
        params = prepare_params(random_params(CFG, seed=0, device="cpu"), tc)
        jenc = j_encode(jparams, jnp.asarray(mel), JCFG, jc)
        jcache = j_fill(jparams, JCFG, jenc, j_init_cache(JCFG, B, jc, ctx=CTX), jc)
        cache = init_cache(CFG, B, tc, CTX, "cpu")
        _, jcache = j_prefill(jparams, JCFG, jnp.asarray(_prompt(B)), jcache, jc)
        step = jax.jit(j_decode_step, static_argnums=(1, 5))
        snaps = {}
        for k in range(1, max(STEP_KS) + 1):
            before = jcache
            jlogits, jcache = step(jparams, JCFG, jnp.asarray(forced[k]), jnp.asarray(w.PROMPT_LEN + k - 1), jcache, jc)
            if k in STEP_KS:
                snaps[k] = (before, np.asarray(jlogits), jcache)
        out[name] = (params, cache, snaps)
    return forced, out


@pytest.mark.parametrize("k", STEP_KS)
@pytest.mark.parametrize("mode", list(MODES))
def test_body_step_matches_jax(trajectories, mode, k):
    forced, by_mode = trajectories
    params, cache, snaps = by_mode[mode]
    compute = MODES[mode][1]
    before, jlogits, after = snaps[k]
    for name in CACHE_FIELDS:  # the JAX side's caches before step k
        if getattr(cache, name) is not None:
            _take(getattr(cache, name), getattr(before, name))
    rng = np.random.default_rng(100 + k)
    tokens = np.full((B, MAX_TOKENS), EOT, np.int32)
    tokens[:, :k] = rng.integers(0, CFG.n_vocab, (B, k))
    done = np.array([False, k == 9])  # a finished stream emits EOT
    state = w.GreedyState(
        k=torch.tensor(k, dtype=torch.int32), cur=torch.from_numpy(forced[k]).long(),
        tokens=torch.from_numpy(tokens.copy()), done=torch.from_numpy(done.copy()), cache=cache,
    )
    pos = w.PROMPT_LEN + k - 1
    fresh = {n: getattr(cache, n).clone() for n in ("self_k", "self_v", "self_kv_scale") if getattr(cache, n) is not None}
    logits = w.greedy_step(params, CFG, state, compute)

    # the JAX body (whisper_burn_tpu/models/whisper.py:153-163) on the JAX step's logits
    ref = jlogits.copy()
    if k < MIN_TOKENS:
        ref[:, EOT] = -np.inf
    nxt = np.where(done, EOT, ref.argmax(axis=-1)).astype(np.int32)
    tokens[:, k] = nxt
    _close(logits, ref, 1e-4)
    assert int(state.k) == k + 1 and state.k.dtype == torch.int32
    np.testing.assert_array_equal(state.tokens.numpy(), tokens)
    np.testing.assert_array_equal(state.done.numpy(), done | (nxt == EOT))
    np.testing.assert_array_equal(state.cur.numpy(), nxt)

    # the row at pos: what decode_step writes from the same state, exactly;
    # the JAX side's row but for codes at rounding ties; no other row moved
    direct = init_cache(CFG, B, compute, CTX, "cpu")
    for name in CACHE_FIELDS:
        if getattr(direct, name) is not None:
            getattr(direct, name).copy_(fresh.get(name, getattr(cache, name)))
    decode_step(params, CFG, torch.from_numpy(forced[k]).long(), _pos(pos), direct, compute)
    for name, t in fresh.items():
        ours = getattr(cache, name)
        assert torch.equal(ours, getattr(direct, name)), name
        others = torch.ones(CTX, dtype=torch.bool)
        others[pos] = False
        assert torch.equal(ours[:, :, others], t[:, :, others]), name
        row, jrow = ours[:, :, pos].numpy(), np.asarray(getattr(after, name))[:, :, pos]
        if name == "self_kv_scale":
            _close(row, jrow, 1e-5)
        elif row.dtype in (np.int8, np.uint8):
            diff = np.abs(_codes(row) - _codes(jrow))
            assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, name
        else:
            _close(row, jrow, 1e-4)


# --------------------------------------------------------------------------
# two requests through one cached runner


@pytest.mark.parametrize("mode", ["int8", "serving"])
def test_reused_runner_gives_jax_tokens_twice(mode):
    """The second request reuses the first one's runner (cache and state
    filled in place) after its state, the self cache's rows past the
    prompt and the cross cache (pad columns and scales too) were set to
    garbage: both give the JAX package's greedy tokens."""
    jc, tc = MODES[mode]
    jparams = j_prepare(j_random_params(JCFG, seed=0), jc)
    params = prepare_params(random_params(CFG, seed=0, device="cpu"), tc)
    lang = np.full(B, CFG.lang_token_start, np.int32)
    w.clear_runners()
    runners = []
    for r, seed in enumerate((7, 8)):
        mel = np.random.default_rng(seed).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)
        ref = j_greedy(jparams, JCFG, jnp.asarray(mel), jnp.asarray(lang), jc, max_tokens=MAX_TOKENS)
        out = w.greedy_decode(params, CFG, torch.from_numpy(mel), torch.from_numpy(lang), tc, max_tokens=MAX_TOKENS)
        np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
        runners.append(w.cached_runners())
        state = runners[-1][0].state
        assert out.tokens.data_ptr() != state.tokens.data_ptr()  # the result outlives the runner's buffer
        if r == 0:  # poison everything the next request must overwrite or never read
            state.k.fill_(40)
            state.cur.fill_(7)
            state.tokens.fill_(3)
            state.done.fill_(True)
            c = state.cache
            for t in (c.self_k, c.self_v):
                t[:, :, w.PROMPT_LEN :] = 5
            if c.self_kv_scale is not None:
                c.self_kv_scale[:, :, w.PROMPT_LEN :] = 3.0
            for t in (c.cross_k, c.cross_v, c.cross_k_scale, c.cross_v_scale):
                if t is not None:
                    t.fill_(9)
    assert len(runners[0]) == len(runners[1]) == 1 and runners[0][0] is runners[1][0]
    w.clear_runners()


def test_positions_past_the_self_cache_raise():
    """The loop checks its last position against the self cache once per
    request (the step never reads it on the host)."""
    params = prepare_params(random_params(CFG, seed=0, device="cpu"), Compute.parity())
    mel = torch.zeros((B, CFG.n_mels, 2 * CFG.n_audio_ctx))
    with pytest.raises(ValueError, match="overrun"):
        w.greedy_decode(params, CFG, mel, torch.full((B,), CFG.lang_token_start), Compute.parity(), max_tokens=62)


# --------------------------------------------------------------------------
# the plain kernels with a tensor position against their host-int formulas


def _sliced_attention(q, kf, vf, ks, vs, pos, h):
    """The plain self-attention as it was computed with a host int: keys
    ``t < pos`` sliced, the current token's raw K/V merged after."""
    b, _, d = q.shape
    dh = d // h
    qf = q.float().reshape(b, h, dh)
    kf = kf[:, :pos].float().reshape(b, pos, h, dh)
    vf = vf[:, :pos].float().reshape(b, pos, h, dh)
    s = torch.einsum("bhd,bthd->bht", qf, kf) * (1.0 / math.sqrt(dh))
    if ks is not None:
        s = s * ks[:, None, :pos]
    m = torch.full((b, h), -1e30)
    if pos:
        m = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    pv = p if vs is None else p * vs[:, None, :pos]
    acc = torch.einsum("bht,bthd->bhd", pv, vf)
    return acc.reshape(b, 1, d), m[:, None], p.sum(dim=-1)[:, None]


def _int_and_tensor_agree(out, ref):
    """The tensor form sums over the whole cache with the masked keys at 0,
    the int form over ``pos`` keys: the same terms in another order."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert (out - ref).abs().max().item() <= 1e-6 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("pos", [0, 1, 37, 63])
def test_plain_kernels_with_a_tensor_position(pos):
    rng = np.random.default_rng(30 + pos)
    l_dim, b, ctx, d, h, layer = 2, 2, 64, 256, 4, 1
    q, kn, vn = (torch.from_numpy(rng.standard_normal((b, 1, d)).astype(np.float32)) for _ in range(3))
    i8 = lambda *shape: torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))

    # B: int8 cache with per-token scales, the row and scales stored at pos
    kc, vc = i8(l_dim, b, ctx, d), i8(l_dim, b, ctx, d)
    sc = torch.from_numpy(rng.uniform(0.001, 0.02, (l_dim, b, ctx, 2)).astype(np.float32))
    kq, vq = i8(b, 1, d), i8(b, 1, d)
    nsc = torch.from_numpy(rng.uniform(0.001, 0.02, (b, 1, 2)).astype(np.float32))
    caches = (kc.clone(), vc.clone(), sc.clone())
    out = decode_self_attention_plain(q, *caches, layer, _pos(pos), h, kn, vn, kq, vq, nsc)
    state = _sliced_attention(q, kc[layer], vc[layer], sc[layer, ..., 0], sc[layer, ..., 1], pos, h)
    _int_and_tensor_agree(out, flash_merge_extra_key(*state, q, kn, vn, h))
    for t, new in ((kc, kq), (vc, vq), (sc, nsc)):
        t[layer, :, pos] = new[:, 0]
    for a, r in zip(caches, (kc, vc, sc)):
        assert torch.equal(a, r)

    # B': a float cache, nothing stored
    kf, vf = (torch.from_numpy(rng.standard_normal((l_dim, b, ctx, d)).astype(np.float32)) for _ in range(2))
    out = decode_attention_merged_plain(q, kf, vf, layer, _pos(pos), h, kn, vn)
    state = _sliced_attention(q, kf[layer], vf[layer], None, None, pos, h)
    _int_and_tensor_agree(out, flash_merge_extra_key(*state, q, kn, vn, h))

    # G: int4 keys and values with group scales, nothing stored
    k4, ksc = _quantize_tokens4(torch.from_numpy(rng.standard_normal((l_dim, b, ctx, d)).astype(np.float32)))
    v4, vsc = _quantize_tokens4(torch.from_numpy(rng.standard_normal((l_dim, b, ctx, d)).astype(np.float32)))
    sc4 = torch.cat([ksc, vsc], dim=-1)
    out = decode_attention_merged_int4_plain(q, k4, v4, sc4, layer, _pos(pos), h, kn, vn)
    lanes = int4_lanes("G", q, k4, v4, sc4, h)
    kd, vd = dequantize_self_rows(k4[layer, :, :pos], v4[layer, :, :pos], sc4[layer, :, :pos], lanes)
    state = _sliced_attention(q, kd, vd, None, None, pos, h)
    _int_and_tensor_agree(out, flash_merge_extra_key(*state, q, kn, vn, h))

    # F: one slot across layers and streams, exactly the slice assignment
    for dtype in (torch.int8, torch.uint8, torch.float32):
        cache = torch.from_numpy(rng.integers(0, 100, (l_dim, b, ctx, 24))).to(dtype)
        new = torch.from_numpy(rng.integers(0, 100, (l_dim, b, 1, 24))).to(dtype)
        ref = cache.clone()
        ref[:, :, pos] = new[:, :, 0]
        write_cache_slot_plain(cache, new, _pos(pos))
        assert torch.equal(cache, ref)


def test_pipeline_reuses_its_runners():
    """Repeated calls of one batch shape reuse its runner; a new bucket
    (3 windows -> 4 streams, against a batch of 2) makes one more."""
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    w.clear_runners()
    pipe = WhisperPipeline((CFG, random_params(CFG, seed=0, device="cpu")), compute=Compute.parity(), max_tokens=4,
                           device="cpu")
    rng = np.random.default_rng(3)
    chunk = pipe.chunk_samples
    utterances = [(rng.standard_normal(chunk) * 0.1).astype(np.float32) for _ in range(2)]
    first = pipe.transcribe_batch(utterances, ["en", "en"])
    runners = w.cached_runners()
    assert len(runners) == 1 and runners[0].batch == 2
    again = pipe.transcribe_batch(utterances, ["en", "en"])
    assert w.cached_runners() == runners
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    pipe.transcribe_long((rng.standard_normal(int(2.5 * chunk)) * 0.1).astype(np.float32), language="en")
    assert [r.batch for r in w.cached_runners()] == [2, 4]
    w.clear_runners()
