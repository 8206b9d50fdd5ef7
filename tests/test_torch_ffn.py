"""Kernel I (the fused FFN, ``ops/ffn_kernel.py``) and kernel A's bf16
rounding against the Pallas kernels they replace, on the CPU.

The port's plain versions (what its wrappers take for CPU tensors) against
``pallas_ffn.py``'s K7 (``fused_ffn_pallas``) and K4
(``fused_ffn_pallas_stacked``, fc2's bias added by the caller in the
compute dtype, as the JAX decode step adds it) and ``pallas_q4.py``'s K5
and K1, in interpret mode, on the same seeded numpy inputs:

* f32: within 1e-5 (sums in another order).
* bf16 (``Compute.fast()``): at most 1% of outputs differ, and none by more
  than one bf16 step (a sum that lands near a rounding tie may round the
  other way). Weights round as the Pallas kernels round them,
  ``bf16(code x bf16(scale))``.
* The two faults this replaced stay visible: dequantizing in f32 differs
  from the Pallas kernels in more than 25% of bf16 outputs, and K7's bias
  order against K4 in more than 10%.
* Whisper Medium's width (8 rows, 1024 <-> 4096), bf16 and f32, against
  K7 and K4, at the same tolerances.
* The second copy of the weights that kernel I's decode regime reads
  (``unit_layout``): codes and scales where its lanes read them, and its
  mma fragments reproducing the product.
* One prefill and one decode step of a tiny model in ``Compute.fast()``
  against the JAX package's on its Pallas kernels: at ``tiny_test()``
  widths (an F the JAX package does not fuse) and at D = 128 (F = 512,
  which it fuses).

tests/test_torch_cuda.py holds the CUDA kernel against the plain version
on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.decoder import decode_step as j_decode_step
from whisper_burn_tpu.models.decoder import fill_cross_cache as j_fill
from whisper_burn_tpu.models.decoder import init_cache as j_init_cache
from whisper_burn_tpu.models.decoder import prefill as j_prefill
from whisper_burn_tpu.models.encoder import encode as j_encode
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.ops.pallas_ffn import fused_ffn_pallas, fused_ffn_pallas_stacked
from whisper_burn_tpu.ops.pallas_q4 import q4_matmul_pallas, q4_matmul_pallas_stacked
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.gguf.repack import repack_f32
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.decoder import decode_step, init_cache, prefill
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.ffn_kernel import fused_ffn, fused_ffn_plain, unit_layout
from whisper_burn_tpu_torch.ops.linear import apply_ffn, fusable
from whisper_burn_tpu_torch.ops.q4_kernel import q4_matmul
from whisper_burn_tpu_torch.transcribe import prepare_params

PALLAS = KernelBackend.PALLAS
JF32, JBF16 = JCompute.parity().replace(backend=PALLAS), JCompute.fast().replace(backend=PALLAS)
M, D, F, L = 8, 256, 1024, 2
BF = torch.bfloat16


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


def _linear(rng, l_dim, k, n):
    qts = [repack_f32(rng.standard_normal((n, k)).astype(np.float32) * 0.05) for _ in range(l_dim)]
    qws, scs = [qt.qw for qt in qts], [qt.scales for qt in qts]
    b = (rng.standard_normal((l_dim, n)) * 0.01).astype(np.float32)
    return {"qw": np.stack(qws), "scales": np.stack(scs), "b": b}


def _ffn(seed, m=M, d=D, f=F):
    rng = np.random.default_rng(seed)
    fc1, fc2 = _linear(rng, L, d, f), _linear(rng, L, f, d)
    x = (rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    return x, fc1, fc2


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree, layer=None):
    return {k: jnp.asarray(v if layer is None else v[layer]) for k, v in tree.items()}


def _np(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def _bf16_gap(out, ref) -> tuple[float, float]:
    """The share of bf16 outputs that differ, and the largest difference in
    bf16 steps (2^-7 of the larger magnitude's power of two)."""
    a, r = _np(out).astype(np.float64), _np(ref).astype(np.float64)
    mag = np.maximum(np.abs(a), np.abs(r))
    step = np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))) - 7)
    return float(np.mean(a != r)), float(np.max(np.abs(a - r) / step))


def _assert_bf16_match(out, ref):
    share, steps = _bf16_gap(out, ref)
    assert share <= 0.01 and steps <= 1.0, f"{share:.2%} of outputs differ, by up to {steps:g} bf16 steps"


def _k4_ref(x, fc1, fc2, layer, kind, jc, dtype):
    """K4 plus fc2's bias in the compute dtype, as the JAX decode step adds it."""
    y = fused_ffn_pallas_stacked(jnp.asarray(x), _j(fc1), _j(fc2), jnp.asarray(layer), kind, jc, interpret=True)
    return y + jnp.asarray(fc2["b"][layer]).astype(dtype)


def _k7_ref(x, fc1, fc2, layer, kind, jc):
    return fused_ffn_pallas(jnp.asarray(x), _j(fc1, layer), _j(fc2, layer), kind, jc, interpret=True)


@pytest.mark.parametrize("kind", ["tanh", "erf"])
@pytest.mark.parametrize("stacked", [False, True], ids=["k7", "k4"])
def test_fused_ffn_f32_matches_pallas(kind, stacked):
    x, fc1, fc2 = _ffn(2)
    ref = _k4_ref(x, fc1, fc2, 1, kind, JF32, jnp.float32) if stacked else _k7_ref(x, fc1, fc2, 1, kind, JF32)
    out = fused_ffn(torch.from_numpy(x), _t(fc1), _t(fc2), kind, layer=1, bias_after_round=stacked)
    np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["tanh", "erf"])
@pytest.mark.parametrize("stacked", [False, True], ids=["k7", "k4"])
def test_fused_ffn_bf16_matches_pallas(kind, stacked):
    x, fc1, fc2 = _ffn(3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = _k4_ref(xb, fc1, fc2, 0, kind, JBF16, jnp.bfloat16) if stacked else _k7_ref(xb, fc1, fc2, 0, kind, JBF16)
    assert ref.dtype == jnp.bfloat16
    out = fused_ffn(torch.from_numpy(x).to(BF), _t(fc1), _t(fc2), kind, layer=0, bias_after_round=stacked)
    assert out.dtype == BF
    _assert_bf16_match(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("stacked", [False, True], ids=["k7", "k4"])
def test_fused_ffn_medium_width_matches_pallas(dtype, stacked):
    """Whisper Medium's FFN (1024 <-> 4096) at the greedy batch's 8 rows,
    against K7 and K4 in interpret mode, at the tolerances above."""
    x, fc1, fc2 = _ffn(7, 8, 1024, 4096)
    kind = "erf"
    if dtype == torch.float32:
        ref = _k4_ref(x, fc1, fc2, 1, kind, JF32, jnp.float32) if stacked else _k7_ref(x, fc1, fc2, 1, kind, JF32)
        out = fused_ffn(torch.from_numpy(x), _t(fc1), _t(fc2), kind, layer=1, bias_after_round=stacked)
        np.testing.assert_allclose(_np(out), np.asarray(ref, np.float32), rtol=1e-5, atol=1e-5)
    else:
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        ref = _k4_ref(xb, fc1, fc2, 1, kind, JBF16, jnp.bfloat16) if stacked else _k7_ref(xb, fc1, fc2, 1, kind, JBF16)
        out = fused_ffn(torch.from_numpy(x).to(BF), _t(fc1), _t(fc2), kind, layer=1, bias_after_round=stacked)
        assert out.shape == (8, 1024) and out.dtype == BF
        _assert_bf16_match(out, ref)


def test_unit_layout_feeds_the_mma_fragments():
    """The decode regime's copy of the weights (``unit_layout``): each
    16-column unit's 32-row blocks hold their codes where csrc/ffn.cu's
    lanes read them, then their scales; and the mma.sync fragments the
    kernel builds from them (16-row step h: rows 8t + 4h .. 8t + 4h + 3 of
    a block as the mma's k = 2t, 2t+1, 2t+8, 2t+9; n8 tile j: columns 2n +
    j) give x . W, simulated here in f32 with the k permutation applied to
    x as the kernel's 16-byte A loads apply it."""
    rng = np.random.default_rng(8)
    k, n = 64, 48
    qw = rng.integers(-8, 8, (2, k, n)).astype(np.int8)
    sc = rng.random((2, k // 32, n)).astype(np.float32)
    units = unit_layout(torch.from_numpy(qw), torch.from_numpy(sc)).numpy()
    assert units.shape == (2, n // 16, k // 32, 576) and units.dtype == np.uint8
    x = rng.standard_normal((16, k)).astype(np.float32)
    for layer in range(2):
        y = np.zeros((16, n), np.float32)
        for u in range(n // 16):
            for kb in range(k // 32):
                blk = units[layer, u, kb]
                assert np.array_equal(blk[512:].view(np.float32), sc[layer, kb, 16 * u:16 * u + 16])
                codes = blk[:512].view(np.int8).reshape(8, 4, 4, 2, 2)  # lane (g, t), word q, row p, column c
                for g in range(8):
                    for t in range(4):
                        for h in range(2):
                            rows = 32 * kb + 8 * t + 4 * h + np.arange(4)  # the mma's k = 2t, 2t+1, 2t+8, 2t+9
                            for j in range(2):
                                w = codes[g, t, 2 * h:2 * h + 2, :, j].reshape(4)  # rows 8t+4h .. +3, column 2g + j
                                col = 16 * u + 2 * g + j
                                assert np.array_equal(w, qw[layer, rows, col])
                                y[:, col] += x[:, rows] @ (w * sc[layer, kb, col])
        np.testing.assert_allclose(y, x @ (qw[layer].reshape(k // 32, 32, n) * sc[layer][:, None]).reshape(k, n),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fault", ["f32_dequant", "k7_bias_order"])
def test_fused_ffn_bf16_faults_miss_the_bound(fault):
    """The forms this PR replaced differ from the Pallas kernels far beyond
    the bound above: the f32 dequant against K7, K7's bias order against K4."""
    x, fc1, fc2 = _ffn(3)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(BF)
    t1, t2 = _t(fc1), _t(fc2)
    if fault == "f32_dequant":
        ref = _k7_ref(xb, fc1, fc2, 0, "tanh", JBF16)
        deq = lambda p: (p["qw"][0].float().reshape(-1, 32, p["qw"].shape[-1]) * p["scales"][0][:, None]).reshape(p["qw"].shape[1:])
        h = xt.float() @ deq(t1) + t1["b"][0]
        g = (h * 0.5 * (torch.tanh((h + 0.044715 * h * h * h) * 0.7978845608028654) + 1.0)).to(BF)
        old, floor = (g.float() @ deq(t2) + t2["b"][0]).to(BF), 0.25
    else:
        ref = _k4_ref(xb, fc1, fc2, 0, "tanh", JBF16, jnp.bfloat16)
        old, floor = fused_ffn(xt, t1, t2, "tanh", layer=0, bias_after_round=False), 0.10
    share, _ = _bf16_gap(old, ref)
    assert share > floor, f"{fault}: only {share:.2%} of outputs differ"
    _assert_bf16_match(fused_ffn(xt, t1, t2, "tanh", layer=0, bias_after_round=fault == "k7_bias_order"), ref)


def _q4(seed, l_dim, k, n, m):
    rng = np.random.default_rng(seed)
    lin = _linear(rng, l_dim, k, n)
    return rng.standard_normal((m, k)).astype(np.float32), lin["qw"], lin["scales"]


@pytest.mark.parametrize("site", ["k5", "k1", "k5_bias"])
def test_q4_matmul_bf16_matches_pallas(site):
    """Kernel A's plain version in bf16 against K5 (8 x 1024 x 512), K1 (the
    layer-indexed form, 8 x 1280 x 256 at layer 1) and K5 followed by the
    bias in bf16, as the JAX package's linears add it. The f32 dequant and
    the bias added to the f32 sum, which this replaced, miss the bound."""
    layer = int(site == "k1")
    x, qw, sc = _q4(4, 1, 1024, 512, 8) if site != "k1" else _q4(5, 2, 1280, 256, 8)
    b = (np.random.default_rng(6).standard_normal(qw.shape[-1]) * 0.5).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    if site == "k1":
        ref = q4_matmul_pallas_stacked(xb, jnp.asarray(qw), jnp.asarray(sc), jnp.asarray(1), JBF16, interpret=True)
        out = q4_matmul(torch.from_numpy(x).to(BF), torch.from_numpy(qw), torch.from_numpy(sc), layer=1)
    else:
        ref = q4_matmul_pallas(xb, jnp.asarray(qw[0]), jnp.asarray(sc[0]), JBF16, interpret=True)
        bias = torch.from_numpy(b) if site == "k5_bias" else None
        if bias is not None:
            ref = ref + jnp.asarray(b).astype(jnp.bfloat16)
        out = q4_matmul(torch.from_numpy(x).to(BF), torch.from_numpy(qw[0]), torch.from_numpy(sc[0]), bias=bias)
    assert ref.dtype == jnp.bfloat16 and out.dtype == BF
    _assert_bf16_match(out, ref)
    # the forms this replaced: the weights dequantized in f32; the bias in the f32 sum
    w = torch.from_numpy(qw[layer]).float().reshape(-1, 32, qw.shape[-1]) * torch.from_numpy(sc[layer])[:, None]
    old = torch.from_numpy(x).to(BF).float() @ w.reshape(qw.shape[1:])
    if site == "k5_bias":
        w16 = w.to(BF).float().reshape(qw.shape[1:])
        old = torch.from_numpy(x).to(BF).float() @ w16 + torch.from_numpy(b)
    share, _ = _bf16_gap(old.to(BF), ref)
    assert share > (0.10 if site == "k5_bias" else 0.25), f"the old form differs in only {share:.2%} of outputs"


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_apply_ffn_takes_fused_ffn_plain(dtype):
    """Below LARGE_M rows with Q4 weights apply_ffn is kernel I; on CPU
    tensors its plain version, bit for bit. An F the JAX package does not
    fuse (not a multiple of 512) takes the two linears instead."""
    x, fc1, fc2 = _ffn(6)
    bp = {"fc1": _t(fc1), "fc2": _t(fc2)}
    compute = Compute.parity() if dtype == torch.float32 else Compute.fast()
    xt = torch.from_numpy(x)
    assert fusable(bp["fc1"], bp["fc2"])
    out = apply_ffn(bp, xt, "erf", compute, layer=1, bias_after_round=True)
    p1, p2 = ({k: v[1] for k, v in bp[n].items()} for n in ("fc1", "fc2"))
    ref = fused_ffn_plain(xt.to(dtype), p1["qw"], p1["scales"], p1["b"], p2["qw"], p2["scales"], p2["b"], "erf", True)
    assert out.dtype == dtype and torch.equal(out, ref)
    narrow = {"fc1": {k: v[..., :256] for k, v in bp["fc1"].items()},
              "fc2": {"qw": bp["fc2"]["qw"][:, :256], "scales": bp["fc2"]["scales"][:, :8], "b": bp["fc2"]["b"]}}
    assert not fusable(narrow["fc1"], narrow["fc2"])
    assert apply_ffn(narrow, xt, "tanh", compute, layer=0).shape == (M, D)


# --------------------------------------------------------------------------
# one prefill and one decode step of a tiny model in bf16 against JAX

CONFIGS = {"tiny": {}, "tiny_d128": dict(n_audio_state=128, n_text_state=128)}
B, CTX = 2, 16
CACHE_FIELDS = ("self_k", "self_v", "self_kv_scale", "cross_k", "cross_v", "cross_k_scale", "cross_v_scale")
# f32 logits of |x| < 1 from bf16 hidden states; the gap left comes from the
# layers outside the FFN and the linears (LayerNorm, attention, residuals in
# bf16, sums in another order): measured 4.8e-3 to 7.3e-3 (5.8e-3 to 8.3e-3
# before the weights and fc2's bias were rounded as the Pallas kernels do)
LOGIT_TOL = 1e-2


def _take(cache, jcache):
    for name in CACHE_FIELDS:
        if getattr(cache, name) is not None:
            getattr(cache, name).copy_(torch.from_numpy(np.array(getattr(jcache, name).astype(jnp.float32))))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tiny_prefill_and_step_bf16_match_jax(name):
    """``Compute.fast()``: the JAX package's prefill and decode step on its
    Pallas kernels (K4 in the step and K7 in the prefill where it fuses the
    FFN) against the port's, each side starting from the JAX side's caches."""
    jcfg, cfg = JConfig.tiny_test().replace(**CONFIGS[name]), WhisperConfig.tiny_test().replace(**CONFIGS[name])
    assert fusable({"qw": torch.zeros(cfg.n_text_state, cfg.ffn_dim), "scales": 0, "b": 0},
                   {"qw": torch.zeros(cfg.ffn_dim, cfg.n_text_state), "scales": 0, "b": 0}) == (name != "tiny")
    jc, tc = JBF16, Compute.fast()
    mel = np.random.default_rng(7).standard_normal((B, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    prompt = np.array([[50258, cfg.lang_token_start, cfg.transcribe_token, cfg.no_timestamps_token]] * B, np.int32)
    token = np.random.default_rng(9).integers(0, cfg.n_vocab, B).astype(np.int32)
    jparams = j_prepare(j_random_params(jcfg, seed=0), jc)
    params = prepare_params(random_params(cfg, seed=0, device="cpu"), tc)
    jenc = j_encode(jparams, jnp.asarray(mel), jcfg, jc)
    jcache = j_fill(jparams, jcfg, jenc, j_init_cache(jcfg, B, jc, ctx=CTX), jc)
    cache = init_cache(cfg, B, tc, CTX, "cpu")
    _take(cache, jcache)
    jlog, jcache = j_prefill(jparams, jcfg, jnp.asarray(prompt), jcache, jc)
    log = prefill(params, cfg, torch.from_numpy(prompt), cache, tc)
    _take(cache, jcache)
    jstep, _ = j_decode_step(jparams, jcfg, jnp.asarray(token), jnp.asarray(4), jcache, jc)
    step = decode_step(params, cfg, torch.from_numpy(token), torch.tensor(4, dtype=torch.int32), cache, tc)
    for what, ours, ref in (("prefill", log, jlog), ("step", step, jstep)):
        ref = np.asarray(ref, np.float32)
        live = np.isfinite(ref)
        ours = _np(ours)
        assert np.array_equal(np.isfinite(ours), live)
        gap = float(np.max(np.abs(ours[live] - ref[live])))
        print(f"{name} {what}: max abs logit difference {gap:g} (max |logit| {np.max(np.abs(ref[live])):g})")
        assert gap <= LOGIT_TOL, f"{name} {what}: logits differ by {gap:g}"
