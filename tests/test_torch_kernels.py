"""Each kernel module of the PyTorch port against the JAX Pallas kernel it
replaces, on the CPU: the port's plain versions (what its wrappers take for
CPU tensors) against the Pallas kernels in interpret mode, in f32, on the
same numpy inputs. The CUDA kernels are held against the same plain
versions on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.ops.pallas_attention import decode_attention_kT, decode_attention_layer as j_layer
from whisper_burn_tpu.ops.pallas_attention import decode_attention_merged
from whisper_burn_tpu.ops.pallas_attention import flash_merge_extra_key as j_merge
from whisper_burn_tpu.ops.pallas_cache import write_cache_slot as j_write_slot
from whisper_burn_tpu.ops.pallas_encoder_attention import encoder_attention_packed
from whisper_burn_tpu.ops.pallas_ffn import fused_ffn_pallas, fused_ffn_pallas_stacked
from whisper_burn_tpu.ops.pallas_q4 import q4_matmul_pallas, q4_matmul_pallas_stacked
from whisper_burn_tpu.ops.q4_matmul import q4_matmul as j_q4_matmul

from whisper_burn_tpu_torch.gguf.repack import repack_f32
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.ops.cache import write_cache_slot
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer,
    decode_cross_attention,
    decode_cross_attention_plain,
    decode_cross_attention_ties,
    decode_self_attention,
    flash_merge_extra_key,
)
from whisper_burn_tpu_torch.ops.encoder_attention import encoder_attention
from whisper_burn_tpu_torch.ops.linear import apply_ffn
from whisper_burn_tpu_torch.ops.q4_kernel import q4_matmul
from whisper_burn_tpu_torch.ops.q4_matmul import LARGE_M
from whisper_burn_tpu_torch.ops.q4_matmul import q4_matmul as q4_dispatch

JC = JCompute.parity().replace(backend=KernelBackend.PALLAS)
TC = Compute.parity()
RTOL = 1e-5  # f32 on both sides; sums taken in another order
ATOL = 1e-5


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), rtol=rtol, atol=atol)


def _linear(rng, l_dim, k, n):
    qts = [repack_f32(rng.standard_normal((n, k)).astype(np.float32) * 0.05) for _ in range(l_dim)]
    qws, scs = [qt.qw for qt in qts], [qt.scales for qt in qts]
    b = (rng.standard_normal((l_dim, n)) * 0.01).astype(np.float32)
    return np.stack(qws), np.stack(scs), b


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("m,k,n", [(5, 256, 768), (16, 512, 256)])
def test_q4_matmul_matches_pallas(m, k, n):
    rng = np.random.default_rng(0)
    qw, sc, _ = _linear(rng, 1, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = q4_matmul_pallas(jnp.asarray(x), jnp.asarray(qw[0]), jnp.asarray(sc[0]), JC, interpret=True)
    out = q4_matmul(torch.from_numpy(x), torch.from_numpy(qw[0]), torch.from_numpy(sc[0]))
    _close(out, ref)


@pytest.mark.parametrize("layer", [0, 2])
def test_q4_matmul_stacked_matches_pallas(layer):
    rng = np.random.default_rng(1)
    qw, sc, _ = _linear(rng, 3, 256, 768)
    x = rng.standard_normal((2, 1, 256)).astype(np.float32)
    ref = q4_matmul_pallas_stacked(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(sc), jnp.asarray(layer), JC, interpret=True
    )
    out = q4_matmul(torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(sc), layer=layer)
    assert out.shape == (2, 1, 768)
    _close(out, ref)


def _ffn(seed, l_dim, d=256, f=1024):
    rng = np.random.default_rng(seed)
    q1, s1, b1 = _linear(rng, l_dim, d, f)
    q2, s2, b2 = _linear(rng, l_dim, f, d)
    x = (rng.standard_normal((3, d)) * 0.5).astype(np.float32)
    return x, {"qw": q1, "scales": s1, "b": b1}, {"qw": q2, "scales": s2, "b": b2}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree, layer=None):
    return {k: jnp.asarray(v if layer is None else v[layer]) for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["tanh", "erf"])
def test_ffn_matches_pallas(kind):
    x, fc1, fc2 = _ffn(2, 1)
    ref = fused_ffn_pallas(jnp.asarray(x), _j(fc1, 0), _j(fc2, 0), kind, JC, interpret=True)
    out = apply_ffn({"fc1": _t(fc1), "fc2": _t(fc2)}, torch.from_numpy(x), kind, TC, layer=0)
    # 1e-5 also covers the Pallas kernel's A&S erf (about 3e-6 from erff)
    _close(out, ref)


@pytest.mark.parametrize("kind", ["tanh", "erf"])
def test_ffn_stacked_matches_pallas(kind):
    x, fc1, fc2 = _ffn(3, 2)
    ref = fused_ffn_pallas_stacked(
        jnp.asarray(x), _j(fc1), _j(fc2), jnp.asarray(1), kind, JC, interpret=True
    ) + fc2["b"][1]  # the stacked Pallas kernel leaves fc2's bias to its caller
    out = apply_ffn({"fc1": _t(fc1), "fc2": _t(fc2)}, torch.from_numpy(x), kind, TC, layer=1)
    _close(out, ref)


@pytest.mark.parametrize("pos", [0, 37, 63])
def test_self_attention_with_store_matches_pallas(pos):
    _self_attention_with_store(pos, 256, 4)


@pytest.mark.parametrize("pos", [0, 37, 63])
def test_self_attention_with_store_matches_pallas_large_v3_heads(pos):
    """Kernel B's plain version at Large-V3's head layout (D 1280, 20 heads)."""
    _self_attention_with_store(pos, 1280, 20)


def _self_attention_with_store(pos, d, h):
    rng = np.random.default_rng(4)
    l_dim, b, ctx, layer = 2, 2, 64, 1
    k8 = rng.integers(-127, 128, (l_dim, b, ctx, d), dtype=np.int8)
    v8 = rng.integers(-127, 128, (l_dim, b, ctx, d), dtype=np.int8)
    sc = rng.uniform(0.001, 0.02, (l_dim, b, ctx, 2)).astype(np.float32)
    q, kn, vn = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    kq = rng.integers(-127, 128, (b, 1, d), dtype=np.int8)
    vq = rng.integers(-127, 128, (b, 1, d), dtype=np.int8)
    new_sc = rng.uniform(0.001, 0.02, (b, 1, 2)).astype(np.float32)

    ref, ref_k, ref_v = decode_attention_merged(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(layer), jnp.asarray(pos), h,
        jnp.asarray(kn), jnp.asarray(vn), kv_scale4=jnp.asarray(sc), interpret=True,
        kq=jnp.asarray(kq), vq=jnp.asarray(vq),
    )
    tk, tv, tsc = torch.from_numpy(k8.copy()), torch.from_numpy(v8.copy()), torch.from_numpy(sc.copy())
    out = decode_self_attention(
        torch.from_numpy(q), tk, tv, tsc, layer, torch.tensor(pos, dtype=torch.int32), h, torch.from_numpy(kn),
        torch.from_numpy(vn), torch.from_numpy(kq), torch.from_numpy(vq), torch.from_numpy(new_sc),
    )
    _close(out, ref)
    # the stored cache equals the Pallas kernel's exactly; no other row moved
    np.testing.assert_array_equal(tk.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ref_v))
    expect_sc = sc.copy()
    expect_sc[layer, :, pos] = new_sc[:, 0]
    np.testing.assert_array_equal(tsc.numpy(), expect_sc)


def _self_cache(rng, l_dim, b, ctx, d):
    k8 = rng.integers(-127, 128, (l_dim, b, ctx, d), dtype=np.int8)
    v8 = rng.integers(-127, 128, (l_dim, b, ctx, d), dtype=np.int8)
    sc = rng.uniform(0.001, 0.02, (l_dim, b, ctx, 2)).astype(np.float32)
    return k8, v8, sc


# ctx 64 is one key tile of the Pallas kernel; ctx 96 is three 32-key tiles
# (its flash recurrence), which kernel E covers in one exact pass
@pytest.mark.parametrize("ctx,valid", [(64, 1), (64, 37), (64, 64), (96, 1), (96, 37), (96, 96)])
def test_attention_layer_and_merge_match_pallas(ctx, valid):
    """Kernel E's plain version (unnormalized acc, m, l) against the general
    Pallas kernel, then the flash merge of the current token on top."""
    rng = np.random.default_rng(8)
    l_dim, b, d, h, layer = 2, 3, 256, 4, 1
    k8, v8, sc = _self_cache(rng, l_dim, b, ctx, d)
    q, kn, vn = (rng.standard_normal((b, 1, d)).astype(np.float32) for _ in range(3))
    ref = j_layer(
        jnp.asarray(q), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(layer), jnp.asarray(valid), h,
        kv_scale4=jnp.asarray(sc), interpret=True,
    )
    out = decode_attention_layer(
        torch.from_numpy(q), torch.from_numpy(k8), torch.from_numpy(v8), torch.from_numpy(sc), layer,
        torch.tensor(valid, dtype=torch.int32), h,
    )
    assert [tuple(a.shape) for a in out] == [(b, 1, d), (b, 1, h), (b, 1, h)]
    for a, r in zip(out, ref):
        _close(a, r)
    merged = flash_merge_extra_key(*out, torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), h)
    _close(merged, j_merge(*ref, jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), h))


@pytest.mark.parametrize("pos", [0, 13, 63])
def test_cache_slot_matches_pallas(pos):
    """Kernel F's plain version writes exactly what the Pallas slot writer
    writes, and nothing else."""
    rng = np.random.default_rng(9)
    cache = rng.integers(-127, 128, (2, 3, 64, 256), dtype=np.int8)
    new = rng.integers(-127, 128, (2, 3, 1, 256), dtype=np.int8)
    ref = j_write_slot(jnp.asarray(cache), jnp.asarray(new), jnp.asarray(pos), interpret=True)
    out = torch.from_numpy(cache.copy())
    write_cache_slot(out, torch.from_numpy(new), torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _pack4(q4, axis):
    lo, hi = np.split((q4 + 8).astype(np.uint8), 2, axis=axis)
    return lo | (hi << 4)


@pytest.mark.parametrize("valid", [100, 128])
def test_cross_attention_int4_matches_pallas(valid):
    rng = np.random.default_rng(5)
    l_dim, b, t, d, h, layer = 2, 2, 128, 256, 4, 1
    kT = _pack4(rng.integers(-8, 8, (l_dim, b, d, t), dtype=np.int8), axis=2)  # [L, B, D/2, T]
    v = _pack4(rng.integers(-8, 8, (l_dim, b, t, d), dtype=np.int8), axis=2)  # [L, B, T/2, D]
    q = (rng.standard_normal((b, 1, d)) * 0.3).astype(np.float32)
    ref, _, _ = decode_attention_kT(
        jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(valid), h,
        interpret=True, normalized=True,
    )
    out = decode_cross_attention(torch.from_numpy(q), torch.from_numpy(kT), torch.from_numpy(v), layer, valid, h)
    _close(out, ref)


@pytest.mark.parametrize("valid", [100, 128])
def test_grouped_cross_attention_int4_matches_pallas(valid):
    """Three query streams per cross-cache entry (beam search's
    batch_groups): stream b reads entry b // 3."""
    rng = np.random.default_rng(10)
    l_dim, b, g, t, d, h, layer = 2, 2, 3, 128, 256, 4, 1
    kT = _pack4(rng.integers(-8, 8, (l_dim, b, d, t), dtype=np.int8), axis=2)
    v = _pack4(rng.integers(-8, 8, (l_dim, b, t, d), dtype=np.int8), axis=2)
    q = (rng.standard_normal((b * g, 1, d)) * 0.3).astype(np.float32)
    ref, _, _ = decode_attention_kT(
        jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(valid), h,
        batch_groups=g, interpret=True, normalized=True,
    )
    out = decode_cross_attention(
        torch.from_numpy(q), torch.from_numpy(kT), torch.from_numpy(v), layer, valid, h, batch_groups=g
    )
    _close(out, ref)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("valid", [100, 128])
@pytest.mark.parametrize("cache", ["int4", "int8", "bf16"])
def test_cross_attention_bf16_matches_pallas(cache, valid, groups):
    """Kernels C and C' with a bf16 query (and, for C', an int8 or bf16
    cache) against K3 in interpret mode: K3 rounds p to bf16 before the
    value product, and the int4 form folds the values' bias out with the
    unrounded sum. Held to 1e-4 of max|out|, plus, where a p lies within
    256 f32 steps of a bf16 rounding tie, one bf16 step of it (the two
    frameworks' scores differ in their last bits); the form that keeps p
    in f32 misses 1e-4 by more than 10x. Stream b reads entry b // groups."""
    rng = np.random.default_rng(15)
    l_dim, b, t, d, h, layer = 2, 2, 128, 256, 4, 1
    if cache == "int4":
        kT = _pack4(rng.integers(-8, 8, (l_dim, b, d, t), dtype=np.int8), axis=2)  # [L, B, D/2, T]
        v = _pack4(rng.integers(-8, 8, (l_dim, b, t, d), dtype=np.int8), axis=2)  # [L, B, T/2, D]
        qs = 0.3
    elif cache == "int8":
        kT = rng.integers(-127, 128, (l_dim, b, d, t), dtype=np.int8)
        v = rng.integers(-127, 128, (l_dim, b, t, d), dtype=np.int8)
        qs = 0.003
    else:
        kT = rng.standard_normal((l_dim, b, d, t)).astype(np.float32)
        v = rng.standard_normal((l_dim, b, t, d)).astype(np.float32)
        qs = 1.0
    q = (rng.standard_normal((b * groups, 1, d)) * qs).astype(np.float32)
    j = lambda x: jnp.asarray(x).astype(jnp.bfloat16) if x.dtype == np.float32 else jnp.asarray(x)
    tt = lambda x: torch.from_numpy(x).to(torch.bfloat16) if x.dtype == np.float32 else torch.from_numpy(x)
    ref, _, _ = decode_attention_kT(
        j(q), j(kT), j(v), jnp.asarray(layer), jnp.asarray(valid), h,
        batch_groups=groups, interpret=True, normalized=True,
    )
    args = (tt(q), tt(kT), tt(v), layer, valid, h)
    out = decode_cross_attention(*args, batch_groups=groups).numpy()
    ref = np.asarray(ref, np.float32)
    ties = decode_cross_attention_ties(*args, groups, ulps=256).numpy()
    assert (np.abs(out - ref) <= 1e-4 * np.abs(ref).max() + ties).all()
    # the form before the repair: p kept in f32 (an f32 query of the same values)
    f32_p = decode_cross_attention_plain(args[0].float(), *args[1:], groups).numpy()
    assert np.abs(f32_p - ref).max() > 10 * 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("valid", [100, 128])
def test_encoder_attention_matches_pallas(valid):
    rng = np.random.default_rng(6)
    b, t, d, h = 2, 128, 256, 4
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32) for _ in range(3))
    ref = encoder_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, valid=valid, interpret=True)
    out = encoder_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h, valid=valid)
    _close(out, ref)


def test_large_m_dispatch_matches_jax():
    """At LARGE_M rows and above both packages dequantize once and use a
    library matmul instead of the kernel."""
    rng = np.random.default_rng(7)
    qw, sc, b = _linear(rng, 1, 256, 128)
    x = rng.standard_normal((LARGE_M, 256)).astype(np.float32)
    ref = j_q4_matmul(jnp.asarray(x), jnp.asarray(qw[0]), jnp.asarray(sc[0]), JC) + b[0]
    out = q4_dispatch(
        torch.from_numpy(x), torch.from_numpy(qw), torch.from_numpy(sc), TC,
        layer=0, bias=torch.from_numpy(b),
    )
    _close(out, ref)
