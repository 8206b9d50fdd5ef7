"""Kernel D' (the head-blocked encoder attention, K10) of the PyTorch port
against ``pallas_encoder_attention.encoder_attention`` in interpret mode,
on the CPU in f32: the same outputs (at the tolerance of
tests/test_flash_prefill.py), and the same shapes declined."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_burn_tpu.ops import pallas_encoder_attention as jea

from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops import encoder_attention as ea


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain version: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("b,t,d,h", [(2, 128, 128, 2), (1, 300, 256, 4), (2, 1500, 128, 2)])
def test_encoder_attention_heads_matches_pallas(b, t, d, h):
    """The shapes of tests/test_flash_prefill.py, T padded to 128 inside."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    ref = jea.encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True)
    out = ea.encoder_attention_heads(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    assert out.shape == (b, t, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_encoder_attention_heads_wide_heads_on_cpu():
    """128-wide heads (Large-V3's width over 10 heads): the JAX gate admits
    them, and on the CPU the port answers as the Pallas kernel does (the
    CUDA kernel takes 64-wide heads only and raises for these)."""
    b, t, d, h = 1, 130, 1280, 10
    assert ea.supported(t, d, h) and jea.supported(t, d, h)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32) * 0.5 for _ in range(3))
    ref = jea.encoder_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), h, interpret=True)
    out = ea.encoder_attention_heads(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), h)
    assert out.shape == (b, t, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=3e-5, rtol=1e-4)


def test_encoder_attention_heads_bf16_keeps_dtype():
    """The output takes q's dtype, as the Pallas kernel's does."""
    q = torch.randn((1, 200, 128), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    out = ea.encoder_attention_heads(q, q, q, 2)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = ea.encoder_attention_plain(q, q, q, 2, 200)
    assert (out.float() - ref.float()).abs().max().item() <= 1e-2 * ref.float().abs().max().item()


def test_encoder_attention_heads_declines_long_t():
    b, t, d, h = 1, 4096, 128, 2
    q = np.zeros((b, t, d), np.float32)
    assert jea.encoder_attention(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q), h, interpret=True) is None
    assert ea.encoder_attention_heads(*(torch.from_numpy(q),) * 3, h) is None


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d,h", [(1280, 20), (1024, 16), (64, 1), (128, 2), (96, 3), (1280, 10)])
def test_supported_and_head_groups_match_jax(d, h, itemsize):
    """The gate and its head groups over the grid of
    tests/test_flash_prefill.py (plus a 32-wide and a 128-wide head), at the
    encoder's padded T and at the lengths around the limit."""
    for t in (1536 if d >= 512 else 128, 1500, 2048, 2049, 100):
        assert ea.supported(t, d, h, itemsize) == jea.supported(t, d, h, itemsize), (t, d, h, itemsize)
        tp = -(-t // 128) * 128
        assert ea._pick_dgrp(tp, d, h, itemsize) == jea._pick_dgrp(tp, d, h, itemsize), (t, d, h, itemsize)


def test_head_major_plain_matches_packed_plain():
    """The head-major plain version (padded, pad keys masked) gives kernel
    D's plain version's rows."""
    rng = np.random.default_rng(3)
    b, t, d, h = 2, 100, 256, 4
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)) for _ in range(3))
    out = ea.encoder_attention_heads(q, k, v, h)
    ref = ea.encoder_attention_plain(q, k, v, h, t)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t,valid", [(128, 100), (256, 129), (256, 200)])
def test_bf16_plain_versions_round_p_as_the_pallas_kernels(t, valid):
    """Both plain versions in bf16 against K6 (``encoder_attention_packed``)
    and K10 (``_attn_call``, the head-major layout) in interpret mode, keys
    ``t >= valid`` masked (129: one key in the last 64-key tile). Each
    rounds the unnormalized ``exp(s - max)`` to bf16 before the value
    product and divides by the f32 row sum after it, so the outputs are
    equal but where XLA's and PyTorch's f32 exp or summation order differ
    by an ulp at a bf16 rounding boundary (of ``p`` or of the output): at
    most one bf16 step of an element, 2e-3 of max|out|, in at most 1% of
    the elements. The softmax normalized before the value product (the
    plain versions' earlier form) misses both bounds."""
    rng = np.random.default_rng(5)
    b, d, h = 2, 256, 4
    q, k, v = (rng.standard_normal((b, t, d)).astype(np.float32) for _ in range(3))
    jb = lambda x: jnp.asarray(x, jnp.bfloat16)
    tb = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)

    def within(out, ref):
        out, ref = out.float().numpy(), np.asarray(ref.astype(jnp.float32))
        return np.abs(out - ref).max() <= 2e-3 * np.abs(ref).max(), (out != ref).mean() <= 0.01

    def close(out, ref):
        assert within(out, ref) == (True, True)

    ref = jea.encoder_attention_packed(jb(q), jb(k), jb(v), h, valid=valid, interpret=True)
    out = ea.encoder_attention(tb(q), tb(k), tb(v), h, valid=valid)
    assert out.dtype == torch.bfloat16
    close(out, ref)
    split = lambda x: tb(x).float().reshape(b, t, h, 64).transpose(1, 2)
    s = (split(q) @ split(k).transpose(-1, -2) / 8.0).masked_fill(torch.arange(t) >= valid, float("-inf"))
    normalized_first = (torch.softmax(s, dim=-1) @ split(v)).transpose(1, 2).reshape(b, t, d).to(torch.bfloat16)
    assert within(normalized_first, ref) == (False, False)
    heads = lambda x: x.reshape(b, t, h, 64).transpose(0, 2, 1, 3)
    qh, kh, vT = heads(q), heads(k), heads(v).transpose(0, 1, 3, 2)
    ref = jea._attn_call(jb(qh), jb(kh), jb(vT), n_heads=h, valid=valid, interpret=True)
    out = ea.encoder_attention_heads_kernel(tb(qh), tb(kh), tb(vT), valid)
    assert out.dtype == torch.bfloat16
    close(out, ref)
