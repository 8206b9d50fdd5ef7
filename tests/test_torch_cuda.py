"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (it is
decided inside the fixture, not at import). On a machine with the card:

    python -m pytest tests/test_torch_cuda.py -q

The kernels are built from ``whisper_burn_tpu_torch/csrc`` at first use.
chip_smoke.py runs the same checks at the main paths' Large-V3 and Medium
shapes. The kernels' tests at a model's layout run at Large-V3's (D 1280,
20 heads) and Whisper Medium's (D 1024, 16 heads).
"""

import pytest
import torch

from whisper_burn_tpu_torch.models.decoder import self_kv_groups
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.cache import (
    write_cache_slot,
    write_cache_slot_plain,
    write_cache_slots,
    write_cache_slots_beam,
    write_cache_slots_beam_plain,
    write_cache_slots_plain,
)
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer,
    decode_attention_layer_int4,
    decode_attention_layer_int4_plain,
    decode_attention_layer_plain,
    decode_attention_merged,
    decode_attention_merged_int4,
    decode_attention_merged_int4_plain,
    decode_attention_merged_plain,
    decode_cross_attention,
    decode_cross_attention_plain,
    decode_cross_attention_ties,
    decode_self_attention,
    decode_self_attention_plain,
)
from whisper_burn_tpu_torch.ops.encoder_attention import (
    encoder_attention,
    encoder_attention_heads,
    encoder_attention_heads_kernel,
    encoder_attention_heads_plain,
    encoder_attention_plain,
)
from whisper_burn_tpu_torch.ops.ffn_kernel import fused_ffn, fused_ffn_plain
from whisper_burn_tpu_torch.ops.layer_norm import gap_allowance, layer_norm, layer_norm_plain
from whisper_burn_tpu_torch.ops.q4_kernel import q4_matmul, q4_matmul_plain, regime

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _at(pos: int) -> torch.Tensor:
    """A kernel's position: one int32 in device memory."""
    return torch.tensor(pos, dtype=torch.int32, device="cuda")


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


# Kernel A's two regimes: weight read (f32 x; bf16 x of few rows) with K
# split over a cluster, tensor cores (bf16 x of many rows). Shapes: M = 1
# with K 5120 split 8 ways, decode qkv at 8 rows, 37 and 40 rows (beam
# search's 8 x 5) with N = 1284 not a multiple of the column tile, the
# cross fill's 1500 and the encoder's 1536 rows (ragged against the
# 128-row tile), and K = 288, not a multiple of any K tile; 20 and 63 rows
# take two and four 16-row tiles in the bf16 weight-read form. Whisper
# Medium's (D 1024, K split over its cluster as 1024 and 4096 divide): the
# decode qkv and projection at 8 and 40 rows, the prefill's 32, the int8
# logits over the 52224 padded vocab columns, the encoder's 1536 rows and
# the cross fill's 1500.
Q4_SHAPES = [(1, 256, 768), (1, 5120, 1280), (8, 1280, 3840), (20, 512, 1284), (37, 1280, 1284),
             (40, 1280, 1280), (40, 1280, 1284), (63, 1280, 768), (300, 512, 256), (300, 288, 256),
             (1500, 1280, 2560), (1536, 5120, 1280),
             (8, 1024, 3072), (40, 1024, 1024), (32, 1024, 3072), (8, 1024, 52224), (40, 1024, 52224),
             (1536, 4096, 1024), (1500, 1024, 2048)]
EPILOGUES = [(False, None), (True, None), (True, "tanh"), (True, "erf")]


def _q4_inputs(gen, m, k, n, dtype):
    qw = torch.randint(-8, 8, (3, k, n), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((3, k // 32, n), generator=gen, device="cuda") * 0.01
    b = torch.randn((3, n), generator=gen, device="cuda") * 0.1
    x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
    return x, qw, sc, b


@pytest.mark.parametrize("m,k,n", Q4_SHAPES)
@pytest.mark.parametrize("with_bias,gelu", EPILOGUES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_q4_matmul_kernel(gen, m, k, n, with_bias, gelu, dtype, tol):
    x, qw, sc, b = _q4_inputs(gen, m, k, n, dtype)
    bias = b if with_bias else None
    _build.reset_launches()
    out = q4_matmul(x, qw, sc, layer=2, bias=bias, gelu=gelu)
    assert _build.LAUNCHES["q4_matmul"] == 1
    torch.cuda.synchronize()
    ref = q4_matmul_plain(x, qw[2], sc[2], b[2] if with_bias else None, gelu, dtype)
    assert out.shape == (m, n) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("m,k,n,dtype", [(1, 5120, 1280, torch.bfloat16), (8, 1280, 3840, torch.float32),
                                         (40, 1280, 1284, torch.bfloat16), (1536, 1280, 3840, torch.bfloat16)])
def test_q4_matmul_bitwise_repeatable(gen, m, k, n, dtype):
    """A fixed order of summation (no float atomics): two calls on the same
    inputs give the same bits, in both regimes."""
    x, qw, sc, b = _q4_inputs(gen, m, k, n, dtype)
    first = q4_matmul(x, qw, sc, layer=1, bias=b, gelu="tanh", out_dtype=torch.float32)
    second = q4_matmul(x, qw, sc, layer=1, bias=b, gelu="tanh", out_dtype=torch.float32)
    assert torch.equal(first, second)


def test_q4_matmul_regimes(gen):
    """f32 x always reads weights on CUDA cores; bf16 x goes to tensor cores
    from the threshold up, the entry's 1500 and 1536 rows among them."""
    assert regime(1536, torch.float32) == "weight_read"
    assert regime(1, torch.bfloat16) == regime(8, torch.bfloat16) == "weight_read"
    assert regime(1500, torch.bfloat16) == regime(1536, torch.bfloat16) == "tensor_core"


# Kernel I at Large-V3's FFN (1280 <-> 5120): the greedy decode's 8 rows and
# the beam's 40 (the decode regime: weights held in shared memory, one grid
# barrier), the entry's 1, the prefill's 4, the encoder's 1536 (the encoder
# regime's wgmma tiles); Whisper Medium's (1024 <-> 4096) at 8, 40 and 1536
# rows and its prefill's 32; and Whisper tiny's D = 384 at 100 rows (one
# ragged row tile, half a column tile).
FFN_SHAPES = [(8, 1280, 5120), (40, 1280, 5120), (1, 1280, 5120), (4, 1280, 5120), (1536, 1280, 5120),
              (8, 1024, 4096), (40, 1024, 4096), (32, 1024, 4096), (1536, 1024, 4096), (100, 384, 1536)]


def _ffn_inputs(gen, m, d, f, dtype):
    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (2, k, n), generator=gen, device="cuda", dtype=torch.int8),
                "scales": torch.rand((2, k // 32, n), generator=gen, device="cuda") * 0.01,
                "b": torch.randn((2, n), generator=gen, device="cuda") * 0.1}
    return torch.randn((m, d), generator=gen, device="cuda").to(dtype), lin(d, f), lin(f, d)


@pytest.mark.parametrize("m,d,f", FFN_SHAPES)
@pytest.mark.parametrize("kind", ["tanh", "erf"])
@pytest.mark.parametrize("bias_after_round", [False, True], ids=["k7", "k4"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_fused_ffn_kernel(gen, m, d, f, kind, bias_after_round, dtype, tol):
    x, fc1, fc2 = _ffn_inputs(gen, m, d, f, dtype)
    _build.reset_launches()
    out = fused_ffn(x, fc1, fc2, kind, layer=1, bias_after_round=bias_after_round)
    assert _build.LAUNCHES["fused_ffn"] == 1 and sum(_build.LAUNCHES.values()) == 1
    torch.cuda.synchronize()
    p1, p2 = ({k: v[1] for k, v in p.items()} for p in (fc1, fc2))
    ref = fused_ffn_plain(x, p1["qw"], p1["scales"], p1["b"], p2["qw"], p2["scales"], p2["b"], kind, bias_after_round)
    assert out.shape == (m, d) and out.dtype == dtype
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("d,f", [(1280, 5120), (1024, 4096)], ids=["large_v3", "medium"])
@pytest.mark.parametrize("m", [8, 40, 1536])
def test_fused_ffn_bitwise_repeatable(gen, m, d, f):
    """No float atomics, every sum in a fixed order: three calls give the
    same bits, and so do two replays of a CUDA graph that captured the
    launch (the cooperative launch is captured, and its barrier count is
    left ready for the next launch)."""
    x, fc1, fc2 = _ffn_inputs(gen, m, d, f, torch.bfloat16)
    first, second, third = (fused_ffn(x, fc1, fc2, "tanh", layer=0, bias_after_round=True) for _ in range(3))
    assert torch.equal(first, second) and torch.equal(second, third)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        captured = fused_ffn(x, fc1, fc2, "tanh", layer=0, bias_after_round=True)
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    replayed = captured.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, first) and torch.equal(captured, first)
    assert torch.equal(fused_ffn(x, fc1, fc2, "tanh", layer=0, bias_after_round=True), first)


@pytest.mark.parametrize("pos", [0, 1, 63])
def test_self_attention_kernel_and_store(gen, pos):
    l_dim, b, ctx, d, h = 2, 3, 64, 256, 4
    kc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    vc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((l_dim, b, ctx, 2), generator=gen, device="cuda") * 0.02
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda") for _ in range(3))
    kq = torch.randint(-127, 128, (b, 1, d), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, 1, d), generator=gen, device="cuda", dtype=torch.int8)
    nsc = torch.rand((b, 1, 2), generator=gen, device="cuda")
    caches = [(kc.clone(), vc.clone(), sc.clone()) for _ in range(2)]
    out = decode_self_attention(q, *caches[0], 1, _at(pos), h, kn, vn, kq, vq, nsc)
    ref = decode_self_attention_plain(q, *caches[1], 1, _at(pos), h, kn, vn, kq, vq, nsc)
    assert _rel_err(out, ref) <= 1e-5
    for a, r in zip(*caches):
        assert torch.equal(a, r)


@pytest.mark.parametrize("groups", [1, 5])
def test_cross_attention_kernel(gen, groups):
    l_dim, b, t, d, h = 2, 3, 256, 256, 4
    kT = torch.randint(0, 256, (l_dim, b, d // 2, t), generator=gen, device="cuda", dtype=torch.uint8)
    v = torch.randint(0, 256, (l_dim, b, t // 2, d), generator=gen, device="cuda", dtype=torch.uint8)
    q = torch.randn((b * groups, 1, d), generator=gen, device="cuda") * 0.1
    out = decode_cross_attention(q, kT, v, 1, 200, h, groups)
    _cross_close(out, q, kT, v, 1, 200, h, groups)


def _cross_close(out, q, kT, v, layer, valid, h, groups):
    """Kernel C or C' against its plain version: 1e-5 of max|out| (f32
    math both ways, sums in another order), plus, with a bf16 query, one
    bf16 step of each p that lies within 32 f32 steps of a rounding tie
    (the two round such a p apart; decode_cross_attention_ties)."""
    ref = decode_cross_attention_plain(q, kT, v, layer, valid, h, groups)
    ties = decode_cross_attention_ties(q, kT, v, layer, valid, h, groups)
    assert ((out - ref).abs() <= 1e-5 * ref.abs().max() + ties).all()


@pytest.mark.parametrize("ctx,valid", [(64, 0), (64, 37), (96, 96), (448, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_layer_kernel(gen, ctx, valid, dtype):
    l_dim, b, d, h = 2, 3, 256, 4
    kc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    vc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((l_dim, b, ctx, 2), generator=gen, device="cuda") * 0.02
    q = torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    out = decode_attention_layer(q, kc, vc, sc, 1, _at(valid), h)
    assert _build.LAUNCHES["decode_attention_layer"] == 1
    ref = decode_attention_layer_plain(q, kc, vc, sc, 1, _at(valid), h)
    for a, r in zip(out, ref):  # f32 math both ways, sums in another order
        assert (a - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)


@pytest.mark.parametrize("pos", [0, 1, 63])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_attention_kernel(gen, pos, dtype):
    """Kernel B' over a float cache: the plain version's output, nothing stored."""
    l_dim, b, ctx, d, h = 2, 3, 64, 256, 4
    kc, vc = (torch.randn((l_dim, b, ctx, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    k0, v0 = kc.clone(), vc.clone()
    _build.reset_launches()
    out = decode_attention_merged(q, kc, vc, 1, _at(pos), h, kn, vn)
    assert _build.LAUNCHES["decode_attention_merged"] == 1
    assert _rel_err(out, decode_attention_merged_plain(q, kc, vc, 1, _at(pos), h, kn, vn)) <= 1e-5
    assert torch.equal(kc, k0) and torch.equal(vc, v0)


@pytest.mark.parametrize("ctx,valid", [(64, 0), (64, 37), (96, 96), (448, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_layer_unscaled_kernel(gen, ctx, valid, dtype):
    """Kernel E' over a float cache, no scales."""
    l_dim, b, d, h = 2, 3, 256, 4
    kc, vc = (torch.randn((l_dim, b, ctx, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    q = torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    out = decode_attention_layer(q, kc, vc, None, 1, _at(valid), h)
    assert _build.LAUNCHES["decode_attention_layer_unscaled"] == 1
    ref = decode_attention_layer_plain(q, kc, vc, None, 1, _at(valid), h)
    for a, r in zip(out, ref):
        assert (a - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)


@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("cache", [torch.int8, torch.bfloat16, torch.float32])
def test_cross_attention_unpacked_kernel(gen, cache, groups):
    """Kernel C' over int8 (bf16 query) and float caches, keys [L, B, D, T]."""
    l_dim, b, t, d, h = 2, 3, 256, 256, 4
    if cache == torch.int8:
        kT = torch.randint(-127, 128, (l_dim, b, d, t), generator=gen, device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, (l_dim, b, t, d), generator=gen, device="cuda", dtype=torch.int8)
        q = (torch.randn((b * groups, 1, d), generator=gen, device="cuda") * 0.003).to(torch.bfloat16)
    else:
        kT = torch.randn((l_dim, b, d, t), generator=gen, device="cuda").to(cache)
        v = torch.randn((l_dim, b, t, d), generator=gen, device="cuda").to(cache)
        q = torch.randn((b * groups, 1, d), generator=gen, device="cuda").to(cache)
    _build.reset_launches()
    out = decode_cross_attention(q, kT, v, 1, 200, h, groups)
    assert _build.LAUNCHES["decode_cross_attention_unpacked"] == 1
    _cross_close(out, q, kT, v, 1, 200, h, groups)


@pytest.mark.parametrize("dtype,width", [(torch.int8, 1280), (torch.bfloat16, 1280), (torch.float32, 2), (torch.bfloat16, 3)])
def test_cache_slot_kernel(gen, dtype, width):
    """16-byte multiples (int8 and bf16 at width 1280) take the vector path;
    8- and 6-byte rows the byte path."""
    cache = torch.randn((3, 5, 16, width), generator=gen, device="cuda").mul(50).to(dtype)
    new = torch.randn((3, 5, 1, width), generator=gen, device="cuda").mul(50).to(dtype)
    ref = cache.clone()
    write_cache_slot(cache, new, _at(7))
    write_cache_slot_plain(ref, new, _at(7))
    assert torch.equal(cache, ref)


# Kernel F's two forms at Large-V3's layout (32 layers, D 1280, ctx 256)
# and Medium's (24 layers, D 1024: rows of 512 + 512 + 64 bytes in the int4
# self form, where Large-V3's are 640 + 640 + 80), each self-cache form:
# (K dtype, V dtype, K width, V width, scale lanes) at width d
F_FORMS = {
    "int8": lambda d: (torch.int8, torch.int8, d, d, 2),
    "int4self": lambda d: (torch.uint8, torch.uint8, d // 2, d // 2, 2 * self_kv_groups(d)),
    "mixed": lambda d: (torch.int8, torch.uint8, d, d // 2, 1 + self_kv_groups(d)),
    "bf16": lambda d: (torch.bfloat16, torch.bfloat16, d, d, 0),
    "f32": lambda d: (torch.float32, torch.float32, d, d, 0),
}
F_LAYOUTS = {"large_v3": (32, 1280), "medium": (24, 1024)}  # layers, D


def _f_rows(gen, form, streams, t, layout="large_v3"):
    """Random ``[L, streams, t, W]`` K, V and (quantized forms) scale rows."""
    l_dim, d = F_LAYOUTS[layout]
    kd, vd, kw, vw, lanes = F_FORMS[form](d)

    def rand(dtype, width):
        shape = (l_dim, streams, t, width)
        if dtype.is_floating_point:
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dtype)

    return [rand(kd, kw), rand(vd, vw)] + ([rand(torch.float32, lanes)] if lanes else [])


@pytest.mark.parametrize("layout", list(F_LAYOUTS))
@pytest.mark.parametrize("pos", [0, 1, 115, 255])
@pytest.mark.parametrize("streams", [8, 40])
@pytest.mark.parametrize("form", list(F_FORMS))
def test_cache_slot_forms_large_v3(gen, form, streams, pos, layout):
    """Both forms of kernel F in one launch a call, exactly their plain
    versions, twice bitwise alike. The slot form leaves every other row of
    the caches as it was; the beam form (the streams in utterances of 5
    beams, or 4 at 8 streams, each taking a random parent among its
    utterance's) writes the other buffer's rows up to pos, leaves its later
    rows and the step's buffer as they were."""
    ctx = 256
    caches, news = _f_rows(gen, form, streams, ctx, layout), _f_rows(gen, form, streams, 1, layout)
    at = _at(pos)
    outs = []
    for _ in range(2):
        got = [c.clone() for c in caches]
        _build.reset_launches()
        write_cache_slots(list(zip(got, news)), at)
        assert dict(_build.LAUNCHES) == {"write_cache_slot": 1}
        outs.append(got)
    ref = [c.clone() for c in caches]
    write_cache_slots_plain(list(zip(ref, news)), at)
    for a, b, r in zip(*outs, ref):
        assert torch.equal(a, r) and torch.equal(a.view(torch.uint8), b.view(torch.uint8))

    width = 5 if streams % 5 == 0 else 4  # beams of an utterance
    parent = torch.randint(0, width, (streams // width, width), generator=gen, device="cuda")
    src = (torch.arange(streams // width, device="cuda")[:, None] * width + parent).reshape(-1).to(torch.int32)
    stale = _f_rows(gen, form, streams, ctx, layout)
    xs = [c.clone() for c in caches]
    outs = []
    for _ in range(2):
        ys = [y.clone() for y in stale]
        _build.reset_launches()
        write_cache_slots_beam(list(zip(ys, xs, news)), src, at)
        assert dict(_build.LAUNCHES) == {"write_cache_slot_beam": 1}
        outs.append(ys)
    ref = [y.clone() for y in stale]
    write_cache_slots_beam_plain(list(zip(ref, [c.clone() for c in caches], news)), src, at)
    for a, b, r, y0, x, c in zip(*outs, ref, stale, xs, caches):
        assert torch.equal(a[:, :, : pos + 1], r[:, :, : pos + 1])
        assert torch.equal(a[:, :, pos + 1 :], y0[:, :, pos + 1 :])
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)) and torch.equal(x, c)


# Kernel D: T not a multiple of the 128-query tile (200), a valid that
# leaves one key in the last 64-key tile (129), the encoder's 1536 rows
# with 1500 valid at Large-V3's 20 heads and Medium's 16 (at its serving
# batch of 8 too), and B = 1
ENCODER_SHAPES = [(2, 128, 100, 256, 4), (2, 200, 200, 256, 4), (2, 256, 129, 256, 4),
                  (2, 1536, 1500, 1280, 20), (1, 1536, 1500, 1024, 16), (8, 1536, 1500, 1024, 16),
                  (1, 300, 300, 1280, 20)]


@pytest.mark.parametrize("b,t,valid,d,h", ENCODER_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_encoder_attention_kernel(gen, b, t, valid, d, h, dtype, tol):
    """f32 on CUDA cores (sums in another order); bf16 on tensor cores,
    p rounded against the running max where the plain version rounds
    against the row's final max. One launch a call; the rows past
    ``valid`` are computed and finite."""
    q, k, v = (torch.randn((b, t, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    _build.reset_launches()
    out = encoder_attention(q, k, v, h, valid=valid)
    assert _build.LAUNCHES["encoder_attention"] == 1
    assert _rel_err(out, encoder_attention_plain(q, k, v, h, valid)) <= tol
    assert bool(torch.isfinite(out[:, valid:]).all())


def _int4_cache(gen, fmt, l_dim, b, ctx, d):
    """A uint8-valued self cache: int4 keys and values with 2 * ng group
    scales, int8 keys with 1 + ng (mixed), one scalar a side, or none."""
    ng = self_kv_groups(d)
    v = torch.randint(0, 256, (l_dim, b, ctx, d // 2), generator=gen, device="cuda", dtype=torch.uint8)
    if fmt == "mixed":
        k = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    else:
        k = torch.randint(0, 256, (l_dim, b, ctx, d // 2), generator=gen, device="cuda", dtype=torch.uint8)
    sw = {"groups": 2 * ng, "mixed": 1 + ng, "scalar": 2, "unscaled": 0}[fmt]
    sc = torch.rand((l_dim, b, ctx, sw), generator=gen, device="cuda") * 0.04 + 0.01 if sw else None
    return k, v, sc


@pytest.mark.parametrize("fmt", ["groups", "mixed", "scalar", "unscaled"])
@pytest.mark.parametrize("pos", [0, 37, 63])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merged_attention_int4_kernel(gen, fmt, pos, dtype):
    """Kernel G over a uint8-valued cache: the plain version's output,
    nothing stored; f32 math both ways, sums in another order."""
    l_dim, b, ctx, d, h = 2, 3, 64, 640, 10
    k, v, sc = _int4_cache(gen, fmt, l_dim, b, ctx, d)
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    k0, v0 = k.clone(), v.clone()
    _build.reset_launches()
    out = decode_attention_merged_int4(q, k, v, sc, 1, _at(pos), h, kn, vn)
    assert _build.LAUNCHES["decode_attention_merged_int4"] == 1
    ref = decode_attention_merged_int4_plain(q, k, v, sc, 1, _at(pos), h, kn, vn)
    assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(k, k0) and torch.equal(v, v0)


@pytest.mark.parametrize("fmt", ["groups", "mixed", "scalar", "unscaled"])
@pytest.mark.parametrize("ctx,valid", [(64, 0), (64, 37), (448, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_layer_int4_kernel(gen, fmt, ctx, valid, dtype):
    """Kernel H over a uint8-valued cache: acc, m, l of the plain version."""
    l_dim, b, d, h = 2, 3, 256, 4
    k, v, sc = _int4_cache(gen, fmt, l_dim, b, ctx, d)
    q = torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype)
    _build.reset_launches()
    out = decode_attention_layer_int4(q, k, v, sc, 1, _at(valid), h)
    assert _build.LAUNCHES["decode_attention_layer_int4"] == 1
    ref = decode_attention_layer_int4_plain(q, k, v, sc, 1, _at(valid), h)
    for a, r in zip(out, ref):
        assert (a - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)


@pytest.mark.parametrize("b,t,d,h", [(2, 128, 128, 2), (1, 300, 256, 4), (2, 1500, 128, 2), (2, 129, 256, 4),
                                     (1, 1500, 1280, 20), (1, 1500, 1024, 16)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_encoder_attention_heads_kernel(gen, b, t, d, h, dtype, tol):
    """Kernel D' on its head-major layout, through the op and directly:
    the pad keys ``t..Tp`` masked (t = 129 leaves one key in the last
    64-key tile), one launch a call, the pad rows' outputs finite."""
    q, k, v = (torch.randn((b, t, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    _build.reset_launches()
    out = encoder_attention_heads(q, k, v, h)
    assert _build.LAUNCHES["encoder_attention_heads"] == 1
    assert _rel_err(out, encoder_attention_plain(q, k, v, h, t)) <= tol
    tp = -(-t // 128) * 128
    qh, kh = (torch.randn((b, h, tp, 64), generator=gen, device="cuda").to(dtype) for _ in range(2))
    vT = torch.randn((b, h, 64, tp), generator=gen, device="cuda").to(dtype)
    out = encoder_attention_heads_kernel(qh, kh, vT, t)
    assert _build.LAUNCHES["encoder_attention_heads"] == 2
    assert _rel_err(out[..., :t], encoder_attention_heads_plain(qh, kh, vT, t)[..., :t]) <= tol
    assert bool(torch.isfinite(out).all())


def test_encoder_attention_heads_kernel_ragged_tp_raises(gen):
    """vT's rows must be 16-byte multiples for the kernel's copies: a Tp
    that is not a multiple of 8 raises on a CUDA tensor, with no launch."""
    qh = torch.randn((1, 2, 100, 64), generator=gen, device="cuda").to(torch.bfloat16)
    vT = torch.randn((1, 2, 64, 100), generator=gen, device="cuda").to(torch.bfloat16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="multiple of 8"):
        encoder_attention_heads_kernel(qh, qh, vT, 90)
    assert sum(_build.LAUNCHES.values()) == 0


def test_encoder_attention_heads_wide_heads_raise(gen):
    """128-wide heads, which the gate admits: the kernel takes 64-wide heads
    only, and a CUDA tensor raises rather than taking the plain version."""
    q = torch.randn((1, 130, 1280), generator=gen, device="cuda")
    _build.reset_launches()
    with pytest.raises(ValueError, match="64-wide heads"):
        encoder_attention_heads(q, q, q, 10)
    assert sum(_build.LAUNCHES.values()) == 0


# Kernels B, B', E, E', G and H (one loop, csrc/decode_attention.cu
# attend_cached) at Large-V3's layout: D 1280, 20 heads (G and H: head
# pairs h, h + 10, one scale lane for two heads), ctx 256, 3 streams; and
# at Medium's: D 1024, 16 heads (pairs h, h + 8; 16 int4 scale lanes). The
# positions leave the 8 warps' runs of keys and their 16-key steps uneven
# (0, 1, 7, 8, 9), take the mean decode position (115) and reach the
# cache's end (226, 255). Each output is held to 1e-5 of its scale (f32
# math both ways, sums in another order), and two launches are bitwise
# equal (a fixed order of merging, no atomics).
LV3_STREAMS, LV3_CTX = 3, 256
LV3_POS = [0, 1, 7, 8, 9, 115, 226, 255]
LAYOUTS = pytest.mark.parametrize("d,h", [(1280, 20), (1024, 16)], ids=["large_v3", "medium"])


def _close_parts(out, ref):
    for a, r in zip(out, ref):
        assert (a - r).abs().max().item() <= 1e-5 * max(r.abs().max().item(), 1.0)


def _bitwise_twice(call, first):
    """A second launch gives bitwise equal outputs."""
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    assert all(torch.equal(a, r) for a, r in zip(as_tuple(first), as_tuple(call())))


@pytest.mark.parametrize("pos", LV3_POS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@LAYOUTS
def test_self_attention_kernel_large_v3(gen, pos, dtype, d, h):
    """Kernel B: the output, the stored row and scales exactly as the plain
    version's, and no other row of the caches touched."""
    l_dim, b, ctx = 2, LV3_STREAMS, LV3_CTX
    kc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    vc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((l_dim, b, ctx, 2), generator=gen, device="cuda") * 0.02 + 1e-3
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    kq = torch.randint(-127, 128, (b, 1, d), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, 1, d), generator=gen, device="cuda", dtype=torch.int8)
    nsc = torch.rand((b, 1, 2), generator=gen, device="cuda") * 0.02 + 1e-3
    caches = [(kc.clone(), vc.clone(), sc.clone()) for _ in range(2)]
    call = lambda: decode_self_attention(q, *caches[0], 1, _at(pos), h, kn, vn, kq, vq, nsc)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_self_attention"] == 1
    ref = decode_self_attention_plain(q, *caches[1], 1, _at(pos), h, kn, vn, kq, vq, nsc)
    assert _rel_err(out, ref) <= 1e-5
    for got, want, orig in zip(caches[0], caches[1], (kc, vc, sc)):
        assert torch.equal(got, want)
        rest = got.clone()
        rest[1, :, pos] = orig[1, :, pos]
        assert torch.equal(rest, orig)
    _bitwise_twice(call, out)  # row pos is stored again, never read


@pytest.mark.parametrize("pos", LV3_POS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@LAYOUTS
def test_merged_attention_kernel_large_v3(gen, pos, dtype, d, h):
    """Kernel B' over a float cache of the query's dtype, nothing stored."""
    l_dim, b, ctx = 2, LV3_STREAMS, LV3_CTX
    kc, vc = (torch.randn((l_dim, b, ctx, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    k0, v0 = kc.clone(), vc.clone()
    call = lambda: decode_attention_merged(q, kc, vc, 1, _at(pos), h, kn, vn)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_attention_merged"] == 1
    assert _rel_err(out, decode_attention_merged_plain(q, kc, vc, 1, _at(pos), h, kn, vn)) <= 1e-5
    assert torch.equal(kc, k0) and torch.equal(vc, v0)
    _bitwise_twice(call, out)


@pytest.mark.parametrize("valid", LV3_POS)
@pytest.mark.parametrize("scaled", [True, False], ids=["E", "E'"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@LAYOUTS
def test_attention_layer_kernel_large_v3(gen, valid, scaled, dtype, d, h):
    """Kernel E (int8 cache, per-token scales) and E' (float cache): acc, m
    and l of the plain version."""
    l_dim, b, ctx = 2, LV3_STREAMS, LV3_CTX
    if scaled:
        kc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
        vc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
        sc = torch.rand((l_dim, b, ctx, 2), generator=gen, device="cuda") * 0.02
    else:
        kc, vc = (torch.randn((l_dim, b, ctx, d), generator=gen, device="cuda").to(dtype) for _ in range(2))
        sc = None
    q = torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype)
    call = lambda: decode_attention_layer(q, kc, vc, sc, 1, _at(valid), h)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_attention_layer" if scaled else "decode_attention_layer_unscaled"] == 1
    _close_parts(out, decode_attention_layer_plain(q, kc, vc, sc, 1, _at(valid), h))
    _bitwise_twice(call, out)


@pytest.mark.parametrize("fmt", ["groups", "mixed", "scalar", "unscaled"])
@pytest.mark.parametrize("pos", LV3_POS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@LAYOUTS
def test_merged_attention_int4_kernel_large_v3(gen, fmt, pos, dtype, d, h):
    """Kernel G in its four cache forms, one block a head pair."""
    l_dim, b, ctx = 2, LV3_STREAMS, LV3_CTX
    k, v, sc = _int4_cache(gen, fmt, l_dim, b, ctx, d)
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    k0, v0 = k.clone(), v.clone()
    call = lambda: decode_attention_merged_int4(q, k, v, sc, 1, _at(pos), h, kn, vn)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_attention_merged_int4"] == 1
    assert _rel_err(out, decode_attention_merged_int4_plain(q, k, v, sc, 1, _at(pos), h, kn, vn)) <= 1e-5
    assert torch.equal(k, k0) and torch.equal(v, v0)
    _bitwise_twice(call, out)


@pytest.mark.parametrize("fmt", ["groups", "mixed", "scalar", "unscaled"])
@pytest.mark.parametrize("valid", LV3_POS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@LAYOUTS
def test_attention_layer_int4_kernel_large_v3(gen, fmt, valid, dtype, d, h):
    """Kernel H in its four cache forms: acc, m and l of the plain version."""
    l_dim, b, ctx = 2, LV3_STREAMS, LV3_CTX
    k, v, sc = _int4_cache(gen, fmt, l_dim, b, ctx, d)
    q = torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype)
    call = lambda: decode_attention_layer_int4(q, k, v, sc, 1, _at(valid), h)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_attention_layer_int4"] == 1
    _close_parts(out, decode_attention_layer_int4_plain(q, k, v, sc, 1, _at(valid), h))
    _bitwise_twice(call, out)


# Kernels C and C' at Large-V3's layout: D 1280, 20 heads (10 head pairs),
# and at Medium's: D 1024, 16 heads (8 pairs); T 1536, 1, 4 and 8 cache
# entries, one or five streams each. The valid lengths hit the
# edges of the 16-key units and of the blocks' runs, and the int4 cache's
# half boundary (T/2 = 768: 767 leaves the high halves empty, 769 adds one
# key there); 1536 leaves no key masked.
XV3_VALID = [1, 100, 767, 768, 769, 1500, 1536]
XV3_FORMS = [("int4", torch.float32), ("int4", torch.bfloat16), ("int8", torch.float32),
             ("int8", torch.bfloat16), ("bf16", torch.bfloat16), ("f32", torch.float32)]


@pytest.mark.parametrize("valid", XV3_VALID)
@pytest.mark.parametrize("entries", [1, 4, 8])
@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("cache,dtype", XV3_FORMS, ids=[f"{c}-{str(d)[6:]}" for c, d in XV3_FORMS])
@LAYOUTS
def test_cross_attention_kernel_large_v3(gen, cache, dtype, groups, entries, valid, d, h):
    """One launch a call, finite, the plain version's output (_cross_close),
    and two launches bitwise equal (fixed orders of merging, no atomics)."""
    l_dim, t = 2, 1536
    ints = lambda lo, hi, shape, dt: torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dt)
    if cache == "int4":
        kT, v = ints(0, 256, (l_dim, entries, d // 2, t), torch.uint8), ints(0, 256, (l_dim, entries, t // 2, d), torch.uint8)
        qs = 0.05
    elif cache == "int8":
        kT, v = ints(-127, 128, (l_dim, entries, d, t), torch.int8), ints(-127, 128, (l_dim, entries, t, d), torch.int8)
        qs = 0.003
    else:
        kT, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for shape in
                 ((l_dim, entries, d, t), (l_dim, entries, t, d)))
        qs = 1.0
    q = (torch.randn((entries * groups, 1, d), generator=gen, device="cuda") * qs).to(dtype)
    call = lambda: decode_cross_attention(q, kT, v, 1, valid, h, groups)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_cross_attention" if cache == "int4" else "decode_cross_attention_unpacked"] == 1
    assert torch.isfinite(out).all()
    _cross_close(out, q, kT, v, 1, valid, h, groups)
    _bitwise_twice(call, out)


def test_self_attention_misaligned_cache_raises(gen):
    """The loop reads cache rows 16 bytes at a time: a cache that does not
    start on a 16-byte boundary raises, with no launch."""
    l_dim, b, ctx, d, h = 2, 1, 64, 256, 4
    flat = torch.zeros(l_dim * b * ctx * d + 1, device="cuda", dtype=torch.bfloat16)
    kc = flat[1:].reshape(l_dim, b, ctx, d)  # 2 bytes past the allocation's start
    q = torch.randn((b, 1, d), generator=gen, device="cuda").to(torch.bfloat16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="16-byte aligned"):
        decode_attention_merged(q, kc, kc, 1, _at(5), h, q, q)
    assert sum(_build.LAUNCHES.values()) == 0


# --------------------------------------------------------------------------
# the greedy loop as a CUDA graph of its step (models/whisper.py), at
# Large-V3's layout cut to 2 layers, 4 streams, 40 tokens (two done checks)

GRAPH_MODES = ("serving", "int8", "fast", "int4self", "mixed")
GRAPH_B, GRAPH_TOKENS = 4, 40


def _graph_compute(mode):
    from whisper_burn_tpu_torch.ops.compute import Compute

    serving = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
    return {"serving": serving, "int8": Compute.fastest().replace(quantized_logits=True, w8a8=True),
            "fast": Compute.fast(), "int4self": serving.replace(self_kv_bits=4),
            "mixed": serving.replace(self_kv_vbits=4)}[mode]


@pytest.fixture(scope="module")
def lv3_two_layers():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_fabricated_params

    cfg = WhisperConfig.large_v3().replace(n_text_layer=2, n_audio_layer=2)
    raw = device_fabricated_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    mels = [torch.randn((GRAPH_B, cfg.n_mels, 3000), generator=g, device="cuda") for _ in range(2)]
    return cfg, raw, mels


def _eager_greedy(params, cfg, mel, compute, max_tokens):
    """The loop body called step by step, on a fresh state: the tokens and
    the last step's logits."""
    from whisper_burn_tpu_torch.models import whisper as w
    from whisper_burn_tpu_torch.models.decoder import init_cache

    state = w.new_state(init_cache(cfg, mel.shape[0], compute, w.self_cache_len(cfg, max_tokens), mel.device),
                        max_tokens)
    lang = torch.full((mel.shape[0],), cfg.lang_token_start, dtype=torch.int32, device=mel.device)
    w.start_request(params, cfg, mel, lang, compute, state, detect=False, task="transcribe")
    logits = None
    for k in range(1, max_tokens):
        if k % w.DONE_CHECK_EVERY == 0 and bool(state.done.all()):
            break
        logits = w.greedy_step(params, cfg, state, compute)
    return state.tokens.clone(), logits.clone()


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_greedy_graph_replay_equals_eager_body(lv3_two_layers, mode):
    """Two requests through one runner (the first captures its step after
    an eager first step, the second replays from k = 1) give the eager
    body's tokens and last logits bit for bit, and the launches of the
    eager loop."""
    from whisper_burn_tpu_torch.models import whisper as w
    from whisper_burn_tpu_torch.transcribe import prepare_params

    cfg, raw, mels = lv3_two_layers
    compute = _graph_compute(mode)
    params = prepare_params(raw, compute)
    w.clear_runners()
    lang = torch.full((GRAPH_B,), cfg.lang_token_start, dtype=torch.int32, device="cuda")
    for mel in mels:
        _build.reset_launches()
        tokens, logits = _eager_greedy(params, cfg, mel, compute, GRAPH_TOKENS)
        eager_launches = dict(_build.LAUNCHES)
        _build.reset_launches()
        res = w.greedy_decode(params, cfg, mel, lang, compute, max_tokens=GRAPH_TOKENS)
        runner = w.greedy_runner(params, cfg, compute, GRAPH_B, GRAPH_TOKENS, mel.device)
        assert runner.graphs and len(w.cached_runners()) == 1
        assert torch.equal(res.tokens, tokens)
        assert torch.equal(runner.logits, logits)
        assert dict(_build.LAUNCHES) == eager_launches
    w.clear_runners()


def test_graph_capture_raises_on_a_host_read(gen):
    """A step that reads a device value on the host cannot be captured:
    the capture raises, and the next capture on the stream works."""
    from whisper_burn_tpu_torch.models.whisper import capture_graph

    x = torch.randn(16, generator=gen, device="cuda")
    stream = torch.cuda.Stream()
    with pytest.raises(RuntimeError):
        capture_graph(lambda: x * float(x.sum()), stream)
    graph, out, tally = capture_graph(lambda: x * 2, stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2) and tally.log == []


def test_graph_replay_counts_the_eager_step_launches(lv3_two_layers):
    """The tally a capture of the step records is the eager step's
    launches, by kernel and shape, and each replay adds it once."""
    from whisper_burn_tpu_torch.models import whisper as w
    from whisper_burn_tpu_torch.models.decoder import init_cache
    from whisper_burn_tpu_torch.transcribe import prepare_params

    cfg, raw, mels = lv3_two_layers
    compute = _graph_compute("serving")
    params = prepare_params(raw, compute)
    state = w.new_state(init_cache(cfg, GRAPH_B, compute, 64, "cuda"), 16)
    lang = torch.full((GRAPH_B,), cfg.lang_token_start, dtype=torch.int32, device="cuda")
    w.start_request(params, cfg, mels[0], lang, compute, state, detect=False, task="transcribe")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    _build.reset_launches()
    with torch.cuda.stream(stream):
        w.greedy_step(params, cfg, state, compute)
    eager = dict(_build.LAUNCH_SHAPES)
    graph, _, tally = w.capture_graph(lambda: w.greedy_step(params, cfg, state, compute), stream)
    assert dict(_build.LAUNCH_SHAPES) == eager  # the capture launched nothing
    assert dict(tally.shapes) == eager
    torch.cuda.current_stream().wait_stream(stream)
    _build.reset_launches()
    for _ in range(3):
        graph.replay()
        _build.add_launches(tally)
    assert dict(_build.LAUNCH_SHAPES) == {key: 3 * n for key, n in eager.items()}
    assert int(state.k) == 5  # one eager step and three replays from k = 1


# the beam loop as CUDA graphs of its step (models/beam.py), at the same
# layout: 4 utterances x 5 beams, 40 tokens (two done checks)
GRAPH_W = 5


def _eager_beam(params, cfg, mel, compute, max_tokens):
    """The loop body called step by step from here, on a fresh state, its
    buffers taken in turn: the result of the request."""
    from whisper_burn_tpu_torch.models import beam
    from whisper_burn_tpu_torch.models import whisper as w

    b = mel.shape[0]
    state = beam.new_beam_state(cfg, compute, b, GRAPH_W, w.self_cache_len(cfg, max_tokens), max_tokens, mel.device)
    lang = torch.full((b,), cfg.lang_token_start, dtype=torch.int32, device=mel.device)
    lang = beam.start_beam_request(params, cfg, mel, lang, compute, state, detect=False, task="transcribe")
    for k in range(1, max_tokens):
        if k % w.DONE_CHECK_EVERY == 0 and bool(state.done.all()):
            break
        beam.beam_step(params, cfg, state, compute, (k - 1) % 2, length_penalty=1.0, early_stopping=False)
    return beam.BeamResult(*beam.select_best(state, 1.0), lang)


@pytest.mark.parametrize("mode", GRAPH_MODES)
def test_beam_graph_replay_equals_eager_body(lv3_two_layers, mode):
    """Two requests through one beam runner (the first runs its first
    step eagerly, then captures the step from each buffer of the
    self-cache pair; the second replays from k = 1) give the eager body's
    tokens, lengths and scores bit for bit, and the launches of the eager
    loop: one beam-form F a step, no slot form."""
    from whisper_burn_tpu_torch.models import beam
    from whisper_burn_tpu_torch.models import whisper as w
    from whisper_burn_tpu_torch.transcribe import prepare_params

    cfg, raw, mels = lv3_two_layers
    compute = _graph_compute(mode)
    params = prepare_params(raw, compute)
    w.clear_runners()
    lang = torch.full((GRAPH_B,), cfg.lang_token_start, dtype=torch.int32, device="cuda")
    for mel in mels:
        _build.reset_launches()
        ref = _eager_beam(params, cfg, mel, compute, GRAPH_TOKENS)
        eager_launches = dict(_build.LAUNCHES)
        _build.reset_launches()
        res = beam.beam_decode(params, cfg, mel, lang, compute, beam_width=GRAPH_W, max_tokens=GRAPH_TOKENS)
        (runner,) = w.cached_runners()
        assert isinstance(runner, beam.BeamRunner) and len(runner.graphs) == 2
        for a, b in zip(res, ref):
            assert torch.equal(a, b)
        assert dict(_build.LAUNCHES) == eager_launches
        assert eager_launches["write_cache_slot_beam"] == int(runner.state.k) - 1
        assert "write_cache_slot" not in eager_launches
    w.clear_runners()


# --------------------------------------------------------------------------
# Whisper Medium and Large-V3-Turbo through the runners, cut to 2 decoder
# layers (Turbo keeps unequal stacks: 4 encoder layers over 2 decoder ones)

PRESETS = {"medium": ("medium", dict(n_audio_layer=2, n_text_layer=2)),
           "turbo": ("large_v3_turbo", dict(n_audio_layer=4, n_text_layer=2))}


@pytest.fixture(scope="module", params=list(PRESETS))
def preset_two_layers(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_fabricated_params
    from whisper_burn_tpu_torch.transcribe import prepare_params

    name, cut = PRESETS[request.param]
    cfg = getattr(WhisperConfig, name)().replace(**cut)
    params = prepare_params(device_fabricated_params(cfg, seed=1, device="cuda"), _graph_compute("serving"))
    g = torch.Generator(device="cuda")
    g.manual_seed(4)
    mels = [torch.randn((GRAPH_B, cfg.n_mels, 3000), generator=g, device="cuda") for _ in range(2)]
    return cfg, params, mels


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_preset_graph_replay_equals_eager_body(preset_two_layers, decode):
    """The serving compute at Medium's width and 80 mel bins, and at
    Turbo's unequal stacks: two requests through one runner give the eager
    body's tokens (a beam's lengths and scores too) bit for bit, with the
    eager loop's launches."""
    from whisper_burn_tpu_torch.models import beam
    from whisper_burn_tpu_torch.models import whisper as w

    cfg, params, mels = preset_two_layers
    compute = _graph_compute("serving")
    w.clear_runners()
    lang = torch.full((GRAPH_B,), cfg.lang_token_start, dtype=torch.int32, device="cuda")
    for mel in mels:
        _build.reset_launches()
        if decode == "greedy":
            ref, _ = _eager_greedy(params, cfg, mel, compute, GRAPH_TOKENS)
        else:
            ref = _eager_beam(params, cfg, mel, compute, GRAPH_TOKENS)
        eager_launches = dict(_build.LAUNCHES)
        _build.reset_launches()
        if decode == "greedy":
            res = w.greedy_decode(params, cfg, mel, lang, compute, max_tokens=GRAPH_TOKENS)
            assert torch.equal(res.tokens, ref)
        else:
            res = beam.beam_decode(params, cfg, mel, lang, compute, beam_width=GRAPH_W, max_tokens=GRAPH_TOKENS)
            for a, b in zip(res, ref):
                assert torch.equal(a, b)
        assert dict(_build.LAUNCHES) == eager_launches
        assert eager_launches["encoder_attention"] == cfg.n_audio_layer
        assert eager_launches["decode_cross_attention"] % cfg.n_text_layer == 0
    w.clear_runners()


def test_gguf_load_moved_to_the_card(gen, tmp_path):
    """A checkpoint written by the port's GgufWriter (Q4_0 matrices, F32
    rest) and loaded through the repacked cache: its params on the card
    equal the CPU load's, leaf for leaf and dtype for dtype."""
    import numpy as np

    from whisper_burn_tpu_torch.gguf import GgufWriter
    from whisper_burn_tpu_torch.gguf.cache import load_whisper
    from whisper_burn_tpu_torch.models.params import params_to_torch

    rng = np.random.default_rng(0)
    d, w = 256, GgufWriter()
    w.add_string("general.architecture", "whisper")
    w.add_u32("whisper.n_lang", 99)
    rand = lambda *shape: rng.standard_normal(shape).astype(np.float32) * 0.05
    w.add_tensor("encoder.conv1.weight", rand(d, 80, 3))
    w.add_tensor("encoder.conv2.weight", rand(d, d, 3))
    for name in ("encoder.conv1.bias", "encoder.conv2.bias", "encoder.ln_post.weight", "encoder.ln_post.bias",
                 "decoder.ln.weight", "decoder.ln.bias"):
        w.add_tensor(name, rand(d))
    w.add_tensor("encoder.positional_embedding", rand(64, d))
    w.add_tensor("decoder.positional_embedding", rand(32, d))
    w.add_tensor("decoder.token_embedding.weight", rand(51865, d))
    for side, cross in (("encoder", False), ("decoder", True)):
        p = f"{side}.blocks.0"
        for ln in ("attn_ln", "mlp_ln") + (("cross_attn_ln",) if cross else ()):
            w.add_tensor(f"{p}.{ln}.weight", rand(d))
            w.add_tensor(f"{p}.{ln}.bias", rand(d))
        for attn in ("attn",) + (("cross_attn",) if cross else ()):
            for proj in ("query", "key", "value", "out"):
                w.add_tensor(f"{p}.{attn}.{proj}.weight", rand(d, d), quantize=True)
                if proj != "key":
                    w.add_tensor(f"{p}.{attn}.{proj}.bias", rand(d))
        w.add_tensor(f"{p}.mlp.0.weight", rand(4 * d, d), quantize=True)
        w.add_tensor(f"{p}.mlp.0.bias", rand(4 * d))
        w.add_tensor(f"{p}.mlp.2.weight", rand(d, 4 * d), quantize=True)
        w.add_tensor(f"{p}.mlp.2.bias", rand(d))
    w.write(tmp_path / "m.gguf")
    model = load_whisper(tmp_path / "m.gguf", cache_dir=tmp_path)
    assert (model.config.n_mels, model.config.n_audio_head, model.config.n_lang) == (80, 4, 99)
    on_card, on_cpu = params_to_torch(model.params, "cuda"), params_to_torch(model.params, "cpu")

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}") if isinstance(v, dict) else [(f"{prefix}/{k}", v)]

    card, cpu = dict(leaves(on_card)), dict(leaves(on_cpu))
    assert card.keys() == cpu.keys() and "/decoder/blocks/fc1/qw" in card
    for key, x in card.items():
        assert x.is_cuda and x.dtype == cpu[key].dtype and torch.equal(x.cpu(), cpu[key]), key


# --------------------------------------------------------------------------
# serving: the batching transcriber and several threads on one runner, at
# Large-V3's layout cut to 2 layers, the serving compute, 40 tokens


@pytest.fixture(scope="module")
def lv3_pipeline(lv3_two_layers):
    import numpy as np

    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    cfg, raw, _ = lv3_two_layers
    pipe = WhisperPipeline((cfg, raw), None, compute=_graph_compute("serving"), max_tokens=GRAPH_TOKENS,
                           device="cuda")
    rng = np.random.default_rng(7)
    audios = [(0.1 * rng.standard_normal(int(s * 16000))).astype(np.float32) for s in (30, 12, 5, 21, 1, 30, 9, 17)]
    return pipe, audios


def test_batching_transcriber_equals_transcribe_batch(lv3_pipeline):
    """Four requests in order from one thread (the transcriber's worker
    captures the runner's graph), then three (padded with a 1 s silence in
    "en"): per request, the tokens and language token of
    ``transcribe_batch`` on the same fixed batch, bit for bit."""
    import numpy as np

    from whisper_burn_tpu_torch.models import whisper as w
    from whisper_burn_tpu_torch.serving import BatchingTranscriber

    pipe, audios = lv3_pipeline
    w.clear_runners()
    langs = ["en", "auto", "de", "auto"]
    server = BatchingTranscriber(pipe, batch_size=4, max_wait_ms=2000)
    try:
        first = [r.wait(timeout=600) for r in [server.submit(a, l) for a, l in zip(audios[:4], langs)]]
        second = [r.wait(timeout=600) for r in [server.submit(a, l) for a, l in zip(audios[4:7], langs)]]
    finally:
        final = server.shutdown()
    assert (final["completed"], final["batches"]) == (7, 2)
    silence = np.zeros(16000, np.float32)
    for got, batch, blangs in ((first, audios[:4], langs), (second, audios[4:7] + [silence], langs[:3] + ["en"])):
        want = pipe.transcribe_batch(batch, blangs)
        for o, r in zip(got, want):
            np.testing.assert_array_equal(o.tokens, r.tokens)
            assert o.lang_token == r.lang_token
    assert len(w.cached_runners()) == 1
    w.clear_runners()


@pytest.mark.parametrize("cold", [False, True], ids=["captured", "cold"])
def test_threads_on_one_runner_equal_sequential(lv3_pipeline, cold):
    """Four threads, each transcribing its own batch of two utterances
    twice through one runner: each batch's sequential tokens. The runner
    is the one the sequential run captured, or (``cold``) a new one, which
    one thread captures while the others copy their audio to the card and
    compute its mel."""
    import threading

    import numpy as np

    from whisper_burn_tpu_torch.models import whisper as w

    pipe, audios = lv3_pipeline
    w.clear_runners()
    batches = [(audios[2 * t: 2 * t + 2], ["en", "auto"]) for t in range(4)]
    want = [pipe.transcribe_batch(a, l) for a, l in batches]
    if cold:
        w.clear_runners()
    got, errors = {}, []

    def client(t):
        try:
            got[t] = [pipe.transcribe_batch(*batches[t]) for _ in range(2)]
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads) and len(got) == 4
    for t in range(4):
        for results in got[t]:
            for o, r in zip(results, want[t]):
                np.testing.assert_array_equal(o.tokens, r.tokens)
                assert o.lang_token == r.lang_token
    assert len(w.cached_runners()) == 1
    w.clear_runners()


# --------------------------------------------------------------------------
# the teacher-forced steps of eval/quant_accuracy.py as a CUDA graph of one
# step, and the device fixture generator


FORCED_VARIANTS = ("q4_bf16", "q4_int8kv", "q4_int4selfkv")
FORCED_STEPS = 24


def _forced_inputs(lv3_two_layers, variant):
    from whisper_burn_tpu_torch.eval.quant_accuracy import VARIANTS
    from whisper_burn_tpu_torch.transcribe import prepare_params

    cfg, raw, mels = lv3_two_layers
    compute = VARIANTS[variant]
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    tokens = torch.randint(0, cfg.n_vocab, (GRAPH_B, FORCED_STEPS), generator=g, device="cuda", dtype=torch.int32)
    lang = torch.full((GRAPH_B,), cfg.lang_token_start, dtype=torch.int32, device="cuda")
    return cfg, prepare_params(raw, compute), mels[0], lang, tokens, compute


@pytest.mark.parametrize("variant", FORCED_VARIANTS)
def test_forced_replay_equals_eager_body(lv3_two_layers, variant):
    """The replayed teacher-forced logits equal the eager step's bit for
    bit, with the eager run's launches, in three serving variants."""
    from whisper_burn_tpu_torch.eval.quant_accuracy import forced_logits

    cfg, params, mel, lang, tokens, compute = _forced_inputs(lv3_two_layers, variant)
    _build.reset_launches()
    eager = forced_logits(params, cfg, mel, lang, tokens, compute, FORCED_STEPS, graph=False)
    eager_launches = dict(_build.LAUNCHES)
    _build.reset_launches()
    replayed = forced_logits(params, cfg, mel, lang, tokens, compute, FORCED_STEPS)
    assert torch.equal(replayed, eager)
    assert dict(_build.LAUNCHES) == eager_launches
    assert torch.isfinite(replayed[..., : cfg.n_vocab]).all()


def test_forced_step_capture_raises_on_a_host_read(lv3_two_layers):
    """A forced step that reads its step counter on the host runs eagerly
    but cannot be captured: the runner's capture raises."""
    from whisper_burn_tpu_torch.eval.quant_accuracy import ForcedRunner, forced_step
    from whisper_burn_tpu_torch.models.whisper import encode_and_fill

    cfg, params, mel, lang, tokens, compute = _forced_inputs(lv3_two_layers, "q4_bf16")

    class HostRead(ForcedRunner):
        def _body(self, variant):
            int(self.k)  # a host read of a device value
            return forced_step(self.params, self.cfg, self.compute, self.cache, self.tokens_t, self.k, self.out)

    cache = encode_and_fill(params, cfg, mel, compute, FORCED_STEPS, "forced_logits")
    out = torch.zeros((FORCED_STEPS, GRAPH_B, cfg.n_vocab_padded), device="cuda")
    runner = HostRead(params, cfg, compute, cache, tokens.long().T.contiguous(), out)
    with pytest.raises(RuntimeError):
        runner.step()  # the eager step, then the capture
    torch.cuda.synchronize()


def test_device_fixture_generator_quantizes_as_the_cpu(gen):
    """The device generator's Q4 codes and scales, made on the card, are
    the CPU quantizer's on the same float weights (``repack_f32`` and the
    device quantizer's CPU run): the card's float64 division, rounding and
    f16 scale agree bit for bit. CPU and CUDA generators draw different
    streams, so the floats are the card's own, moved to the CPU."""
    import numpy as np

    from whisper_burn_tpu_torch.gguf.repack import repack_f32
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_random_params, quantize_linears

    cfg = WhisperConfig.tiny_test().replace(n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4)
    for structured in (False, True):
        f32 = device_random_params(cfg, seed=1, quantized=False, structured=structured, device="cuda")
        q4 = device_random_params(cfg, seed=1, quantized=True, structured=structured, device="cuda")
        cpu = quantize_linears({side: {"blocks": {k: {n: t.cpu() for n, t in p.items()}
                                                  for k, p in f32[side]["blocks"].items() if "w" in p}}
                                for side in ("encoder", "decoder")})
        for side in ("encoder", "decoder"):
            for name, p in cpu[side]["blocks"].items():
                assert torch.equal(q4[side]["blocks"][name]["qw"].cpu(), p["qw"]), (side, name)
                assert torch.equal(q4[side]["blocks"][name]["scales"].cpu(), p["scales"]), (side, name)
        w = f32["decoder"]["blocks"]["fc2"]["w"][1].cpu().numpy()
        ref = repack_f32(np.ascontiguousarray(w.T))
        np.testing.assert_array_equal(q4["decoder"]["blocks"]["fc2"]["qw"][1].cpu().numpy(), ref.qw)
        np.testing.assert_array_equal(q4["decoder"]["blocks"]["fc2"]["scales"][1].cpu().numpy(), ref.scales)


# Tensor parallelism: Large-V3's per-rank shapes over 2 model ranks (10
# heads, D 640, F 2560) for kernels A (qkv 1280 -> 1920, the K-split
# projections 640 -> 1280, xattn_q 1280 -> 640), I (8 rows, 1280 <-> 2560,
# fc2's bias zeroed as the sharded FFN runs it), B, C and D; and G, H and
# C at 4 ranks' 5 heads (D 320: odd heads; G and H with 10 scale groups of
# 32 channels, one block a head; C one head a cluster) and at 3 heads.
TP2_Q4 = [(8, 1280, 1920), (8, 640, 1280), (8, 1280, 640), (32, 1280, 1920), (40, 640, 1280)]


@pytest.mark.parametrize("m,k,n", TP2_Q4)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_q4_matmul_kernel_tp2_shard(gen, m, k, n, dtype, tol):
    x, qw, sc, _ = _q4_inputs(gen, m, k, n, dtype)
    out = q4_matmul(x, qw, sc, layer=1)
    assert _rel_err(out, q4_matmul_plain(x, qw[1], sc[1], None, None, dtype)) <= tol


@pytest.mark.parametrize("m", [8, 40, 64])
@pytest.mark.parametrize("order", [True, False], ids=["K4", "K7"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_fused_ffn_kernel_tp2_shard(gen, m, order, dtype, tol):
    """Kernel I on a shard's F, fc2 without its bias (a null pointer, as
    the sharded FFN runs it; 64 bf16 rows take the wgmma regime)."""
    x, fc1, fc2 = _ffn_inputs(gen, m, 1280, 2560, dtype)
    fc2 = {k: v for k, v in fc2.items() if k != "b"}
    _build.reset_launches()
    out = fused_ffn(x, fc1, fc2, "erf", layer=1, bias_after_round=order)
    assert _build.LAUNCHES["fused_ffn"] == 1
    ref = fused_ffn_plain(x, *(fc1[k][1] for k in ("qw", "scales", "b")), fc2["qw"][1], fc2["scales"][1], None,
                          "erf", order)
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("pos", [0, 115, 226])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_self_attention_kernel_tp2_shard(gen, pos, dtype):
    l_dim, b, ctx, d, h = 2, 8, 256, 640, 10
    kc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    vc = torch.randint(-127, 128, (l_dim, b, ctx, d), generator=gen, device="cuda", dtype=torch.int8)
    sc = torch.rand((l_dim, b, ctx, 2), generator=gen, device="cuda") * 0.02 + 1e-3
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    kq = torch.randint(-127, 128, (b, 1, d), generator=gen, device="cuda", dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, 1, d), generator=gen, device="cuda", dtype=torch.int8)
    nsc = torch.rand((b, 1, 2), generator=gen, device="cuda") * 0.02 + 1e-3
    caches = [(kc.clone(), vc.clone(), sc.clone()) for _ in range(2)]
    out = decode_self_attention(q, *caches[0], 1, _at(pos), h, kn, vn, kq, vq, nsc)
    ref = decode_self_attention_plain(q, *caches[1], 1, _at(pos), h, kn, vn, kq, vq, nsc)
    assert _rel_err(out, ref) <= 1e-5
    assert all(torch.equal(a, r) for a, r in zip(*caches))


@pytest.mark.parametrize("groups", [1, 5])
def test_cross_attention_kernel_tp2_shard(gen, groups):
    l_dim, b, t, d, h = 2, 8, 1536, 640, 10
    kT = torch.randint(0, 256, (l_dim, b, d // 2, t), generator=gen, device="cuda", dtype=torch.uint8)
    v = torch.randint(0, 256, (l_dim, b, t // 2, d), generator=gen, device="cuda", dtype=torch.uint8)
    q = (torch.randn((b * groups, 1, d), generator=gen, device="cuda") * 0.05).to(torch.bfloat16)
    out = decode_cross_attention(q, kT, v, 1, 1500, h, groups)
    _cross_close(out, q, kT, v, 1, 1500, h, groups)


@pytest.mark.parametrize("groups", [1, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", [(320, 5), (192, 3)], ids=["tp4_shard", "three_heads"])
def test_cross_attention_kernel_odd_heads(gen, d, h, dtype, groups):
    """Kernel C at an odd head count (one head a cluster, each key channel
    row's own nibble) over the int4 cache in the JAX layout: the plain
    version's output, bitwise twice."""
    l_dim, b, t = 2, 8, 1536
    kT = torch.randint(0, 256, (l_dim, b, d // 2, t), generator=gen, device="cuda", dtype=torch.uint8)
    v = torch.randint(0, 256, (l_dim, b, t // 2, d), generator=gen, device="cuda", dtype=torch.uint8)
    q = (torch.randn((b * groups, 1, d), generator=gen, device="cuda") * 0.05).to(dtype)
    call = lambda: decode_cross_attention(q, kT, v, 1, 1500, h, groups)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_cross_attention"] == 1
    _cross_close(out, q, kT, v, 1, 1500, h, groups)
    _bitwise_twice(call, out)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
def test_encoder_attention_kernel_tp2_shard(gen, dtype, tol):
    b, t, valid, d, h = 2, 1536, 1500, 640, 10
    q, k, v = (torch.randn((b, t, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    out = encoder_attention(q, k, v, h, valid=valid)
    assert _rel_err(out[:, :valid], encoder_attention_plain(q, k, v, h, valid)[:, :valid]) <= tol


@pytest.mark.parametrize("fmt", ["groups", "mixed", "scalar", "unscaled"])
@pytest.mark.parametrize("pos", [0, 9, 115, 255])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h", [(320, 5), (192, 3)], ids=["tp4_shard", "three_heads"])
def test_int4_self_attention_kernels_odd_heads(gen, fmt, pos, dtype, d, h):
    """Kernels G and H at an odd head count (one block a head, each lane's
    own nibble and scale group): the plain versions' outputs, bitwise
    twice."""
    l_dim, b, ctx = 2, 8, 256
    k, v, sc = _int4_cache(gen, fmt, l_dim, b, ctx, d)
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device="cuda").to(dtype) for _ in range(3))
    call = lambda: decode_attention_merged_int4(q, k, v, sc, 1, _at(pos), h, kn, vn)
    _build.reset_launches()
    out = call()
    assert _build.LAUNCHES["decode_attention_merged_int4"] == 1
    assert _rel_err(out, decode_attention_merged_int4_plain(q, k, v, sc, 1, _at(pos), h, kn, vn)) <= 1e-5
    _bitwise_twice(call, out)
    call = lambda: decode_attention_layer_int4(q, k, v, sc, 1, _at(pos), h)
    out = call()
    assert _build.LAUNCHES["decode_attention_layer_int4"] == 1
    _close_parts(out, decode_attention_layer_int4_plain(q, k, v, sc, 1, _at(pos), h))
    _bitwise_twice(call, out)


# Kernel J (the LayerNorm) at its paths' rows: the encoder's B x 1536 at
# B = 32 and 8, the decode step's 32 and 40 (beam) streams, Whisper
# Medium's D 1024, and f32; each with and without the residual, and the
# encoder's final norm over a strided x[:, :1500].
LN_CASES = {  # id: (shape, dtype, strided)
    "enc_b32": ((49152, 1280), torch.bfloat16, False),
    "enc_b8": ((12288, 1280), torch.bfloat16, False),
    "step_32": ((32, 1, 1280), torch.bfloat16, False),
    "step_40": ((40, 1, 1280), torch.bfloat16, False),
    "medium": ((8, 1024), torch.bfloat16, False),
    "f32": ((40, 1, 1280), torch.float32, False),
    "enc_tail": ((4, 1500, 1280), torch.bfloat16, True),
}


@pytest.mark.parametrize("residual", [False, True], ids=["plain", "residual"])
@pytest.mark.parametrize("case", sorted(LN_CASES))
def test_layer_norm_kernel(gen, case, residual):
    """The sum bit for bit PyTorch's add; LN(s) within ``gap_allowance`` of
    the plain version (one step of the dtype, and a sliver of the row's
    terms where the output cancels to near zero: only the two row sums'
    order differs) and bf16 equal in 99.9% of elements; two calls bitwise
    equal."""
    shape, dtype, strided = LN_CASES[case]
    d = shape[-1]
    if strided:
        x = (torch.randn((shape[0], 1536, d), generator=gen, device="cuda") * 3 + 0.5).to(dtype)[:, : shape[1]]
    else:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 0.5).to(dtype)
    r = torch.randn(shape, generator=gen, device="cuda").to(dtype) if residual else None
    g = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    b = 0.1 * torch.randn(d, generator=gen, device="cuda")
    call = lambda: layer_norm(x, g, b, residual=r)
    _build.reset_launches()
    out = call()
    assert dict(_build.LAUNCHES) == {"layer_norm": 1}
    torch.cuda.synchronize()
    if residual:
        s, y = out
        assert s.dtype == dtype and torch.equal(s, x + r)
    else:
        s, y = x, out
    want = layer_norm_plain(s, g, b)
    assert y.shape == x.shape and y.dtype == dtype and y.is_contiguous()
    gap = (y.float() - want.float()).abs()
    assert bool((gap <= gap_allowance(s, g, want)).all()), float(gap.max())
    if dtype == torch.bfloat16:
        assert float((y == want).float().mean()) >= 0.999
    _bitwise_twice(call, out)


def test_layer_norm_kernel_in_a_graph(gen):
    """Captured into a CUDA graph and replayed twice: the eager call's bits."""
    x = torch.randn((40, 1, 1280), generator=gen, device="cuda").to(torch.bfloat16)
    r = torch.randn((40, 1, 1280), generator=gen, device="cuda").to(torch.bfloat16)
    g, b = torch.randn(1280, generator=gen, device="cuda"), torch.randn(1280, generator=gen, device="cuda")
    first = layer_norm(x, g, b, residual=r)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        captured = layer_norm(x, g, b, residual=r)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(first, captured))


def test_layer_norm_kernel_refuses(gen):
    g, b = torch.ones(1284, device="cuda"), torch.zeros(1284, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        layer_norm(torch.randn((4, 1284), device="cuda"), g, b)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        layer_norm(torch.randn((4, 1280), device="cuda").half(), g[:1280], b[:1280])
    with pytest.raises(ValueError, match="residual"):
        x = torch.randn((4, 1280), device="cuda")
        layer_norm(x.bfloat16(), g[:1280], b[:1280], residual=x)
