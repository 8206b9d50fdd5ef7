"""Kernel J's plain side on the CPU (``ops/layer_norm.py``): the plain
LayerNorm bit for bit the arithmetic the port had before the kernel, and
against the JAX package's; the residual form; the row layouts the wrapper
hands the kernel; and its launches counted but kept out of the launch log.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py -k layer_norm``)."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from whisper_burn_tpu.models.layers import layer_norm as j_layer_norm

from whisper_burn_tpu_torch.models.layers import layer_norm
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.layer_norm import NAME, _split, _strides, gap_allowance, layer_norm_plain
from whisper_burn_tpu_torch.ops.layer_norm import layer_norm as ln_op

SHAPES = [(4, 1280), (2, 3, 1024), (1, 1, 64)]
DTYPES = [torch.float32, torch.bfloat16]


def _before(x, g, b):
    """The port's LayerNorm as it was written before kernel J."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    centered = x32 - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    normed = centered * torch.rsqrt(var + 1e-5)
    return (normed * g.float() + b.float()).to(x.dtype)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 3 + 0.5).to(dtype)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(d).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(d).astype(np.float32))
    return x, g, b


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_is_the_arithmetic_before_the_kernel(shape, dtype):
    x, g, b = _inputs(shape, dtype)
    want = _before(x, g, b)
    for got in (layer_norm(x, g, b), layer_norm_plain(x, g, b), ln_op(x, g, b)):
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_layer_norm(shape, dtype):
    x, g, b = _inputs(shape, dtype, seed=1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(j_layer_norm(jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(g.numpy()),
                                   jnp.asarray(b.numpy())).astype(jnp.float32))
    got = layer_norm(x, g, b).float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:  # the two sums' orders differ: at most one bf16 step apart
        step = np.abs(want) * 2.0**-7 + 1e-30
        assert (np.abs(got - want) <= step).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_residual_form_is_the_add_then_the_norm(dtype):
    x, g, b = _inputs((3, 5, 128), dtype, seed=2)
    r, _, _ = _inputs((3, 5, 128), dtype, seed=3)
    for s, y in (ln_op(x, g, b, residual=r), layer_norm(x, g, b, residual=r)):
        assert torch.equal(s, x + r)
        assert torch.equal(y, _before(x + r, g, b))


def test_residual_must_be_like_x():
    x, g, b = _inputs((2, 64), torch.bfloat16, seed=4)
    with pytest.raises(ValueError, match="residual"):
        ln_op(x, g, b, residual=x.float())
    with pytest.raises(ValueError, match="residual"):
        ln_op(x, g, b, residual=x[:1])


@pytest.mark.parametrize("case", ["contiguous", "encoder_tail", "last_row", "one_row", "transposed", "three_strides"])
def test_rows_as_the_kernel_reads_them(case):
    """The wrapper's view of x's rows: two merged leading dims whose strides
    find every row where it lies, or None where it copies first."""
    base = torch.zeros(3, 16, 64, dtype=torch.bfloat16)
    x, split = {
        "contiguous": (base, (1, 48)),
        "encoder_tail": (base[:, :12], (3, 12)),  # x[:, :1500] of [B, 1536, D]
        "last_row": (base[:, -1], (1, 3)),  # the prompt's x[:, -1]
        "one_row": (base[1:2, 5:6], (1, 1)),
        "transposed": (base.transpose(0, 1)[:, :2], (16, 2)),
        "three_strides": (base.view(3, 4, 4, 64)[:, :2, :3], None),  # copied first
    }[case]
    assert _split(x) == split
    if split is None:
        return
    so, si = _strides(x, *split)
    rows = [x[idx] for idx in itertools.product(*map(range, x.shape[:-1]))]
    starts = [(r.data_ptr() - base.data_ptr()) // 2 for r in rows]
    first = (x.data_ptr() - base.data_ptr()) // 2
    assert starts == [first + k // split[1] * so + k % split[1] * si for k in range(len(rows))]


def test_misaligned_rows_are_copied():
    base = torch.zeros(4, 68, dtype=torch.bfloat16)
    assert _strides(base[:, 4:], 1, 4) is None  # rows of 64 at a stride of 136 bytes
    assert _strides(base[:, :64], 1, 4) is None
    assert _strides(base.view(-1)[8:8 + 4 * 64].view(4, 64), 1, 4) == (256, 64)


def test_launch_counted_and_kept_out_of_the_log():
    """A layer_norm launch counts in LAUNCHES and LAUNCH_SHAPES but never
    enters LAUNCH_LOG, counted directly or added by a graph's tally; a
    logged kernel's launch beside it does."""
    assert NAME in _build.UNLOGGED and NAME in _build.SOURCES
    shape = (32, 1280, 2, 1)
    saved = _build.LAUNCH_LOG
    _build.reset_launches()
    _build.LAUNCH_LOG = []
    try:
        _build.count_launch(NAME, shape)
        _build.count_launch("q4_matmul", (8, 1280, 3840))
        assert _build.LAUNCH_LOG == [("q4_matmul", (8, 1280, 3840))]
        with _build.recording_launches() as recorded:
            _build.count_launch(NAME, shape)
            _build.count_launch("fused_ffn", (8,))
            _build.count_collective("all_reduce")
            _build.count_launch(NAME, shape)
        tally = _build.LaunchTally(recorded)
        assert tally.log == [("fused_ffn", (8,))]
        assert tally.names == {NAME: 2, "fused_ffn": 1}
        for _ in range(3):
            _build.add_launches(tally)
        assert _build.LAUNCHES[NAME] == 1 + 3 * 2
        assert _build.LAUNCH_SHAPES[(NAME, shape)] == 7
        assert _build.COLLECTIVES["all_reduce"] == 3
        assert all(name != NAME for name, _ in _build.LAUNCH_LOG)
        assert len(_build.LAUNCH_LOG) == 1 + 3
    finally:
        _build.LAUNCH_LOG = saved
        _build.reset_launches()


def test_cpu_tensors_launch_nothing():
    x, g, b = _inputs((2, 8, 128), torch.bfloat16)
    _build.reset_launches()
    layer_norm(x, g, b)
    layer_norm(x, g, b, residual=x)
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_gap_allowance(dtype):
    """One step of the dtype at the output, and a sliver of the row's terms
    (2^-22: in bf16 below a step wherever the output is of the row's
    scale, in f32 a few steps)."""
    x, g, b = _inputs((4, 256), dtype, seed=5)
    b[7] = 0.0
    want = layer_norm_plain(x, g, b)
    allow = gap_allowance(x, g, want)
    assert allow.shape == want.shape and bool((allow > 0).all())
    w = want.float()
    step = torch.exp2(torch.floor(torch.log2(w.abs()))) * torch.finfo(dtype).eps
    big = w.abs() > 0.5
    assert bool((allow[big] >= step[big]).all())
    if dtype == torch.bfloat16:
        assert bool((allow[big] < 1.01 * step[big]).all())
    else:
        assert bool((allow[big] < 32 * step[big]).all())
    assert float(allow.min()) > 2.0**-24  # never below the terms' own rounding
