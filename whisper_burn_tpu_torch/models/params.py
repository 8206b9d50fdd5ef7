"""Parameter dicts: random and fabricated fixtures, fusing, W8A8 copies.

Port of ``whisper_burn_tpu/models/params.py``. The model is a nested dict
of tensors; per-layer blocks are stacked along a leading layer axis
(``[L, ...]``) so the decode kernels can index a layer without a copy.

Structure (D = n_state, F = 4D, V = n_vocab_padded, ``lin`` = quantized
``{qw int8 [K, N], scales f32 [K/32, N], b? [N]}`` or dense ``{w, b?}``)::

    {"encoder": {"conv1": {"w", "b"}, "conv2": {"w", "b"}, "pos": [T, D],
                 "blocks": {"attn_ln": {"g", "b"}, "attn_q/k/v/o": lin,
                            "mlp_ln", "fc1": lin, "fc2": lin},
                 "ln_post": {"g", "b"}},
     "decoder": {"tok_emb": [V, D], "pos": [n_text_ctx, D],
                 "blocks": {...encoder keys..., "xattn_ln",
                            "xattn_q/k/v/o": lin},
                 "ln": {"g", "b"}}}

The numpy fixtures draw from the same ``np.random.default_rng`` stream as
the JAX package, so the same seed gives the same numbers bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from whisper_burn_tpu_torch.gguf.repack import repack_f32, repack_f32_tensor
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.ops.compute import resolve_device

Params = dict[str, Any]

Q4_BLOCK = 32


def stack_layers(layers: list[Params]) -> Params:
    """Stack identical per-layer dicts of arrays along a new leading axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: stack_layers([p[k] for p in layers]) for k in first}
    return np.stack(layers)


def _rand_linear(
    rng: np.random.Generator, k: int, n: int, *, quantized: bool, bias: bool, scale: float = 0.05
) -> Params:
    w = rng.standard_normal((n, k)).astype(np.float32) * scale  # [N, K] ckpt layout
    if quantized:
        qt = repack_f32(w)
        p: Params = {"qw": qt.qw, "scales": qt.scales}
    else:
        p = {"w": np.ascontiguousarray(w.T)}
    if bias:
        p["b"] = rng.standard_normal(n).astype(np.float32) * 0.01
    return p


def _rand_ln(rng: np.random.Generator, d: int) -> Params:
    return {
        "g": 1.0 + rng.standard_normal(d).astype(np.float32) * 0.02,
        "b": rng.standard_normal(d).astype(np.float32) * 0.02,
    }


def _rand_block(
    rng: np.random.Generator, d: int, f: int, *, cross: bool, quantized: bool, scale: float = 0.05
) -> Params:
    lin = lambda k, n, bias: _rand_linear(rng, k, n, quantized=quantized, bias=bias, scale=scale)
    p = {
        "attn_ln": _rand_ln(rng, d),
        "attn_q": lin(d, d, True),
        "attn_k": lin(d, d, False),
        "attn_v": lin(d, d, True),
        "attn_o": lin(d, d, True),
        "mlp_ln": _rand_ln(rng, d),
        "fc1": lin(d, f, True),
        "fc2": lin(f, d, True),
    }
    if cross:
        p.update(
            xattn_ln=_rand_ln(rng, d),
            xattn_q=lin(d, d, True),
            xattn_k=lin(d, d, False),
            xattn_v=lin(d, d, True),
            xattn_o=lin(d, d, True),
        )
    return p


def sinusoidal_positions(length: int, channels: int) -> np.ndarray:
    """Whisper's sinusoidal encoder positions."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def random_params(
    cfg: WhisperConfig, seed: int = 0, *, quantized: bool = True, device=None
) -> Params:
    """Random model parameters with the real structure (test fixture)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.n_audio_state, cfg.ffn_dim
    enc_blocks = [
        _rand_block(rng, d, f, cross=False, quantized=quantized) for _ in range(cfg.n_audio_layer)
    ]
    dec_blocks = [
        _rand_block(rng, d, f, cross=True, quantized=quantized) for _ in range(cfg.n_text_layer)
    ]
    tok_emb = np.zeros((cfg.n_vocab_padded, d), dtype=np.float32)
    tok_emb[: cfg.n_vocab] = rng.standard_normal((cfg.n_vocab, d)).astype(np.float32) * 0.02
    np_params = {
        "encoder": {
            "conv1": {
                "w": rng.standard_normal((d, cfg.n_mels, 3)).astype(np.float32) * 0.05,
                "b": np.zeros(d, np.float32),
            },
            "conv2": {
                "w": rng.standard_normal((d, d, 3)).astype(np.float32) * 0.02,
                "b": np.zeros(d, np.float32),
            },
            "pos": sinusoidal_positions(cfg.n_audio_ctx, d),
            "blocks": stack_layers(enc_blocks),
            "ln_post": _rand_ln(rng, d),
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos": rng.standard_normal((cfg.n_text_ctx, d)).astype(np.float32) * 0.01,
            "blocks": stack_layers(dec_blocks),
            "ln": _rand_ln(rng, d),
        },
    }
    return params_to_torch(np_params, device)


def structured_params(
    cfg: WhisperConfig, seed: int = 0, *, quantized: bool = True, v_eff: int = 64, device=None
) -> Params:
    """The accuracy fixture with a peaked logit surface, bit for bit the
    JAX package's for the same seed and ``quantized`` flag.

    :func:`random_params`' i.i.d. weights at a 51k vocab give a nearly
    flat logit surface, where argmax agreement under weight quantization
    is tie-breaking noise. Here the block weights scale as 1/sqrt(depth),
    so the residual stream stays O(1) as in a trained net, and the first
    ``v_eff`` embedding rows are anchors at 20x the tail's norm, so the
    logits are peaked over a small effective vocabulary (kept small: the
    top-2 margin among n anchor projections shrinks as n grows).
    ``quantized`` picks the member of a matched f32/Q4 pair: the same
    stream, so the same float weights."""
    rng = np.random.default_rng(seed)
    d, f = cfg.n_audio_state, cfg.ffn_dim
    depth = max(cfg.n_audio_layer, cfg.n_text_layer)
    scale = 0.05 / float(np.sqrt(depth))
    enc_blocks = [
        _rand_block(rng, d, f, cross=False, quantized=quantized, scale=scale) for _ in range(cfg.n_audio_layer)
    ]
    dec_blocks = [
        _rand_block(rng, d, f, cross=True, quantized=quantized, scale=scale) for _ in range(cfg.n_text_layer)
    ]
    v_eff = min(v_eff, cfg.n_vocab)
    tok_emb = np.zeros((cfg.n_vocab_padded, d), dtype=np.float32)
    tok_emb[: cfg.n_vocab] = rng.standard_normal((cfg.n_vocab, d)).astype(np.float32) * 0.002
    tok_emb[:v_eff] *= 20.0  # anchor rows: a clear winner set for the argmax
    np_params = {
        "encoder": {
            "conv1": {
                "w": rng.standard_normal((d, cfg.n_mels, 3)).astype(np.float32) * 0.05,
                "b": np.zeros(d, np.float32),
            },
            "conv2": {
                "w": rng.standard_normal((d, d, 3)).astype(np.float32) * 0.02,
                "b": np.zeros(d, np.float32),
            },
            "pos": sinusoidal_positions(cfg.n_audio_ctx, d),
            "blocks": stack_layers(enc_blocks),
            "ln_post": _rand_ln(rng, d),
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos": rng.standard_normal((cfg.n_text_ctx, d)).astype(np.float32) * 0.01,
            "blocks": stack_layers(dec_blocks),
            "ln": _rand_ln(rng, d),
        },
    }
    return params_to_torch(np_params, device)


LINEARS = ("attn_q", "attn_k", "attn_v", "attn_o", "fc1", "fc2", "xattn_q", "xattn_k", "xattn_v", "xattn_o")


def quantize_linears(params: Params) -> Params:
    """The Q4 member of a matched pair from its f32 member: every dense
    block linear ``{"w": [L, K, N]}`` becomes ``{"qw", "scales"}`` through
    :func:`~whisper_burn_tpu_torch.gguf.repack.repack_f32_tensor` on the
    weights' device, bit for bit what the numpy fixtures'
    ``quantized=True`` gives for the same seed. Unfused params only."""

    def blocks(bp: Params) -> Params:
        out = dict(bp)
        for name in LINEARS:
            p = bp.get(name)
            if p is not None and "w" in p:
                qw, scales = repack_f32_tensor(p["w"].transpose(-1, -2))
                out[name] = {"qw": qw, "scales": scales, **({"b": p["b"]} if "b" in p else {})}
        return out

    return {
        side: {**params[side], "blocks": blocks(params[side]["blocks"])} for side in ("encoder", "decoder")
    }


def device_random_params(
    cfg: WhisperConfig, seed: int = 0, *, quantized: bool = True, structured: bool = False, v_eff: int = 64,
    device=None,
) -> Params:
    """:func:`random_params` (or, with ``structured``, :func:`structured_params`)
    drawn on the device from a seeded ``torch.Generator``: the same
    distributions, structure and dtypes, and Q4 codes and scales made on
    the device with ``repack_f32``'s arithmetic (:func:`quantize_linears`).
    ``quantized`` again picks the member of a matched pair. The stream is
    PyTorch's, not numpy's, and differs between the CPU and CUDA
    generators, so a seed here gives other weights than the numpy
    fixtures' (and ``ACCURACY.json``'s) seed of the same number. At
    Large-V3 the numpy fixtures take the host minutes; this takes the card
    seconds."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, f = cfg.n_audio_state, cfg.ffn_dim
    depth = max(cfg.n_audio_layer, cfg.n_text_layer)
    scale = 0.05 / float(np.sqrt(depth)) if structured else 0.05

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=dev) * std + mean

    def ln(l):
        return {"g": randn(l, d, std=0.02, mean=1.0), "b": randn(l, d, std=0.02)}

    def lin(l, k, n, bias):
        p = {"w": randn(l, k, n, std=scale)}
        if bias:
            p["b"] = randn(l, n, std=0.01)
        return p

    def blocks(l, cross):
        p = {
            "attn_ln": ln(l),
            "attn_q": lin(l, d, d, True),
            "attn_k": lin(l, d, d, False),
            "attn_v": lin(l, d, d, True),
            "attn_o": lin(l, d, d, True),
            "mlp_ln": ln(l),
            "fc1": lin(l, d, f, True),
            "fc2": lin(l, f, d, True),
        }
        if cross:
            p.update(
                xattn_ln=ln(l),
                xattn_q=lin(l, d, d, True),
                xattn_k=lin(l, d, d, False),
                xattn_v=lin(l, d, d, True),
                xattn_o=lin(l, d, d, True),
            )
        return p

    tok_emb = torch.zeros((cfg.n_vocab_padded, d), device=dev)
    tok_emb[: cfg.n_vocab] = randn(cfg.n_vocab, d, std=0.002 if structured else 0.02)
    if structured:
        tok_emb[: min(v_eff, cfg.n_vocab)] *= 20.0
    one_ln = lambda: {k: v[0] for k, v in ln(1).items()}
    params = {
        "encoder": {
            "conv1": {"w": randn(d, cfg.n_mels, 3, std=0.05), "b": torch.zeros(d, device=dev)},
            "conv2": {"w": randn(d, d, 3, std=0.02), "b": torch.zeros(d, device=dev)},
            "pos": torch.from_numpy(sinusoidal_positions(cfg.n_audio_ctx, d)).to(dev),
            "blocks": blocks(cfg.n_audio_layer, False),
            "ln_post": one_ln(),
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos": randn(cfg.n_text_ctx, d, std=0.01),
            "blocks": blocks(cfg.n_text_layer, True),
            "ln": one_ln(),
        },
    }
    return quantize_linears(params) if quantized else params


def _fab_linear(rng: np.random.Generator, k: int, n: int, *, bias: bool) -> Params:
    """A quantized linear fabricated directly (codes + f16-exact scales),
    without the float quantize round trip."""
    raw = np.frombuffer(rng.bytes(k * n), dtype=np.uint8)
    qw = ((raw & 0x0F).astype(np.int8) - 8).reshape(k, n)
    scales = (
        (rng.uniform(0.5, 1.5, size=(k // 32, n)) * (0.05 / 7))
        .astype(np.float16)
        .astype(np.float32)
    )
    p: Params = {"qw": qw, "scales": scales}
    if bias:
        p["b"] = rng.standard_normal(n).astype(np.float32) * 0.01
    return p


def fabricated_quantized_params(cfg: WhisperConfig, seed: int = 0, device=None) -> Params:
    """Benchmark fixture with the structure, dtypes and shapes of a real
    Q4_0 checkpoint, drawn with numpy exactly as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    d, f = cfg.n_audio_state, cfg.ffn_dim

    def block(cross: bool) -> Params:
        p = {
            "attn_ln": _rand_ln(rng, d),
            "attn_q": _fab_linear(rng, d, d, bias=True),
            "attn_k": _fab_linear(rng, d, d, bias=False),
            "attn_v": _fab_linear(rng, d, d, bias=True),
            "attn_o": _fab_linear(rng, d, d, bias=True),
            "mlp_ln": _rand_ln(rng, d),
            "fc1": _fab_linear(rng, d, f, bias=True),
            "fc2": _fab_linear(rng, f, d, bias=True),
        }
        if cross:
            p.update(
                xattn_ln=_rand_ln(rng, d),
                xattn_q=_fab_linear(rng, d, d, bias=True),
                xattn_k=_fab_linear(rng, d, d, bias=False),
                xattn_v=_fab_linear(rng, d, d, bias=True),
                xattn_o=_fab_linear(rng, d, d, bias=True),
            )
        return p

    # draw order matters for bit-identical numbers: embedding first, then
    # the rest in dict order
    tok_emb = np.zeros((cfg.n_vocab_padded, d), dtype=np.float32)
    tok_emb[: cfg.n_vocab] = rng.standard_normal((cfg.n_vocab, d)).astype(np.float32) * 0.02
    np_params = {
        "encoder": {
            "conv1": {
                "w": rng.standard_normal((d, cfg.n_mels, 3)).astype(np.float32) * 0.05,
                "b": np.zeros(d, np.float32),
            },
            "conv2": {
                "w": rng.standard_normal((d, d, 3)).astype(np.float32) * 0.02,
                "b": np.zeros(d, np.float32),
            },
            "pos": sinusoidal_positions(cfg.n_audio_ctx, d),
            "blocks": stack_layers([block(False) for _ in range(cfg.n_audio_layer)]),
            "ln_post": _rand_ln(rng, d),
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos": rng.standard_normal((cfg.n_text_ctx, d)).astype(np.float32) * 0.01,
            "blocks": stack_layers([block(True) for _ in range(cfg.n_text_layer)]),
            "ln": _rand_ln(rng, d),
        },
    }
    return params_to_torch(np_params, device)


def device_fabricated_params(cfg: WhisperConfig, seed: int = 0, device=None) -> Params:
    """The fabricated fixture drawn on the device with a seeded
    ``torch.Generator``: same structure, dtypes and distributions as
    :func:`fabricated_quantized_params`, other numbers. At Large-V3 the
    numpy fixture spends minutes on the host; this one takes seconds."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    d, f = cfg.n_audio_state, cfg.ffn_dim

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(shape, generator=g, device=dev) * std + mean

    def ln(l):
        return {"g": randn(l, d, std=0.02, mean=1.0), "b": randn(l, d, std=0.02)}

    def lin(l, k, n, bias):
        p = {
            "qw": torch.randint(-8, 8, (l, k, n), generator=g, device=dev, dtype=torch.int8),
            "scales": ((torch.rand((l, k // 32, n), generator=g, device=dev) + 0.5) * (0.05 / 7))
            .half()
            .float(),
        }
        if bias:
            p["b"] = randn(l, n, std=0.01)
        return p

    def blocks(l, cross):
        p = {
            "attn_ln": ln(l),
            "attn_q": lin(l, d, d, True),
            "attn_k": lin(l, d, d, False),
            "attn_v": lin(l, d, d, True),
            "attn_o": lin(l, d, d, True),
            "mlp_ln": ln(l),
            "fc1": lin(l, d, f, True),
            "fc2": lin(l, f, d, True),
        }
        if cross:
            p.update(
                xattn_ln=ln(l),
                xattn_q=lin(l, d, d, True),
                xattn_k=lin(l, d, d, False),
                xattn_v=lin(l, d, d, True),
                xattn_o=lin(l, d, d, True),
            )
        return p

    tok_emb = torch.zeros((cfg.n_vocab_padded, d), device=dev)
    tok_emb[: cfg.n_vocab] = randn(cfg.n_vocab, d, std=0.02)
    one_ln = lambda: {k: v[0] for k, v in ln(1).items()}
    return {
        "encoder": {
            "conv1": {"w": randn(d, cfg.n_mels, 3, std=0.05), "b": torch.zeros(d, device=dev)},
            "conv2": {"w": randn(d, d, 3, std=0.02), "b": torch.zeros(d, device=dev)},
            "pos": torch.from_numpy(sinusoidal_positions(cfg.n_audio_ctx, d)).to(dev),
            "blocks": blocks(cfg.n_audio_layer, False),
            "ln_post": one_ln(),
        },
        "decoder": {
            "tok_emb": tok_emb,
            "pos": randn(cfg.n_text_ctx, d, std=0.01),
            "blocks": blocks(cfg.n_text_layer, True),
            "ln": one_ln(),
        },
    }


def params_to_torch(np_params: Params, device=None) -> Params:
    """Bridge from a dict of numpy arrays (the JAX package's parameter
    layout) to the same dict of tensors on ``device`` (``cuda`` unless
    the caller asks for another one)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return conv(np_params)


def _w8_from_q4(qw: torch.Tensor, scales: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-column int8 requant of a stacked Q4 weight: ``qw [L, K, N]`` +
    ``scales [L, K/32, N]`` -> (``qw8 [L, K, N] int8``, ``s8 [L, N] f32``)
    with absmax/127 column scales. The per-32-block Q4 scales cannot factor
    out of an integer dot; rank-1 scales can."""
    l_dim, k, n = qw.shape
    qw8 = torch.empty_like(qw)
    s8 = torch.empty((l_dim, n), dtype=torch.float32, device=qw.device)
    for l in range(l_dim):  # per layer: bounds the f32 transient to one matrix
        w = qw[l].float() * scales[l].float().repeat_interleave(Q4_BLOCK, dim=0)
        s8[l] = torch.clamp_min(w.abs().amax(dim=0), 1e-12) / 127.0
        qw8[l] = torch.clamp(torch.round(w / s8[l]), -127, 127).to(torch.int8)
    return qw8, s8


def attach_w8a8(params: Params) -> Params:
    """Replace the Q4 codes of the large-M surfaces (every encoder linear,
    the decoder's cross-KV projections) by per-column int8 copies
    ``{qw8, s8}``: those matmuls run at M = B*1500 where
    ops/linear.w8a8_matmul always serves them. Decode matmuls keep Q4."""

    def augment(blocks: Params, names) -> Params:
        out = dict(blocks)
        for name in names:
            p = blocks.get(name)
            if p is None or "qw" not in p:
                continue
            qw8, s8 = _w8_from_q4(p["qw"], p["scales"])
            out[name] = {k: v for k, v in p.items() if k not in ("qw", "scales")}
            out[name].update(qw8=qw8, s8=s8)
        return out

    enc_names = ("attn_qkv", "attn_q", "attn_k", "attn_v", "attn_o", "fc1", "fc2")
    dec_names = ("xattn_kv", "xattn_k", "xattn_v")
    return {
        **params,
        "encoder": {**params["encoder"], "blocks": augment(params["encoder"]["blocks"], enc_names)},
        "decoder": {**params["decoder"], "blocks": augment(params["decoder"]["blocks"], dec_names)},
    }


def _interleave_n(arrs: list[torch.Tensor], tp: int) -> torch.Tensor:
    """Concatenate ``[..., N]`` tensors along N, interleaved at ``tp``-shard
    granularity: ``[a0_s0 | a1_s0 | ... | a0_s1 | a1_s1 | ...]`` where
    ``ai_sj`` is tensor i's j-th N shard; a plain concat at ``tp = 1``. An
    equal split of the fused N axis into ``tp`` shards then gives each
    model rank its own ``[q | k | v]`` slab, so ``ops/linear.qkv_proj``'s
    thirds stay right on a shard."""
    if tp == 1:
        return torch.cat(arrs, dim=-1)
    for a in arrs:
        if a.shape[-1] % tp:
            raise ValueError(f"fused N axis {a.shape[-1]} not divisible by tp={tp}")
    return torch.cat([c for s in range(tp) for c in (a.chunk(tp, dim=-1)[s] for a in arrs)], dim=-1)


def _fuse_linears(linears: list[Params], tp: int = 1) -> Params:
    """Concatenate linears that share an input along the output axis;
    a missing bias (the key projections) becomes zeros. ``tp > 1`` builds
    the shard-interleaved layout of :func:`_interleave_n`."""
    key = "qw" if "qw" in linears[0] else "w"
    fused: Params = {key: _interleave_n([p[key] for p in linears], tp)}
    if key == "qw":
        fused["scales"] = _interleave_n([p["scales"] for p in linears], tp)
    if any("b" in p for p in linears):
        biases = []
        for p in linears:
            if "b" in p:
                biases.append(p["b"])
            else:
                shape = p[key].shape[:-2] + p[key].shape[-1:]
                biases.append(torch.zeros(shape, dtype=torch.float32, device=p[key].device))
        fused["b"] = _interleave_n(biases, tp)
    return fused


def fuse_attention_params(params: Params, tp: int = 1) -> Params:
    """Fuse q/k/v (``attn_qkv``) and cross k/v (``xattn_kv``) projections
    into single wide matmuls. ``tp > 1`` builds the fused N axis
    shard-interleaved, for params that ``parallel/sharding.shard_params``
    then splits over ``tp`` model ranks (wrong to use unsharded)."""

    def fuse_blocks(blocks: Params, cross: bool) -> Params:
        nb = dict(blocks)
        nb["attn_qkv"] = _fuse_linears([blocks["attn_q"], blocks["attn_k"], blocks["attn_v"]], tp)
        for k in ("attn_q", "attn_k", "attn_v"):
            del nb[k]
        if cross:
            nb["xattn_kv"] = _fuse_linears([blocks["xattn_k"], blocks["xattn_v"]], tp)
            del nb["xattn_k"], nb["xattn_v"]
        return nb

    return {
        **params,
        "encoder": {**params["encoder"], "blocks": fuse_blocks(params["encoder"]["blocks"], False)},
        "decoder": {**params["decoder"], "blocks": fuse_blocks(params["decoder"]["blocks"], True)},
    }
