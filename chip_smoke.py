"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each timed and each fatal on failure:

1. card: the GPU's name and power limit as nvidia-smi reports them;
2. build: ``nvcc`` compiles every kernel of ``whisper_burn_tpu_torch/csrc``
   (one process per source, in parallel) into ``build/kernels``;
3. main paths: Large-V3 serving parameters fabricated on the device from a
   seed, ``prepare_params`` with the serving compute (bf16, int4 cross-KV,
   int8 self-KV, int8 logits, W8A8), then (a) three greedy requests of
   8 x 30 s of seeded synthetic audio through mel ->
   ``greedy_decode(max_tokens=224)`` and (b) three beam requests of the
   same audio through mel -> ``beam_decode(beam_width=5, max_tokens=224)``
   (8 utterances x 5 beams = 40 decode streams; the first request is a
   warm-up, the other two are timed). Every launch counter is set to 0
   just before each path and read just after; each request's launches are
   held against the counts the shapes predict, and its host syncs counted
   (at most one per done check);
4. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' Large-V3 shapes (kernel A at M = 8, 32 and
   40 rows; B; C ungrouped and with 5 streams per cross-cache entry; D; E
   at 4, 115 and 227 valid keys; F exactly), with the tolerance stated;
   device time per call, from torch.profiler traces, of the kernel, the
   plain version and one PyTorch library call computing the same function
   (a yardstick only: the port never calls it), and the least time the
   card could take (bytes over 3.35 TB/s or operations over 989 TFLOP/s);
   then one more greedy request and one beam request of 32 tokens under
   torch.profiler, whose traces give each kernel's device time per launch
   at each main-path shape, the stages ``greedy_decode`` and
   ``beam_decode`` mark, and the decode step split into the hand-written
   kernels, the beam's self-cache reorder (its ``beam_decode.reorder``
   ranges), other device work and idle;
5. end to end at a small config in f32: the same greedy and beam tokens,
   and the same teacher-forced logits (ungrouped and grouped), through the
   kernels as through the plain versions.

It prints ``{"kernels": [...]}`` and the card line before its last line,
and last ``{"ok": true, "device": {...}}``. It needs one CUDA card and the
repository beside it, and exits non-zero without a result otherwise.
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
BATCH, REQUESTS, MAX_TOKENS = 8, 3, 224
BEAM_WIDTH, TRACED_BEAM_TOKENS = 5, 32
STREAMS = BATCH * BEAM_WIDTH  # beam search's decode rows
SEED = 0
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the hand-written kernels as the trace names them, by counter name
KERNEL_OF = {"q4_matmul": "q4_matmul", "decode_self_attention": "self_attn",
             "decode_attention_layer": "layer_attn", "decode_cross_attention": "cross_attn",
             "encoder_attention": "encoder_attn", "write_cache_slot": "slot"}
OURS = re.compile(r"\b(q4_matmul|self_attn|layer_attn|cross_attn|encoder_attn|slot)_kernel<")
STAGES = {"encode", "cross_fill", "prefill", "decode"}


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def traced(fn):
    """``fn()`` under torch.profiler (host and device); returns its result
    and the device events of the trace (kernels, copies, fills; chrome
    trace form, times in microseconds) and its host and device ranges."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"trace-{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink()
    device = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    ranges = [e for e in events if e.get("cat") in ("user_annotation", "gpu_user_annotation")]
    return out, sorted(device, key=lambda e: e["ts"]), ranges


def signature(e: dict) -> tuple[str, str]:
    """A kernel launch as the trace shows it: its name and grid."""
    return e["name"], str(e.get("args", {}).get("grid"))


def device_ms(fn, iters: int, warmup: int = 3, ours: bool = False):
    """Device milliseconds per call of ``fn`` from a trace of ``iters``
    calls: the summed durations of what it runs on the card, host dispatch
    excluded. With ``ours``, the mean duration of the hand-written kernel's
    launches and their signatures. The trace may lose a launch's record
    (the first of a session most often), so two calls run in the session
    before the timed window, and ``ours`` averages the records it got."""
    from torch.profiler import record_function

    for _ in range(warmup):
        fn()

    def window():
        fn(), fn()
        with record_function("chip_smoke.window"):
            for _ in range(iters):
                fn()

    _, dev, ranges = traced(window)
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
                 if e["cat"] == "gpu_user_annotation" and e["name"] == "chip_smoke.window"]
    dev = [e for e in dev if lo <= e["ts"] <= hi]
    if not ours:
        return sum(e["dur"] for e in dev) / iters / 1e3
    mine = [e for e in dev if OURS.search(e["name"])]
    if not iters - 2 <= len(mine) <= iters:
        raise AssertionError(f"{len(mine)} kernel launches traced for {iters} calls")
    return sum(e["dur"] for e in mine) / len(mine) / 1e3, {signature(e) for e in mine}


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations")


def mean_decode_pos(steps: int) -> float:
    """Mean cache position of ``steps`` decode steps: step k writes at
    PROMPT_LEN + k - 1 = 3 + k and reads the keys below it."""
    return 3 + (steps + 1) / 2


def self_attention_bound(pos: float, d: int) -> tuple[float, str]:
    """Kernel B at ``pos``: q bf16, the int8 K/V rows below pos and their
    f32 scales, the raw k/v bf16, their int8 codes and scales, the f32
    output, and the stored row and scales."""
    nbytes = BATCH * (d * 2 + 2 * pos * d + pos * 8 + 2 * d * 2 + 2 * d + 8 + d * 4 + 2 * d + 8)
    return bound(nbytes, 4.0 * BATCH * (pos + 1) * d)


def layer_attention_bound(pos: float, d: int, h: int) -> tuple[float, str]:
    """Kernel E at ``pos`` over the STREAMS beam streams: q bf16, the int8
    K/V rows below pos and their f32 scales, acc f32 and m, l f32."""
    nbytes = STREAMS * (d * 2 + 2 * pos * d + pos * 8 + d * 4 + 2 * h * 4)
    return bound(nbytes, 4.0 * STREAMS * pos * d)


def max_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


def check(name: str, err: float, ref: torch.Tensor, rel: float) -> None:
    """Fail unless ``err <= rel * max|ref|`` (tolerance relative to the
    output's scale: the sums run in another order than the plain version,
    and a bf16 output may round to the neighbouring value)."""
    tol = rel * max(ref.float().abs().max().item(), 1e-30)
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err:.3e} above {tol:.3e}")


# --------------------------------------------------------------------------
# phase 4: the kernels against their plain versions, and the traced request


def q4_rows(cases, gen, path: str) -> list[dict]:
    """Kernel A at each (site, rows, linear, gelu, out dtype, replaces) of
    ``cases`` against its plain version in bf16 and f32, and its times."""
    from whisper_burn_tpu_torch.ops import q4_kernel
    from whisper_burn_tpu_torch.ops.q4_matmul import dequant_weight

    dev = torch.device("cuda")
    q4 = "whisper_burn_tpu_torch/csrc/q4_matmul.cu"
    rows = []
    for site, m, lin, gelu, out_dtype, replaces in cases:
        n_layers, k, n = lin["qw"].shape
        bias = lin.get("b")
        epi = 0 if bias is None else {None: 1, "tanh": 2, "erf": 3}[gelu]
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        for dtype, rel in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            xi = x.to(dtype)
            od = out_dtype if dtype == torch.bfloat16 else torch.float32
            out = q4_kernel.q4_matmul(xi, lin["qw"], lin["scales"], layer=0, bias=bias, gelu=gelu, out_dtype=od)
            ref = q4_kernel.q4_matmul_plain(
                xi, lin["qw"][0], lin["scales"][0], None if bias is None else bias[0], gelu, od
            )
            err = max_err(out, ref)
            # bf16: one bf16 step of the output (2^-8) plus f32 order noise;
            # f32: the sum of K products in another order
            check(f"q4_matmul/{site} {dtype}", err, ref, rel)
            if dtype == torch.bfloat16:
                err_bf16 = err
        it = iter(range(1 << 30))
        layer = lambda: next(it) % n_layers  # cycle layers: weights come from HBM, not L2
        kern = lambda: q4_kernel.q4_matmul(
            x, lin["qw"], lin["scales"], layer=layer(), bias=bias, gelu=gelu, out_dtype=out_dtype
        )
        plain = lambda: q4_kernel.q4_matmul_plain(
            x, lin["qw"][(l := layer())], lin["scales"][l], None if bias is None else bias[l], gelu, out_dtype
        )
        w16 = [dequant_weight(lin["qw"][l], lin["scales"][l], torch.bfloat16) for l in range(n_layers)]
        lib = lambda: torch.matmul(x, w16[layer()])
        (ms, sig), plain_ms, lib_ms = device_ms(kern, 64, ours=True), device_ms(plain, 16), device_ms(lib, 64)
        del w16
        ybytes = 2 if out_dtype == torch.bfloat16 else 4
        nbytes = m * k * 2 + k * n + (k // 32) * n * 4 + (n * 4 if bias is not None else 0) + m * n * ybytes
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
        rows.append(dict(
            name=f"q4_matmul/{site}", route="cuda", source=q4, replaces=replaces, path=path,
            shape_key=["q4_matmul", [m, k, n, epi]], sig=sig, max_abs_err=err_bf16, isolated_ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_call="torch.matmul(x, w) on a pre-dequantized bf16 weight (no bias, no GELU)",
            tol="bf16 1e-2 and f32 1e-5 of max|out|", shape=f"M={m} K={k} N={n}",
        ))
    return rows


def decode_linears(params, cfg, m: int, prefix: str = "") -> list[tuple]:
    """Kernel A's decode-step sites at ``m`` rows: the four projections (two
    shapes), the FFN's two launches and the int8 logits."""
    blocks = params["decoder"]["blocks"]
    emb_q = params["decoder"]["tok_emb_q"]
    logits_lin = {"qw": emb_q["qw"][None], "scales": emb_q["scales"][None]}
    k1, k4, k5 = (f"whisper_burn_tpu/ops/{f}" for f in ("pallas_q4.py:121 (K1)", "pallas_ffn.py:153 (K4)", "pallas_q4.py:44 (K5)"))
    return [
        (f"{prefix}attn_qkv", m, blocks["attn_qkv"], None, torch.bfloat16, k1),
        (f"{prefix}attn_o/xattn_q/xattn_o", m, blocks["attn_o"], None, torch.bfloat16, k1),
        (f"{prefix}ffn_fc1", m, blocks["fc1"], cfg.gelu, torch.bfloat16, k4),
        (f"{prefix}ffn_fc2", m, blocks["fc2"], None, torch.bfloat16, k4),
        (f"{prefix}logits", m, logits_lin, None, torch.float32, k5),
    ]


def kernel_checks(params, cfg, gen):
    from whisper_burn_tpu_torch.ops.decode_attention import (
        decode_cross_attention, decode_cross_attention_plain,
        decode_self_attention, decode_self_attention_plain, unpack_int4,
    )
    from whisper_burn_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain

    dev = torch.device("cuda")
    blocks = params["decoder"]["blocks"]
    L = cfg.n_text_layer
    cases = decode_linears(params, cfg, BATCH) + [  # site, launch rows, linear, gelu, out dtype, replaces
        ("prefill_qkv", 4 * BATCH, blocks["attn_qkv"], None, torch.bfloat16, "whisper_burn_tpu/ops/pallas_q4.py:44 (K5)"),
        ("prefill_proj", 4 * BATCH, blocks["attn_o"], None, torch.bfloat16, "whisper_burn_tpu/ops/pallas_q4.py:44 (K5)"),
        ("prefill_fc1", 4 * BATCH, blocks["fc1"], cfg.gelu, torch.bfloat16, "whisper_burn_tpu/ops/pallas_ffn.py:93 (K7)"),
        ("prefill_fc2", 4 * BATCH, blocks["fc2"], None, torch.bfloat16, "whisper_burn_tpu/ops/pallas_ffn.py:93 (K7)"),
    ]
    rows = q4_rows(cases, gen, "greedy")

    # kernel B at the main path's cache shape, at the mean decode position
    # when all MAX_TOKENS - 1 steps run (positions 4 .. 226)
    d, h, ctx = cfg.n_text_state, cfg.n_text_head, 256
    pos = round(mean_decode_pos(MAX_TOKENS - 1))
    da = "whisper_burn_tpu_torch/csrc/decode_attention.cu"
    kc = torch.randint(-127, 128, (L, BATCH, ctx, d), generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (L, BATCH, ctx, d), generator=gen, device=dev, dtype=torch.int8)
    sc = torch.rand((L, BATCH, ctx, 2), generator=gen, device=dev) * 0.02 + 1e-3
    q, kn, vn = (torch.randn((BATCH, 1, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3))
    kq = torch.randint(-127, 128, (BATCH, 1, d), generator=gen, device=dev, dtype=torch.int8)
    vq = torch.randint(-127, 128, (BATCH, 1, d), generator=gen, device=dev, dtype=torch.int8)
    nsc = torch.rand((BATCH, 1, 2), generator=gen, device=dev) * 0.02 + 1e-3
    for dtype in (torch.bfloat16, torch.float32):
        for layer in (0, L - 1):
            ck, cv, cs = kc.clone(), vc.clone(), sc.clone()
            pk, pv, ps = kc.clone(), vc.clone(), sc.clone()
            args = (q.to(dtype), layer, pos, h, kn.to(dtype), vn.to(dtype), kq, vq, nsc)
            out = decode_self_attention(args[0], ck, cv, cs, *args[1:])
            ref = decode_self_attention_plain(args[0], pk, pv, ps, *args[1:])
            err = max_err(out, ref)
            check(f"decode_self_attention {dtype}", err, ref, 1e-5)  # f32 math both ways
            if not (torch.equal(ck, pk) and torch.equal(cv, pv) and torch.equal(cs, ps)):
                raise AssertionError("decode_self_attention: the in-place store differs from the plain version")
            ck[layer, :, pos], cv[layer, :, pos], cs[layer, :, pos] = kc[layer, :, pos], vc[layer, :, pos], sc[layer, :, pos]
            if not (torch.equal(ck, kc) and torch.equal(cv, vc) and torch.equal(cs, sc)):
                raise AssertionError("decode_self_attention: a cache row other than pos changed")
            if dtype == torch.bfloat16 and layer == 0:
                self_err = err
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L
    kern = lambda: decode_self_attention(q, kc, vc, sc, layer(), pos, h, kn, vn, kq, vq, nsc)
    plain = lambda: decode_self_attention_plain(q, kc, vc, sc, layer(), pos, h, kn, vn, kq, vq, nsc)
    deq = lambda c, s: (c[:, :pos + 1].float() * s[:, :pos + 1, None]).to(torch.bfloat16).reshape(BATCH, pos + 1, h, 64).transpose(1, 2)
    kd = [deq(kc[l], sc[l, :, :, 0]) for l in range(L)]
    vd = [deq(vc[l], sc[l, :, :, 1]) for l in range(L)]
    qh = q.reshape(BATCH, 1, h, 64).transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l])
    b_ms, b_by = self_attention_bound(pos, d)
    ms, sig = device_ms(kern, 64, ours=True)
    rows.append(dict(
        name="decode_self_attention", route="cuda", source=da, path="greedy",
        replaces="whisper_burn_tpu/ops/pallas_attention.py:66 (K2)",
        shape_key=["decode_self_attention", [BATCH, ctx, d]], sig=sig, max_abs_err=self_err,
        isolated_ms=ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64),
        library_call="scaled_dot_product_attention on the dequantized bf16 cache (no store)",
        tol="1e-5 of max|out|; cache store exact", shape=f"B={BATCH} ctx={ctx} pos={pos} D={d}",
    ))
    del kc, vc, kd, vd

    # kernel C over the int4 cross cache, T = 1536 with 1500 valid
    t, valid = 1536, cfg.n_audio_ctx
    kT = torch.randint(0, 256, (L, BATCH, d // 2, t), generator=gen, device=dev, dtype=torch.uint8)
    v4 = torch.randint(0, 256, (L, BATCH, t // 2, d), generator=gen, device=dev, dtype=torch.uint8)
    qx = (torch.randn((BATCH, 1, d), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        out = decode_cross_attention(qx.to(dtype), kT, v4, L - 1, valid, h)
        ref = decode_cross_attention_plain(qx.to(dtype), kT, v4, L - 1, valid, h)
        err = max_err(out, ref)
        check(f"decode_cross_attention {dtype}", err, ref, 1e-5)
        if dtype == torch.bfloat16:
            cross_err = err
    it = iter(range(1 << 30))
    kern = lambda: decode_cross_attention(qx, kT, v4, layer(), valid, h)
    plain = lambda: decode_cross_attention_plain(qx, kT, v4, layer(), valid, h)
    kd = [unpack_int4(kT[l], 1, torch.bfloat16)[..., :valid].reshape(BATCH, h, 64, valid).transpose(-1, -2).contiguous() for l in range(L)]
    vd = [unpack_int4(v4[l], 1, torch.bfloat16)[:, :valid].reshape(BATCH, valid, h, 64).transpose(1, 2).contiguous() for l in range(L)]
    qh = qx.reshape(BATCH, 1, h, 64).transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l])
    # the keys' packed [D/2, T] rows are needed up to `valid` only; every
    # packed value row holds a valid time step (t < T/2 <= valid); q bf16
    # in, f32 out
    nbytes = BATCH * ((d // 2) * valid + (t // 2) * d + d * 2 + d * 4)
    b_ms, b_by = bound(nbytes, 4.0 * BATCH * valid * d)
    ms, sig = device_ms(kern, 64, ours=True)
    rows.append(dict(
        name="decode_cross_attention", route="cuda", source=da, path="greedy",
        replaces="whisper_burn_tpu/ops/pallas_attention.py:636 (K3)",
        shape_key=["decode_cross_attention", [BATCH, t, d, 1]], sig=sig, max_abs_err=cross_err,
        isolated_ms=ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64),
        library_call="scaled_dot_product_attention on the dequantized bf16 cache",
        tol="1e-5 of max|out|", shape=f"B={BATCH} T={t} valid={valid} D={d}",
    ))
    del kT, v4, kd, vd

    # kernel D: one encoder layer's attention at T = 1536 with 1500 valid
    ea = "whisper_burn_tpu_torch/csrc/encoder_attention.cu"
    qkv = [torch.randn((BATCH, t, d), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
    for dtype, b_chk, rel in ((torch.bfloat16, BATCH, 1e-2), (torch.float32, 2, 1e-5)):
        xs = [a[:b_chk].to(dtype) for a in qkv]
        out = encoder_attention(*xs, h, valid=valid)
        ref = encoder_attention_plain(*xs, h, valid)
        err = max_err(out, ref)
        check(f"encoder_attention {dtype}", err, ref, rel)
        if dtype == torch.bfloat16:
            enc_err = err
    kern = lambda: encoder_attention(*qkv, h, valid=valid)
    plain = lambda: encoder_attention_plain(*qkv, h, valid)
    hq, hk, hv = (a.reshape(BATCH, t, h, 64).transpose(1, 2) for a in qkv)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(hq, hk[:, :, :valid], hv[:, :, :valid])
    # q and the output over all T rows, k and v over the valid rows, bf16
    b_ms, b_by = bound(BATCH * (2 * t + 2 * valid) * d * 2, 4.0 * BATCH * h * t * valid * 64)
    ms, sig = device_ms(kern, 5, 1, ours=True)
    rows.append(dict(
        name="encoder_attention", route="cuda", source=ea, path="greedy",
        replaces="whisper_burn_tpu/ops/pallas_encoder_attention.py:96 (K6)",
        shape_key=["encoder_attention", [BATCH, t, d]], sig=sig, max_abs_err=enc_err,
        isolated_ms=ms, plain_ms=device_ms(plain, 3, 1), bound_ms=b_ms,
        bound_by=b_by, library_ms=device_ms(lib, 5, 1),
        library_call="scaled_dot_product_attention over the 1500 valid keys",
        tol="bf16 1e-2 and f32 1e-5 of max|out|", shape=f"B={BATCH} T={t} valid={valid} D={d} H={h}",
    ))
    return rows


def beam_kernel_checks(params, cfg, gen):
    """The kernels at the beam path's shapes: kernel A at M = STREAMS, E, F
    and C with BEAM_WIDTH streams per cross-cache entry; and the device
    time of the beam step's self-cache reorder at ctx 256."""
    from whisper_burn_tpu_torch.ops.cache import write_cache_slot, write_cache_slot_plain
    from whisper_burn_tpu_torch.ops.decode_attention import (
        decode_attention_layer, decode_attention_layer_plain,
        decode_cross_attention, decode_cross_attention_plain, unpack_int4,
    )

    dev = torch.device("cuda")
    L = cfg.n_text_layer
    rows = q4_rows(decode_linears(params, cfg, STREAMS, "beam_"), gen, "beam")
    d, h, ctx = cfg.n_text_state, cfg.n_text_head, 256
    da = "whisper_burn_tpu_torch/csrc/decode_attention.cu"
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L  # cycle layers: caches come from HBM, not L2

    # kernel E over the int8 self cache of the 40 streams, at the first,
    # mean and last positions of 224 tokens' decode steps (ctx 256)
    kc = torch.randint(-127, 128, (L, STREAMS, ctx, d), generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (L, STREAMS, ctx, d), generator=gen, device=dev, dtype=torch.int8)
    sc = torch.rand((L, STREAMS, ctx, 2), generator=gen, device=dev) * 0.02 + 1e-3
    q = torch.randn((STREAMS, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = round(mean_decode_pos(MAX_TOKENS - 1))
    layer_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for valid in (4, pos, 3 + MAX_TOKENS):
            out = decode_attention_layer(q.to(dtype), kc, vc, sc, L - 1, valid, h)
            ref = decode_attention_layer_plain(q.to(dtype), kc, vc, sc, L - 1, valid, h)
            for part, a, r in zip(("acc", "m", "l"), out, ref):
                err = max_err(a, r)
                check(f"decode_attention_layer {dtype} valid={valid} {part}", err, r, 1e-5)  # f32 math both ways
                if dtype == torch.bfloat16:
                    layer_err = max(layer_err, err)
    kern = lambda: decode_attention_layer(q, kc, vc, sc, layer(), pos, h)
    plain = lambda: decode_attention_layer_plain(q, kc, vc, sc, layer(), pos, h)
    deq = lambda c, s: (c[:, :pos].float() * s[:, :pos, None]).to(torch.bfloat16).reshape(STREAMS, pos, h, 64).transpose(1, 2)
    kd = [deq(kc[l], sc[l, :, :, 0]) for l in range(L)]
    vd = [deq(vc[l], sc[l, :, :, 1]) for l in range(L)]
    qh = q.reshape(STREAMS, 1, h, 64).transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l])
    ms, sig = device_ms(kern, 64, ours=True)
    b_ms, b_by = layer_attention_bound(pos, d, h)
    rows.append(dict(
        name="decode_attention_layer", route="cuda", source=da, path="beam",
        replaces="whisper_burn_tpu/ops/pallas_attention.py:66 (K8)",
        shape_key=["decode_attention_layer", [STREAMS, ctx, d]], sig=sig, max_abs_err=layer_err,
        isolated_ms=ms, isolated_bound_ms=b_ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64),
        library_call="scaled_dot_product_attention on the dequantized bf16 layer (normalized)",
        tol="1e-5 of max|acc|, max|m|, max|l|", shape=f"B*W={STREAMS} ctx={ctx} valid={pos} D={d}",
    ))

    # the beam step's reorder of the self caches (not a kernel of the port:
    # index_select, as the JAX package leaves jnp.take to XLA): each
    # stream takes a parent among its utterance's beams
    parent = torch.randint(0, BEAM_WIDTH, (BATCH, BEAM_WIDTH), generator=gen, device=dev)
    src = (torch.arange(BATCH, device=dev)[:, None] * BEAM_WIDTH + parent).reshape(STREAMS)
    reorder = lambda: [c.index_select(1, src) for c in (kc, vc, sc)]
    nbytes = 2 * (kc.numel() + vc.numel() + sc.numel() * 4)  # read and write each cache once
    reorder_row = {"ms": device_ms(reorder, 16), "bound_ms": bound(nbytes, 0.0)[0], "bytes": nbytes,
                   "shape": f"2 x int8 [{L}, {STREAMS}, {ctx}, {d}] + f32 scales"}

    # kernel F: one slot of the int8 self cache across all layers and streams
    new = torch.randint(-127, 128, (L, STREAMS, 1, d), generator=gen, device=dev, dtype=torch.int8)
    for p in (0, pos, ctx - 1):
        out, ref = kc.clone(), kc.clone()
        write_cache_slot(out, new, p)
        write_cache_slot_plain(ref, new, p)
        if not torch.equal(out, ref):
            raise AssertionError(f"write_cache_slot at {p} differs from the plain version")
    del out, ref
    kern = lambda: write_cache_slot(kc, new, pos)
    plain = lambda: write_cache_slot_plain(kc, new, pos)
    idx = torch.tensor([pos], device=dev)
    lib = lambda: kc.index_copy_(2, idx, new)
    ms, sig = device_ms(kern, 64, ours=True)
    b_ms, b_by = bound(2 * L * STREAMS * d, 0.0)  # read new once, write the rows once
    rows.append(dict(
        name="write_cache_slot", route="cuda", source="whisper_burn_tpu_torch/csrc/cache_slot.cu", path="beam",
        replaces="whisper_burn_tpu/ops/pallas_cache.py:33 (K9)",
        shape_key=["write_cache_slot", [L, STREAMS, ctx, d]], sig=sig, max_abs_err=0.0,
        isolated_ms=ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64), library_call="index_copy_ along T",
        tol="exact", shape=f"L={L} B*W={STREAMS} ctx={ctx} W={d} int8",
    ))
    del kc, vc, kd, vd

    # kernel C grouped: BEAM_WIDTH streams per utterance's int4 cross cache
    t, valid = 1536, cfg.n_audio_ctx
    kT = torch.randint(0, 256, (L, BATCH, d // 2, t), generator=gen, device=dev, dtype=torch.uint8)
    v4 = torch.randint(0, 256, (L, BATCH, t // 2, d), generator=gen, device=dev, dtype=torch.uint8)
    qx = (torch.randn((STREAMS, 1, d), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        out = decode_cross_attention(qx.to(dtype), kT, v4, L - 1, valid, h, BEAM_WIDTH)
        ref = decode_cross_attention_plain(qx.to(dtype), kT, v4, L - 1, valid, h, BEAM_WIDTH)
        err = max_err(out, ref)
        check(f"decode_cross_attention grouped {dtype}", err, ref, 1e-5)
        if dtype == torch.bfloat16:
            cross_err = err
    kern = lambda: decode_cross_attention(qx, kT, v4, layer(), valid, h, BEAM_WIDTH)
    plain = lambda: decode_cross_attention_plain(qx, kT, v4, layer(), valid, h, BEAM_WIDTH)
    kd = [unpack_int4(kT[l], 1, torch.bfloat16)[..., :valid].reshape(BATCH, h, 64, valid).transpose(-1, -2).contiguous() for l in range(L)]
    vd = [unpack_int4(v4[l], 1, torch.bfloat16)[:, :valid].reshape(BATCH, valid, h, 64).transpose(1, 2).contiguous() for l in range(L)]
    qh = qx.reshape(BATCH, BEAM_WIDTH, h, 64).transpose(1, 2)  # an utterance's beams as its queries
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l])
    # each utterance's packed bytes read once (the kernel re-reads them per
    # beam, mostly from L2); q bf16 in and f32 out per stream
    nbytes = BATCH * ((d // 2) * valid + (t // 2) * d) + STREAMS * (d * 2 + d * 4)
    b_ms, b_by = bound(nbytes, 4.0 * STREAMS * valid * d)
    ms, sig = device_ms(kern, 64, ours=True)
    rows.append(dict(
        name="decode_cross_attention/grouped", route="cuda", source=da, path="beam",
        replaces="whisper_burn_tpu/ops/pallas_attention.py:636 (K3, batch_groups)",
        shape_key=["decode_cross_attention", [STREAMS, t, d, BEAM_WIDTH]], sig=sig, max_abs_err=cross_err,
        isolated_ms=ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64),
        library_call="scaled_dot_product_attention on the dequantized bf16 cache, the beams as 5 queries",
        tol="1e-5 of max|out|", shape=f"B={BATCH} x G={BEAM_WIDTH} T={t} valid={valid} D={d}",
    ))
    return rows, reorder_row


# --------------------------------------------------------------------------
# phase 3: the main path


def expected_steps(tokens: torch.Tensor, max_tokens: int, check_every: int, eot_id: int) -> int:
    """Decode steps greedy_decode runs: all of them, unless every stream
    stopped and the loop saw it at a check."""
    eot = tokens == eot_id
    if not bool(eot.any(dim=1).all()):
        return max_tokens - 1
    k_stop = int(eot.int().argmax(dim=1).max())  # the step of the last stream's EOT
    k_break = -(-(k_stop + 1) // check_every) * check_every
    return min(max_tokens, k_break) - 1


def request(params, cfg, compute, mel_frontend, audio):
    """One request through the entries a user calls: mel -> greedy_decode."""
    from whisper_burn_tpu_torch.models.whisper import greedy_decode

    lang = torch.full((BATCH,), cfg.lang_token_start, dtype=torch.int32, device=audio.device)
    return greedy_decode(params, cfg, mel_frontend(audio), lang, compute, max_tokens=MAX_TOKENS)


def main_path(params, cfg, compute, mel_frontend):
    """Three counted greedy requests; returns the counts, by kernel and by
    (kernel, shape), and the audios."""
    from whisper_burn_tpu_torch.models.config import EOT
    from whisper_burn_tpu_torch.models.whisper import DONE_CHECK_EVERY
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.decode_attention import CROSS, SELF

    dev = torch.device("cuda")
    audios = []
    for r in range(REQUESTS):
        g = torch.Generator(device=dev)
        g.manual_seed(SEED + 1 + r)
        audios.append(torch.randn((BATCH, 480_000), generator=g, device=dev) * 0.1)
    torch.cuda.synchronize()
    L, La = cfg.n_text_layer, cfg.n_audio_layer
    _build.reset_launches()
    for r, audio in enumerate(audios):
        before = dict(_build.LAUNCHES)
        torch.cuda.set_sync_debug_mode("warn")  # each implicit host sync warns
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = request(params, cfg, compute, mel_frontend, audio)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        got = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
        steps = expected_steps(res.tokens, MAX_TOKENS, DONE_CHECK_EVERY, EOT)
        checks = min(steps + 1, MAX_TOKENS - 1) // DONE_CHECK_EVERY  # done checks the loop ran
        want = {
            "q4_matmul": (6 * L + 1) * (1 + steps),
            SELF: L * steps,
            CROSS: L * steps,
            "encoder_attention": La,
        }
        log({"request": r, "wall_ms": wall * 1e3, "tokens_shape": list(res.tokens.shape),
             "audio_s_per_s": BATCH * 30.0 / wall, "decode_steps": steps, "host_syncs": syncs,
             "done_checks": checks, "n_generated": res.n_generated.tolist(), "launches": got,
             "expected_launches": want})
        if got != want:
            raise AssertionError(f"request {r}: launches {got} differ from the shapes' prediction {want}")
        if not 1 <= syncs <= max(checks, 1):
            raise AssertionError(f"request {r}: {syncs} host syncs for {checks} done checks")
        tok = res.tokens
        if tok.min() < 0 or tok.max() >= cfg.n_vocab:
            raise AssertionError("token id out of range")
        after_eot = (tok == EOT).int().cummax(dim=1).values.bool()
        if not bool((tok[after_eot] == EOT).all()):
            raise AssertionError("a stream emitted a token after its EOT")
    return dict(_build.LAUNCHES), shape_counts(), audios


def shape_counts() -> dict:
    from whisper_burn_tpu_torch.ops import _build

    return {json.dumps([k[0], list(k[1])]): v for k, v in _build.LAUNCH_SHAPES.items()}


def beam_request(params, cfg, compute, mel_frontend, audio, max_tokens=MAX_TOKENS):
    """One request through the entries a user calls: mel -> beam_decode."""
    from whisper_burn_tpu_torch.models.beam import beam_decode

    lang = torch.full((BATCH,), cfg.lang_token_start, dtype=torch.int32, device=audio.device)
    return beam_decode(params, cfg, mel_frontend(audio), lang, compute, beam_width=BEAM_WIDTH, max_tokens=max_tokens)


def beam_path(params, cfg, compute, mel_frontend, audios):
    """One warm-up and two timed beam requests (B=8 x W=5), counted;
    returns the counts, by kernel and by (kernel, shape)."""
    from whisper_burn_tpu_torch.models.config import EOT
    from whisper_burn_tpu_torch.models.whisper import DONE_CHECK_EVERY
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.cache import FN as SLOT
    from whisper_burn_tpu_torch.ops.decode_attention import CROSS, LAYER

    L, La = cfg.n_text_layer, cfg.n_audio_layer
    _build.reset_launches()
    for r, audio in enumerate(audios):
        before = dict(_build.LAUNCHES)
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = beam_request(params, cfg, compute, mel_frontend, audio)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        got = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
        # the decode steps run: all of them when no utterance finished
        # (a finished one's best hypothesis is shorter than the cap)
        steps = got.get(LAYER, 0) // L
        if bool((res.n_generated == MAX_TOKENS).all()) and steps != MAX_TOKENS - 1:
            raise AssertionError(f"beam request {r}: {steps} decode steps, no utterance finished")
        checks = min(steps + 1, MAX_TOKENS - 1) // DONE_CHECK_EVERY
        want = {
            "q4_matmul": (6 * L + 1) * (1 + steps),
            LAYER: L * steps,
            CROSS: L * steps,
            SLOT: 2 * steps,
            "encoder_attention": La,
        }
        log({"beam_request": r, "timed": r > 0, "wall_ms": wall * 1e3, "audio_s_per_s": BATCH * 30.0 / wall,
             "beam_width": BEAM_WIDTH, "decode_steps": steps, "host_syncs": syncs, "done_checks": checks,
             "n_generated": res.n_generated.tolist(), "scores": res.scores.tolist(), "launches": got,
             "expected_launches": want})
        if got != want:
            raise AssertionError(f"beam request {r}: launches {got} differ from the shapes' prediction {want}")
        if not 1 <= steps <= MAX_TOKENS - 1:
            raise AssertionError(f"beam request {r}: {steps} decode steps")
        if not 1 <= syncs <= max(checks, 1):
            raise AssertionError(f"beam request {r}: {syncs} host syncs for {checks} done checks")
        tok, n_gen = res.tokens, res.n_generated
        if tuple(tok.shape) != (BATCH, MAX_TOKENS) or tok.min() < 0 or tok.max() >= cfg.n_vocab:
            raise AssertionError(f"beam request {r}: tokens {tuple(tok.shape)} out of shape or range")
        col = torch.arange(MAX_TOKENS, device=tok.device)[None, :]
        if not bool(((tok == EOT) == (col >= n_gen[:, None])).all()):
            raise AssertionError(f"beam request {r}: tokens are not EOT exactly past n_generated")
        if not bool(torch.isfinite(res.scores).all() and (res.scores <= 0).all()):
            raise AssertionError(f"beam request {r}: scores {res.scores.tolist()} are not log-probabilities")
    return dict(_build.LAUNCHES), shape_counts()


def traced_run(run, sigs: dict, alias=lambda key: key):
    """``run()`` (returning its result and wall seconds) under
    torch.profiler with the launch log on. Returns the result, the wall,
    the device durations (µs) of the hand-written kernels' launches by
    (kernel, shape), matched one by one to the launch log by their
    signatures ``sigs`` (from the kernel phase), the records the trace
    lost per kernel, the device events, the ranges and the launch log.
    ``alias`` maps a logged (kernel, shape) key to the key of its row."""
    from whisper_burn_tpu_torch.ops import _build

    _build.LAUNCH_LOG = []
    try:
        (res, wall), dev, ranges = traced(run)
        launch_log = _build.LAUNCH_LOG
    finally:
        _build.LAUNCH_LOG = None
    # walk each kernel's launches in the trace, in issue order (CUPTI's
    # correlation ids), beside its entries of the launch log; a logged
    # launch whose signature the next traced one does not carry lost its
    # record in the trace (launches of one signature share a shape, but
    # for attn_o / fc2, where two lost records in a row could swap them)
    ours = sorted((e for e in dev if OURS.search(e["name"])), key=lambda e: e["args"]["correlation"])
    durations, lost = collections.defaultdict(list), {}
    for name, kernel in KERNEL_OF.items():
        traced_ = [e for e in ours if OURS.search(e["name"]).group(1) == kernel]
        logged = [alias(json.dumps([name, list(shape)])) for n, shape in launch_log if n == name]
        j = 0
        for key in logged:
            if j < len(traced_) and signature(traced_[j]) == sigs[key]:
                durations[key].append(traced_[j]["dur"])
                j += 1
        if j != len(traced_):
            raise AssertionError(f"{name}: {len(traced_) - j} traced launches match no logged launch")
        lost[name] = len(logged) - j
        if lost[name] > max(1, len(logged) // 100):
            raise AssertionError(f"{name}: the trace lost {lost[name]} of {len(logged)} launch records")
    return res, wall, durations, lost, dev, ranges, launch_log


def stage_split(ranges, entry: str) -> tuple[dict, dict]:
    """The stages ``entry`` marks, host and device ms, and their device spans."""
    stages = {"host_ms": {}, "device_ms": {}}
    spans = {}
    for e in ranges:
        stage = e["name"].split(".", 1)[1] if e["name"].startswith(f"{entry}.") else None
        if stage in STAGES:
            side = "device_ms" if e["cat"] == "gpu_user_annotation" else "host_ms"
            stages[side][stage] = e["dur"] / 1e3
            if side == "device_ms":
                spans[stage] = (e["ts"], e["ts"] + e["dur"])
    if set(spans) != STAGES:
        raise AssertionError(f"the trace's device ranges of {entry} are {sorted(spans)}")
    return stages, spans


def decode_split(dev, span, steps: int, gather_spans=()) -> dict:
    """Each decode step's device time: the hand-written kernels, the work
    inside ``gather_spans`` (the beam's reorder of its self caches), other
    work, idle."""
    lo, hi = span
    in_decode = [e for e in dev if lo <= e["ts"] < hi]
    busy = sum(e["dur"] for e in in_decode)
    ours_busy = sum(e["dur"] for e in in_decode if OURS.search(e["name"]))
    gathers = [e for e in in_decode if any(a <= e["ts"] < b for a, b in gather_spans)]
    gather = sum(e["dur"] for e in gathers)
    other = collections.Counter()
    for e in in_decode:
        if not OURS.search(e["name"]):
            other[e["name"][:160]] += e["dur"]
    return {
        "decode_steps": steps,
        "decode_step_ms": (hi - lo) / steps / 1e3,
        "decode_step_device_busy_ms": busy / steps / 1e3,
        "decode_step_kernels_ms": ours_busy / steps / 1e3,
        "decode_step_gather_ms": gather / steps / 1e3,
        "decode_gather_kernels": sorted({e["name"][:90] for e in gathers}),
        "decode_step_other_device_ms": (busy - ours_busy - gather) / steps / 1e3,
        "decode_device_ops_per_step": len(in_decode) / steps,
        "decode_device_idle_share": 1 - busy / (hi - lo),
        "decode_other_top": [[n, t / steps / 1e3] for n, t in other.most_common(12)],
    }


def traced_request(params, cfg, compute, mel_frontend, audio, sigs: dict) -> tuple[dict, dict]:
    """One more greedy request under torch.profiler. Returns the device
    durations (µs) of the hand-written kernels' launches by (kernel,
    shape), and the breakdown: the stages greedy_decode marks, on the host
    and on the device, and each decode step split into the kernels, other
    device work and idle."""
    from whisper_burn_tpu_torch.models.config import EOT
    from whisper_burn_tpu_torch.models.whisper import DONE_CHECK_EVERY

    def run():
        t0 = time.perf_counter()
        res = request(params, cfg, compute, mel_frontend, audio)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, wall, durations, lost, dev, ranges, _ = traced_run(run, sigs)
    stages, spans = stage_split(ranges, "greedy_decode")
    steps = expected_steps(res.tokens, MAX_TOKENS, DONE_CHECK_EVERY, EOT)
    breakdown = {
        "wall_ms": wall * 1e3,
        "stages": stages,
        **decode_split(dev, spans["decode"], steps),
        "request_device_busy_ms": sum(e["dur"] for e in dev) / 1e3,
        "trace_records_lost": lost,
    }
    return durations, breakdown


def traced_beam_request(params, cfg, compute, mel_frontend, audio, sigs: dict) -> tuple[dict, dict]:
    """One beam request of TRACED_BEAM_TOKENS tokens under torch.profiler
    (a short one: the profiler's host cost grows with the steps). Returns
    the kernels' device durations by (kernel, shape) and the breakdown, as
    :func:`traced_request`, with the cache reorder gather split out."""
    from whisper_burn_tpu_torch.ops.cache import FN as SLOT
    from whisper_burn_tpu_torch.ops.decode_attention import LAYER

    def run():
        t0 = time.perf_counter()
        res = beam_request(params, cfg, compute, mel_frontend, audio, max_tokens=TRACED_BEAM_TOKENS)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def alias(key):
        """32 tokens size the self cache 64 wide, not 256: E's launches
        (whose work follows the valid keys, not ctx) and F's (one row per
        layer and stream) stand for the main path's ctx-256 rows."""
        kernel, shape = json.loads(key)
        if kernel == LAYER:
            shape[1] = 256
        if kernel == SLOT:
            shape[2] = 256
        return json.dumps([kernel, shape])

    res, wall, durations, lost, dev, ranges, launch_log = traced_run(run, sigs, alias)
    stages, spans = stage_split(ranges, "beam_decode")
    steps = sum(n == LAYER for n, _ in launch_log) // cfg.n_text_layer
    reorder = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
               if e["cat"] == "gpu_user_annotation" and e["name"] == "beam_decode.reorder"]
    if not reorder:
        raise AssertionError("the trace holds no beam_decode.reorder range")
    breakdown = {
        "wall_ms": wall * 1e3,
        "max_tokens": TRACED_BEAM_TOKENS,
        "reorder_ranges": len(reorder),
        "stages": stages,
        **decode_split(dev, spans["decode"], steps, reorder),
        "request_device_busy_ms": sum(e["dur"] for e in dev) / 1e3,
        "trace_records_lost": lost,
    }
    return durations, breakdown


# --------------------------------------------------------------------------
# phase 5: small config, kernels against plain versions end to end


def small_end_to_end() -> dict:
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.models.beam import beam_decode
    from whisper_burn_tpu_torch.models.config import EOT, SOT, WhisperConfig
    from whisper_burn_tpu_torch.models.decoder import decode_step, fill_cross_cache, init_cache, prefill
    from whisper_burn_tpu_torch.models.encoder import encode
    from whisper_burn_tpu_torch.models.params import random_params
    from whisper_burn_tpu_torch.models.whisper import greedy_decode
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.cache import FN as SLOT
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.ops.decode_attention import CROSS, LAYER
    from whisper_burn_tpu_torch.transcribe import prepare_params

    cfg = WhisperConfig.tiny_test().replace(
        n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4, n_audio_ctx=128, n_text_ctx=64
    )
    # f32; W8A8 off: its per-row int8 rounding turns one-ulp differences at
    # a rounding tie into a whole code step (tests/test_torch_slice.py)
    compute = Compute.fastest(kv_bits=4).replace(quantized_logits=True, dtype=torch.float32)
    audio = (np.random.default_rng(7).standard_normal((2, 2 * 128 * 160)) * 0.1).astype(np.float32)
    g = 3  # beams
    runs = {}
    for dev in ("cuda", "cpu"):
        params = prepare_params(random_params(cfg, seed=0, device=dev), compute)
        mel = MelFrontend(n_mels=cfg.n_mels)(torch.from_numpy(audio).to(dev))
        lang = torch.full((2,), cfg.lang_token_start, dtype=torch.int32, device=dev)
        _build.reset_launches()
        res = greedy_decode(params, cfg, mel, lang, compute, max_tokens=8)
        launched = sum(_build.LAUNCHES.values())
        if (dev == "cuda") != (launched > 0):
            raise AssertionError(f"{dev}: {launched} kernel launches")
        prompt = torch.tensor([SOT, cfg.lang_token_start, cfg.transcribe_token, cfg.no_timestamps_token],
                              device=mel.device).repeat(2, 1)
        enc = encode(params, mel, cfg, compute)
        caches = [fill_cross_cache(params, cfg, enc, init_cache(cfg, 2, compute, 64, mel.device), compute) for _ in range(2)]
        logits = [prefill(params, cfg, prompt, caches[0], compute)]
        forced = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.n_vocab, (8, 2 * g))).to(dev)
        for k in range(8):
            logits.append(decode_step(params, cfg, forced[k, :2], 4 + k, caches[0], compute))
        # the beam branch of the decode step: self caches repeated g-fold
        grouped, cache = [], caches[1]
        prefill(params, cfg, prompt, cache, compute)
        for name in ("self_k", "self_v", "self_kv_scale"):
            setattr(cache, name, getattr(cache, name).repeat_interleave(g, dim=1))
        _build.reset_launches()
        for k in range(8):
            grouped.append(decode_step(params, cfg, forced[k], 4 + k, cache, compute, batch_groups=g))
        # beam search with the EOT row scaled, so hypotheses are banked
        # before the cap (tests/test_torch_beam.py)
        bparams = random_params(cfg, seed=0, device=dev)
        bparams["decoder"]["tok_emb"][EOT] *= 2.5
        beam = beam_decode(prepare_params(bparams, compute), cfg, mel, lang, compute, beam_width=g, max_tokens=10)
        counts = dict(_build.LAUNCHES)
        if dev == "cuda" and not all(counts.get(n, 0) > 0 for n in ("q4_matmul", LAYER, CROSS, SLOT)):
            raise AssertionError(f"small beam: launches {counts}")
        if dev == "cpu" and counts:
            raise AssertionError(f"cpu: kernel launches {counts}")
        runs[dev] = (res.tokens.cpu(), torch.stack(logits).cpu(), torch.stack(grouped).cpu(),
                     [t.cpu() for t in beam])
    if not torch.equal(runs["cuda"][0], runs["cpu"][0]):
        raise AssertionError(f"small greedy tokens differ: {runs['cuda'][0]} vs {runs['cpu'][0]}")
    errs = []
    for i, what in ((1, "teacher-forced"), (2, "grouped teacher-forced")):
        a, b = runs["cuda"][i], runs["cpu"][i]
        live = torch.isfinite(b)
        errs.append((a[live] - b[live]).abs().max().item())
        if not (torch.equal(torch.isfinite(a), live) and errs[-1] <= 1e-4 * max(1.0, b[live].abs().max().item())):
            raise AssertionError(f"small {what} logits differ by {errs[-1]:.3e}")
    (tok, ngen, sc, lang_t), (tok_p, ngen_p, sc_p, lang_p) = runs["cuda"][3], runs["cpu"][3]
    if not (torch.equal(tok, tok_p) and torch.equal(ngen, ngen_p) and torch.equal(lang_t, lang_p)):
        raise AssertionError(f"small beam differs: {tok} {ngen} vs {tok_p} {ngen_p}")
    beam_err = (sc - sc_p).abs().max().item()
    if not beam_err <= 1e-4:
        raise AssertionError(f"small beam scores differ by {beam_err:.3e}")
    return {"tokens": runs["cuda"][0].tolist(), "logits_max_abs_err": errs[0],
            "grouped_logits_max_abs_err": errs[1], "beam_tokens": tok.tolist(),
            "beam_n_generated": ngen.tolist(), "beam_scores_max_abs_err": beam_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import whisper_burn_tpu_torch  # noqa: F401  (fails outside a checkout)
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_fabricated_params
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.ops.decode_attention import LAYER, SELF
    from whisper_burn_tpu_torch.transcribe import prepare_params

    t_all = time.perf_counter()
    phases = {}
    card = card_line()
    log({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build_s = _build.build_all()
    phases["build_s"] = time.perf_counter() - t0
    log({"phase": "build", "seconds": phases["build_s"], "nvcc_wall_s": build_s})

    t0 = time.perf_counter()
    cfg = WhisperConfig.large_v3()
    L = cfg.n_text_layer
    compute = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
    params = prepare_params(device_fabricated_params(cfg, seed=SEED, device="cuda"), compute)
    torch.cuda.synchronize()
    phases["params_s"] = time.perf_counter() - t0
    log({"phase": "params", "seconds": phases["params_s"],
         "device_bytes": torch.cuda.memory_allocated()})

    # the timed requests of both paths run before any profiler session
    # (the kernel times and the traced requests below use torch.profiler)
    t0 = time.perf_counter()
    mel_frontend = MelFrontend(n_mels=cfg.n_mels, norm="slaney")
    mel_frontend(torch.zeros((1, 16_000), device="cuda"))  # its bases go to the card once
    launches, greedy_counts, audios = main_path(params, cfg, compute, mel_frontend)
    phases["main_path_s"] = time.perf_counter() - t0
    log({"phase": "main_path", "seconds": phases["main_path_s"], "launches": launches})

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    beam_launches, beam_counts = beam_path(params, cfg, compute, mel_frontend, audios)
    phases["beam_path_s"] = time.perf_counter() - t0
    log({"phase": "beam_path", "seconds": phases["beam_path_s"], "launches": beam_launches,
         "peak_device_bytes": torch.cuda.max_memory_allocated()})

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = kernel_checks(params, cfg, gen)
    beam_rows, reorder = beam_kernel_checks(params, cfg, gen)
    rows += beam_rows
    phases["kernels_s"] = time.perf_counter() - t0
    log({"phase": "kernels", "seconds": phases["kernels_s"], "beam_reorder_isolated": reorder})
    sigs = {}
    for row in rows:
        counts = greedy_counts if row["path"] == "greedy" else beam_counts
        row["launches"] = counts.get(json.dumps(row["shape_key"]), 0)
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} was not launched on the {row['path']} path")
        (sig,) = row.pop("sig")
        sigs[json.dumps(row["shape_key"])] = sig

    t0 = time.perf_counter()
    durations, breakdown = traced_request(params, cfg, compute, mel_frontend, audios[0], sigs)
    phases["traced_request_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    beam_durations, beam_breakdown = traced_beam_request(params, cfg, compute, mel_frontend, audios[0], sigs)
    phases["traced_beam_request_s"] = time.perf_counter() - t0
    for row in rows:
        # the bound at the traced run's positions
        if row["name"] == "decode_self_attention":
            row["bound_ms"], row["bound_by"] = self_attention_bound(
                mean_decode_pos(breakdown["decode_steps"]), cfg.n_text_state)
        if row["name"] == "decode_attention_layer":
            row["bound_ms"], row["bound_by"] = layer_attention_bound(
                mean_decode_pos(beam_breakdown["decode_steps"]), cfg.n_text_state, cfg.n_text_head)
        durs = (durations if row["path"] == "greedy" else beam_durations)[json.dumps(row.pop("shape_key"))]
        row["ms"] = sum(durs) / len(durs) / 1e3  # mean device time per launch, main-path trace
    for bd, path, steps in ((breakdown, "greedy", launches[SELF] / L), (beam_breakdown, "beam", beam_launches[LAYER] / L)):
        decode_rows = [r for r in rows if r["path"] == path and not r["name"].startswith(("q4_matmul/prefill", "encoder"))]
        bd["bound_ms_per_decode_step"] = sum(r["bound_ms"] * r["launches"] for r in decode_rows) / steps
    log({"phase": "traced_request", "seconds": phases["traced_request_s"], **breakdown})
    log({"phase": "traced_beam_request", "seconds": phases["traced_beam_request_s"], **beam_breakdown})
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    small = small_end_to_end()
    phases["small_e2e_s"] = time.perf_counter() - t0
    log({"phase": "small_end_to_end", "seconds": phases["small_e2e_s"], **small})
    phases["total_s"] = time.perf_counter() - t_all
    log({"phases": phases})

    log({"kernels": rows})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
