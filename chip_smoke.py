"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each timed and each fatal on failure:

1. card: the GPU's name and power limit as nvidia-smi reports them;
2. build: ``nvcc`` compiles every kernel of ``whisper_burn_tpu_torch/csrc``
   (one process per source, in parallel) into ``build/kernels``;
3. main paths: Large-V3 parameters fabricated on the device from a seed,
   prepared twice: for the serving compute (bf16, int4 cross-KV, int8
   self-KV, int8 logits, W8A8) and for ``Compute.fast()`` (bf16, every
   cache unquantized, bf16 logits). Then requests of 8 x 30 s of seeded
   synthetic audio through mel -> ``greedy_decode(max_tokens=224)`` or
   ``beam_decode(beam_width=5, max_tokens=224)`` (8 utterances x 5 beams =
   40 decode streams), one path at a time: ``greedy`` and ``beam`` (the
   serving compute, three requests each), ``fast_greedy`` and ``fast_beam``
   (``Compute.fast()``), ``int8_greedy`` and ``int8_beam`` (the serving
   compute with the int8 cross cache, ``Compute.fastest()``),
   ``int4self_greedy`` and ``int4self_beam`` (the serving compute with int4
   self keys and values, ``self_kv_bits=4``), ``mixed_greedy`` and
   ``mixed_beam`` (int8 self keys, int4 values, ``self_kv_vbits=4``), two
   requests each; ``entry``: three calls of the flagship step
   ``whisper_burn_tpu_torch.entry.entry()`` (Large-V3 with the numpy
   fixture, ``Compute.fast()``, B=1, 16 tokens); ``pipeline``: a
   ``WhisperPipeline`` on the raw parameters in the int4 self mode,
   ``transcribe_batch`` of 5 x 30 s with the language detected (bucketed to
   8) and ``transcribe_long`` of 75 s (3 windows, bucketed to 4), each
   after a warm-up call; ``encoder_attention_heads``: kernel D' through
   its own op (no model path reaches it) at B=8 x 1500 frames, Large-V3 and Medium
   widths; and ``medium_ffn``: kernel I through its op at Whisper Medium's
   width (1024 <-> 4096, 24 stacked layers, K4's bias order), 8 rows, two
   requests. Then two more models through the same entries:
   3a. Whisper Medium (D 1024, 16 heads, 24 + 24 layers, 80 mel bins),
   fabricated on the device from the seed and prepared for the serving
   compute: ``medium_greedy`` and ``medium_beam`` (B = 8 x 30 s through an
   80-bin mel, 224 tokens, 5 beams), two requests each;
   3b. the GGUF loader: a Large-V3-Turbo checkpoint (32 encoder and 4
   decoder layers) written into a temporary directory under ``build/``
   with the port's ``GgufWriter``, laid out as the JAX package's
   converter lays one out (its Q4_0 blocks raw from a seeded generator),
   loaded by ``load_whisper`` cold (parse, repack, cache save) and warm (a
   hit on the repacked cache), then parsed alone: the config it infers
   must be ``WhisperConfig.large_v3_turbo()``, the warm and the parsed
   params the cold ones array for array, one repacked layer's codes times
   scales its dequantized blocks exactly (``{"phase": "loader", ...}``
   gives the sizes and walls); then ``turbo_greedy`` and ``turbo_beam`` on
   the loaded params moved to the card and prepared for the serving
   compute, two requests each;
   3c. serving and the CLI on that warm Turbo model and its checkpoint:
   ``WhisperPipeline`` over the Turbo tensors already on the card (Q4
   weights shared with the Turbo paths), in the compute that ``serve``
   builds from its default options (``cli.serving_compute``:
   ``Compute.fastest()``, int8 cross and self caches, kernels A, I, B, C'
   and D), under a ``BatchingTranscriber`` (batch 8, 2 s wait), eight seeded utterances
   of 1-30 s submitted in order from one thread, then five, each result
   equal to ``transcribe_batch`` of the same batch (the five padded with
   three 1 s silences in "en") bit for bit, the first batch's launches
   held to the shapes' prediction; then ``serve_http`` with 8 client
   threads of 4 WAVs each (16-bit PCM, 5-30 s, some 44.1 kHz stereo):
   every reply 200 with a language token in range, a malformed body 400,
   ``/stats`` with all 32 completed and a mean batch fill above 1, one
   runner (B = 8) captured and no other, every kernel of the path launched
   (``{"phase": "serving", ...}``: latency percentiles, requests/s,
   audio-s/s, batches, fill, capture ms); then
   ``python -m whisper_burn_tpu_torch.cli`` in processes of its own:
   ``transcribe --bf16 --json --trace`` of two WAVs (the trace
   naming kernels A, I, C' and D), ``eval --bf16`` of a four-row manifest,
   ``serve --port 0`` for one ``/healthz`` and one POST, then SIGINT, exit
   0 (``{"phase": "serving_cli", ...}``: each command's wall);
   3d. ``serve`` over a mesh, on the same checkpoint: two processes of this
   script (``--rank serving_mesh``) share the card over an explicit gloo
   group at mesh (2, 1), each loading the checkpoint (warm) into the
   pipeline ``serve`` builds from its default options (batch 8, 4 a
   rank). Rank 0 hands each batch to rank 1 over the control group
   (``parallel/multihost.control_group``): a ``BatchingTranscriber`` given
   eight seeded utterances in order (one batch), then ``serve_http`` given
   phase 3c's HTTP mix (32 requests from 8 clients) from this process,
   then SIGINT to both ranks; rank 1 follows (``serving.follow_batches``).
   Every reply 200, rank 1's batches as many as rank 0 formed, on each
   rank the first batch's launches as the shapes predict at B = 4, every
   kernel of the path launched, one captured runner of batch 4, its rows
   of the eight equal bit for bit to a one-rank pipeline's at batch 4,
   every rank exit 0; then ``serve --dp 1`` under ``torch.distributed.run``
   (NCCL at world 1): ``/healthz`` and phase 3c's POST with its language
   token, then SIGINT to the rank, exit 0 (``{"phase": "serving_mesh",
   ...}``: latency, requests/s, audio-s/s, batches, fill, each rank's
   set-up and capture ms, the hand-off's ms a batch). The directory is
   removed on the way out.
   The first request of a path is its warm-up. Every request
   runs its decode loop through a cached runner's CUDA graphs of the step
   (``models/whisper.py``, ``models/beam.py``): the runner's first request
   takes one eager step, captures the step (a beam runner once from each
   buffer of its self-cache pair) and replays it for the rest (a line
   ``{"phase": "graph_capture", ...}`` logs each runner's capture wall),
   later requests replay it from the first step. Every launch counter is
   set to 0 just before each path and read just after (a replay adds what
   its capture recorded); each request's launches are held against the
   counts the shapes predict, and its host syncs counted (at most one per
   done check). Then each path (and the entry and the pipeline's
   ``transcribe_batch``) runs one eager reference request, the loop's body
   called step by step from this script, whose tokens (and a beam's
   scores) must equal the replayed request's bit for bit (``{"phase":
   "eager_reference", ...}``): ``greedy`` and the entry at their own token
   counts against their last request, the pipeline at 224, the others at
   32 tokens against two requests of a runner of their own (the first
   captures, the second replays);
4. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main paths' Large-V3 shapes (kernel A, the Q4 matmul,
   in its two regimes: the weight read, K split over a thread block
   cluster with each weight byte read once, for f32 x and bf16 x of few
   rows, and 128 x 128 mma.sync tiles for bf16 x of many rows; each row
   names its regime. Kernel A at M = 8, 32 and
   40 rows, and at the entry's 1, 4, 1500 cross-fill and 1536 encoder rows;
   kernel I, the fused FFN, at the decode's 8 and 40 rows (K4's bias
   order), the prefill's 32 (K7's), the entry's 1, 4 and 1536, and
   Medium's 8 rows (its op's path), each in bf16 and f32, both GELU forms
   and both bias orders, beside kernel A's two launches on the same inputs
   and the library pair; a line ``{"phase": "kernel_i_plan", ...}`` before
   each case's row gives the launch it takes (regime, grid, threads, the
   cooperative attribute);
   B and B' at 4, 115 and 227 cached keys, B' also at the entry's one
   stream and 4, 11 and 18; C and C' (int8 and bf16) ungrouped and with 5
   streams per cross-cache entry, C' bf16 also at the entry's one entry;
   D (also at the entry's B = 1) and D' (Large-V3 and Medium widths); E
   and E' at 4, 115 and 227 valid
   keys; G (8 streams) and H (40) over the int4 and the mixed self caches
   at 4, 115 and 227; F exactly, its slot form (K, V and the scale row in
   one launch) at each greedy path's shape (8 streams, the entry's one,
   the pipeline's 4 and 8) and its beam form (the slot written and the
   streams gathered by parent into the other buffer of the pair) at each
   beam path's 40 streams, the beam form also timed at slots 4, 115 and
   226 beside the slot form followed by index_select (lines ``{"phase":
   "kernel_f_beam_positions", ...}``); and the pipeline's own shapes at B
   = 4 and 8: A at M = B and 4B, I at B, 4B and the detection pass's B, D,
   C and G); and every kernel at Whisper Medium's shapes (rows named
   ``.../medium``: A at 8, 32 and 40 rows and the logits, I at 8, 32 and
   40, B, C, grouped C and D at B = 8, E and F's beam form at 40 streams;
   marked ``off_path``, launches 0, the kernels no Medium path launches in
   the serving compute: B', E', C' int8 and bf16, G, H and F's slot
   form), with the tolerance stated; device time per call,
   from torch.profiler traces, of the kernel, the plain version and one
   PyTorch library call computing the same function (a yardstick only: the
   port never calls it), and the least time the card could take (bytes
   over 3.35 TB/s or operations over 989 TFLOP/s); then one more request of
   five paths under torch.profiler (greedy at 224 tokens; beam,
   fast_greedy, fast_beam and int4self_greedy at 32; a greedy path's is
   its eager reference, whose launches and ranges a trace can follow one
   by one), whose traces give each kernel's device time per launch at
   each main-path shape, the stages ``greedy_decode`` and ``beam_decode``
   mark, and the decode step split into the hand-written kernels, the
   beam's reorder of its tokens (the rest of its ``beam_decode.reorder``
   ranges), the logits (``decode_step.logits``), other device work and
   idle (and one line of the encoder's device ms in each traced request);
   and for each of them, every other beam path and Medium's and Turbo's
   paths a replayed request under torch.profiler (``{"phase":
   "traced_replay_<path>", ...}``: the replayed step's wall, device busy,
   idle share and device operations per step, the device ms of the eager
   stages before the loop, its tokens equal to the eager one's); a kernel row of a path
   without a traced request takes its isolated time; and the device
   memory with the runners alive (the cache keeps the RUNNERS_KEPT used
   last, by the traced and replayed requests);
5. end to end at a small config in f32, for the int4 serving modes (int8,
   int4 and mixed self caches), ``Compute.parity()`` and
   ``Compute.fastest()``: the same greedy and beam tokens, and the same
   teacher-forced logits (ungrouped and grouped), through the kernels as
   through the plain versions;
6. accuracy (``eval/quant_accuracy.py``): Large-V3 at full width and
   depth, seeds 0-3, the iid and the structured Q4 fixture drawn on the
   card (``device_random_params``); for each, ``Compute.parity()`` (TF32
   off) gives the greedy trajectory of B = 4 streams, 64 tokens, and its
   teacher-forced logits; q4_bf16, q4_int8kv, q4_int4kv, q4_int4kv_q8log
   and q4_w8a8 on both fixtures and q4_int4selfkv on the iid one are
   teacher-forced along it (a CUDA graph of one step, replayed). The
   four-seed mean agreement must meet ``FLOORS`` (drift over the
   reference's spread at most ``NORM_DRIFT_MAX``), ``OPT_FLOORS`` and
   ``STRUCT_FLOORS``; q4_int4kv_q8log's replayed logits must equal the
   eager step's bit for bit; the launches must equal the shapes'
   prediction (``{"phase": "accuracy", ...}``: each row's mean, min,
   drifts and floor), then the device memory.

7. scale-out (``parallel/``), run after phase 3c and before phase 4:
   ``scaleout_nccl``: this process as a one-rank NCCL group,
   ``sharded_greedy_decode`` and ``sharded_beam_decode`` (the serving
   compute, B = 8, 224 tokens) through the runners, bit for bit
   ``greedy_decode``'s and ``beam_decode``'s, one counted all-reduce, then
   two processes trying one NCCL communicator on this card (NCCL's answer
   logged); with two or more cards, one rank a card at tp = 2 through the
   captured graphs, held to the eager body. ``scaleout_shared``: two
   processes of this script (``--rank scaleout``) share the card over an
   explicit gloo group, Large-V3 at full width and depth from seed 0 (the
   accuracy phase's iid fixture), B = 8 x 30 s, 32 tokens, the loop body
   driven step by step: meshes (1, 2) and (2, 1) in ``Compute.parity()``
   (tokens equal to one rank's, or a divergence at a near-tie of the
   one-rank f32 top-2 gap), (1, 2) 5-beam in ``Compute.parity()`` (each
   stream equal to one rank's beam, or a near-tie of its score), (1, 2)
   in the serving compute teacher-forced (agreement at least
   q4_int8kv's floor) and (1, 2) serving 5-beam; on every
   rank launches and collectives as the shapes predict and the
   replication guard at 0. Phase 4 then adds ``tp_kernels``: every kernel
   at Large-V3's per-rank shapes for tp = 2 (its rows' launches from rank
   0's (1, 2) runs) and tp = 4 (off every path here, launches 0).

Last, kernel J (the LayerNorm) at the encoder's B x 1536 rows (B = 32,
off every path here, and 8), the prompt's 32 and the beam step's 40 rows,
with and without the residual, against its plain chain (kernel rows with
``equal_share`` and ``gap_of_allowance``, at most 1).

It prints ``{"kernels": [...]}`` and the card line before its last line,
and last ``{"ok": true, "device": {...}}``. It needs one CUDA card and the
repository beside it, and exits non-zero without a result otherwise.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
BATCH, REQUESTS, MAX_TOKENS = 8, 3, 224
NEW_PATH_REQUESTS = 2  # a warm-up and one timed request
BEAM_WIDTH, TRACED_TOKENS = 5, 32
STREAMS = BATCH * BEAM_WIDTH  # beam search's decode rows
CTX = 256  # the self cache of 224 tokens: 4 + 224 rounded up to 64
SEED = 0
TRACE_DIR = Path(__file__).resolve().parent / "build" / "traces"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_ATTEMPTS = 3  # traces device_ms takes before it gives up on lost records
# the hand-written kernels as the trace names them, by counter name
KERNEL_OF = {"q4_matmul": "q4_matmul", "decode_self_attention": "self_attn",
             "decode_attention_merged": "merged_attn", "decode_attention_layer": "layer_attn",
             "decode_attention_layer_unscaled": "layer_unscaled", "decode_cross_attention": "cross_attn",
             "decode_cross_attention_unpacked": "cross_unpacked", "encoder_attention": "encoder_attn",
             "write_cache_slot": "slot", "write_cache_slot_beam": "slot_beam",
             "decode_attention_merged_int4": "merged_int4",
             "decode_attention_layer_int4": "layer_int4", "encoder_attention_heads": "encoder_heads",
             "fused_ffn": "ffn"}
OURS = re.compile(r"\b(q4_matmul|self_attn|merged_attn|layer_attn|layer_unscaled|cross_attn|cross_unpacked"
                  r"|encoder_attn|slot|slot_beam|merged_int4|layer_int4|encoder_heads|ffn)(?:_wgmma)?_kernel[<(]")
STAGES = {"encode", "cross_fill", "prefill", "decode"}
DA = "whisper_burn_tpu_torch/csrc/decode_attention.cu"
XTOL = "1e-5 of max|out|, plus one bf16 step of each p within 32 f32 steps of a bf16 rounding tie"
F_SRC = "whisper_burn_tpu_torch/csrc/cache_slot.cu"
K9 = "whisper_burn_tpu/ops/pallas_cache.py:33 (K9)"


def at(pos: int) -> torch.Tensor:
    """A kernel's position: one int32 in the card's memory, which the
    self-attention kernels and the slot writer read there."""
    return torch.tensor(pos, dtype=torch.int32, device="cuda")


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def traced(fn, runtime: list | None = None):
    """``fn()`` under torch.profiler (host and device); returns its result
    and the device events of the trace (kernels, copies, fills; chrome
    trace form, times in microseconds) and its host and device ranges.
    ``runtime`` collects the CUDA API calls (launches, graph launches)."""
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
    if runtime is not None:
        runtime.extend(e for e in events if e.get("cat", "").startswith("cuda_"))  # CUDA API calls
    return out, sorted(device, key=lambda e: e["ts"]), ranges


def signature(e: dict) -> tuple[str, str]:
    """A kernel launch as the trace shows it: its name and grid."""
    return e["name"], str(e.get("args", {}).get("grid"))


def device_ms(fn, iters: int, warmup: int = 3, ours: bool = False, pattern: re.Pattern = OURS):
    """Device milliseconds per call of ``fn`` from a trace of ``iters``
    calls: the summed durations of what it runs on the card, host dispatch
    excluded. With ``ours``, the mean duration of the hand-written kernel's
    launches (named as ``pattern`` matches) and their signatures. The
    trace may lose launch records (the first of a session most often;
    kernel A's short cluster launches lost 12 of 64), so two calls run in
    the session before the timed window, ``ours`` averages the records it
    got, at least half of them, and a trace that lost the window's device
    range or more records is taken again, up to ``TRACE_ATTEMPTS`` times."""
    from torch.profiler import record_function

    for _ in range(warmup):
        fn()

    def window():
        fn(), fn()
        with record_function("chip_smoke.window"):
            for _ in range(iters):
                fn()

    for _ in range(TRACE_ATTEMPTS):
        _, dev, ranges = traced(window)
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
                 if e["cat"] == "gpu_user_annotation" and e["name"] == "chip_smoke.window"]
        if len(spans) != 1:
            problem = f"{len(spans)} device ranges of the timed window"
            continue
        (lo, hi), = spans
        dev = [e for e in dev if lo <= e["ts"] <= hi]
        if not ours:
            return sum(e["dur"] for e in dev) / iters / 1e3
        mine = [e for e in dev if pattern.search(e["name"])]
        if iters // 2 <= len(mine) <= iters:
            return sum(e["dur"] for e in mine) / len(mine) / 1e3, {signature(e) for e in mine}
        problem = f"{len(mine)} kernel launches traced for {iters} calls"
    raise AssertionError(f"{problem}, in each of {TRACE_ATTEMPTS} traces")


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


def check_cross(name: str, out: torch.Tensor, ref: torch.Tensor, ties: torch.Tensor) -> float:
    """Kernel C or C' against its plain version: fail unless every output
    is within 1e-5 of max|ref| plus its tie allowance (one bf16 step of
    each p within 32 f32 steps of a bf16 rounding tie, which the two round
    apart; zero in f32). Returns the max abs error."""
    err = max_err(out, ref)
    excess = ((out.float() - ref.float()).abs() - 1e-5 * ref.float().abs().max() - ties).max().item()
    if not excess <= 0:
        raise AssertionError(f"{name}: max abs error {err:.3e}, {excess:.3e} above its tolerance")
    return err


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
    ``cases`` against its plain version in bf16 and f32, its times, and the
    regime its bf16 launches take (the f32 check runs the weight-read
    regime's f32 form)."""
    from whisper_burn_tpu_torch.ops import q4_kernel
    from whisper_burn_tpu_torch.ops.q4_kernel import dequant_weight

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
            regime=q4_kernel.regime(m, x.dtype),
            shape_key=["q4_matmul", [m, k, n, epi]], sig=sig, max_abs_err=err_bf16, isolated_ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            library_call="torch.matmul(x, w) on a pre-dequantized bf16 weight (no bias, no GELU)",
            tol="bf16 1e-2 and f32 1e-5 of max|out|", shape=f"M={m} K={k} N={n}",
        ))
    return rows


def decode_linears(params, cfg, m: int, prefix: str = "") -> list[tuple]:
    """Kernel A's decode-step sites at ``m`` rows: the four projections (two
    shapes) and the int8 logits where the params hold them
    (``Compute.fast()``'s bf16 logits are a torch.mm)."""
    blocks = params["decoder"]["blocks"]
    k1, k5 = (f"whisper_burn_tpu/ops/{f}" for f in ("pallas_q4.py:121 (K1)", "pallas_q4.py:44 (K5)"))
    sites = [
        (f"{prefix}attn_qkv", m, blocks["attn_qkv"], None, torch.bfloat16, k1),
        (f"{prefix}attn_o/xattn_q/xattn_o", m, blocks["attn_o"], None, torch.bfloat16, k1),
    ]
    emb_q = params["decoder"].get("tok_emb_q")
    if emb_q is not None:
        logits_lin = {"qw": emb_q["qw"][None], "scales": emb_q["scales"][None]}
        sites.append((f"{prefix}logits", m, logits_lin, None, torch.float32, k5))
    return sites


def prefill_linears(params, cfg, m: int, prefix: str = "") -> list[tuple]:
    """Kernel A's prefill sites at ``m`` rows (four prompt tokens per
    utterance): the projections (two shapes)."""
    blocks = params["decoder"]["blocks"]
    k5 = "whisper_burn_tpu/ops/pallas_q4.py:44 (K5)"
    return [
        (f"{prefix}prefill_qkv", m, blocks["attn_qkv"], None, torch.bfloat16, k5),
        (f"{prefix}prefill_proj", m, blocks["attn_o"], None, torch.bfloat16, k5),
    ]


K4 = "whisper_burn_tpu/ops/pallas_ffn.py:153 (K4)"
K7 = "whisper_burn_tpu/ops/pallas_ffn.py:93 (K7)"


def ffn_rows(cases, gen, path: str) -> list[dict]:
    """Kernel I at each (site, rows, stacked blocks, GELU, K4's bias order,
    replaces) of ``cases`` against its plain version: every case in bf16
    and f32, both GELU forms and both bias orders (bf16 1e-2 and f32 1e-5
    of max|out|); then, in the case's own dtype (bf16), GELU and order, the
    kernel's device time per launch, the plain version's, kernel A's two
    launches on the same inputs (fc1 with the bias+GELU epilogue, then
    fc2) and the library pair (torch.matmul on the pre-dequantized bf16
    weights, GELU, torch.matmul), and the bound."""
    from whisper_burn_tpu_torch.ops import ffn_kernel, q4_kernel
    from whisper_burn_tpu_torch.ops.q4_kernel import dequant_weight

    dev = torch.device("cuda")
    rows = []
    for site, m, blocks, kind, after, replaces in cases:
        fc1, fc2 = blocks["fc1"], blocks["fc2"]
        n_layers, d, f = fc1["qw"].shape
        x = torch.randn((m, d), generator=gen, device=dev).to(torch.bfloat16)
        # the launch this case takes: its regime, grid, block and the cooperative attribute
        log({"phase": "kernel_i_plan", "site": site, "path": path, "rows": m, "d": d, "f": f,
             **ffn_kernel._plan(dev, m, d, f, True)[0]})
        lyr = lambda p, l: [p[k][l] if k in p else None for k in ("qw", "scales", "b")]  # a shard's fc2: no "b"
        err_case = 0.0
        for dtype, rel in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
            for g in ("tanh", "erf"):
                for order in (False, True):
                    xi = x.to(dtype)
                    out = ffn_kernel.fused_ffn(xi, fc1, fc2, g, layer=0, bias_after_round=order)
                    ref = ffn_kernel.fused_ffn_plain(xi, *lyr(fc1, 0), *lyr(fc2, 0), g, order)
                    err = max_err(out, ref)
                    check(f"fused_ffn/{site} {dtype} {g} {'K4' if order else 'K7'} order", err, ref, rel)
                    if dtype == torch.bfloat16 and g == kind and order == after:
                        err_case = err
        it = iter(range(1 << 30))
        layer = lambda: next(it) % n_layers  # cycle layers: weights come from HBM, not L2
        kern = lambda: ffn_kernel.fused_ffn(x, fc1, fc2, kind, layer=layer(), bias_after_round=after)
        plain = lambda: ffn_kernel.fused_ffn_plain(x, *lyr(fc1, (l := layer())), *lyr(fc2, l), kind, after)

        def two_launch():
            l = layer()
            h = q4_kernel.q4_matmul(x, fc1["qw"], fc1["scales"], layer=l, bias=fc1["b"], gelu=kind)
            return q4_kernel.q4_matmul(h, fc2["qw"], fc2["scales"], layer=l, bias=fc2.get("b"))

        w16 = [(dequant_weight(fc1["qw"][l], fc1["scales"][l], torch.bfloat16),
                dequant_weight(fc2["qw"][l], fc2["scales"][l], torch.bfloat16)) for l in range(n_layers)]

        def lib():
            w1, w2 = w16[layer()]
            return torch.matmul(ffn_kernel.gelu(torch.matmul(x, w1), kind), w2)

        (ms, sig), plain_ms = device_ms(kern, 64, ours=True), device_ms(plain, 16)
        two_ms, lib_ms = device_ms(two_launch, 64), device_ms(lib, 64)
        del w16
        # x and the output bf16, codes and scales of both weights, the biases
        nbytes = 2 * m * d * 2 + 2 * (d * f + (d // 32) * f * 4) + (f + (d if "b" in fc2 else 0)) * 4
        b_ms, b_by = bound(nbytes, 4.0 * m * d * f)
        rows.append(dict(
            name=f"fused_ffn/{site}", route="cuda", source="whisper_burn_tpu_torch/csrc/ffn.cu", replaces=replaces,
            path=path, shape_key=["fused_ffn", [m, d, f, int(after)]], sig=sig, max_abs_err=err_case,
            isolated_ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
            two_launch_ms=two_ms,
            library_call="torch.matmul(gelu(torch.matmul(x, w1)), w2) on pre-dequantized bf16 weights (no biases)",
            tol="bf16 1e-2 and f32 1e-5 of max|out|, tanh and erf, K4 and K7 order",
            shape=f"M={m} D={d} F={f} {kind} {'K4' if after else 'K7'} order",
        ))
    return rows


# Whisper Medium's decoder FFN (1024 <-> 4096, 24 layers) at the greedy batch's rows
MEDIUM_FFN_LAYERS, MEDIUM_D, MEDIUM_F = 24, 1024, 4096


def medium_ffn_blocks(gen) -> dict:
    """Stacked Q4 FFN weights of Whisper Medium's width, fabricated on the card."""
    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (MEDIUM_FFN_LAYERS, k, n), generator=gen, device="cuda", dtype=torch.int8),
                "scales": torch.rand((MEDIUM_FFN_LAYERS, k // 32, n), generator=gen, device="cuda") * 0.01,
                "b": torch.randn((MEDIUM_FFN_LAYERS, n), generator=gen, device="cuda") * 0.1}
    return {"fc1": lin(MEDIUM_D, MEDIUM_F), "fc2": lin(MEDIUM_F, MEDIUM_D)}


def medium_ffn_path(cfg) -> tuple[dict, dict]:
    """Kernel I at Whisper Medium's width through its own entry point, the
    op ``fused_ffn`` as the decode step calls it (K4's bias order, one
    layer of the stacked weights a call): 8 rows through each of 24 layers,
    two requests; outputs finite and of the input's shape."""
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.ffn_kernel import fused_ffn

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 21)
    blocks = medium_ffn_blocks(g)
    torch.cuda.synchronize()
    _build.reset_launches()
    for r in range(NEW_PATH_REQUESTS):
        x = torch.randn((BATCH, MEDIUM_D), generator=g, device="cuda").to(torch.bfloat16)
        t0 = time.perf_counter()
        for layer in range(MEDIUM_FFN_LAYERS):
            x = x + fused_ffn(x, blocks["fc1"], blocks["fc2"], cfg.gelu, layer=layer, bias_after_round=True)
        torch.cuda.synchronize()
        log({"path": "medium_ffn", "request": r, "wall_ms": (time.perf_counter() - t0) * 1e3,
             "launches": dict(_build.LAUNCHES)})
        if x.shape != (BATCH, MEDIUM_D) or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"medium_ffn: {tuple(x.shape)}, finite {bool(torch.isfinite(x).all())}")
    return dict(_build.LAUNCHES), shape_counts()


def kernel_checks(params, cfg, gen):
    rows = q4_rows(decode_linears(params, cfg, BATCH) + prefill_linears(params, cfg, 4 * BATCH), gen, "greedy")
    blocks = params["decoder"]["blocks"]
    rows += ffn_rows([("decode", BATCH, blocks, cfg.gelu, True, K4),
                      ("prefill", 4 * BATCH, blocks, cfg.gelu, False, K7)], gen, "greedy")
    rows += ffn_rows([("medium_decode", BATCH, medium_ffn_blocks(gen), cfg.gelu, True, K4)], gen, "medium_ffn")
    rows.append(self_attention_row(cfg, gen, "greedy", "decode_self_attention"))
    rows.append(cross_int4_row(cfg, gen, BATCH, 1, "greedy", "decode_cross_attention"))
    rows.append(encoder_attention_row(cfg, gen, BATCH, "greedy", "encoder_attention"))
    return rows


def self_attention_row(cfg, gen, path: str, name: str, ctx: int = CTX, steps: int = MAX_TOKENS - 1) -> dict:
    """Kernel B over the int8 self cache of BATCH streams at ``ctx`` (its
    path's cache), at the mean decode position when all ``steps`` steps
    run (positions 4 .. 226 at 224 tokens): against its plain version, the
    store exact, and its times."""
    from whisper_burn_tpu_torch.ops.decode_attention import decode_self_attention, decode_self_attention_plain

    dev = torch.device("cuda")
    L = cfg.n_text_layer
    d, h = cfg.n_text_state, cfg.n_text_head
    pos = round(mean_decode_pos(steps))
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
            args = (q.to(dtype), layer, at(pos), h, kn.to(dtype), vn.to(dtype), kq, vq, nsc)
            out = decode_self_attention(args[0], ck, cv, cs, *args[1:])
            ref = decode_self_attention_plain(args[0], pk, pv, ps, *args[1:])
            err = max_err(out, ref)
            check(f"{name} {dtype}", err, ref, 1e-5)  # f32 math both ways
            if not (torch.equal(ck, pk) and torch.equal(cv, pv) and torch.equal(cs, ps)):
                raise AssertionError("decode_self_attention: the in-place store differs from the plain version")
            ck[layer, :, pos], cv[layer, :, pos], cs[layer, :, pos] = kc[layer, :, pos], vc[layer, :, pos], sc[layer, :, pos]
            if not (torch.equal(ck, kc) and torch.equal(cv, vc) and torch.equal(cs, sc)):
                raise AssertionError("decode_self_attention: a cache row other than pos changed")
            if dtype == torch.bfloat16 and layer == 0:
                self_err = err
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L
    pos_t = at(pos)
    kern = lambda: decode_self_attention(q, kc, vc, sc, layer(), pos_t, h, kn, vn, kq, vq, nsc)
    plain = lambda: decode_self_attention_plain(q, kc, vc, sc, layer(), pos_t, h, kn, vn, kq, vq, nsc)
    deq = lambda c, s: (c[:, :pos + 1].float() * s[:, :pos + 1, None]).to(torch.bfloat16).reshape(BATCH, pos + 1, h, 64).transpose(1, 2)
    kd = [deq(kc[l], sc[l, :, :, 0]) for l in range(L)]
    vd = [deq(vc[l], sc[l, :, :, 1]) for l in range(L)]
    qh = q.reshape(BATCH, 1, h, 64).transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l])
    b_ms, b_by = self_attention_bound(pos, d)
    ms, sig = device_ms(kern, 64, ours=True)
    row = dict(
        name=name, route="cuda", source=DA, path=path,
        replaces="whisper_burn_tpu/ops/pallas_attention.py:66 (K2)",
        shape_key=["decode_self_attention", [BATCH, ctx, d]], sig=sig, max_abs_err=self_err,
        isolated_ms=ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64),
        library_call="scaled_dot_product_attention on the dequantized bf16 cache (no store)",
        tol="1e-5 of max|out|; cache store exact", shape=f"B={BATCH} ctx={ctx} pos={pos} D={d}",
        isolated_bound_ms=b_ms, bound_of_pos=lambda p: self_attention_bound(p, d),
    )
    del kc, vc, kd, vd
    return row


def cross_int4_row(cfg, gen, b: int, g: int, path: str, name: str) -> dict:
    """Kernel C over the int4 cross cache of ``b`` entries (T = 1536 with
    1500 valid) with ``g`` query streams per entry, against its plain
    version, and its times."""
    from whisper_burn_tpu_torch.ops.decode_attention import (
        decode_cross_attention, decode_cross_attention_plain, decode_cross_attention_ties, unpack_int4,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    L, d, h = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    t, valid = 1536, cfg.n_audio_ctx
    kT = torch.randint(0, 256, (L, b, d // 2, t), generator=gen, device=dev, dtype=torch.uint8)
    v4 = torch.randint(0, 256, (L, b, t // 2, d), generator=gen, device=dev, dtype=torch.uint8)
    qx = (torch.randn((b * g, 1, d), generator=gen, device=dev) * 0.05).to(bf)
    for dtype in (bf, torch.float32):
        args = (qx.to(dtype), kT, v4, L - 1, valid, h, g)
        out = decode_cross_attention(*args)
        err = check_cross(f"{name} {dtype}", out, decode_cross_attention_plain(*args), decode_cross_attention_ties(*args))
        if dtype == bf:
            cross_err = err
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L  # cycle layers: caches come from HBM, not L2
    kd = [unpack_int4(kT[l], 1, bf)[..., :valid].reshape(b, h, 64, valid).transpose(-1, -2).contiguous() for l in range(L)]
    vd = [unpack_int4(v4[l], 1, bf)[:, :valid].reshape(b, valid, h, 64).transpose(1, 2).contiguous() for l in range(L)]
    qh = qx.reshape(b, g, h, 64).transpose(1, 2)  # an entry's streams as its queries
    # the keys' packed [D/2, T] rows are needed up to `valid` only; every
    # packed value row holds a valid time step (t < T/2 <= valid); each
    # entry's bytes read once, by one block for all g streams of the entry;
    # q bf16 in and f32 out per stream
    nbytes = b * ((d // 2) * valid + (t // 2) * d) + b * g * (d * 2 + d * 4)
    return isolated_row(
        name, path, DA, "whisper_burn_tpu/ops/pallas_attention.py:636 (K3" + (", batch_groups)" if g > 1 else ")"),
        ["decode_cross_attention", [b * g, t, d, g]],
        lambda: decode_cross_attention(qx, kT, v4, layer(), valid, h, g),
        lambda: decode_cross_attention_plain(qx, kT, v4, layer(), valid, h, g),
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l]),
        cross_err, bound(nbytes, 4.0 * b * g * valid * d),
        "scaled_dot_product_attention on the dequantized bf16 cache" + (f", the beams as {g} queries" if g > 1 else ""),
        XTOL, f"B={b}" + (f" x G={g}" if g > 1 else "") + f" T={t} valid={valid} D={d}",
    )


def encoder_attention_row(cfg, gen, b: int, path: str, name: str) -> dict:
    """Kernel D: one encoder layer's attention over ``b`` utterances at
    T = 1536 with 1500 valid, against its plain version, and its times."""
    from whisper_burn_tpu_torch.ops.encoder_attention import encoder_attention, encoder_attention_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    d, h = cfg.n_audio_state, cfg.n_audio_head
    t, valid = 1536, cfg.n_audio_ctx
    qkv = [torch.randn((b, t, d), generator=gen, device=dev).to(bf) for _ in range(3)]
    for dtype, b_chk, rel in ((bf, b, 1e-2), (torch.float32, min(b, 2), 1e-5)):
        xs = [a[:b_chk].to(dtype) for a in qkv]
        out = encoder_attention(*xs, h, valid=valid)
        ref = encoder_attention_plain(*xs, h, valid)
        err = max_err(out, ref)
        check(f"{name} {dtype}", err, ref, rel)
        if dtype == bf:
            enc_err = err
    kern = lambda: encoder_attention(*qkv, h, valid=valid)
    plain = lambda: encoder_attention_plain(*qkv, h, valid)
    hq, hk, hv = (a.reshape(b, t, h, 64).transpose(1, 2) for a in qkv)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(hq, hk[:, :, :valid], hv[:, :, :valid])
    # q and the output over all T rows, k and v over the valid rows, bf16
    b_ms, b_by = bound(b * (2 * t + 2 * valid) * d * 2, 4.0 * b * h * t * valid * 64)
    ms, sig = device_ms(kern, 5, 1, ours=True)
    return dict(
        name=name, route="cuda", source="whisper_burn_tpu_torch/csrc/encoder_attention.cu", path=path,
        replaces="whisper_burn_tpu/ops/pallas_encoder_attention.py:96 (K6)",
        shape_key=["encoder_attention", [b, t, d]], sig=sig, max_abs_err=enc_err,
        isolated_ms=ms, plain_ms=device_ms(plain, 3, 1), bound_ms=b_ms,
        bound_by=b_by, library_ms=device_ms(lib, 5, 1),
        library_call="scaled_dot_product_attention over the 1500 valid keys",
        tol="bf16 1e-2 and f32 1e-5 of max|out|", shape=f"B={b} T={t} valid={valid} D={d} H={h}",
    )


def beam_kernel_checks(params, cfg, gen):
    """The kernels at the beam path's shapes: kernel A at M = STREAMS, E
    and C with BEAM_WIDTH streams per cross-cache entry (F: kernel_f_checks)."""
    rows = q4_rows(decode_linears(params, cfg, STREAMS, "beam_"), gen, "beam")
    rows += ffn_rows([("beam_decode", STREAMS, params["decoder"]["blocks"], cfg.gelu, True, K4)], gen, "beam")
    rows.append(layer_attention_row(cfg, gen, "beam", "decode_attention_layer"))
    rows.append(cross_int4_row(cfg, gen, BATCH, BEAM_WIDTH, "beam", "decode_cross_attention/grouped"))
    return rows


def layer_attention_row(cfg, gen, path: str, name: str, ctx: int = CTX, steps: int = MAX_TOKENS - 1) -> dict:
    """Kernel E over the int8 self cache of the STREAMS beam streams
    (``ctx``), at the first, mean and last positions of ``steps`` decode
    steps (224 tokens' by default), against its plain version, and its
    times at the mean."""
    from whisper_burn_tpu_torch.ops.decode_attention import decode_attention_layer, decode_attention_layer_plain

    dev = torch.device("cuda")
    L = cfg.n_text_layer
    d, h = cfg.n_text_state, cfg.n_text_head
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L  # cycle layers: caches come from HBM, not L2
    kc = torch.randint(-127, 128, (L, STREAMS, ctx, d), generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (L, STREAMS, ctx, d), generator=gen, device=dev, dtype=torch.int8)
    sc = torch.rand((L, STREAMS, ctx, 2), generator=gen, device=dev) * 0.02 + 1e-3
    q = torch.randn((STREAMS, 1, d), generator=gen, device=dev).to(torch.bfloat16)
    pos = round(mean_decode_pos(steps))
    layer_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for valid in (4, pos, 4 + steps):
            out = decode_attention_layer(q.to(dtype), kc, vc, sc, L - 1, at(valid), h)
            ref = decode_attention_layer_plain(q.to(dtype), kc, vc, sc, L - 1, at(valid), h)
            for part, a, r in zip(("acc", "m", "l"), out, ref):
                err = max_err(a, r)
                check(f"{name} {dtype} valid={valid} {part}", err, r, 1e-5)  # f32 math both ways
                if dtype == torch.bfloat16:
                    layer_err = max(layer_err, err)
    pos_t = at(pos)
    kern = lambda: decode_attention_layer(q, kc, vc, sc, layer(), pos_t, h)
    plain = lambda: decode_attention_layer_plain(q, kc, vc, sc, layer(), pos_t, h)
    deq = lambda c, s: (c[:, :pos].float() * s[:, :pos, None]).to(torch.bfloat16).reshape(STREAMS, pos, h, 64).transpose(1, 2)
    kd = [deq(kc[l], sc[l, :, :, 0]) for l in range(L)]
    vd = [deq(vc[l], sc[l, :, :, 1]) for l in range(L)]
    qh = q.reshape(STREAMS, 1, h, 64).transpose(1, 2)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l])
    ms, sig = device_ms(kern, 64, ours=True)
    b_ms, b_by = layer_attention_bound(pos, d, h)
    row = dict(
        name=name, route="cuda", source=DA, path=path,
        replaces="whisper_burn_tpu/ops/pallas_attention.py:66 (K8)",
        shape_key=["decode_attention_layer", [STREAMS, ctx, d]], sig=sig, max_abs_err=layer_err,
        isolated_ms=ms, isolated_bound_ms=b_ms, plain_ms=device_ms(plain, 16), bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lib, 64),
        library_call="scaled_dot_product_attention on the dequantized bf16 layer (normalized)",
        tol="1e-5 of max|acc|, max|m|, max|l|", shape=f"B*W={STREAMS} ctx={ctx} valid={pos} D={d}",
        bound_of_pos=lambda p: layer_attention_bound(p, d, h),
    )
    del kc, vc, kd, vd
    return row


def merged_attention_bound(pos: float, d: int, b: int) -> tuple[float, str]:
    """Kernel B' at ``pos`` over ``b`` streams: q, the bf16 K/V rows below
    pos, the raw k/v bf16, the f32 output."""
    nbytes = b * (d * 2 + 2 * pos * d * 2 + 2 * d * 2 + d * 4)
    return bound(nbytes, 4.0 * b * (pos + 1) * d)


def unscaled_layer_bound(pos: float, d: int, h: int) -> tuple[float, str]:
    """Kernel E' at ``pos`` over the STREAMS beam streams: q bf16, the bf16
    K/V rows below pos, acc f32 and m, l f32."""
    nbytes = STREAMS * (d * 2 + 2 * pos * d * 2 + d * 4 + 2 * h * 4)
    return bound(nbytes, 4.0 * STREAMS * pos * d)


def isolated_row(name, path, source, replaces, shape_key, kern, plain, lib, err, bound_ms_by,
                 library_call, tol, shape, **extra) -> dict:
    """A kernel row: the kernel's isolated device time and signature, the
    plain version's and the library call's, from traces of 64, 16 and 64
    calls."""
    ms, sig = device_ms(kern, 64, ours=True)
    return dict(
        name=name, route="cuda", source=source, path=path, replaces=replaces, shape_key=shape_key,
        sig=sig, max_abs_err=err, isolated_ms=ms, plain_ms=device_ms(plain, 16),
        bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1], library_ms=device_ms(lib, 64),
        library_call=library_call, tol=tol, shape=shape, **extra,
    )


LN_KERNEL = re.compile(r"\blayer_norm_kernel[<(]")


def layer_norm_rows(gen, counts: dict) -> list[dict]:
    """Kernel J at the encoder's rows (B x 1536 at B = 32, the offline
    benchmark's, off every path here, and at the paths' B = 8), the
    prompt's 8 x 4 and the beam step's 40, each with and without the
    residual: its isolated device time against its bytes bound and the
    eleven-launch plain chain's (with the add before it for the residual
    form), every output within ``gap_allowance`` of the chain's, 99.9%
    equal, and the sum equal to PyTorch's add."""
    from whisper_burn_tpu_torch.ops.layer_norm import NAME, gap_allowance, layer_norm, layer_norm_plain

    d, rows = 1280, []
    for site, m, path in (("encoder B=32", 32 * 1536, None), ("encoder", BATCH * 1536, "greedy"),
                          ("prefill", 4 * BATCH, "greedy"), ("beam_decode", STREAMS, "beam")):
        for residual in (False, True):
            x = (torch.randn((m, d), generator=gen, device="cuda") * 3 + 0.5).to(torch.bfloat16)
            r = torch.randn((m, d), generator=gen, device="cuda").to(torch.bfloat16) if residual else None
            g = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
            b = 0.1 * torch.randn(d, generator=gen, device="cuda")
            kern = lambda: layer_norm(x, g, b, residual=r)
            plain = (lambda: layer_norm_plain(x + r, g, b)) if residual else (lambda: layer_norm_plain(x, g, b))
            out = kern()
            s, y = out if residual else (x, out)
            if residual and not torch.equal(s, x + r):
                raise AssertionError(f"layer_norm {site} {m}: the sum differs from PyTorch's add")
            want = layer_norm_plain(s, g, b)
            gap = (y.float() - want.float()).abs()
            over = float((gap / gap_allowance(s, g, want)).max())  # at most 1
            equal = float((y == want).float().mean())
            if over > 1.0 or equal < 0.999:
                raise AssertionError(f"layer_norm {site} {m}: {over} of the allowed gap, {equal} equal")
            ms, _ = device_ms(kern, 64, ours=True, pattern=LN_KERNEL)
            key = json.dumps([NAME, [m, d, 2, int(residual)]])
            launches = counts[path].get(key, 0) if path else 0
            rows.append(dict(
                name=f"layer_norm {site} {m}x{d}" + (" +residual" if residual else ""), route="cuda",
                source="whisper_burn_tpu_torch/csrc/layer_norm.cu", path=path or "offline benchmark, B = 32",
                replaces="none (the JAX package leaves LayerNorm to XLA)", isolated_ms=ms, ms=ms,
                ms_source="isolated", plain_ms=device_ms(plain, 16), bound_ms=bound(m * d * 2 * (4 if residual else 2), 0)[0],
                bound_by="bytes", max_abs_err=float(gap.max()), gap_of_allowance=over, equal_share=equal,
                launches=launches, off_path=path is None, shape=[m, d]))
            if path and not launches:
                raise AssertionError(f"layer_norm {site} ({key}) was not launched on the {path} path")
            del x, r, out, s, y, want, gap
    torch.cuda.empty_cache()
    return rows


def mode_kernel_checks(fast_params, cfg, gen) -> list[dict]:
    """The kernels of the unquantized and int8 cache modes at their paths'
    Large-V3 shapes: kernel A at the entry's encoder and cross-fill rows and
    at its decode step's one row and its prefill's four; B' (fast_greedy and
    entry), E' (fast_beam), C' over the int8 and bf16 cross caches,
    ungrouped and grouped (int8_greedy, int8_beam, fast_greedy, fast_beam,
    entry), and D at the entry's B = 1 (F: kernel_f_checks)."""
    from whisper_burn_tpu_torch.entry import MAX_TOKENS as ENTRY_TOKENS

    t_enc = -(-cfg.n_audio_ctx // 128) * 128  # the encoder's padded rows, 1536
    enc, dec = fast_params["encoder"]["blocks"], fast_params["decoder"]["blocks"]
    k5 = "whisper_burn_tpu/ops/pallas_q4.py:44 (K5)"
    rows = q4_rows([
        ("encoder_qkv", t_enc, enc["attn_qkv"], None, torch.bfloat16, k5),
        ("encoder_attn_o", t_enc, enc["attn_o"], None, torch.bfloat16, k5),
        ("cross_fill_kv", cfg.n_audio_ctx, dec["xattn_kv"], None, torch.bfloat16, k5),
    ] + decode_linears(fast_params, cfg, 1, "entry_") + prefill_linears(fast_params, cfg, 4, "entry_"), gen, "entry")
    rows += ffn_rows([("entry_decode", 1, dec, cfg.gelu, True, K4), ("entry_prefill", 4, dec, cfg.gelu, False, K7),
                      ("entry_encoder", t_enc, enc, cfg.gelu, False, K7)], gen, "entry")
    # the entry's self cache: 4 + 16 tokens rounded up to 64
    entry_ctx = max(64, -(-(4 + ENTRY_TOKENS) // 64) * 64)
    rows += merged_rows(cfg, gen, (("fast_greedy", BATCH, CTX, MAX_TOKENS - 1), ("entry", 1, entry_ctx, ENTRY_TOKENS - 1)))
    rows.append(unscaled_layer_row(cfg, gen, "fast_beam"))
    rows += cross_unpacked_rows(cfg, gen, (("int8", ((BATCH, 1, "int8_greedy"), (BATCH, BEAM_WIDTH, "int8_beam"))),
                                           ("bf16", ((BATCH, 1, "fast_greedy"), (BATCH, BEAM_WIDTH, "fast_beam"),
                                                     (1, 1, "entry")))))
    # kernel D at the entry's one utterance
    rows.append(encoder_attention_row(cfg, gen, 1, "entry", "encoder_attention/entry"))
    return rows


def decoder_row_tools(cfg, gen):
    """What the decoder's attention rows share: the card, the stack's L, D
    and heads, ``layer()`` cycling the stack (caches come from HBM, not
    L2), ``rand(*shape, scale=)`` drawing bf16 on the card from ``gen``, and
    ``heads(x, n)`` viewing ``[B, n, D]`` as ``[B, H, n, 64]``."""
    dev = torch.device("cuda")
    L, d, h = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L
    rand = lambda *shape, scale=1.0: (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)
    heads = lambda x, n: x.reshape(x.shape[0], n, h, 64).transpose(1, 2)
    return dev, L, d, h, layer, rand, heads


def merged_rows(cfg, gen, cases, suffix: str = "") -> list[dict]:
    """Kernel B' over the bf16 self cache, nothing stored, at each (path,
    streams, ctx, decode steps) of ``cases``: against its plain version at
    the first, mean and last positions of the steps, its times at the mean."""
    from whisper_burn_tpu_torch.ops.decode_attention import decode_attention_merged, decode_attention_merged_plain

    dev, L, d, h, layer, rand, heads = decoder_row_tools(cfg, gen)
    bf = torch.bfloat16
    rows = []
    for path, b, ctx, steps in cases:
        p_mean = round(mean_decode_pos(steps))
        kc, vc = rand(L, b, ctx, d), rand(L, b, ctx, d)
        q, kn, vn = rand(b, 1, d), rand(b, 1, d), rand(b, 1, d)
        err = 0.0
        for dtype in (bf, torch.float32):
            kcd, vcd = kc.to(dtype), vc.to(dtype)
            k0, v0 = kcd.clone(), vcd.clone()
            args = (q.to(dtype), kcd, vcd)
            for p in (4, p_mean, 3 + steps):
                for lyr in (0, L - 1):
                    new = (kn.to(dtype), vn.to(dtype))
                    out = decode_attention_merged(*args, lyr, at(p), h, *new)
                    ref = decode_attention_merged_plain(*args, lyr, at(p), h, *new)
                    e = max_err(out, ref)
                    check(f"decode_attention_merged {path} {dtype} pos={p}", e, ref, 1e-5)  # f32 math both ways
                    err = max(err, e) if dtype == bf else err
            if not (torch.equal(kcd, k0) and torch.equal(vcd, v0)):
                raise AssertionError("decode_attention_merged changed its cache")
            del k0, v0
        kd = [heads(kc[l, :, :p_mean + 1], p_mean + 1) for l in range(L)]
        vd = [heads(vc[l, :, :p_mean + 1], p_mean + 1) for l in range(L)]
        qh = heads(q, 1)
        rows.append(isolated_row(
            "decode_attention_merged" + ("/entry" if path == "entry" else "") + suffix, path, DA,
            "whisper_burn_tpu/ops/pallas_attention.py:66 (K2, decode_attention_merged without kq/vq)",
            ["decode_attention_merged", [b, ctx, d]],
            lambda p_t=at(p_mean): decode_attention_merged(q, kc, vc, layer(), p_t, h, kn, vn),
            lambda p_t=at(p_mean): decode_attention_merged_plain(q, kc, vc, layer(), p_t, h, kn, vn),
            lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l]),
            err, merged_attention_bound(p_mean, d, b),
            "scaled_dot_product_attention on the bf16 cache rows up to pos", "1e-5 of max|out|; cache unchanged",
            f"B={b} ctx={ctx} pos={p_mean} D={d} bf16", isolated_bound_ms=merged_attention_bound(p_mean, d, b)[0],
            bound_of_pos=lambda p, b=b: merged_attention_bound(p, d, b),
        ))
        del kc, vc, kd, vd
    return rows


def unscaled_layer_row(cfg, gen, path: str) -> dict:
    """Kernel E': the STREAMS beam streams over the bf16 self cache (ctx
    CTX), against its plain version at valid 4, the mean and the last
    position, its times at the mean."""
    from whisper_burn_tpu_torch.ops.decode_attention import decode_attention_layer, decode_attention_layer_plain

    dev, L, d, h, layer, rand, heads = decoder_row_tools(cfg, gen)
    bf = torch.bfloat16
    pos = round(mean_decode_pos(MAX_TOKENS - 1))
    kc, vc = rand(L, STREAMS, CTX, d), rand(L, STREAMS, CTX, d)
    q = rand(STREAMS, 1, d)
    err = 0.0
    for dtype in (bf, torch.float32):
        args = (q.to(dtype), kc.to(dtype), vc.to(dtype), None, L - 1)
        for valid in (4, pos, 3 + MAX_TOKENS):
            out = decode_attention_layer(*args, at(valid), h)
            ref = decode_attention_layer_plain(*args, at(valid), h)
            for part, a, r in zip(("acc", "m", "l"), out, ref):
                e = max_err(a, r)
                check(f"decode_attention_layer_unscaled {dtype} valid={valid} {part}", e, r, 1e-5)
                err = max(err, e) if dtype == bf else err
    kd = [heads(kc[l, :, :pos], pos) for l in range(L)]
    vd = [heads(vc[l, :, :pos], pos) for l in range(L)]
    qh = heads(q, 1)
    row = isolated_row(
        "decode_attention_layer_unscaled", path, DA,
        "whisper_burn_tpu/ops/pallas_attention.py:66 (K8, kv_scale4=None)",
        ["decode_attention_layer_unscaled", [STREAMS, CTX, d]],
        lambda p_t=at(pos): decode_attention_layer(q, kc, vc, None, layer(), p_t, h),
        lambda p_t=at(pos): decode_attention_layer_plain(q, kc, vc, None, layer(), p_t, h),
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l]),
        err, unscaled_layer_bound(pos, d, h),
        "scaled_dot_product_attention on the bf16 layer (normalized)", "1e-5 of max|acc|, max|m|, max|l|",
        f"B*W={STREAMS} ctx={CTX} valid={pos} D={d} bf16", isolated_bound_ms=unscaled_layer_bound(pos, d, h)[0],
        bound_of_pos=lambda p: unscaled_layer_bound(p, d, h),
    )
    del kc, vc, kd, vd
    return row


def cross_unpacked_rows(cfg, gen, kinds, suffix: str = "") -> list[dict]:
    """Kernel C' over the int8, bf16 and f32 cross caches, T = 1536 with
    1500 valid, at each (kind, [(entries, streams per entry, path)]) of
    ``kinds``: against its plain version, and its times."""
    from whisper_burn_tpu_torch.ops.decode_attention import (
        decode_cross_attention, decode_cross_attention_plain, decode_cross_attention_ties,
    )

    dev, L, d, h, layer, rand, heads = decoder_row_tools(cfg, gen)
    bf = torch.bfloat16
    rows = []
    t, valid = 1536, cfg.n_audio_ctx
    for kind, cases in kinds:
        if kind == "int8":
            kT = torch.randint(-127, 128, (L, BATCH, d, t), generator=gen, device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, (L, BATCH, t, d), generator=gen, device=dev, dtype=torch.int8)
            qscale, item = 0.003, 1
        elif kind == "bf16":
            kT, v = rand(L, BATCH, d, t), rand(L, BATCH, t, d)
            qscale, item = 0.3, 2
        else:  # f32, Compute.parity()'s cache
            kT, v = rand(L, BATCH, d, t).float(), rand(L, BATCH, t, d).float()
            qscale, item = 0.3, 4
        kd = [heads(kT[l, :, :, :valid].transpose(1, 2).to(bf), valid).contiguous() for l in range(L)]
        vd = [heads(v[l, :, :valid].to(bf), valid).contiguous() for l in range(L)]
        for b, g, path in cases:
            kTb, vb = (kT, v) if b == BATCH else (kT[:, :b].contiguous(), v[:, :b].contiguous())
            qx = rand(b * g, 1, d, scale=qscale)
            err = 0.0
            for dtype in (bf, torch.float32):
                if kind != "int8" and dtype != {"bf16": bf, "f32": torch.float32}[kind]:
                    continue  # a float cache takes a query of its dtype
                args = (qx.to(dtype), kTb, vb, L - 1, valid, h, g)
                out = decode_cross_attention(*args)
                e = check_cross(f"decode_cross_attention {kind} B={b} G={g} {dtype}", out,
                                decode_cross_attention_plain(*args), decode_cross_attention_ties(*args))
                err = max(err, e) if dtype == bf or kind == "f32" else err
            if kind == "f32":
                qx = qx.float()  # the f32 cache's query, timed as its path runs it
            qh = qx.to(bf).reshape(b, g, h, 64).transpose(1, 2)  # an utterance's streams as its queries
            # each entry's keys up to `valid` and its values read once; q bf16
            # in and f32 out per stream
            nbytes = b * 2 * valid * d * item + b * g * (d * qx.element_size() + d * 4)
            rows.append(isolated_row(
                f"decode_cross_attention_unpacked/{kind}" + ("/grouped" if g > 1 else "") + ("/entry" if path == "entry" else "")
                + suffix,
                path, DA,
                f"whisper_burn_tpu/ops/pallas_attention.py:636 (K3, {kind} branch" + (", batch_groups)" if g > 1 else ")"),
                ["decode_cross_attention_unpacked", [b * g, t, d, g, item]],
                lambda: decode_cross_attention(qx, kTb, vb, layer(), valid, h, g),
                lambda: decode_cross_attention_plain(qx, kTb, vb, layer(), valid, h, g),
                lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())][:b], vd[l][:b]),
                err, bound(nbytes, 4.0 * b * g * valid * d),
                f"scaled_dot_product_attention on the {kind} cache as bf16" + (", the beams as 5 queries" if g > 1 else ""),
                XTOL, f"B={b} x G={g} T={t} valid={valid} D={d} {kind}",
            ))
            del kTb, vb
        del kT, v, kd, vd
    return rows


def int4_attention_bound(pos: float, d: int, b: int, sw: int, key_bytes: float, merged: bool,
                         h: int) -> tuple[float, str]:
    """Kernel G (``merged``) or H at ``pos`` over ``b`` streams: q bf16, the
    packed K (``key_bytes`` a channel: 0.5 int4, 1 int8) and int4 V rows
    below pos and their f32 scales; G also the raw k/v bf16 and the f32
    output, H acc f32 and m, l f32."""
    cached = pos * (d * key_bytes + d * 0.5 + sw * 4)
    io = 2 * d * 2 + d * 4 if merged else d * 4 + 2 * h * 4
    return bound(b * (d * 2 + cached + io), 4.0 * b * (pos + merged) * d)


def int4_self_row(cfg, gen, mode: str, merged: bool, b: int, path: str, suffix: str = "") -> dict:
    """Kernel G (``merged``) or H over ``b`` streams' int4 (``mode``
    "int4self") or mixed self cache at ctx CTX, against its plain version
    at positions 4, 115 and 227 in bf16 and f32, and its times at 115."""
    from whisper_burn_tpu_torch.models.decoder import self_kv_groups
    from whisper_burn_tpu_torch.ops.decode_attention import (
        LAYER4, MERGED4, decode_attention_layer_int4, decode_attention_layer_int4_plain,
        decode_attention_merged_int4, decode_attention_merged_int4_plain, dequantize_self_rows, int4_lanes,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    L, d, h = cfg.n_text_layer, cfg.n_text_state, cfg.n_text_head
    it = iter(range(1 << 30))
    layer = lambda: next(it) % L  # cycle layers: caches come from HBM, not L2
    pos = round(mean_decode_pos(MAX_TOKENS - 1))
    ng = self_kv_groups(d)
    heads = lambda x: x.reshape(x.shape[0], x.shape[1], h, 64).transpose(1, 2)
    sw, key_bytes = (2 * ng, 0.5) if mode == "int4self" else (1 + ng, 1.0)
    fn = MERGED4 if merged else LAYER4
    k_shape = (L, b, CTX, d // 2 if mode == "int4self" else d)
    if mode == "int4self":
        kc = torch.randint(0, 256, k_shape, generator=gen, device=dev, dtype=torch.uint8)
    else:
        kc = torch.randint(-127, 128, k_shape, generator=gen, device=dev, dtype=torch.int8)
    vc = torch.randint(0, 256, (L, b, CTX, d // 2), generator=gen, device=dev, dtype=torch.uint8)
    sc = torch.rand((L, b, CTX, sw), generator=gen, device=dev) * 0.04 + 0.01
    if mode == "mixed":
        sc[..., 0] *= 0.1  # an int8 key step
    q, kn, vn = (torch.randn((b, 1, d), generator=gen, device=dev).to(bf) for _ in range(3))
    err = 0.0
    for dtype in (bf, torch.float32):
        for p in (4, pos, 3 + MAX_TOKENS):
            if merged:
                args = (q.to(dtype), kc, vc, sc, L - 1, at(p), h, kn.to(dtype), vn.to(dtype))
                outs, refs = [decode_attention_merged_int4(*args)], [decode_attention_merged_int4_plain(*args)]
            else:
                args = (q.to(dtype), kc, vc, sc, L - 1, at(p), h)
                outs, refs = decode_attention_layer_int4(*args), decode_attention_layer_int4_plain(*args)
            for part, a, r in zip(("out",) if merged else ("acc", "m", "l"), outs, refs):
                e = max_err(a, r)
                check(f"{fn} {mode} B={b} {dtype} pos={p} {part}", e, r, 1e-5)  # f32 math
                err = max(err, e) if dtype == bf else err
    n = pos + merged  # the cached rows, and the current token's for G
    lanes = int4_lanes("check", q, kc, vc, sc, h)
    deq = [dequantize_self_rows(kc[l, :, :n], vc[l, :, :n], sc[l, :, :n], lanes) for l in range(L)]
    kd = [heads(k_.to(bf)) for k_, _ in deq]
    vd = [heads(v_.to(bf)) for _, v_ in deq]
    del deq
    qh = heads(q)
    pos_t = at(pos)
    if merged:
        kern = lambda: decode_attention_merged_int4(q, kc, vc, sc, layer(), pos_t, h, kn, vn)
        plain = lambda: decode_attention_merged_int4_plain(q, kc, vc, sc, layer(), pos_t, h, kn, vn)
        replaces = "whisper_burn_tpu/ops/pallas_attention.py:66 (K11, int4 branches :174-258, merged form, no store"
    else:
        kern = lambda: decode_attention_layer_int4(q, kc, vc, sc, layer(), pos_t, h)
        plain = lambda: decode_attention_layer_int4_plain(q, kc, vc, sc, layer(), pos_t, h)
        replaces = "whisper_burn_tpu/ops/pallas_attention.py:66 (K11, int4 branches :174-258, general unnormalized form"
    replaces += ", voff=1 :337-338)" if mode == "mixed" else ")"
    b_of = lambda p: int4_attention_bound(p, d, b, sw, key_bytes, merged, h)
    return isolated_row(
        f"{fn}/{mode}" + (f"/pipeline/B={b}" if path == "pipeline" else "") + suffix, path, DA, replaces,
        [fn, [b, CTX, d, sw]], kern, plain,
        lambda: torch.nn.functional.scaled_dot_product_attention(qh, kd[(l := layer())], vd[l]),
        err, b_of(pos), "scaled_dot_product_attention on the dequantized bf16 cache rows",
        "1e-5 of max|out| (G) or of max|acc|, |m|, |l| (H)",
        f"B={b} ctx={CTX} pos={pos} D={d} {'int4 K+V' if mode == 'int4self' else 'int8 K, int4 V'}, {sw} scale lanes",
        isolated_bound_ms=b_of(pos)[0], bound_of_pos=b_of,
    )


def f_tensors(cfg, compute, streams: int, t: int, gen) -> list[torch.Tensor]:
    """Random self-cache tensors of ``compute``'s forms, ``[L, streams, t,
    W]``: K, V and (a quantized self cache) the f32 scales."""
    from whisper_burn_tpu_torch.models.decoder import SELF_FIELDS, init_self_cache

    fields = init_self_cache(cfg, streams, compute, t, "cuda")
    out = []
    for x in (fields[name] for name in SELF_FIELDS if fields[name] is not None):
        if x.dtype.is_floating_point:
            x.copy_(torch.randn(x.shape, generator=gen, device="cuda"))
        else:
            lo, hi = (-128, 128) if x.dtype == torch.int8 else (0, 256)
            x.copy_(torch.randint(lo, hi, x.shape, generator=gen, device="cuda", dtype=x.dtype))
        out.append(x)
    return out


def self_form(compute) -> str:
    if not compute.quantized_self_kv:
        return str(compute.self_kv_storage_dtype).removeprefix("torch.").replace("bfloat16", "bf16")
    return "int4self" if compute.self_kv_packed else "mixed" if compute.self_v_packed else "int8"


def f_row(cfg, gen, compute, path: str, streams: int, ctx: int, beam: bool, steps: int,
          suffix: str | None = None, positions: bool = True) -> tuple[dict, dict | None]:
    """Kernel F at one path's shape: the slot form (greedy paths: K, V and
    the scale row of ``streams`` streams in one launch) or the beam form
    (``streams`` = B x BEAM_WIDTH, each utterance's streams taking random
    parents among them), exactly its plain version at slots 0, the mean of
    ``steps`` decode steps and ctx - 1 (the beam form on the rows up to the
    slot, its later rows and its source untouched), and its times at the
    mean slot beside the plain version and the library calls (index_copy_
    of each cache; for the beam form also index_select by parent, the old
    reorder). A beam form also returns its times at slots 4, 115 and 226
    beside the slot form followed by the index_selects. The beam form's
    bound counts its rows up to the slot written for every stream and
    read once for each distinct parent."""
    from whisper_burn_tpu_torch.ops.cache import (
        BEAM_FN, FN, write_cache_slots, write_cache_slots_beam, write_cache_slots_beam_plain, write_cache_slots_plain,
    )

    dev = torch.device("cuda")
    L = cfg.n_text_layer
    xs, news = f_tensors(cfg, compute, streams, ctx, gen), f_tensors(cfg, compute, streams, 1, gen)
    rbs = [x.shape[-1] * x.element_size() for x in xs]
    pos = round(mean_decode_pos(steps))
    form = self_form(compute)
    idx = torch.tensor([pos], device=dev)
    shape = f"L={L} {'B*W' if beam else 'B'}={streams} ctx={ctx} {form}, rows of {' + '.join(map(str, rbs))} bytes"
    if suffix is None:
        suffix = "/entry" if path == "entry" else "/pipeline" if path == "pipeline" else ""
    if not beam:
        pairs = list(zip(xs, news))
        for p in (0, pos, ctx - 1):
            got, ref = [x.clone() for x in xs], [x.clone() for x in xs]
            write_cache_slots(list(zip(got, news)), at(p))
            write_cache_slots_plain(list(zip(ref, news)), at(p))
            if not all(torch.equal(a, r) for a, r in zip(got, ref)):
                raise AssertionError(f"write_cache_slots {path} at {p} differs from the plain version")
        del got, ref
        return isolated_row(
            f"write_cache_slot/{form}/{streams}{suffix}", path, F_SRC, K9, [FN, [L, streams, ctx, *rbs]],
            lambda p_t=at(pos): write_cache_slots(pairs, p_t),
            lambda p_t=at(pos): write_cache_slots_plain(pairs, p_t),
            lambda: [x.index_copy_(2, idx, n) for x, n in pairs], 0.0, bound(2 * L * streams * sum(rbs), 0.0),
            f"index_copy_ along T of each of the {len(pairs)} caches", "exact", shape,
        ), None
    ys = f_tensors(cfg, compute, streams, ctx, gen)  # the other buffer, its rows stale
    parent = torch.randint(0, BEAM_WIDTH, (streams // BEAM_WIDTH, BEAM_WIDTH), generator=gen, device=dev)
    src = (torch.arange(streams // BEAM_WIDTH, device=dev)[:, None] * BEAM_WIDTH + parent).reshape(-1).to(torch.int32)
    src_l = src.long()
    for p in (0, pos, ctx - 1):
        x0 = [x.clone() for x in xs]
        got, ref = [y.clone() for y in ys], [y.clone() for y in ys]
        write_cache_slots_beam(list(zip(got, xs, news)), src, at(p))
        source_kept = all(torch.equal(x, c) for x, c in zip(xs, x0))
        write_cache_slots_beam_plain(list(zip(ref, x0, news)), src, at(p))
        if not (source_kept and all(torch.equal(a[:, :, :p + 1], r[:, :, :p + 1])
                                    and torch.equal(a[:, :, p + 1:], y[:, :, p + 1:]) for a, r, y in zip(got, ref, ys))):
            raise AssertionError(f"write_cache_slots_beam {path} at {p} differs from the plain version")
        del x0, got, ref
    triples = list(zip(ys, xs, news))
    # the rows up to the slot, written for every stream and read once for
    # each distinct parent (its streams read them through L2)
    of = lambda p, parents=int(src.unique().numel()): bound(L * (p + 1) * sum(rbs) * (streams + parents), 0.0)
    row = isolated_row(
        f"write_cache_slot_beam/{form}/{streams}{suffix}", path, F_SRC, K9 + " then jnp.take by parent (models/beam.py:222-232)",
        [BEAM_FN, [L, streams, ctx, *rbs]],
        lambda p_t=at(pos): write_cache_slots_beam(triples, src, p_t),
        lambda p_t=at(pos): write_cache_slots_beam_plain(triples, src, p_t),
        lambda: [x.index_copy_(2, idx, n).index_select(1, src_l) for x, n in zip(xs, news)], 0.0, of(pos),
        f"index_copy_ along T, then index_select by parent, of each of the {len(xs)} caches (the old reorder)",
        "exact on the rows up to pos", shape, isolated_bound_ms=of(pos)[0], bound_of_pos=of,
    )
    if not positions:
        return row, None
    positions = {}
    for p in (4, round(mean_decode_pos(MAX_TOKENS - 1)), 3 + MAX_TOKENS - 1):
        p_t = at(p)
        positions[p] = {
            "beam_form_ms": device_ms(lambda: write_cache_slots_beam(triples, src, p_t), 16),
            "slot_form_then_index_selects_ms": device_ms(
                lambda: (write_cache_slots(list(zip(xs, news)), p_t), [x.index_select(1, src_l) for x in xs]), 16),
            "bound_ms": of(p)[0],
        }
    return row, {"phase": "kernel_f_beam_positions", "path": path, "shape": shape, "positions": positions}


def kernel_f_checks(cfg, gen, computes: dict) -> list[dict]:
    """Kernel F at every path's shape (``computes``: each path's compute):
    the slot form on the greedy paths whose step leaves the slot to F
    (fast_greedy and the entry in bf16, int4self_greedy, mixed_greedy, the
    pipeline's int4 self caches at B = 4 and 8), the beam form on every
    beam path (40 streams). Rows of one shape are measured once."""
    from whisper_burn_tpu_torch.entry import MAX_TOKENS as ENTRY_TOKENS

    entry_ctx = max(64, -(-(4 + ENTRY_TOKENS) // 64) * 64)
    cases = [("fast_greedy", BATCH, CTX, False), ("entry", 1, entry_ctx, False), ("int4self_greedy", BATCH, CTX, False),
             ("mixed_greedy", BATCH, CTX, False), ("pipeline", 4, CTX, False), ("pipeline", BATCH, CTX, False),
             ("beam", STREAMS, CTX, True), ("int8_beam", STREAMS, CTX, True), ("fast_beam", STREAMS, CTX, True),
             ("int4self_beam", STREAMS, CTX, True), ("mixed_beam", STREAMS, CTX, True)]
    rows, seen = [], {}
    for path, streams, ctx, beam in cases:
        compute = computes[path]
        key = (self_form(compute), streams, ctx, beam)
        if key in seen:
            row = dict(seen[key], path=path)
            row["name"] = row["name"].split("/pipeline")[0] + ("/pipeline" if path == "pipeline" else "")
        else:
            steps = (ENTRY_TOKENS if path == "entry" else MAX_TOKENS) - 1
            row, positions = f_row(cfg, gen, compute, path, streams, ctx, beam, steps)
            seen[key] = row
            if positions is not None:
                log(positions)
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def medium_kernel_checks(params, cfg, gen, serving) -> list[dict]:
    """Every hand-written kernel at Whisper Medium's shapes (D 1024, 16
    heads, 24 decoder layers), each row's name ending ``/medium``. On the
    ``medium_greedy`` path: kernel A at M = 8 (qkv, the projections, the
    int8 logits) and the prefill's 32, I at 8 (K4's order) and 32 (K7's),
    B, C and D at B = 8; on ``medium_beam``: A and I at 40 rows, E, grouped
    C and F's beam form at 40 streams. Rows marked ``off_path`` (launches 0)
    are kernels that no Medium path launches in the serving compute, held
    all the same at Medium's shapes, where the other cache modes would run
    them: B' at 8 streams, E' at 40, C' over int8 and bf16 caches
    ungrouped and grouped, G at 8 and H at 40 over the int4 and mixed self
    caches, and F's slot form at 8 streams in the int8 and int4 forms
    (kernel B stores the serving greedy step's row itself)."""
    blocks = params["decoder"]["blocks"]
    rows = q4_rows(decode_linears(params, cfg, BATCH) + prefill_linears(params, cfg, 4 * BATCH), gen, "medium_greedy")
    rows += ffn_rows([("decode", BATCH, blocks, cfg.gelu, True, K4), ("prefill", 4 * BATCH, blocks, cfg.gelu, False, K7)],
                     gen, "medium_greedy")
    rows += [self_attention_row(cfg, gen, "medium_greedy", "decode_self_attention"),
             cross_int4_row(cfg, gen, BATCH, 1, "medium_greedy", "decode_cross_attention"),
             encoder_attention_row(cfg, gen, BATCH, "medium_greedy", "encoder_attention")]
    rows += q4_rows(decode_linears(params, cfg, STREAMS, "beam_"), gen, "medium_beam")
    rows += ffn_rows([("beam_decode", STREAMS, blocks, cfg.gelu, True, K4)], gen, "medium_beam")
    rows += [layer_attention_row(cfg, gen, "medium_beam", "decode_attention_layer"),
             cross_int4_row(cfg, gen, BATCH, BEAM_WIDTH, "medium_beam", "decode_cross_attention/grouped")]
    row, positions = f_row(cfg, gen, serving, "medium_beam", STREAMS, CTX, True, MAX_TOKENS - 1)
    log({**positions, "model": "medium"})
    rows.append(row)

    off = merged_rows(cfg, gen, (("medium_greedy", BATCH, CTX, MAX_TOKENS - 1),))
    off.append(unscaled_layer_row(cfg, gen, "medium_beam"))
    off += cross_unpacked_rows(cfg, gen, tuple((kind, ((BATCH, 1, "medium_greedy"), (BATCH, BEAM_WIDTH, "medium_beam")))
                                               for kind in ("int8", "bf16")))
    off += [int4_self_row(cfg, gen, mode, merged, b, path) for mode in ("int4self", "mixed")
            for merged, b, path in ((True, BATCH, "medium_greedy"), (False, STREAMS, "medium_beam"))]
    off += [f_row(cfg, gen, compute, "medium_greedy", BATCH, CTX, False, MAX_TOKENS - 1)[0]
            for compute in (serving, serving.replace(self_kv_bits=4))]
    for r in off:
        r["off_path"] = True
    for r in rows + off:
        r["name"] += "/medium"
    torch.cuda.empty_cache()
    return rows + off


def int4_kernel_checks(cfg, gen) -> list[dict]:
    """The kernels of the int4 self-KV modes and of the head-blocked encoder
    attention at their paths' Large-V3 shapes: G over the int4 and the mixed
    self caches at 8 streams (int4self_greedy, mixed_greedy), H at 40
    (int4self_beam, mixed_beam), at positions 4, 115 and 227 of ctx 256;
    D' at B=8 x 1500 frames at Large-V3 and Medium widths (its own op's
    path)."""
    from whisper_burn_tpu_torch.ops.encoder_attention import (
        HEADS, encoder_attention_heads, encoder_attention_heads_kernel, encoder_attention_heads_plain,
        encoder_attention_plain,
    )

    dev = torch.device("cuda")
    bf = torch.bfloat16
    d, h = cfg.n_text_state, cfg.n_text_head
    rows = [int4_self_row(cfg, gen, mode, merged, b, f"{mode}_{kind}")
            for mode in ("int4self", "mixed") for merged, b, kind in ((True, BATCH, "greedy"), (False, STREAMS, "beam"))]

    # kernel D' through its op: B=8 x 1500 frames, T padded to 1536, at
    # Large-V3 and Medium widths
    t, tp = cfg.n_audio_ctx, -(-cfg.n_audio_ctx // 128) * 128
    for width, dd, hh in (("Large-V3", d, h), ("Medium", 1024, 16)):
        qkv = [torch.randn((BATCH, t, dd), generator=gen, device=dev).to(bf) for _ in range(3)]
        for dtype, b_chk, rel in ((bf, BATCH, 1e-2), (torch.float32, 2, 1e-5)):
            xs = [a[:b_chk].to(dtype) for a in qkv]
            out = encoder_attention_heads(*xs, hh)
            ref = encoder_attention_plain(*xs, hh, t)
            e = max_err(out, ref)
            check(f"{HEADS} {width} {dtype}", e, ref, rel)
            if dtype == bf:
                err = e
        lay = lambda x: torch.nn.functional.pad(x.reshape(BATCH, t, hh, 64).transpose(1, 2), (0, 0, 0, tp - t))
        qh, kh = lay(qkv[0]).contiguous(), lay(qkv[1]).contiguous()
        vh = qkv[2].reshape(BATCH, t, hh, 64).transpose(1, 2).contiguous()
        vT = torch.nn.functional.pad(vh.transpose(2, 3), (0, tp - t)).contiguous()
        del qkv
        ms, sig = device_ms(lambda: encoder_attention_heads_kernel(qh, kh, vT, t), 5, 1, ours=True)
        # q and the output over all Tp rows, k and v over the valid ones, bf16
        b_ms, b_by = bound(BATCH * (2 * tp + 2 * t) * dd * 2, 4.0 * BATCH * hh * tp * t * 64)
        rows.append(dict(
            name=f"{HEADS}/{width}", route="cuda", source="whisper_burn_tpu_torch/csrc/encoder_attention.cu",
            path="encoder_attention_heads", replaces="whisper_burn_tpu/ops/pallas_encoder_attention.py:48 (K10)",
            shape_key=[HEADS, [BATCH, tp, dd]], sig=sig, max_abs_err=err, isolated_ms=ms,
            plain_ms=device_ms(lambda: encoder_attention_heads_plain(qh, kh, vT, t), 3, 1), bound_ms=b_ms,
            bound_by=b_by,
            library_ms=device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh[:, :, :t], vh), 5, 1),
            library_call="scaled_dot_product_attention over the 1500 valid keys (head-major, v untransposed)",
            tol="bf16 1e-2 and f32 1e-5 of max|out|",
            shape=f"B={BATCH} T={tp} valid={t} D={dd} H={hh}, q/k [B, H, T, 64], v/out [B, H, 64, T]",
        ))
        del qh, kh, vh, vT
    return rows


def pipeline_kernel_checks(params, cfg, gen) -> list[dict]:
    """The kernels at the pipeline path's own shapes, each row counted from
    that path's run: transcribe_long's 3 windows bucketed to B = 4 and
    transcribe_batch's 5 utterances bucketed to B = 8, in the int4 self
    mode with W8A8 and its "openai" front end (exact GELU). Kernel A at the decode step's M = B rows, the prompt
    prefill's 4B, and the language-detection pass's one [SOT] row per
    stream (its four layer shapes are the decode step's at M = B, so those
    rows share their launch counts); D over B x 1536 frames; C over the
    B-entry int4 cross cache; G over the int4 self cache (F:
    kernel_f_checks)."""
    rows, pcfg = [], cfg.replace(gelu="erf")
    for b in (4, BATCH):
        prefix = f"pipeline/B={b}/"
        rows += q4_rows(decode_linears(params, pcfg, b, prefix) + prefill_linears(params, pcfg, 4 * b, prefix)
                        + prefill_linears(params, pcfg, b, prefix + "detect_"), gen, "pipeline")
        blocks = params["decoder"]["blocks"]
        rows += ffn_rows([(f"{prefix}decode", b, blocks, "erf", True, K4), (f"{prefix}prefill", 4 * b, blocks, "erf", False, K7),
                          (f"{prefix}detect_prefill", b, blocks, "erf", False, K7)], gen, "pipeline")
        rows += [
            encoder_attention_row(cfg, gen, b, "pipeline", f"encoder_attention/{prefix[:-1]}"),
            cross_int4_row(cfg, gen, b, 1, "pipeline", f"decode_cross_attention/{prefix[:-1]}"),
            int4_self_row(cfg, gen, "int4self", True, b, "pipeline"),
        ]
    return rows


# --------------------------------------------------------------------------
# phase 3b: the GGUF loader and its repacked cache, at Large-V3-Turbo's size


def write_turbo_gguf(path: Path, cfg, seed: int) -> np.ndarray:
    """A Whisper checkpoint of ``cfg``'s shapes written with the port's
    GgufWriter as the JAX package's converter lays one out: metadata
    ``general.architecture``, the two layer counts and ``whisper.n_lang``;
    tensors by the GGUF naming convention, in sorted order; Q4_0 for the
    2-D weights with min(shape) >= 256 that are not biases, LayerNorms,
    embeddings or convs, F32 for the rest. The Q4_0 blocks are written raw
    from a seeded numpy generator (random nibble bytes, f16 scales
    U(0.5, 1.5) x 0.05 / 7, as models/params.py fabricates them), the F32
    tensors drawn as there. Returns the raw blocks of
    ``decoder.blocks.0.mlp.0.weight``."""
    from whisper_burn_tpu_torch.gguf import GgmlDtype, GgufWriter
    from whisper_burn_tpu_torch.models.params import sinusoidal_positions

    rng = np.random.default_rng(seed)
    d, f = cfg.n_audio_state, cfg.ffn_dim
    tensors = {}  # name -> (shape, Q4_0 blocks or None, F32 array or None)

    def q4(name, n, k):
        blocks = np.empty((n * k // 32, 18), np.uint8)
        blocks[:, :2] = (rng.uniform(0.5, 1.5, len(blocks)) * (0.05 / 7)).astype("<f2").view(np.uint8).reshape(-1, 2)
        blocks[:, 2:] = np.frombuffer(rng.bytes(len(blocks) * 16), np.uint8).reshape(-1, 16)
        tensors[name] = ((n, k), blocks)

    def f32(name, a):
        tensors[name] = (a.shape, np.ascontiguousarray(a, "<f4"))

    def normal(*shape, std):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def block(prefix, cross):
        for ln in ("attn_ln", "mlp_ln") + (("cross_attn_ln",) if cross else ()):
            f32(f"{prefix}.{ln}.weight", 1.0 + normal(d, std=0.02))
            f32(f"{prefix}.{ln}.bias", normal(d, std=0.02))
        for attn in ("attn",) + (("cross_attn",) if cross else ()):
            for proj in ("query", "key", "value", "out"):
                q4(f"{prefix}.{attn}.{proj}.weight", d, d)
                if proj != "key":  # Whisper's key projections have no bias
                    f32(f"{prefix}.{attn}.{proj}.bias", normal(d, std=0.01))
        q4(f"{prefix}.mlp.0.weight", f, d)
        f32(f"{prefix}.mlp.0.bias", normal(f, std=0.01))
        q4(f"{prefix}.mlp.2.weight", d, f)
        f32(f"{prefix}.mlp.2.bias", normal(d, std=0.01))

    f32("encoder.conv1.weight", normal(d, cfg.n_mels, 3, std=0.05))
    f32("encoder.conv1.bias", np.zeros(d, np.float32))
    f32("encoder.conv2.weight", normal(d, d, 3, std=0.02))
    f32("encoder.conv2.bias", np.zeros(d, np.float32))
    f32("encoder.positional_embedding", sinusoidal_positions(cfg.n_audio_ctx, d))
    for i in range(cfg.n_audio_layer):
        block(f"encoder.blocks.{i}", False)
    f32("encoder.ln_post.weight", 1.0 + normal(d, std=0.02))
    f32("encoder.ln_post.bias", normal(d, std=0.02))
    f32("decoder.token_embedding.weight", normal(cfg.n_vocab, d, std=0.02))
    f32("decoder.positional_embedding", normal(cfg.n_text_ctx, d, std=0.01))
    for i in range(cfg.n_text_layer):
        block(f"decoder.blocks.{i}", True)
    f32("decoder.ln.weight", 1.0 + normal(d, std=0.02))
    f32("decoder.ln.bias", normal(d, std=0.02))

    w = GgufWriter()
    w.add_string("general.architecture", "whisper")
    w.add_string("general.name", "whisper-large-v3-turbo (seeded)")
    w.add_u32("whisper.encoder.layer_count", cfg.n_audio_layer)
    w.add_u32("whisper.decoder.layer_count", cfg.n_text_layer)
    w.add_u32("whisper.n_lang", cfg.n_lang)
    for name in sorted(tensors):
        shape, data = tensors[name]
        w.add_raw_tensor(name, shape, GgmlDtype.Q4_0 if data.dtype == np.uint8 else GgmlDtype.F32, data)
    w.write(path)
    return tensors["decoder.blocks.0.mlp.0.weight"][1]


def flat_arrays(tree, prefix=()) -> dict:
    out = {}
    for key, value in tree.items():
        out.update(flat_arrays(value, prefix + (key,)) if isinstance(value, dict) else {prefix + (key,): value})
    return out


def loader_phase(tmp: Path, cfg):
    """The port's GGUF loader on a checkpoint of ``cfg`` written into
    ``tmp``: ``load_whisper(path, cache_dir=tmp)`` cold (parse, repack,
    cache save), then warm (a hit on the repacked cache), then the parse
    and repack alone (``load_whisper_from_gguf``) and the cache save alone
    (``save_repacked`` into a second directory), each timed on its own.
    Holds the config inferred from the checkpoint to ``cfg``
    field for field, the warm and the parsed params to the cold ones array
    for array, and one repacked layer's codes times scales to the
    dequantized raw blocks exactly. The C++ host library that repacks is
    built (or found built) before the cold load, its seconds logged on
    their own, so that no compiler time enters a load's. Logs the sizes
    and walls; returns the warm model."""
    from whisper_burn_tpu_torch import native_host
    from whisper_burn_tpu_torch.gguf import GgufReader
    from whisper_burn_tpu_torch.gguf.cache import CACHE_VERSION, load_whisper, save_repacked
    from whisper_burn_tpu_torch.gguf.loader import infer_config, load_whisper_from_gguf
    from whisper_burn_tpu_torch.gguf.quant import dequantize_q4_0

    gguf = tmp / "whisper-large-v3-turbo.gguf"
    t0 = time.perf_counter()
    raw_fc1 = write_turbo_gguf(gguf, cfg, SEED + 30)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native_host.enabled():
        native_host.library()
    native_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cold = load_whisper(gguf, cache_dir=tmp)
    cold_s = time.perf_counter() - t0
    npz, meta = tmp / (gguf.name + ".repacked.npz"), tmp / (gguf.name + ".repacked.json")
    record, stat = json.loads(meta.read_text()), gguf.stat()
    if (record["cache_version"], record["source_size"], record["source_mtime"]) != (CACHE_VERSION, stat.st_size,
                                                                                   stat.st_mtime):
        raise AssertionError(f"loader: the cache's record {record} does not match its checkpoint")
    t0 = time.perf_counter()
    warm = load_whisper(gguf, cache_dir=tmp)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parsed = load_whisper_from_gguf(gguf)
    parse_s = time.perf_counter() - t0
    (tmp / "resave").mkdir()
    t0 = time.perf_counter()
    resaved = save_repacked(parsed, gguf, tmp / "resave")
    save_s = time.perf_counter() - t0
    if resaved.stat().st_size != npz.stat().st_size:
        raise AssertionError(f"loader: the cache saved again holds {resaved.stat().st_size} bytes, not "
                             f"{npz.stat().st_size}")
    resaved.unlink()

    inferred = infer_config(GgufReader.open(gguf))
    if not (inferred == cold.config == warm.config == parsed.config == cfg):
        raise AssertionError(f"loader: inferred {inferred}, cold {cold.config}, warm {warm.config}, want {cfg}")
    ref = flat_arrays(cold.params)
    for label, model in (("warm", warm), ("parsed", parsed)):
        got = flat_arrays(model.params)
        if got.keys() != ref.keys():
            raise AssertionError(f"loader: the {label} params' keys differ from the cold load's")
        for key, a in got.items():
            if a.dtype != ref[key].dtype or not np.array_equal(a, ref[key]):
                raise AssertionError(f"loader: the {label} params' {'/'.join(key)} differ from the cold load's")
    fc1 = cold.params["decoder"]["blocks"]["fc1"]
    recon = fc1["qw"][0].astype(np.float32) * np.repeat(fc1["scales"][0], 32, axis=0)  # [K, N]
    if not np.array_equal(recon.T.reshape(-1), dequantize_q4_0(raw_fc1, raw_fc1.size // 18 * 32)):
        raise AssertionError("loader: decoder layer 0's fc1, repacked, is not its dequantized Q4_0 blocks")
    q4 = sum(a.size for key, a in ref.items() if key[-1] == "qw")
    log({"phase": "loader", "model": "large_v3_turbo", "gguf_bytes": stat.st_size, "npz_bytes": npz.stat().st_size,
         "q4_weights": q4, "tensors": len(GgufReader.open(gguf).tensors), "write_s": write_s,
         "native_build_s": native_build_s, "cold_load_s": cold_s, "parse_and_repack_s": parse_s, "cache_save_s": save_s,
         "warm_load_s": warm_s, "config": dataclasses.asdict(cold.config)})
    return warm


# --------------------------------------------------------------------------
# phase 3c: serving and the CLI, on the Turbo checkpoint of phase 3b

SERVE_CLIENTS, SERVE_EACH = 8, 4  # HTTP clients, requests each
CLI_KERNELS = {"A": r"q4_matmul_kernel", "I": r"ffn(_wgmma)?_kernel", "C": r"cross_(attn|unpacked)_kernel",
               "D": r"encoder_attn_kernel"}


def pcm_wav(samples: np.ndarray, rate: int, channels: int = 1) -> bytes:
    """16-bit PCM WAV bytes of ``samples``, the same signal on each channel."""
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
        f.writeframes(np.repeat(pcm[:, None], channels, axis=1).tobytes())
    return buf.getvalue()


def utterance(rng: np.random.Generator, seconds: float, rate: int = 16_000) -> np.ndarray:
    """Seeded noise (standard normal x 0.1) or a tone, ``seconds`` long."""
    n = int(seconds * rate)
    if rng.random() < 0.5:
        return (rng.standard_normal(n) * 0.1).astype(np.float32)
    return (0.3 * np.sin(2 * np.pi * rng.uniform(100, 1000) * np.arange(n) / rate)).astype(np.float32)


def same_results(label: str, got: list, want: list) -> None:
    for i, (o, r) in enumerate(zip(got, want, strict=True)):
        if not (np.array_equal(o.tokens, r.tokens) and o.lang_token == r.lang_token):
            raise AssertionError(f"serving {label}: request {i} gives tokens {o.tokens[:8]} (of {len(o.tokens)}), "
                                 f"language {o.lang_token}; transcribe_batch {r.tokens[:8]} (of {len(r.tokens)}), "
                                 f"{r.lang_token}")


def serving_in_process(pipe, cfg, rng) -> dict:
    """(a) ``BatchingTranscriber(pipe, batch_size=8, max_wait_ms=2000)``:
    eight utterances submitted in order from this thread (its worker
    captures the runner's graph; the batch's launches held to the shapes'
    prediction), then five; each result's tokens, count and language token
    equal to ``transcribe_batch`` of the same eight, and of the five with
    three 1 s silences in "en", bit for bit."""
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.serving import BatchingTranscriber

    eight = [utterance(rng, s) for s in (1.0, 30.0, 5.0, 12.0, 30.0, 2.5, 20.0, 8.0)]
    langs8 = ["en", "auto", "de", "auto", "fr", "auto", "ja", "en"]
    five = [utterance(rng, s) for s in (3.0, 30.0, 7.0, 15.0, 1.0)]
    langs5 = ["auto", "es", "auto", "en", "zh"]
    torch.cuda.synchronize()
    _build.reset_launches()
    transcriber = BatchingTranscriber(pipe, batch_size=BATCH, max_wait_ms=2000)
    try:
        t0 = time.perf_counter()
        got8 = [r.wait(timeout=900) for r in [transcriber.submit(a, lang) for a, lang in zip(eight, langs8)]]
        first_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        got5 = [r.wait(timeout=900) for r in [transcriber.submit(a, lang) for a, lang in zip(five, langs5)]]
        second_s = time.perf_counter() - t0
    finally:
        snap = transcriber.shutdown(timeout=900)
    if (snap["completed"], snap["failed"], snap["batches"]) != (13, 0, 2):
        raise AssertionError(f"serving in process: {snap}")
    steps = launches.get(self_kernel(pipe.compute, False), 0) // cfg.n_text_layer
    want = predicted_launches(cfg, pipe.compute, BATCH, steps, False, detect=True)
    if launches != want:
        raise AssertionError(f"serving in process: launches {launches} differ from the prediction {want}")
    same_results("batch of 8", got8, pipe.transcribe_batch(eight, langs8))
    padded = pipe.transcribe_batch(five + [np.zeros(16_000, np.float32)] * 3, langs5 + ["en"] * 3)
    same_results("batch of 5", got5, padded[:5])
    return {"first_batch_ms": first_s * 1e3, "second_batch_ms": second_s * 1e3, "decode_steps": steps,
            "launches": launches, "n_tokens": [len(r.tokens) for r in got8 + got5]}


def http_traffic(base: str, cfg, rng) -> dict:
    """SERVE_CLIENTS client threads sending SERVE_EACH WAVs each to the
    server at ``base`` (16-bit PCM, 5-30 s, every third at 44.1 kHz stereo,
    half with the language detected): every reply 200 with a language
    token in range; a malformed body 400; ``/stats`` with every request
    completed and batches of more than one on average."""
    import threading
    import urllib.error
    import urllib.request

    bodies, audio_s = {}, 0.0
    for c in range(SERVE_CLIENTS):
        for i in range(SERVE_EACH):
            seconds, stereo = float(rng.uniform(5, 30)), (c * SERVE_EACH + i) % 3 == 2
            rate = 44_100 if stereo else 16_000
            lang = "auto" if i % 2 else ("en", "de", "fr", "es")[c % 4]
            bodies[c, i] = (pcm_wav(utterance(rng, seconds, rate), rate, 2 if stereo else 1), lang)
            audio_s += int(seconds * rate) / rate
    replies, errors = {}, []

    def client(c):
        try:
            for i in range(SERVE_EACH):
                body, lang = bodies[c, i]
                req = urllib.request.Request(f"{base}/v1/transcribe", data=body, headers={"X-Language": lang},
                                             method="POST")
                with urllib.request.urlopen(req, timeout=900) as resp:
                    replies[c, i] = (resp.status, json.loads(resp.read()))
        except Exception as e:  # raised below
            errors.append(e)

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
    for th in clients:
        th.start()
    for th in clients:
        th.join()
    wall = time.perf_counter() - t0
    try:
        urllib.request.urlopen(urllib.request.Request(f"{base}/v1/transcribe", data=b"RIFF, but no WAV",
                                                      method="POST"), timeout=60)
        malformed = 200
    except urllib.error.HTTPError as e:
        malformed = e.code
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as resp:
        stats = json.loads(resp.read())
    if errors:
        raise AssertionError(f"serving over HTTP: a client failed: {errors[0]!r}")
    bad = {k: v for k, v in replies.items()
           if v[0] != 200 or not cfg.lang_token_start <= v[1]["lang_token"] < cfg.lang_token_end}
    if len(replies) != SERVE_CLIENTS * SERVE_EACH or bad:
        raise AssertionError(f"serving over HTTP: {len(replies)} replies, out of range: {bad}")
    if malformed != 400:
        raise AssertionError(f"serving over HTTP: a malformed body got {malformed}, not 400")
    if stats["completed"] != len(replies) or stats["failed"] or not stats["mean_batch_fill"] > 1:
        raise AssertionError(f"serving over HTTP: /stats {stats}")
    return {"requests": len(replies), "clients": SERVE_CLIENTS, "wall_s": wall, "requests_per_s": len(replies) / wall,
            "audio_s": audio_s, "audio_s_per_s": audio_s / wall, "latency_ms": stats["latency_ms"],
            "batches": stats["batches"], "mean_batch_fill": stats["mean_batch_fill"],
            "stats_requests_per_s": stats["requests_per_s"],
            "inference_ms": sorted(v[1]["inference_ms"] for v in replies.values())}


def serving_http(pipe, cfg, rng, batch: int) -> dict:
    """(b) ``serve_http(pipe, port=0, batch_size=batch)`` under
    :func:`http_traffic`. This thread touches no CUDA while the server
    decodes; the launches are read after shutdown, and every kernel of the
    path must have run."""
    import threading

    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.serving import serve_http

    torch.cuda.synchronize()
    _build.reset_launches()
    server, transcriber = serve_http(pipe, port=0, batch_size=batch)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        traffic = http_traffic(f"http://127.0.0.1:{server.server_address[1]}", cfg, rng)
    finally:
        server.shutdown()
        server.server_close()
        final = transcriber.shutdown(timeout=900)
        thread.join(timeout=60)
    launches = dict(_build.LAUNCHES)
    missing = sorted(k for k in predicted_launches(cfg, pipe.compute, batch, 1, False) if not launches.get(k))
    if missing or launches.get(self_kernel(pipe.compute, False), 0) % cfg.n_text_layer:
        raise AssertionError(f"serving over HTTP: kernels {missing} not launched ({launches})")
    return {**traffic, "final": final, "launches": launches}


def serving_cli(tmp: Path, gguf: Path, cfg, rng) -> dict:
    """(c) The CLI as a user runs it, each command a process of its own with
    ``PYTHONPATH`` at the checkout (the kernels already built there):
    ``transcribe --bf16 --json --trace`` of two WAVs (one line
    each; the trace names kernels A, I, C and D: C' in bf16, the cross
    cache unquantized); ``eval --bf16`` of a four-row manifest; ``serve``
    on port 0 for one ``/healthz`` and one POST, then SIGINT, exit 0.
    Returns each command's wall."""
    import signal
    import threading
    import urllib.request

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root), XDG_CONFIG_HOME=str(tmp / "xdg"))
    cmd = [sys.executable, "-m", "whisper_burn_tpu_torch.cli"]
    walls = {}

    def run(name, *argv):
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, *argv], cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        walls[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli {name} exited {proc.returncode}: {proc.stderr[-3000:]}")
        return proc.stdout

    wavs = []
    for i, (seconds, rate, channels) in enumerate(((7.0, 16_000, 1), (20.0, 44_100, 2), (30.0, 16_000, 1),
                                                    (12.0, 16_000, 1))):
        wavs.append(tmp / f"cli{i}.wav")
        wavs[-1].write_bytes(pcm_wav(utterance(rng, seconds, rate), rate, channels))
    out = run("transcribe", "transcribe", *map(str, wavs[:2]), "--model", str(gguf), "--bf16", "--json",
              "--trace", str(tmp / "trace"))
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    if [x["file"] for x in lines] != [str(w) for w in wavs[:2]] or not all(x["n_tokens"] > 0 for x in lines):
        raise AssertionError(f"cli transcribe: {out[-2000:]}")
    (trace,) = (tmp / "trace").glob("trace-*.json")
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"] if e.get("cat") == "kernel"}
    found = {k: sorted({m.group(0) for n in names for m in [re.search(pat, n)] if m}) for k, pat in CLI_KERNELS.items()}
    if not all(found.values()):
        raise AssertionError(f"cli transcribe: the trace names no kernel of {[k for k, v in found.items() if not v]}")
    trace_bytes = trace.stat().st_size
    trace.unlink()

    manifest = tmp / "manifest.jsonl"
    manifest.write_text("".join(json.dumps({"id": i, "audio": str(w), "text": "hello world"}) + "\n"
                                for i, w in enumerate(wavs)))
    out = run("eval", "eval", "--model", str(gguf), "--manifest", str(manifest), "--bf16", "--batch", "4")
    summary = json.loads(out.strip().splitlines()[-1])
    if summary["n"] != len(wavs):
        raise AssertionError(f"cli eval: {summary}")

    t0 = time.perf_counter()
    proc = subprocess.Popen([*cmd, "serve", "--model", str(gguf), "--port", "0"], cwd=tmp, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    timer = threading.Timer(600, proc.kill)  # a server that never answers is stopped
    timer.start()
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on http://"):
            raise AssertionError(f"cli serve: {line!r} {proc.stderr.read()[-3000:]}")
        base = line.split()[-1]
        walls["serve_start"] = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            healthy = json.loads(resp.read()) == {"status": "ok"}
        req = urllib.request.Request(f"{base}/v1/transcribe", data=wavs[0].read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body = resp.status, json.loads(resp.read())
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=120)
    finally:
        timer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    walls["serve"] = time.perf_counter() - t0
    if not healthy or status != 200 or proc.returncode != 0:
        raise AssertionError(f"cli serve: healthz {healthy}, POST {status} {body}, exit {proc.returncode}: "
                             f"{err[-3000:]}")
    return {"walls_s": walls, "transcribe": lines, "trace_kernels": found, "trace_bytes": trace_bytes,
            "eval": summary, "serve_reply": body}


def serving_phase(tmp: Path, params, cfg, captured: weakref.WeakSet) -> dict:
    """Phase 3c: a ``WhisperPipeline`` over ``params`` (on the card) as
    ``serve`` builds it from its default options (its compute, beam width
    and batch), through the batching transcriber in process, then over
    HTTP (one runner, B = 8, captured in the first; none other), then the
    CLI in processes of its own on the checkpoint ``tmp`` holds. Returns
    the one-rank ``serve``'s reply to its POST."""
    from whisper_burn_tpu_torch import cli as port_cli
    from whisper_burn_tpu_torch.models.whisper import GreedyRunner, cached_runners
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    gguf = tmp / "whisper-large-v3-turbo.gguf"
    args = port_cli.build_parser().parse_args(["serve", "--model", str(gguf)])
    if args.batch != BATCH:
        raise AssertionError(f"serving: serve's default batch is {args.batch}, not {BATCH}")
    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    pipe = WhisperPipeline((cfg, params), None, compute=port_cli.serving_compute(args), beam_width=args.beam)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    in_process = serving_in_process(pipe, cfg, rng)
    in_process_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    http = serving_http(pipe, cfg, rng, args.batch)
    http_s = time.perf_counter() - t0
    runners = [r for r in cached_runners() if r.params is pipe.params]
    if len(runners) != 1 or not isinstance(runners[0], GreedyRunner) or runners[0].batch != BATCH:
        raise AssertionError(f"serving: runners {[(type(r).__name__, r.batch) for r in runners]}, not one greedy "
                             f"runner of batch {BATCH}")
    if log_captures("serving", captured) != 1:
        raise AssertionError("serving: runners captured other than the one of batch 8")
    log({"phase": "serving", "model": "large_v3_turbo", "compute": f"serve defaults: {pipe.compute}",
         "pipeline_setup_s": setup_s, "in_process_s": in_process_s, "http_s": http_s,
         "capture_ms": runners[0].capture_s * 1e3, "in_process": in_process, **http})
    del pipe, runners
    t0 = time.perf_counter()
    cli = serving_cli(tmp, gguf, cfg, rng)
    log({"phase": "serving_cli", "seconds": time.perf_counter() - t0, **cli})
    return cli["serve_reply"]


# --------------------------------------------------------------------------
# phase 3d: serve over a mesh of two ranks sharing the card, and over NCCL
# at world 1

MESH_SECONDS = (1.0, 30.0, 5.0, 12.0, 30.0, 2.5, 20.0, 8.0)
MESH_LANGS = ("en", "auto", "de", "fr", "auto", "es", "ja", "en")  # each rank's half detects a language


def serving_mesh_rank(rank: int, world: int, port: int, out: Path) -> None:
    """One of two ranks sharing the card at mesh (2, 1) over an explicit
    gloo group (NCCL takes no two ranks of one communicator on one device),
    serving Large-V3-Turbo from the GGUF at ``CHIP_SMOKE_GGUF`` (the
    repacked cache warm) in the pipeline ``serve`` builds from its default
    options, the control group made right after the mesh's groups:

    * rank 0: a ``BatchingTranscriber`` (batch 8, 2 s wait) given eight
      seeded utterances in order, one batch handed to rank 1, then
      stopped; then ``serve_http`` on port 0 (its port written to
      ``OUT/port``) until SIGINT;
    * rank 1: ``follow_batches`` for each of the two;
    * each rank: its launches for the first batch and in all, the runners
      of the meshed pipeline, and its rows of the eight through a one-rank
      pipeline (no mesh) at the per-rank batch of 4."""
    from whisper_burn_tpu_torch import cli as port_cli
    from whisper_burn_tpu_torch.gguf.cache import load_whisper
    from whisper_burn_tpu_torch.models.whisper import cached_runners
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.parallel import make_mesh
    from whisper_burn_tpu_torch.parallel.multihost import control_group, initialize
    from whisper_burn_tpu_torch.serving import BatchingTranscriber, follow_batches, run_until_interrupted, serve_http
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    dev = initialize(f"localhost:{port}", world, rank, device="cuda:0", backend="gloo")
    mesh = make_mesh(2, 1, device=dev)
    group = control_group()
    gguf = os.environ["CHIP_SMOKE_GGUF"]
    args = port_cli.build_parser().parse_args(["serve", "--model", gguf])
    t0 = time.perf_counter()
    model = load_whisper(gguf)
    pipe = WhisperPipeline(model, None, compute=port_cli.serving_compute(args), beam_width=args.beam, mesh=mesh)
    torch.cuda.synchronize()
    report = {"rank": rank, "setup_s": time.perf_counter() - t0}
    rng = np.random.default_rng(SEED + 50)
    eight = [utterance(rng, s) for s in MESH_SECONDS]
    _build.reset_launches()
    if rank == 0:
        transcriber = BatchingTranscriber(pipe, batch_size=args.batch, max_wait_ms=2000, group=group)
        try:
            t0 = time.perf_counter()
            got = [r.wait(timeout=900) for r in [transcriber.submit(a, lang) for a, lang in zip(eight, MESH_LANGS)]]
            first_s = time.perf_counter() - t0
            report["first_batch_launches"] = dict(_build.LAUNCHES)
        finally:
            snap = transcriber.shutdown(timeout=900)
        report["in_process"] = {"first_batch_ms": first_s * 1e3, "stats": snap, "handoffs": transcriber.handoffs,
                                "handoff_ms": transcriber.handoff_s * 1e3, "tokens": [r.tokens.tolist() for r in got],
                                "lang_tokens": [r.lang_token for r in got]}
        server, http = serve_http(pipe, port=0, batch_size=args.batch, group=group)
        (out / "port.tmp").write_text(str(server.server_address[1]))
        (out / "port.tmp").rename(out / "port")
        if run_until_interrupted(server, http):
            raise RuntimeError(f"serving_mesh rank 0: serving stopped: {http.fault!r}")
        report["http"] = {"stats": http.stats.snapshot(), "handoffs": http.handoffs,
                          "handoff_ms_per_batch": http.handoff_s * 1e3 / max(http.handoffs, 1)}
    else:
        followed = [follow_batches(pipe, group)]
        report["first_batch_launches"] = dict(_build.LAUNCHES)
        followed.append(follow_batches(pipe, group))
        report["followed"] = followed
    torch.cuda.synchronize()
    report["launches"] = dict(_build.LAUNCHES)
    steps = report["first_batch_launches"].get(self_kernel(pipe.compute, False), 0) // pipe.config.n_text_layer
    report["first_batch_steps"] = steps
    report["first_batch_predicted"] = predicted_launches(pipe.config, pipe.compute, args.batch // mesh.data, steps,
                                                         False, detect=True)
    report["missing"] = sorted(k for k in report["first_batch_predicted"] if not report["launches"].get(k))
    report["runners"] = [{"kind": type(r).__name__, "batch": r.batch,
                          "capture_ms": None if r.capture_s is None else r.capture_s * 1e3}
                         for r in cached_runners() if r.params is pipe.params]
    rows = mesh.rows(len(eight))
    plain = WhisperPipeline(model, None, compute=pipe.compute, beam_width=args.beam)
    ref = plain.transcribe_batch(eight[rows], list(MESH_LANGS[rows]))
    report["one_rank"] = {"rows": [rows.start, rows.stop], "tokens": [r.tokens.tolist() for r in ref],
                          "lang_tokens": [r.lang_token for r in ref]}
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


def child_pids(pid: int) -> list[int]:
    """The processes whose parent is ``pid`` (read from ``/proc``)."""
    out = []
    for entry in Path("/proc").iterdir():
        if entry.name.isdigit():
            try:
                stat = (entry / "stat").read_text()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry.name))
    return out


def serve_nccl_world1(tmp: Path, gguf: Path, wav: Path, reply: dict) -> dict:
    """``python -m torch.distributed.run --standalone --nproc-per-node 1 -m
    whisper_burn_tpu_torch.cli serve --dp 1 --port 0``: a one-rank NCCL
    group, mesh (1, 1), the control group over gloo and nothing handed
    over. ``/healthz``, the POST of phase 3c's ``serve`` with its language
    token, then SIGINT to the rank (torchrun starts it in a session of its
    own and, SIGINTed itself, exits 1 by its own design): the rank and so
    torchrun exit 0."""
    import signal
    import threading
    import urllib.request

    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root), XDG_CONFIG_HOME=str(tmp / "xdg"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1", "-m",
           "whisper_burn_tpu_torch.cli", "serve", "--model", str(gguf), "--dp", "1", "--port", "0"]
    t0 = time.perf_counter()
    with open(tmp / "serve_nccl.err", "w") as err:
        proc = subprocess.Popen(cmd, cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    ranks: list[int] = []

    def stop():  # the rank first: torchrun killed alone would leave it running
        for pid in ranks or child_pids(proc.pid):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.kill()

    timer = threading.Timer(600, stop)  # a server that never answers is stopped
    timer.start()
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving on http://"):
            raise AssertionError(f"serve --dp 1 under torchrun: {line!r} {(tmp / 'serve_nccl.err').read_text()[-3000:]}")
        start_s = time.perf_counter() - t0
        ranks.extend(child_pids(proc.pid))
        base = line.split()[-1]
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            healthy = json.loads(resp.read()) == {"status": "ok"}
        req = urllib.request.Request(f"{base}/v1/transcribe", data=wav.read_bytes(), method="POST")
        with urllib.request.urlopen(req, timeout=600) as resp:
            status, body = resp.status, json.loads(resp.read())
        if len(ranks) != 1:
            raise AssertionError(f"serve --dp 1 under torchrun: rank processes {ranks}, not one")
        os.kill(ranks[0], signal.SIGINT)
        proc.communicate(timeout=120)
    finally:
        timer.cancel()
        if proc.poll() is None:
            stop()
            proc.communicate()
    log_text = (tmp / "serve_nccl.err").read_text()
    line = {"start_s": start_s, "wall_s": time.perf_counter() - t0, "healthz": healthy, "status": status,
            "reply": body, "one_rank_reply": reply, "exit": proc.returncode,
            "group": next((x for x in log_text.splitlines() if x.startswith("rank 0 of")), None)}
    if not (healthy and status == 200 and body["lang_token"] == reply["lang_token"] and proc.returncode == 0
            and line["group"] == "rank 0 of 1: mesh 1x1 over nccl"):
        raise AssertionError(f"serve --dp 1 under torchrun: {line}: {log_text[-3000:]}")
    return line


def serving_mesh_phase(tmp: Path, gguf: Path, cfg, reply: dict) -> dict:
    """Phase 3d: ``serving_mesh_rank`` on two ranks sharing the card at
    mesh (2, 1), rank 0 given :func:`http_traffic` from this process, then
    SIGINT to both (as a terminal's Ctrl-C; rank 1 ignores it and leaves on
    rank 0's stop). Checks: every reply 200 (``http_traffic``'s checks);
    rank 1 followed as many batches as rank 0 formed, in process and over
    HTTP; on each rank the first batch's launches as the shapes predict,
    every kernel of the path launched, one captured runner of batch 4, and
    its rows of the in-process batch equal bit for bit to the one-rank
    pipeline's at batch 4; every rank exits 0. Then ``serve --dp 1`` under
    torchrun over NCCL (:func:`serve_nccl_world1`)."""
    import signal

    out = tmp / "serving_mesh"
    out.mkdir()
    rng = np.random.default_rng(SEED + 60)
    t0 = time.perf_counter()
    procs = start_ranks("serving_mesh", 2, out, {"CHIP_SMOKE_GGUF": str(gguf)})
    try:
        deadline = time.perf_counter() + 600
        while not (out / "port").exists():
            if any(p.poll() is not None for p in procs) or time.perf_counter() > deadline:
                raise AssertionError("serving_mesh: rank 0 never served")  # finish_ranks says why
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        http = http_traffic(f"http://127.0.0.1:{(out / 'port').read_text()}", cfg, rng)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        reports = finish_ranks("serving_mesh", procs, 300, out)
    r0, r1 = reports
    line = {"mesh": [2, 1], "backend": "gloo", "device": "cuda:0 (shared)", "ranks_start_s": start_s,
            "wall_s": time.perf_counter() - t0, **{k: v for k, v in http.items() if k != "inference_ms"},
            "setup_s": [r["setup_s"] for r in reports],
            "capture_ms": [[x["capture_ms"] for x in r["runners"]] for r in reports],
            "handoff_ms_per_batch": r0["http"]["handoff_ms_per_batch"],
            "in_process": {k: r0["in_process"][k] for k in ("first_batch_ms", "handoffs", "handoff_ms")},
            "followed": r1["followed"], "batches_rank0": [r0["in_process"]["stats"]["batches"],
                                                          r0["http"]["stats"]["batches"]],
            "first_batch_steps": [r["first_batch_steps"] for r in reports],
            "first_batch_launches": [r["first_batch_launches"] for r in reports],
            "launches": [r["launches"] for r in reports]}
    if r1["followed"] != line["batches_rank0"] or [r0["in_process"]["handoffs"], r0["http"]["handoffs"]] != r1["followed"]:
        raise AssertionError(f"serving_mesh: rank 1 followed {r1['followed']} batches, rank 0 formed "
                             f"{line['batches_rank0']} and handed over {r0['in_process']['handoffs']}, "
                             f"{r0['http']['handoffs']}")
    tokens = r0["in_process"]["tokens"]
    for r, rep in enumerate(reports):
        if rep["first_batch_launches"] != rep["first_batch_predicted"]:
            raise AssertionError(f"serving_mesh rank {r}: first batch's launches {rep['first_batch_launches']} "
                                 f"differ from the prediction {rep['first_batch_predicted']}")
        if rep["missing"]:
            raise AssertionError(f"serving_mesh rank {r}: kernels {rep['missing']} not launched ({rep['launches']})")
        if [(x["kind"], x["batch"], x["capture_ms"] is None) for x in rep["runners"]] != [
                ("GreedyRunner", BATCH // 2, False)]:
            raise AssertionError(f"serving_mesh rank {r}: runners {rep['runners']}, not one captured greedy runner "
                                 f"of batch {BATCH // 2}")
        lo, hi = rep["one_rank"]["rows"]
        if tokens[lo:hi] != rep["one_rank"]["tokens"] or \
                r0["in_process"]["lang_tokens"][lo:hi] != rep["one_rank"]["lang_tokens"]:
            raise AssertionError(f"serving_mesh rank {r}: rows {lo}:{hi} of the meshed batch differ from the "
                                 "one-rank pipeline's at the per-rank batch")
    line["rows_equal_one_rank"] = True
    line["nccl_world1"] = serve_nccl_world1(tmp, gguf, tmp / "cli0.wav", reply)
    return line


# --------------------------------------------------------------------------
# phase 6: the accuracy tooling at Large-V3 width and depth

ACC_SEEDS = (0, 1, 2, 3)  # the accuracy phase's seeds, fixed before its first run
ACC_BATCH, ACC_STEPS = 4, 64
ACC_SHARED = ("q4_bf16", "q4_int8kv", "q4_int4kv", "q4_int4kv_q8log", "q4_w8a8")  # on both fixtures
ACC_IID_ONLY = ("q4_int4selfkv",)
ACC_EXACT = "q4_int4kv_q8log"  # its replayed forced logits are held to the eager step's


def accuracy_phase(cfg) -> dict:
    """The accuracy tooling (``eval/quant_accuracy.py``) at Large-V3 width
    and depth on the card: for each seed of ACC_SEEDS, the iid and the
    structured Q4 fixtures drawn on the device (``device_random_params``),
    the reference ``Compute.parity()`` (TF32 off) through the greedy
    runner, 64 steps of B = 4, then its teacher-forced logits, and each
    serving variant teacher-forced along that trajectory (replayed CUDA
    graphs of one step). The four-seed means must meet FLOORS (with
    NORM_DRIFT_MAX), OPT_FLOORS and STRUCT_FLOORS; one variant's replayed
    logits must equal the eager step's bit for bit; the launches must
    equal the shapes' prediction (kernels A, I, B, B', C, C', G, D, F)."""
    from whisper_burn_tpu_torch.eval import quant_accuracy as qa
    from whisper_burn_tpu_torch.models.config import EOT
    from whisper_burn_tpu_torch.models.params import device_random_params
    from whisper_burn_tpu_torch.models.whisper import DONE_CHECK_EVERY, clear_runners
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.transcribe import prepare_params

    parity = Compute.parity()
    rows = collections.defaultdict(list)
    want = collections.Counter()
    exact = None
    torch.cuda.synchronize()
    _build.reset_launches()
    for seed in ACC_SEEDS:
        g = torch.Generator(device="cuda")
        g.manual_seed(1000 + seed)
        mel = torch.randn((ACC_BATCH, cfg.n_mels, 2 * cfg.n_audio_ctx), generator=g, device="cuda")
        langs = torch.randint(cfg.lang_token_start, cfg.lang_token_end, (ACC_BATCH,), generator=g, device="cuda",
                              dtype=torch.int32)
        for structured in (False, True):
            q4 = device_random_params(cfg, seed, quantized=True, structured=structured, device="cuda")
            ref_tokens, ref_lg, valid = qa.reference_run(prepare_params(q4, parity), cfg, mel, langs, parity,
                                                         ACC_STEPS)
            want.update(predicted_launches(cfg, parity, ACC_BATCH, expected_steps(
                ref_tokens, ACC_STEPS, DONE_CHECK_EVERY, EOT), beam=False))  # the greedy reference
            want.update(predicted_launches(cfg, parity, ACC_BATCH, ACC_STEPS - 1, beam=False))  # its forced run
            for name in ACC_SHARED + (() if structured else ACC_IID_ONLY):
                comp = qa.VARIANTS[name]
                params = prepare_params(q4, comp)
                row = qa.compare_variant(ref_lg, valid, params, cfg, mel, langs, ref_tokens, comp, ACC_STEPS)
                rows[name + ("_struct" if structured else "")].append(dict(seed=seed, **row))
                want.update(predicted_launches(cfg, comp, ACC_BATCH, ACC_STEPS - 1, beam=False))
                if exact is None and name == ACC_EXACT:
                    t0 = time.perf_counter()
                    replayed = qa.forced_logits(params, cfg, mel, langs, ref_tokens, comp, ACC_STEPS)
                    eager = qa.forced_logits(params, cfg, mel, langs, ref_tokens, comp, ACC_STEPS, graph=False)
                    for _ in range(2):
                        want.update(predicted_launches(cfg, comp, ACC_BATCH, ACC_STEPS - 1, beam=False))
                    exact = {"variant": name, "seed": seed, "equal": bool(torch.equal(replayed, eager)),
                             "max_abs_diff": float((replayed - eager).abs().nan_to_num().max()),
                             "seconds": time.perf_counter() - t0}
                    if not exact["equal"]:
                        raise AssertionError(f"accuracy: replayed forced logits differ from the eager step's: {exact}")
                    del replayed, eager
                del params
            del q4, ref_lg
            clear_runners()  # the reference's greedy runner holds its params
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = dict(want)
    summary, missed = {}, []
    floors = {**qa.FLOORS, **qa.OPT_FLOORS, **qa.STRUCT_FLOORS}
    for name, per_seed in rows.items():
        agree = [r["token_agreement"] for r in per_seed]
        summary[name] = {"mean": float(np.mean(agree)), "min": float(np.min(agree)), "per_seed": agree,
                         "max_logit_drift": max(r["max_logit_drift"] for r in per_seed),
                         "norm_drift_max": max(r["norm_drift"] for r in per_seed), "floor": floors.get(name)}
        if name in floors and summary[name]["mean"] < floors[name]:
            missed.append(f"{name}: mean {summary[name]['mean']:.4f} below {floors[name]}")
        if name in qa.FLOORS and summary[name]["norm_drift_max"] > qa.NORM_DRIFT_MAX:
            missed.append(f"{name}: norm drift {summary[name]['norm_drift_max']:.3f} above {qa.NORM_DRIFT_MAX}")
    line = {"seeds": list(ACC_SEEDS), "batch": ACC_BATCH, "steps": ACC_STEPS, "fixtures": "device (iid, structured)",
            "rows": summary, "replay_equals_eager": exact, "launches": launches, "expected_launches": want}
    if missed:
        raise AssertionError(f"accuracy: floors missed: {missed}; {line}")
    if launches != want:
        raise AssertionError(f"accuracy: launches {launches} differ from the shapes' prediction {want}")
    if missing := set(floors) - set(summary):
        raise AssertionError(f"accuracy: no rows for {sorted(missing)}")
    return line


# --------------------------------------------------------------------------
# phase 3: the main paths


@dataclasses.dataclass
class MainPath:
    """One main path: ``run(r)`` serves request ``r`` through the entries a
    user calls and returns its result; ``batch`` utterances of up to
    ``max_tokens`` tokens, beam search or greedy, in ``compute``."""

    label: str
    run: object
    compute: object
    batch: int = BATCH
    max_tokens: int = MAX_TOKENS
    beam: bool = False
    requests: int = NEW_PATH_REQUESTS
    eager: object = None  # eager(r, max_tokens): request r through the loop body, step by step
    cfg: object = None  # the model's config, where it is not the main paths' Large-V3


def eager_greedy(params, cfg, mel, lang, compute, max_tokens, detect=False, forced=None, on_logits=None):
    """A greedy request with the loop's body (``greedy_step``) called step
    by step from here, on a fresh state and cache, in the stage ranges
    ``greedy_decode`` marks: the eager reference that every replayed
    request of a greedy path is held to bit for bit. With ``forced``
    (int [B, max_tokens]) step k is fed ``forced[:, k - 1]`` (teacher
    forcing, every step run); ``on_logits(k, logits)`` sees each step's
    logits."""
    from torch.profiler import record_function

    from whisper_burn_tpu_torch.models import whisper as w
    from whisper_burn_tpu_torch.models.config import EOT
    from whisper_burn_tpu_torch.models.decoder import init_cache

    cache = init_cache(cfg, mel.shape[0], compute, w.self_cache_len(cfg, max_tokens), mel.device)
    state = w.new_state(cache, max_tokens)
    lang = w.start_request(params, cfg, mel, lang, compute, state, detect=detect, task="transcribe")
    with record_function("greedy_decode.decode"):
        for k in range(1, max_tokens):
            if forced is None and k % w.DONE_CHECK_EVERY == 0 and bool(state.done.all()):
                break
            if forced is not None:
                state.cur.copy_(forced[:, k - 1])
            logits = w.greedy_step(params, cfg, state, compute)
            if on_logits is not None:
                on_logits(k, logits)
        n_gen = (state.tokens != EOT).sum(dim=-1).to(torch.int32)
    return w.GreedyResult(state.tokens, n_gen, lang)


def eager_beam(params, cfg, mel, lang, compute, max_tokens):
    """A beam request with the loop's body (``beam_step``) called step by
    step from here, on a fresh state, its self-cache pair taken in turn, in
    the stage ranges ``beam_decode`` marks: the eager reference that every
    replayed request of a beam path is held to bit for bit."""
    from torch.profiler import record_function

    from whisper_burn_tpu_torch.models import beam
    from whisper_burn_tpu_torch.models import whisper as w

    state = beam.new_beam_state(cfg, compute, mel.shape[0], BEAM_WIDTH, w.self_cache_len(cfg, max_tokens), max_tokens,
                                mel.device)
    lang = beam.start_beam_request(params, cfg, mel, lang, compute, state, detect=False, task="transcribe")
    with record_function("beam_decode.decode"):
        for k in range(1, max_tokens):
            if k % w.DONE_CHECK_EVERY == 0 and bool(state.done.all()):
                break
            beam.beam_step(params, cfg, state, compute, (k - 1) % 2, length_penalty=1.0, early_stopping=False)
        return beam.BeamResult(*beam.select_best(state, 1.0), lang)


def lang_tokens(cfg, batch: int) -> torch.Tensor:
    return torch.full((batch,), cfg.lang_token_start, dtype=torch.int32, device="cuda")


def audio_path(label, params, cfg, compute, mel_frontend, audios, beam=False, requests=NEW_PATH_REQUESTS):
    """A path of requests on ``audios`` (B=8 x 30 s each): mel ->
    greedy_decode, or mel -> beam_decode with BEAM_WIDTH beams."""
    from whisper_burn_tpu_torch.models.beam import beam_decode
    from whisper_burn_tpu_torch.models.whisper import greedy_decode

    def run(r, max_tokens=MAX_TOKENS):
        mel = mel_frontend(audios[r % len(audios)])
        if beam:
            return beam_decode(params, cfg, mel, lang_tokens(cfg, BATCH), compute, beam_width=BEAM_WIDTH,
                               max_tokens=max_tokens)
        return greedy_decode(params, cfg, mel, lang_tokens(cfg, BATCH), compute, max_tokens=max_tokens)

    def eager(r, max_tokens=MAX_TOKENS):
        return (eager_beam if beam else eager_greedy)(
            params, cfg, mel_frontend(audios[r % len(audios)]), lang_tokens(cfg, BATCH), compute, max_tokens)

    return MainPath(label, run, compute, beam=beam, requests=requests, eager=eager, cfg=cfg)


def self_kernel(compute, beam: bool) -> str:
    """The self-attention kernel of a decode step: B (int8 greedy), B'
    (float greedy), G (int4 or mixed greedy), E (int8 beam), E' (float
    beam) or H (int4 or mixed beam)."""
    from whisper_burn_tpu_torch.ops.decode_attention import LAYER, LAYER4, LAYER_U, MERGED, MERGED4, SELF

    if compute.self_v_packed:
        return LAYER4 if beam else MERGED4
    if beam:
        return LAYER if compute.quantized_self_kv else LAYER_U
    return SELF if compute.quantized_self_kv else MERGED


def predicted_launches(cfg, compute, batch: int, steps: int, beam: bool, detect: bool = False) -> dict:
    """Launches per request the shapes predict. Kernel A: the four
    projections of each layer per step and in the prefill (and in the
    language-detection pass with ``detect``), the int8 logits too with
    ``quantized_logits``; kernel I the FFN of each layer there. Without W8A8
    also the encoder's two projections (A) and FFN (I) per layer and the
    cross fill's one linear (A) while their rows (B x 1536 and B x 1500) are
    below LARGE_M. One self- and one cross-attention launch per layer and
    step (C over int4, C' over int8 or float caches); one launch of F a
    step: its beam form on a beam path, else its slot form where the row
    is not stored by kernel B; D once per encoder layer. Kernel J (the
    LayerNorm) twice per encoder layer and once after the last, and three
    times per decoder layer and once before the logits in the prompt, in
    each step and in the detection pass."""
    from whisper_burn_tpu_torch.ops.cache import BEAM_FN as SLOT_BEAM
    from whisper_burn_tpu_torch.ops.cache import FN as SLOT
    from whisper_burn_tpu_torch.ops.decode_attention import CROSS, CROSS_U, SELF
    from whisper_burn_tpu_torch.ops.ffn_kernel import NAME as FFN
    from whisper_burn_tpu_torch.ops.layer_norm import NAME as LN
    from whisper_burn_tpu_torch.ops.q4_matmul import LARGE_M

    L, La = cfg.n_text_layer, cfg.n_audio_layer
    t_enc = -(-cfg.n_audio_ctx // 128) * 128
    a = (4 * L + int(compute.quantized_logits)) * (1 + steps) + 4 * L * detect
    ffn = L * (1 + steps) + L * detect
    if not compute.w8a8:
        enc = batch * t_enc < LARGE_M
        a += 2 * La * enc + L * (batch * cfg.n_audio_ctx < LARGE_M)
        ffn += La * enc
    self_fn = self_kernel(compute, beam)
    want = {"q4_matmul": a, FFN: ffn, self_fn: L * steps, CROSS if compute.kv_packed else CROSS_U: L * steps,
            "encoder_attention": La, LN: 2 * La + 1 + (3 * L + 1) * (1 + steps + detect)}
    if beam:
        want[SLOT_BEAM] = steps
    elif self_fn != SELF:
        want[SLOT] = steps
    return want


def expected_steps(tokens: torch.Tensor, max_tokens: int, check_every: int, eot_id: int) -> int:
    """Decode steps greedy_decode runs: all of them, unless every stream
    stopped and the loop saw it at a check."""
    eot = tokens == eot_id
    if not bool(eot.any(dim=1).all()):
        return max_tokens - 1
    k_stop = int(eot.int().argmax(dim=1).max())  # the step of the last stream's EOT
    k_break = -(-(k_stop + 1) // check_every) * check_every
    return min(max_tokens, k_break) - 1


def check_result(path: MainPath, r: int, res, cfg) -> None:
    """Tokens in range and EOT-filled after a stream's end; beam scores are
    log-probabilities."""
    from whisper_burn_tpu_torch.models.config import EOT

    tok, n = res.tokens, path.max_tokens
    if tuple(tok.shape) != (path.batch, n) or tok.min() < 0 or tok.max() >= cfg.n_vocab:
        raise AssertionError(f"{path.label} request {r}: tokens {tuple(tok.shape)} out of shape or range")
    if path.beam:
        col = torch.arange(n, device=tok.device)[None, :]
        if not bool(((tok == EOT) == (col >= res.n_generated[:, None])).all()):
            raise AssertionError(f"{path.label} request {r}: tokens are not EOT exactly past n_generated")
        if not bool(torch.isfinite(res.scores).all() and (res.scores <= 0).all()):
            raise AssertionError(f"{path.label} request {r}: scores {res.scores.tolist()} are not log-probabilities")
    else:
        after_eot = (tok == EOT).int().cummax(dim=1).values.bool()
        if not bool((tok[after_eot] == EOT).all()):
            raise AssertionError(f"{path.label} request {r}: a stream emitted a token after its EOT")


def run_path(path: MainPath, cfg) -> tuple[dict, dict, list]:
    """``path.requests`` requests, counted, each held to the predicted
    launches and at most one host sync per done check (a greedy path's
    first request captures its step as a CUDA graph, every later step
    replays it); returns the counts, by kernel and by (kernel, shape), and
    the results."""
    from whisper_burn_tpu_torch.models.config import EOT
    from whisper_burn_tpu_torch.models.whisper import DONE_CHECK_EVERY
    from whisper_burn_tpu_torch.ops import _build

    L, n = cfg.n_text_layer, path.max_tokens
    torch.cuda.synchronize()
    _build.reset_launches()
    results = []
    for r in range(path.requests):
        before = dict(_build.LAUNCHES)
        torch.cuda.set_sync_debug_mode("warn")  # each implicit host sync warns
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            res = path.run(r)
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        got = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
        if path.beam:
            # the decode steps run: all of them when no utterance finished
            # (a finished one's best hypothesis is shorter than the cap)
            steps = got.get(self_kernel(path.compute, True), 0) // L
            if bool((res.n_generated == n).all()) and steps != n - 1:
                raise AssertionError(f"{path.label} request {r}: {steps} decode steps, no utterance finished")
            if not 1 <= steps <= n - 1:
                raise AssertionError(f"{path.label} request {r}: {steps} decode steps")
        else:
            steps = expected_steps(res.tokens, n, DONE_CHECK_EVERY, EOT)
        checks = min(steps + 1, n - 1) // DONE_CHECK_EVERY  # done checks the loop ran
        want = predicted_launches(cfg, path.compute, path.batch, steps, path.beam)
        line = {"path": path.label, "request": r, "timed": r > 0, "wall_ms": wall * 1e3,
                "audio_s_per_s": path.batch * 30.0 / wall, "decode_steps": steps, "host_syncs": syncs,
                "done_checks": checks, "n_generated": res.n_generated.tolist(), "launches": got,
                "expected_launches": want}
        if path.beam:
            line.update(beam_width=BEAM_WIDTH, scores=res.scores.tolist())
        log(line)
        if got != want:
            raise AssertionError(f"{path.label} request {r}: launches {got} differ from the shapes' prediction {want}")
        if not min(checks, 1) <= syncs <= max(checks, 1):
            raise AssertionError(f"{path.label} request {r}: {syncs} host syncs for {checks} done checks")
        check_result(path, r, res, cfg)
        results.append(res)
    return dict(_build.LAUNCHES), shape_counts(), results


def eager_check(path: MainPath, results: list) -> tuple[dict, object]:
    """The path's eager reference request (``path.eager``: the loop body
    called step by step) against its requests replayed through the graph,
    bit for bit (a beam's scores too): at the path's own token count
    against its last request (fully replayed; greedy and entry), else at
    TRACED_TOKENS against two more requests, the first of which captures
    the step of a new runner (the beam's from each buffer of its pair) and
    the second replays it from k = 1. Returns the line and the reference."""
    tokens = path.max_tokens if path.label in ("greedy", "entry") else TRACED_TOKENS
    r = path.requests - 1
    replayed = [results[-1]] if tokens == path.max_tokens else [path.run(r, max_tokens=tokens) for _ in range(2)]
    t0 = time.perf_counter()
    ref = path.eager(r, max_tokens=tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    same = [bool(torch.equal(x.tokens, ref.tokens) and torch.equal(x.n_generated, ref.n_generated)
                 and (not path.beam or torch.equal(x.scores, ref.scores))) for x in replayed]
    line = {"phase": "eager_reference", "path": path.label, "max_tokens": tokens, "eager_wall_ms": wall * 1e3,
            "replayed_requests": len(replayed), "tokens_equal": same, "n_generated": ref.n_generated.tolist()}
    if not all(same):
        raise AssertionError(f"{path.label}: replayed tokens differ from the eager body's: {line}")
    return line, ref


def log_captures(label: str, seen: weakref.WeakSet) -> int:
    """One line per runner that the path made: its shape and the wall of
    its graph's capture. Returns how many it made. ``seen`` holds the
    runners logged before, weakly (a runner dropped from the cache goes)."""
    from whisper_burn_tpu_torch.models.whisper import cached_runners

    made = 0
    for runner in cached_runners():
        if runner not in seen and runner.capture_s is not None:
            seen.add(runner)
            made += 1
            log({"phase": "graph_capture", "path": label, "batch": runner.batch, "ctx": runner.ctx,
                 "max_tokens": runner.max_tokens, "beam_width": getattr(runner, "beam_width", None),
                 "graphs": len(runner.graphs), "capture_ms": runner.capture_s * 1e3,
                 "recorded_launches": [len(tally.log) for _, _, tally in runner.graphs]})
    return made


def pipeline_path(raw, cfg, compute) -> tuple[dict, dict]:
    """The pipeline as a user calls it: ``WhisperPipeline((cfg, raw params),
    compute=compute)`` on numpy audio made from the seed, the language
    detected; ``transcribe_batch`` of 5 x 30 s (bucketed to 8) and
    ``transcribe_long`` of 75 s (3 windows, bucketed to 4), each twice (a
    warm-up and one timed call), each call's launches held against the
    padded batch's prediction; then the eager reference of
    ``transcribe_batch``'s padded request, whose tokens and languages its
    last call must equal."""
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    L = cfg.n_text_layer
    pipe = WhisperPipeline((cfg, raw), tokenizer=None, compute=compute)
    rng = np.random.default_rng(SEED + 10)
    utterances = [(rng.standard_normal(480_000) * 0.1).astype(np.float32) for _ in range(5)]
    long_audio = (rng.standard_normal(75 * 16_000) * 0.1).astype(np.float32)
    calls = (
        ("transcribe_batch", lambda: pipe.transcribe_batch(utterances), 150.0, 5, 8, MAX_TOKENS),
        ("transcribe_long", lambda: [pipe.transcribe_long(long_audio)], 75.0, 1, 4, 3 * MAX_TOKENS),
    )
    torch.cuda.synchronize()
    _build.reset_launches()
    last = {}
    for call, run, audio_s, n_results, padded, max_len in calls:
        for r in range(NEW_PATH_REQUESTS):
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
            steps = got.get(self_kernel(compute, False), 0) // L
            want = predicted_launches(cfg, compute, padded, steps, False, detect=True)
            log({"path": "pipeline", "call": call, "request": r, "timed": r > 0, "wall_ms": wall * 1e3,
                 "audio_s_per_s": audio_s / wall, "batch": padded, "decode_steps": steps,
                 "n_tokens": [len(x.tokens) for x in res], "lang_tokens": [x.lang_token for x in res],
                 "launches": got, "expected_launches": want})
            if got != want:
                raise AssertionError(f"pipeline {call} {r}: launches {got} differ from the prediction {want}")
            if len(res) != n_results or not 1 <= steps <= MAX_TOKENS - 1:
                raise AssertionError(f"pipeline {call} {r}: {len(res)} results, {steps} decode steps")
            if call == "transcribe_batch" and any(len(x.tokens) == MAX_TOKENS for x in res) and steps != MAX_TOKENS - 1:
                raise AssertionError(f"pipeline {call} {r}: an utterance ran to the cap in {steps} steps")
            for x in res:
                if not (len(x.tokens) <= max_len and all(0 <= int(i) < cfg.n_vocab for i in x.tokens)
                        and cfg.lang_token_start <= x.lang_token < cfg.lang_token_end and x.inference_ms > 0):
                    raise AssertionError(f"pipeline {call} {r}: a result out of range: {x.lang_token}, {x.tokens[:8]}")
            last[call] = res
    launches, counts = dict(_build.LAUNCHES), shape_counts()
    # the eager reference of transcribe_batch's request: its padded batch
    # (5 utterances, 3 of silence), its mel, the language detected where asked
    samples = torch.from_numpy(np.stack(utterances + [np.zeros(480_000, np.float32)] * 3)).to("cuda")
    lang = torch.tensor([-1] * 5 + [50259] * 3, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    ref = eager_greedy(pipe.params, pipe.config, pipe.mel(samples), lang, pipe.compute, pipe.max_tokens, detect=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_gen = ref.n_generated.tolist()
    same = [np.array_equal(x.tokens, ref.tokens[i, : n_gen[i]].cpu().numpy()) and x.lang_token == int(ref.lang_tokens[i])
            for i, x in enumerate(last["transcribe_batch"])]
    log({"phase": "eager_reference", "path": "pipeline", "call": "transcribe_batch", "max_tokens": pipe.max_tokens,
         "eager_wall_ms": wall * 1e3, "replayed_requests": 1, "tokens_equal": same, "n_generated": n_gen})
    if not all(same):
        raise AssertionError("pipeline: transcribe_batch's tokens differ from the eager body's")
    return launches, counts


def encoder_heads_path() -> tuple[dict, dict]:
    """Kernel D' through its own entry point, the op
    ``encoder_attention_heads`` (no model path reaches it): B=8 x 1500
    frames of seeded bf16 q/k/v at Large-V3 and Medium widths, two calls
    each; outputs finite and of the input's shape."""
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.encoder_attention import encoder_attention_heads

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 20)
    torch.cuda.synchronize()
    _build.reset_launches()
    for width, d, h in (("Large-V3", 1280, 20), ("Medium", 1024, 16)):
        x = torch.randn((3, BATCH, 1500, d), generator=g, device="cuda").to(torch.bfloat16)
        for r in range(NEW_PATH_REQUESTS):
            t0 = time.perf_counter()
            out = encoder_attention_heads(x[0], x[1], x[2], h)
            torch.cuda.synchronize()
            log({"path": "encoder_attention_heads", "width": width, "request": r,
                 "wall_ms": (time.perf_counter() - t0) * 1e3, "launches": dict(_build.LAUNCHES)})
            if out is None or out.shape != x[0].shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"encoder_attention_heads {width}: {None if out is None else out.shape}")
    return dict(_build.LAUNCHES), shape_counts()


def shape_counts() -> dict:
    from whisper_burn_tpu_torch.ops import _build

    return {json.dumps([k[0], list(k[1])]): v for k, v in _build.LAUNCH_SHAPES.items()}


def traced_run(run, sigs: dict, alias=lambda key: key):
    """``run()`` (returning its result and wall seconds) under
    torch.profiler with the launch log on. Returns the result, the wall,
    the device durations (µs) of the hand-written kernels' launches by
    (kernel, shape), matched one by one to the launch log by their
    signatures ``sigs`` (from the kernel phase), the records the trace
    lost per kernel and the ms those launches took (each at its shape's
    mean), the device events, the ranges and the launch log.
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
    durations, lost, lost_ms = collections.defaultdict(list), {}, {}
    for name, kernel in KERNEL_OF.items():
        traced_ = [e for e in ours if OURS.search(e["name"]).group(1) == kernel]
        logged = [alias(json.dumps([name, list(shape)])) for n, shape in launch_log if n == name]
        j, missed = 0, []
        for key in logged:
            if j < len(traced_) and signature(traced_[j]) == sigs[key]:
                durations[key].append(traced_[j]["dur"])
                j += 1
            else:
                missed.append(key)
        if j != len(traced_):
            raise AssertionError(f"{name}: {len(traced_) - j} traced launches match no logged launch")
        lost[name] = len(missed)
        # the profiler loses records of kernel A's short cluster launches
        # most; every other kernel may lose one in a hundred
        limit = len(logged) // (5 if kernel == "q4_matmul" else 100)
        if lost[name] > max(1, limit):
            raise AssertionError(f"{name}: the trace lost {lost[name]} of {len(logged)} launch records")
        # a lost launch counted at its shape's mean (the kernel's longest if none of its shape survived)
        means = {key: sum(durations[key]) / len(durations[key]) for key in set(logged) if durations.get(key)}
        lost_ms[name] = sum(means.get(key, max(means.values(), default=0.0)) for key in missed) / 1e3
    return res, wall, durations, lost, lost_ms, dev, ranges, launch_log


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


def device_spans(ranges, name: str) -> list[tuple[float, float]]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in ranges if e["cat"] == "gpu_user_annotation" and e["name"] == name]


def decode_split(dev, span, steps: int, gather_spans=(), logits_spans=()) -> dict:
    """Each decode step's device time: the hand-written kernels (kernel F's
    beam form among them), the other work inside ``gather_spans`` (the
    beam's reorder: its tokens' gather by parent), the work inside
    ``logits_spans`` (final LayerNorm and the logits product, kernel A's
    launch among them with int8 logits), other work, idle."""
    lo, hi = span
    in_decode = [e for e in dev if lo <= e["ts"] < hi]
    inside = lambda spans: [e for e in in_decode if any(a <= e["ts"] < b for a, b in spans)]
    busy = sum(e["dur"] for e in in_decode)
    ours_busy = sum(e["dur"] for e in in_decode if OURS.search(e["name"]))
    gathers = [e for e in inside(gather_spans) if not OURS.search(e["name"])]
    logits = inside(logits_spans)
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
        "decode_step_logits_ms": sum(e["dur"] for e in logits) / steps / 1e3,
        "decode_logits_kernels": sorted({e["name"][:90] for e in logits}),
        "decode_step_other_device_ms": (busy - ours_busy - gather) / steps / 1e3,
        "decode_device_ops_per_step": len(in_decode) / steps,
        "decode_device_idle_share": 1 - busy / (hi - lo),
        "decode_other_top": [[n, t / steps / 1e3] for n, t in other.most_common(12)],
    }


def distinct_parents(path: MainPath, max_tokens: int) -> list[int]:
    """The distinct parent streams of each decode step of the beam path's
    eager request 0 at ``max_tokens`` tokens (the streams whose rows kernel
    F's beam form reads), from an untraced run of it that records the
    parents the step passes to ``reorder_self_cache``."""
    from whisper_burn_tpu_torch.models import beam

    parents, reorder = [], beam.reorder_self_cache

    def recording(dst, cache, rows, src, pos):
        parents.append(src.clone())
        reorder(dst, cache, rows, src, pos)

    beam.reorder_self_cache = recording
    try:
        path.eager(0, max_tokens=max_tokens)
    finally:
        beam.reorder_self_cache = reorder
    return [int(src.unique().numel()) for src in parents]


def traced_path(path: MainPath, cfg, sigs: dict, max_tokens: int) -> tuple[dict, dict, object]:
    """One more request of ``path`` at ``max_tokens`` tokens under
    torch.profiler (beam and the new paths at TRACED_TOKENS: the profiler's
    host cost grows with the steps), for a greedy path its eager reference
    (the loop body step by step: a graph replay shows neither the launch
    log's order nor the step's ranges). Returns the device durations (µs)
    of the hand-written kernels' launches by (kernel, shape), the
    breakdown: the stages ``greedy_decode`` or ``beam_decode`` marks, on the
    host and on the device, and each decode step split into the kernels,
    the beam's reorder of its tokens, the logits, other device work and
    idle; and the request's result."""
    from whisper_burn_tpu_torch.ops.cache import BEAM_FN as SLOT_BEAM
    from whisper_burn_tpu_torch.ops.cache import FN as SLOT
    from whisper_burn_tpu_torch.ops.decode_attention import LAYER, LAYER4, LAYER_U, MERGED, MERGED4, SELF

    def run():
        t0 = time.perf_counter()
        res = path.eager(0, max_tokens=max_tokens)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def alias(key):
        """A request of fewer tokens sizes the self cache 64 wide, not CTX:
        its self-attention launches (whose work follows the cached keys,
        not ctx) and slot writes (one row per layer and stream) stand for
        the main path's ctx-CTX rows."""
        kernel, shape = json.loads(key)
        if kernel in (SELF, MERGED, LAYER, LAYER_U, MERGED4, LAYER4):
            shape[1] = CTX
        if kernel in (SLOT, SLOT_BEAM):
            shape[2] = CTX
        return json.dumps([kernel, shape])

    res, wall, durations, lost, lost_ms, dev, ranges, launch_log = traced_run(run, sigs, alias)
    entry = "beam_decode" if path.beam else "greedy_decode"
    stages, spans = stage_split(ranges, entry)
    self_fn = self_kernel(path.compute, path.beam)
    steps = sum(n == self_fn for n, _ in launch_log) // cfg.n_text_layer
    reorder = device_spans(ranges, "beam_decode.reorder")
    if path.beam and not reorder:
        raise AssertionError("the trace holds no beam_decode.reorder range")
    logits = device_spans(ranges, "decode_step.logits")
    if not logits:
        raise AssertionError("the trace holds no decode_step.logits range")
    breakdown = {
        "path": path.label,
        "wall_ms": wall * 1e3,
        "max_tokens": max_tokens,
        "reorder_ranges": len(reorder),
        "logits_ranges": len(logits),
        "stages": stages,
        **decode_split(dev, spans["decode"], steps, reorder, logits),
        "request_device_busy_ms": sum(e["dur"] for e in dev) / 1e3,
        "trace_records_lost": lost,
        "trace_records_lost_ms": lost_ms,
    }
    if path.beam:  # the same request's parents, for the bound of kernel F's beam form
        breakdown["distinct_parents"] = distinct_parents(path, max_tokens)
    # the kernels' time a step, the lost records' launches counted as if
    # all ran in the decode span: the most the records could understate it
    breakdown["decode_step_kernels_max_ms"] = breakdown["decode_step_kernels_ms"] + sum(lost_ms.values()) / steps
    return durations, breakdown, res


def traced_replay(path: MainPath, cfg, max_tokens: int, eager, r: int = 0) -> dict:
    """One more request ``r`` of a path at ``max_tokens`` tokens, its steps
    replayed through the runner's graphs, under torch.profiler (after an
    untraced one, which captures the step if the runner is new: no capture
    under the profiler). The decode stage's device work is what the
    runtime calls inside its host range launched (kernels of a graph carry
    their graph launch's correlation id); returns the replayed step's wall
    (first to last device event of the stage, per step), device busy, idle
    share and device operations per step, and the device ms of the stages
    before the loop (encode, cross_fill, prefill), which run eagerly. Its
    tokens (a beam's scores too) equal the eager request's ``eager`` bit
    for bit."""
    from whisper_burn_tpu_torch.ops import _build

    path.run(r, max_tokens=max_tokens)
    torch.cuda.synchronize()
    _build.reset_launches()

    def run():
        t0 = time.perf_counter()
        res = path.run(r, max_tokens=max_tokens)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    runtime = []
    (res, wall), dev, ranges = traced(run, runtime)
    if not (torch.equal(res.tokens, eager.tokens) and torch.equal(res.n_generated, eager.n_generated)
            and (not path.beam or torch.equal(res.scores, eager.scores))):
        raise AssertionError(f"traced {path.label}: the replayed request's tokens differ from the eager one's")
    steps = _build.LAUNCHES[self_kernel(path.compute, path.beam)] // cfg.n_text_layer
    stage = "beam_decode.decode" if path.beam else "greedy_decode.decode"
    (lo, hi), = [(e["ts"], e["ts"] + e["dur"]) for e in ranges
                 if e["cat"] == "user_annotation" and e["name"] == stage]
    calls = [e for e in runtime if lo <= e["ts"] <= hi]
    corr = {e["args"]["correlation"] for e in calls if "correlation" in e.get("args", {})}
    work = [e for e in dev if e.get("args", {}).get("correlation") in corr]
    if not work:
        raise AssertionError(f"traced {path.label}: no device work in the replayed decode stage")
    start, end = min(e["ts"] for e in work), max(e["ts"] + e["dur"] for e in work)
    busy = sum(e["dur"] for e in work)
    entry = stage.split(".")[0]
    stages = {e["name"].split(".", 1)[1]: e["dur"] / 1e3 for e in ranges  # the eager stages' device ms
              if e["cat"] == "gpu_user_annotation" and e["name"] in {f"{entry}.{s}" for s in STAGES - {"decode"}}}
    return {
        "path": path.label, "wall_ms": wall * 1e3, "max_tokens": max_tokens, "decode_steps": steps,
        "graph_launches": sum(e["name"] == "cudaGraphLaunch" for e in calls),
        "decode_step_ms": (end - start) / steps / 1e3,
        "decode_host_ms_per_step": (hi - lo) / steps / 1e3,
        "decode_step_device_busy_ms": busy / steps / 1e3,
        "decode_device_idle_share": 1 - busy / (end - start),
        "decode_device_ops_per_step": len(work) / steps,
        "request_device_busy_ms": sum(e["dur"] for e in dev) / 1e3,
        "stage_device_ms": stages,
    }


# --------------------------------------------------------------------------
# phase 5: small config, kernels against plain versions end to end


def small_end_to_end(compute) -> dict:
    """Greedy tokens, teacher-forced logits (ungrouped and grouped) and beam
    search at a small config in ``compute`` (f32), on the CPU through the
    plain versions and on the card through the kernels: the same tokens, the
    logits to 1e-4, the beam scores to 1e-4. With an int8 cross cache or an
    int4 self cache the card's teacher-forced steps start from the CPU
    run's caches (its cross fill, and its self cache before each step): the
    two runs' last-bit differences put codes at rounding ties, and one
    moved code shifts every later logit by about 3e-4. Before each such
    copy the card's cross fill and the self-cache rows written since the
    last copy are held against the CPU run's: int8 or int4 codes within one
    step at no more than 1e-3 of places, scales to 1e-5 (as
    tests/test_torch_modes.py and tests/test_torch_int4self.py hold them
    against the JAX package)."""
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.models.beam import beam_decode
    from whisper_burn_tpu_torch.models.config import EOT, SOT, WhisperConfig
    from whisper_burn_tpu_torch.models.decoder import decode_step, fill_cross_cache, init_cache, prefill
    from whisper_burn_tpu_torch.models.encoder import encode
    from whisper_burn_tpu_torch.models.params import random_params
    from whisper_burn_tpu_torch.models.whisper import greedy_decode
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.cache import BEAM_FN as SLOT_BEAM
    from whisper_burn_tpu_torch.ops.cache import FN as SLOT
    from whisper_burn_tpu_torch.ops.decode_attention import CROSS, CROSS_U
    from whisper_burn_tpu_torch.ops.ffn_kernel import NAME as FFN
    from whisper_burn_tpu_torch.transcribe import prepare_params

    cfg = WhisperConfig.tiny_test().replace(
        n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4, n_audio_ctx=128, n_text_ctx=64
    )
    audio = (np.random.default_rng(7).standard_normal((2, 2 * 128 * 160)) * 0.1).astype(np.float32)
    g = 3  # beams
    # every kernel the mode's paths launch
    kernels = {"q4_matmul", FFN, "encoder_attention", self_kernel(compute, False), self_kernel(compute, True),
               CROSS if compute.kv_packed else CROSS_U, SLOT, SLOT_BEAM}
    resync = (compute.quantized_kv and not compute.kv_packed) or compute.self_v_packed
    snaps = {}  # the CPU run's cache states, by (cache, step)
    mismatch = collections.defaultdict(float)  # the largest share of int8 codes that differ, by cache tensor
    runs = {}

    def codes(x):
        """Signed codes: int8 as is, uint8 nibble pairs unpacked."""
        return torch.cat([(x & 15).int() - 8, (x >> 4).int() - 8], dim=-1) if x.dtype == torch.uint8 else x.int()

    for dev in ("cpu", "cuda"):

        def sync(cache, key, rows):
            """Snapshot (CPU) or check and take the snapshot (card);
            ``rows``: the self-cache rows written since the last sync."""
            if resync and dev == "cpu":
                snaps[key] = {f.name: getattr(cache, f.name).clone() for f in dataclasses.fields(cache)
                              if getattr(cache, f.name) is not None}
            elif resync:
                for name, ref in snaps[key].items():
                    ours = getattr(cache, name)
                    a, r = (x[:, :, rows] if name.startswith("self") else x for x in (ours.cpu(), ref))
                    if r.dtype in (torch.int8, torch.uint8):
                        diff = (codes(a) - codes(r)).abs()
                        share = (diff > 0).float().mean().item() if diff.numel() else 0.0
                        mismatch[name] = max(mismatch[name], share)
                        if diff.numel() and (diff.max().item() > 1 or share > 1e-3):
                            raise AssertionError(f"small {key}: {name} codes differ by up to "
                                                 f"{diff.max().item()} at {share:.2e} of places")
                    elif not torch.allclose(a, r, rtol=1e-5, atol=1e-5):
                        raise AssertionError(f"small {key}: {name} differs by {(a - r).abs().max().item():.3e}")
                    ours.copy_(ref)

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
        for i, c in enumerate(caches):
            sync(c, ("fill", i), slice(0, 0))
        written = lambda k: slice(0, 4) if k == 0 else slice(3 + k, 4 + k)  # the prefill's rows, then each step's
        logits = [prefill(params, cfg, prompt, caches[0], compute)]
        forced = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.n_vocab, (8, 2 * g))).to(dev)
        for k in range(8):
            sync(caches[0], ("step", k), written(k))
            slot = torch.tensor(4 + k, dtype=torch.int32, device=dev)
            logits.append(decode_step(params, cfg, forced[k, :2], slot, caches[0], compute))
        sync(caches[0], ("step", 8), written(8))
        # the beam branch of the decode step: self caches repeated g-fold
        grouped, cache = [], caches[1]
        prefill(params, cfg, prompt, cache, compute)
        for name in ("self_k", "self_v", "self_kv_scale"):
            if getattr(cache, name) is not None:
                setattr(cache, name, getattr(cache, name).repeat_interleave(g, dim=1))
        for k in range(8):
            sync(cache, ("grouped step", k), written(k))
            slot = torch.tensor(4 + k, dtype=torch.int32, device=dev)
            grouped.append(decode_step(params, cfg, forced[k], slot, cache, compute, batch_groups=g))
        sync(cache, ("grouped step", 8), written(8))
        # beam search with the EOT row scaled, so hypotheses are banked
        # before the cap (tests/test_torch_beam.py)
        bparams = random_params(cfg, seed=0, device=dev)
        bparams["decoder"]["tok_emb"][EOT] *= 2.5
        beam = beam_decode(prepare_params(bparams, compute), cfg, mel, lang, compute, beam_width=g, max_tokens=10)
        counts = dict(_build.LAUNCHES)
        if dev == "cuda" and not all(counts.get(n, 0) > 0 for n in kernels):
            raise AssertionError(f"small end to end: launches {counts}, expected each of {sorted(kernels)}")
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
    return {"teacher_forced_from_cpu_caches": resync, "code_mismatch_share": dict(mismatch),
            "tokens": runs["cuda"][0].tolist(), "logits_max_abs_err": errs[0],
            "grouped_logits_max_abs_err": errs[1], "beam_tokens": tok.tolist(),
            "beam_n_generated": ngen.tolist(), "beam_scores_max_abs_err": beam_err}


# --------------------------------------------------------------------------
# phase 7: scale-out (parallel/): every kernel at a shard's shapes, two
# ranks sharing the card over gloo, and NCCL at the world the box has

SCALEOUT_TOKENS = 32  # the shared-card ranks' requests: B = 8 x 30 s, 32 tokens
# a parity divergence passes only as a near-tie: the one-rank run's f32
# top-2 gap at the first differing step at most this x max(1, |top-1|)
NEAR_TIE = 1e-3
# a parity beam stream with one rank's tokens: its score within this x
# max(1, |score|) of one rank's
SCORE_TOL = 1e-4
SHARD_NAMES = {2: "(tp = 2 shard)", 4: "(tp = 4 shard)"}


def shard_cfg(cfg, tp: int):
    """Large-V3 as one of ``tp`` model ranks sees its attention: heads and
    width divided (the row helpers read the decoder's and encoder's)."""
    return cfg.replace(n_text_state=cfg.n_text_state // tp, n_text_head=cfg.n_text_head // tp,
                       n_audio_state=cfg.n_audio_state // tp, n_audio_head=cfg.n_audio_head // tp)


def shard_blocks(params, tp: int) -> dict:
    """Model rank 0's shard of the decoder's stacked blocks of ``params``
    (``parallel/sharding.shard_params``)."""
    from whisper_burn_tpu_torch.parallel import Mesh, shard_params

    dec = {"decoder": {"blocks": params["decoder"]["blocks"]}}
    return shard_params(dec, Mesh(1, tp, 0, 0))["decoder"]["blocks"]


def tp_kernel_checks(params, cfg, gen) -> list[dict]:
    """Every kernel at Large-V3's per-rank shapes. tp = 2 (10 heads, D 640,
    F 2560), on the ``scaleout_shared`` path's shapes (B = 8, its 32-token
    self cache of ctx 64): A at the decode's 8 rows (qkv 1280 -> 1920,
    xattn_q 1280 -> 640, the K-split projections 640 -> 1280 without
    bias), the prefill's 32 and the 5-beam step's 40; I at 8 (K4's order),
    32 (K7's) and 40, fc2's bias zeroed as the sharded FFN runs it; B, B',
    E, C, grouped C, C' (f32), D and F's two forms. tp = 4 (5 heads, D 320,
    F 1280, not a multiple of 512, so the FFN is kernel A twice), off every
    path that ran here (one card runs no tp = 4 mesh; launches 0), at the
    224-token shapes: A, B, C (odd heads: one head a cluster, greedy and
    the 5-beam's grouped form), C' (int8), D, E, G and H (odd heads: one
    block a head) and F's slot form. Each against its plain version, as the
    unsharded rows."""
    from whisper_burn_tpu_torch.ops.compute import Compute

    rows = []
    k1, k5 = "whisper_burn_tpu/ops/pallas_q4.py:121 (K1)", "whisper_burn_tpu/ops/pallas_q4.py:44 (K5)"
    bf = torch.bfloat16
    ctx2 = max(64, -(-(4 + SCALEOUT_TOKENS) // 64) * 64)
    for tp in (2, 4):
        tag, path = SHARD_NAMES[tp], "scaleout_shared" if tp == 2 else "tp4_shard"
        blocks = shard_blocks(params, tp)
        scfg = shard_cfg(cfg, tp)
        nob = lambda lin: {k: lin[k] for k in ("qw", "scales")}  # a row-parallel linear: its bias after the sum
        ms = (BATCH, 4 * BATCH, STREAMS) if tp == 2 else (BATCH,)
        cases = []
        for m in ms:
            k = k5 if m == 4 * BATCH else k1
            cases += [(f"attn_qkv/{m} {tag}", m, blocks["attn_qkv"], None, bf, k),
                      (f"xattn_q/{m} {tag}", m, blocks["xattn_q"], None, bf, k),
                      (f"attn_o/xattn_o/{m} {tag}", m, nob(blocks["attn_o"]), None, bf, k)]
        if tp == 4:  # F_loc 1280: the FFN as two launches of A, GELU in fc1's epilogue
            cases += [(f"fc1/{BATCH} {tag}", BATCH, blocks["fc1"], cfg.gelu, bf, K4),
                      (f"fc2/{BATCH} {tag}", BATCH, nob(blocks["fc2"]), None, bf, K4)]
        rows += q4_rows(cases, gen, path)
        if tp == 2:
            ffn = {"fc1": blocks["fc1"], "fc2": {k: v for k, v in blocks["fc2"].items() if k != "b"}}
            rows += ffn_rows([(f"decode {tag}", BATCH, ffn, cfg.gelu, True, K4),
                              (f"prefill {tag}", 4 * BATCH, ffn, cfg.gelu, False, K7),
                              (f"beam_decode {tag}", STREAMS, ffn, cfg.gelu, True, K4)], gen, path)
            rows.append(self_attention_row(scfg, gen, path, f"decode_self_attention {tag}", ctx=ctx2,
                                           steps=SCALEOUT_TOKENS - 1))
            rows += merged_rows(scfg, gen, ((path, BATCH, ctx2, SCALEOUT_TOKENS - 1),), suffix=f" {tag}")
            rows.append(layer_attention_row(scfg, gen, path, f"decode_attention_layer {tag}", ctx=ctx2,
                                            steps=SCALEOUT_TOKENS - 1))
            rows.append(cross_int4_row(scfg, gen, BATCH, 1, path, f"decode_cross_attention {tag}"))
            rows.append(cross_int4_row(scfg, gen, BATCH, BEAM_WIDTH, path, f"decode_cross_attention/grouped {tag}"))
            rows += cross_unpacked_rows(scfg, gen, (("f32", ((BATCH, 1, path),)),), suffix=f" {tag}")
            f32 = Compute.parity()
            serving = Compute.fastest(kv_bits=4)
            rows.append(f_row(scfg, gen, f32, path, BATCH, ctx2, False, SCALEOUT_TOKENS - 1, suffix=f" {tag}")[0])
            rows.append(f_row(scfg, gen, serving, path, STREAMS, ctx2, True, SCALEOUT_TOKENS - 1, suffix=f" {tag}",
                              positions=False)[0])
        else:
            rows.append(self_attention_row(scfg, gen, path, f"decode_self_attention {tag}"))
            rows.append(layer_attention_row(scfg, gen, path, f"decode_attention_layer {tag}"))
            rows += cross_unpacked_rows(scfg, gen, (("int8", ((BATCH, 1, path),)),), suffix=f" {tag}")
            rows.append(cross_int4_row(scfg, gen, BATCH, 1, path, f"decode_cross_attention {tag}"))
            rows.append(cross_int4_row(scfg, gen, BATCH, BEAM_WIDTH, path, f"decode_cross_attention/grouped {tag}"))
            for merged in (True, False):
                for mode in ("int4self", "mixed"):
                    rows.append(int4_self_row(scfg, gen, mode, merged, BATCH if merged else STREAMS, path,
                                              suffix=f" {tag}"))
            int4self = Compute.fastest(kv_bits=4).replace(self_kv_bits=4)
            rows.append(f_row(scfg, gen, int4self, path, BATCH, CTX, False, MAX_TOKENS - 1, suffix=f" {tag}")[0])
        rows.append(encoder_attention_row(scfg, gen, BATCH, path, f"encoder_attention {tag}"))
        for row in rows:
            if row["path"] == "tp4_shard":
                row["off_path"] = True
        del blocks
        torch.cuda.empty_cache()
    return rows


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_ranks(mode: str, world: int, out: Path, env_extra=None) -> list[subprocess.Popen]:
    """``world`` processes of this script in rank mode ``mode``, each
    writing ``out/rank<r>.json`` and its output to ``out/rank<r>.log``."""
    port = free_port()
    env = dict(os.environ, **(env_extra or {}))
    procs = []
    for r in range(world):
        with open(out / f"rank{r}.log", "w") as log_file:
            procs.append(subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank", mode, str(r),
                                           str(world), str(port), str(out)], env=env, stdout=log_file,
                                          stderr=subprocess.STDOUT, text=True))
    return procs


def finish_ranks(mode: str, procs: list, timeout: float, out: Path) -> list[dict]:
    """Wait for the ranks of :func:`start_ranks`; every one still running
    after ``timeout`` is stopped. Returns their JSON, or raises with the
    failing rank's output."""
    try:
        deadline = time.perf_counter() + timeout
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"{mode} rank {r} exited {p.returncode}:\n{(out / f'rank{r}.log').read_text()[-6000:]}")
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(len(procs))]


def run_ranks(mode: str, world: int, timeout: float, out: Path, env_extra=None) -> list[dict]:
    """``world`` processes of this script in rank mode ``mode``, run to
    their end (:func:`start_ranks`, :func:`finish_ranks`)."""
    return finish_ranks(mode, start_ranks(mode, world, out, env_extra), timeout, out)


def beam_agreement(got: list, ref: list, scores: list, ref_scores: list) -> list[dict]:
    """Each stream of a ``Compute.parity()`` beam against one rank's: equal
    tokens with scores within SCORE_TOL x max(1, |score|) (the model
    ranks' split sums move a score by f32 roundings only), or other
    tokens whose score is within NEAR_TIE x max(1, |score|) of one rank's
    (two hypotheses the search could not tell apart). A beam whose
    sharded caches were reordered wrongly attends over another beam's
    history and fails both."""
    out = []
    for b, (g, r, s, s1) in enumerate(zip(got, ref, scores, ref_scores)):
        same, gap = g == r, abs(s - s1)
        tol = (SCORE_TOL if same else NEAR_TIE) * max(1.0, abs(s1))
        out.append({"stream": b, "tokens_equal": same, "score_gap": gap, "tol": tol, "ok": gap <= tol})
    return out


def first_divergence(got: list, ref: list, gaps: list, top1: list) -> dict | None:
    """Where a stream's tokens first differ from the one-rank run's, with
    that run's f32 top-2 gap there (``gaps[k - 1][b]``: step k's)."""
    for b, (g, r) in enumerate(zip(got, ref)):
        for k, (x, y) in enumerate(zip(g, r)):
            if x != y:
                gap, t1 = (gaps[k - 1][b], top1[k - 1][b]) if k >= 1 else (None, None)
                return {"stream": b, "step": k, "got": x, "want": y, "top2_gap": gap, "top1": t1,
                        "near_tie": gap is not None and gap <= NEAR_TIE * max(1.0, abs(t1))}
    return None


def scaleout_rank(rank: int, world: int, port: int, out: Path) -> None:
    """One of two ranks sharing the card over an explicit gloo group
    (gloo carries CUDA tensors through the host; NCCL takes no two ranks
    of one communicator on one device). Large-V3 at full width and depth
    from seed 0, B = 8 x 30 s of seeded audio, SCALEOUT_TOKENS tokens,
    the loop body driven step by step (a graph captures NCCL only):

    The weights are the accuracy phase's iid fixture of seed 0
    (``device_random_params``), on which q4_int8kv's floor was set.

    * rank 0 alone, one rank's references: ``Compute.parity()`` greedy
      (with each step's f32 top-2 gaps) and 5-beam, serving greedy (with
      its gaps) and 5-beam;
    * mesh (1, 2) in ``Compute.parity()``, (2, 1) in ``Compute.parity()``
      (each rank its 4 utterances, gathered), (1, 2) 5-beam in
      ``Compute.parity()``, (1, 2) in the serving compute
      teacher-forced along the one-rank serving trajectory (its argmax
      against that trajectory at the steps before each stream's EOT, as
      ``eval/quant_accuracy`` counts), and (1, 2) serving 5-beam; per run
      the launches, the collectives before any gather, and the replication
      guard's count."""
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.models.config import EOT, WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_random_params
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.collectives import KINDS
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.parallel import make_mesh, shard_params_tp, tp_compute
    from whisper_burn_tpu_torch.parallel.audit import predicted_collectives
    from whisper_burn_tpu_torch.parallel.guard import replication_mismatch
    from whisper_burn_tpu_torch.parallel.multihost import initialize, local_batch_to_global
    from whisper_burn_tpu_torch.transcribe import prepare_params

    dev = initialize(f"localhost:{port}", world, rank, device="cuda:0", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = WhisperConfig.large_v3()
    parity = Compute.parity()
    serving = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
    t0 = time.perf_counter()
    raw = device_random_params(cfg, seed=SEED, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    audio = torch.randn((BATCH, 480_000), generator=g, device=dev) * 0.1
    mel = MelFrontend(n_mels=cfg.n_mels, norm="slaney")(audio)
    lang = torch.full((BATCH,), cfg.lang_token_start, dtype=torch.int32, device=dev)
    n = SCALEOUT_TOKENS
    report = {"rank": rank, "setup_s": time.perf_counter() - t0, "runs": {}}
    torch.cuda.synchronize()

    if rank == 0:  # one rank's references
        t0 = time.perf_counter()
        gaps, top1, sgaps = [], [], []

        def margins(into):
            def on_logits(k, logits):
                v = logits.topk(2, dim=-1).values
                into.append((v[:, 0] - v[:, 1]).tolist())
                if into is gaps:
                    top1.append(v[:, 0].tolist())
            return on_logits

        pparams = prepare_params(raw, parity)
        ref = eager_greedy(pparams, cfg, mel, lang, parity, n, on_logits=margins(gaps))
        pbref = eager_beam(pparams, cfg, mel, lang, parity, n)
        del pparams
        sparams = prepare_params(raw, serving)
        sref = eager_greedy(sparams, cfg, mel, lang, serving, n, on_logits=margins(sgaps))
        bref = eager_beam(sparams, cfg, mel, lang, serving, n)
        del sparams
        report["ref"] = {"parity": ref.tokens.tolist(), "gaps": gaps, "top1": top1, "serving": sref.tokens.tolist(),
                         "serving_n_generated": sref.n_generated.tolist(), "serving_gaps": sgaps,
                         "beam": bref.tokens.tolist(), "beam_scores": bref.scores.tolist(),
                         "parity_beam": pbref.tokens.tolist(), "parity_beam_scores": pbref.scores.tolist(),
                         "s": time.perf_counter() - t0}
        forced = torch.cat([sref.tokens.long(), sref.n_generated.long()[:, None]], dim=1)
    else:
        forced = torch.zeros((BATCH, n + 1), dtype=torch.long, device=dev)
    # the serving trajectory and its lengths, to the other rank
    torch.distributed.broadcast(forced, 0)
    forced, n_gen = forced[:, :n].contiguous(), forced[:, n]
    torch.cuda.synchronize()

    shapes = collections.Counter()
    for label, (data, model), compute, kind in (("parity_1x2", (1, 2), parity, "greedy"),
                                                ("parity_2x1", (2, 1), parity, "greedy"),
                                                ("beam_parity_1x2", (1, 2), parity, "beam"),
                                                ("serving_1x2", (1, 2), serving, "forced"),
                                                ("beam_1x2", (1, 2), serving, "beam")):
        mesh = make_mesh(data, model, device=dev)
        local = tp_compute(compute, mesh)
        params = shard_params_tp(prepare_params(raw, compute, model), mesh)
        rows = mesh.rows(BATCH)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        agree = []
        if kind == "beam":
            res = eager_beam(params, cfg, mel[rows], lang[rows], local, n)
        elif kind == "forced":
            res = eager_greedy(params, cfg, mel[rows], lang[rows], local, n, forced=forced[rows],
                               on_logits=lambda k, lg: agree.append(lg.argmax(dim=-1) == forced[rows][:, k]))
        else:
            res = eager_greedy(params, cfg, mel[rows], lang[rows], local, n)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        collectives = {k: _build.COLLECTIVES.get(k, 0) for k in KINDS}
        if model > 1:
            shapes.update(shape_counts())
        self_fn = self_kernel(compute, kind == "beam")
        steps = launches.get(self_fn, 0) // cfg.n_text_layer
        want = predicted_launches(cfg, compute, BATCH // data, steps, kind == "beam")
        want_coll = {**predicted_collectives(cfg, mesh, steps=steps, beam=kind == "beam"), "all_gather": 0}
        mismatch = replication_mismatch(res, mesh.model_group, mesh.model, mesh.model_index)
        tokens = local_batch_to_global(mesh, res.tokens.contiguous())
        run = {"mesh": [data, model], "wall_s": wall, "decode_steps": steps, "launches": launches,
               "expected_launches": want, "collectives": collectives, "expected_collectives": want_coll,
               "replication_mismatch": mismatch, "tokens": tokens.tolist()}
        if kind == "forced":  # steps k before each stream's EOT (k < n_generated)
            agreed = torch.stack(agree)  # [n - 1, B], step k in row k - 1
            valid = torch.arange(1, n, device=dev)[:, None] < n_gen[rows][None, :]
            run["forced_agreement"] = float(agreed[valid].float().mean())
            run["forced_steps"] = int(valid.sum())
            run["forced_disagree"] = [[k + 1, b] for k, b in (~agreed & valid).nonzero().tolist()]
        if kind == "beam":
            run["scores"] = local_batch_to_global(mesh, res.scores.contiguous()).tolist()
            run["n_generated"] = res.n_generated.tolist()
        else:
            after_eot = (res.tokens == EOT).int().cummax(dim=1).values.bool()
            run["eot_filled"] = bool((res.tokens[after_eot] == EOT).all())
        report["runs"][label] = run
        del params
        torch.cuda.empty_cache()
    report["shapes"] = dict(shapes)
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


def scaleout_shared_phase() -> tuple[dict, dict, dict]:
    """Two ranks on the one card over gloo (``scaleout_rank``); the checks
    on what they report: parity tokens of (1, 2) and (2, 1) equal to the
    one-rank run's (or diverging first at a near-tie), the serving
    compute's teacher-forced agreement at least q4_int8kv's floor, the
    5-beam requests' hypotheses in range, the parity 5-beam's streams
    each equal to one rank's or a near-tie of it (``beam_agreement``),
    and on every rank and run the
    launches and collectives equal to the shapes' prediction and the
    replication guard at 0. Returns the phase line, rank 0's (1, 2)
    launches by kernel and by shape (the ``scaleout_shared`` rows')."""
    from whisper_burn_tpu_torch.eval.quant_accuracy import FLOORS
    from whisper_burn_tpu_torch.models.config import EOT

    TRACE_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TRACE_DIR.parent) as tmp:
        reports = run_ranks("scaleout", 2, 600, Path(tmp))
    ref = reports[0]["ref"]
    line = {"phase": "scaleout_shared", "backend": "gloo", "ranks": 2, "device": "cuda:0 (shared)",
            "tokens": SCALEOUT_TOKENS, "setup_s": [r["setup_s"] for r in reports], "reference_s": ref["s"], "runs": {}}
    floor = FLOORS["q4_int8kv"]
    for label in reports[0]["runs"]:
        runs = [r["runs"][label] for r in reports]
        got = runs[0]
        entry = {"mesh": got["mesh"], "wall_s": [r["wall_s"] for r in runs], "decode_steps": got["decode_steps"],
                 "replication_mismatch": [r["replication_mismatch"] for r in runs],
                 "collectives": got["collectives"], "expected_collectives": got["expected_collectives"]}
        for r, run in enumerate(runs):
            if run["launches"] != run["expected_launches"]:
                raise AssertionError(f"scaleout {label} rank {r}: launches {run['launches']} differ from the "
                                     f"shapes' prediction {run['expected_launches']}")
            if run["collectives"] != run["expected_collectives"]:
                raise AssertionError(f"scaleout {label} rank {r}: collectives {run['collectives']} differ from "
                                     f"the prediction {run['expected_collectives']}")
            if run["replication_mismatch"] != 0:
                raise AssertionError(f"scaleout {label} rank {r}: {run['replication_mismatch']} elements differ "
                                     "across the model ranks")
            if run["tokens"] != got["tokens"]:
                raise AssertionError(f"scaleout {label}: the ranks gathered different tokens")
        if label.startswith("parity"):
            div = first_divergence(got["tokens"], ref["parity"], ref["gaps"], ref["top1"])
            entry["tokens_equal_one_rank"] = div is None
            entry["first_divergence"] = div
            if div is not None and not div["near_tie"]:
                raise AssertionError(f"scaleout {label}: tokens diverge from one rank's at {div}, not a near-tie "
                                     f"(top-2 gap above {NEAR_TIE} x max(1, |top-1|))")
        elif label.startswith("serving"):
            entry["forced_agreement"] = [r["forced_agreement"] for r in runs]
            entry["forced_steps"] = got["forced_steps"]
            entry["floor"] = floor
            # where the argmax left the one-rank trajectory, with that run's top-2 gap there
            entry["disagreements"] = [{"step": k, "stream": b, "one_rank_top2_gap": ref["serving_gaps"][k - 1][b]}
                                      for k, b in got["forced_disagree"][:16]]
            gaps = sorted(g for row in ref["serving_gaps"] for g in row)
            entry["one_rank_top2_gap_median"] = gaps[len(gaps) // 2]
            if min(entry["forced_agreement"]) < floor:
                raise AssertionError(f"scaleout {label}: teacher-forced agreement {entry['forced_agreement']} "
                                     f"below {floor}")
        else:
            tok = torch.tensor(got["tokens"])
            if tuple(tok.shape) != (BATCH, SCALEOUT_TOKENS) or int(tok.min()) < 0 or int(tok.max()) >= 51866:
                raise AssertionError(f"scaleout {label}: tokens {tuple(tok.shape)} out of shape or range")
            if not all(s <= 0 for s in got["scores"]):
                raise AssertionError(f"scaleout {label}: scores {got['scores']} are not log-probabilities")
            key = "parity_beam" if label == "beam_parity_1x2" else "beam"
            entry["tokens_equal_one_rank"] = got["tokens"] == ref[key]
            entry["scores"], entry["one_rank_scores"] = got["scores"], ref[f"{key}_scores"]
            entry["max_score_gap"] = max(abs(a - b) for a, b in zip(got["scores"], ref[f"{key}_scores"]))
            if label == "beam_parity_1x2":
                streams = beam_agreement(got["tokens"], ref[key], got["scores"], ref[f"{key}_scores"])
                entry["streams_tokens_equal"] = sum(s["tokens_equal"] for s in streams)
                bad = [s for s in streams if not s["ok"]]
                if bad:
                    raise AssertionError(f"scaleout {label}: streams {bad} neither equal one rank's beam nor a "
                                         "near-tie of it")
        if not label.startswith("beam") and not all(r["runs"][label].get("eot_filled", True) for r in reports):
            raise AssertionError(f"scaleout {label}: a stream emitted a token after its EOT ({EOT})")
        line["runs"][label] = entry
    launches = collections.Counter()
    for label in ("parity_1x2", "beam_parity_1x2", "serving_1x2", "beam_1x2"):
        launches.update(reports[0]["runs"][label]["launches"])
    return line, dict(launches), reports[0]["shapes"]


def nccl_rank(rank: int, world: int, port: int, out: Path) -> None:
    """One rank a card over NCCL (world >= 2): Large-V3 from seed 0 on
    mesh (world / 2, 2) in the serving compute through the runners (the
    all-reduces captured in the step's graphs), greedy and 5-beam, 224
    tokens, B = 8 per data rank; then the eager body on the same inputs,
    whose tokens the replayed ones must equal bit for bit."""
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_fabricated_params
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.parallel import (
        make_mesh, shard_params_tp, sharded_beam_decode, sharded_greedy_decode, tp_compute,
    )
    from whisper_burn_tpu_torch.parallel.multihost import initialize, local_batch_to_global
    from whisper_burn_tpu_torch.transcribe import prepare_params

    dev = initialize(f"localhost:{port}", world, rank, device=f"cuda:{rank}")
    cfg = WhisperConfig.large_v3()
    serving = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
    mesh = make_mesh(model=2, device=dev)
    params = shard_params_tp(prepare_params(device_fabricated_params(cfg, seed=SEED, device=dev), serving, 2), mesh)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    batch = BATCH * mesh.data
    mel = MelFrontend(n_mels=cfg.n_mels, norm="slaney")(torch.randn((batch, 480_000), generator=g, device=dev) * 0.1)
    lang = torch.full((batch,), cfg.lang_token_start, dtype=torch.int32, device=dev)
    local, rows = tp_compute(serving, mesh), mesh.rows(batch)
    report = {"rank": rank, "mesh": [mesh.data, mesh.model], "nccl": list(torch.cuda.nccl.version())}
    t0 = time.perf_counter()
    res = sharded_greedy_decode(params, cfg, mel, lang, serving, mesh, max_tokens=MAX_TOKENS, debug_replication=True)
    report["greedy_s"] = time.perf_counter() - t0
    eager = eager_greedy(params, cfg, mel[rows], lang[rows], local, MAX_TOKENS)
    report["greedy_equal"] = bool(torch.equal(local_batch_to_global(mesh, eager.tokens.contiguous()), res.tokens))
    t0 = time.perf_counter()
    bres = sharded_beam_decode(params, cfg, mel, lang, serving, mesh, beam_width=BEAM_WIDTH, max_tokens=MAX_TOKENS)
    report["beam_s"] = time.perf_counter() - t0
    beager = eager_beam(params, cfg, mel[rows], lang[rows], local, MAX_TOKENS)
    report["beam_equal"] = bool(torch.equal(local_batch_to_global(mesh, beager.tokens.contiguous()), bres.tokens))
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


def duplicate_rank(rank: int, world: int, port: int, out: Path) -> None:
    """Two ranks of one NCCL communicator on one device: one all-reduce,
    whatever becomes of it written down."""
    from whisper_burn_tpu_torch.parallel.multihost import initialize

    report = {"rank": rank}
    try:
        initialize(f"localhost:{port}", world, rank, device="cuda:0")
        x = torch.ones(4, device="cuda:0")
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        report["result"] = f"all-reduce returned {x.tolist()}"
    except Exception as e:  # the outcome is the record
        report["result"] = f"{type(e).__name__}: {str(e)[:400]}"
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    os._exit(0)  # a refused communicator may leave threads that never end


def scaleout_nccl_phase(params, cfg, mel, lang, serving) -> dict:
    """NCCL at the world the box has. One card: this process is rank 0 of
    a one-rank NCCL group, ``sharded_greedy_decode`` and
    ``sharded_beam_decode`` (B = 8, 224 tokens, the serving compute)
    through the runners, their tokens (and scores) bit for bit those of
    ``greedy_decode`` and ``beam_decode``; one all-reduce over the group;
    then two processes try one communicator on this card, and what NCCL
    does is logged. With two or more cards, one rank a card runs tp = 2
    through the captured graphs (``nccl_rank``)."""
    from whisper_burn_tpu_torch.models.beam import beam_decode
    from whisper_burn_tpu_torch.models.whisper import greedy_decode
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.collectives import all_reduce
    from whisper_burn_tpu_torch.parallel import make_mesh, sharded_beam_decode, sharded_greedy_decode
    from whisper_burn_tpu_torch.parallel.multihost import initialize

    world = torch.cuda.device_count()
    line = {"phase": "scaleout_nccl", "world": world, "nccl": list(torch.cuda.nccl.version())}
    initialize(f"localhost:{free_port()}", 1, 0, device="cuda:0")
    try:
        mesh = make_mesh(1, 1, device="cuda:0")
        t0 = time.perf_counter()
        res = sharded_greedy_decode(params, cfg, mel, lang, serving, mesh, max_tokens=MAX_TOKENS, debug_replication=True)
        bres = sharded_beam_decode(params, cfg, mel, lang, serving, mesh, beam_width=BEAM_WIDTH, max_tokens=MAX_TOKENS)
        torch.cuda.synchronize()
        line["sharded_s"] = time.perf_counter() - t0
        ref = greedy_decode(params, cfg, mel, lang, serving, max_tokens=MAX_TOKENS)
        bref = beam_decode(params, cfg, mel, lang, serving, beam_width=BEAM_WIDTH, max_tokens=MAX_TOKENS)
        line["greedy_equal"] = bool(torch.equal(res.tokens, ref.tokens) and torch.equal(res.n_generated, ref.n_generated))
        line["beam_equal"] = bool(torch.equal(bres.tokens, bref.tokens) and torch.equal(bres.scores, bref.scores))
        _build.reset_launches()
        x = all_reduce(torch.full((4,), 2.0, device="cuda:0"), torch.distributed.group.WORLD)
        line["all_reduce"] = {"result": x.tolist(), "counted": dict(_build.COLLECTIVES)}
        if not (line["greedy_equal"] and line["beam_equal"] and x.tolist() == [2.0] * 4):
            raise AssertionError(f"scaleout_nccl at world 1: {line}")
    finally:
        torch.distributed.destroy_process_group()
    TRACE_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TRACE_DIR.parent) as tmp:
        try:
            dup = run_ranks("duplicate", 2, 120, Path(tmp))
            line["two_ranks_one_card"] = [r["result"] for r in dup]
        except (AssertionError, subprocess.TimeoutExpired) as e:
            line["two_ranks_one_card"] = f"{type(e).__name__}: {str(e)[:400]}"
        if world >= 2:
            ranks = run_ranks("nccl", world - world % 2, 900, Path(tmp))
            line["multi_card"] = ranks
            if not all(r["greedy_equal"] and r["beam_equal"] for r in ranks):
                raise AssertionError(f"scaleout_nccl: replayed tokens differ from the eager body's: {ranks}")
        else:
            line["multi_card"] = "not run: one card (tp >= 2 over NCCL needs one rank a card)"
    return line


def rank_main(argv: list) -> int:
    """``chip_smoke.py --rank MODE RANK WORLD PORT OUT``: one rank of a
    scale-out phase."""
    mode, rank, world, port, out = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), Path(argv[4])
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    if mode == "duplicate":
        duplicate_rank(rank, world, port, out)
    else:
        {"scaleout": scaleout_rank, "nccl": nccl_rank, "serving_mesh": serving_mesh_rank}[mode](rank, world, port, out)
    return 0


def is_decode_row(row: dict) -> bool:
    return not any(stage in row["name"] for stage in ("prefill", "encoder", "cross_fill"))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import whisper_burn_tpu_torch  # noqa: F401  (fails outside a checkout)
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.entry import MAX_TOKENS as ENTRY_TOKENS
    from whisper_burn_tpu_torch.entry import entry
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.models.params import device_fabricated_params, params_to_torch
    from whisper_burn_tpu_torch.models.whisper import cached_runners, clear_runners
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.cache import BEAM_FN as SLOT_BEAM
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.ops.ffn_kernel import _UNITS
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
    serving = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
    int8 = Compute.fastest().replace(quantized_logits=True, w8a8=True)
    fast = Compute.fast()
    int4self, mixed = serving.replace(self_kv_bits=4), serving.replace(self_kv_vbits=4)
    raw = device_fabricated_params(cfg, seed=SEED, device="cuda")  # the pipeline prepares its own
    params = prepare_params(raw, serving)  # serves every cache mode: prepare_params reads none
    fast_params = prepare_params(raw, fast)  # Q4 encoder weights (no W8A8 copies), bf16 embedding
    torch.cuda.synchronize()
    phases["params_s"] = time.perf_counter() - t0
    log({"phase": "params", "seconds": phases["params_s"],
         "device_bytes": torch.cuda.memory_allocated()})

    # the timed requests of every path run before any profiler session
    # (the kernel times and the traced requests below use torch.profiler)
    mel_frontend = MelFrontend(n_mels=cfg.n_mels, norm="slaney")
    mel_frontend(torch.zeros((1, 16_000), device="cuda"))  # its bases go to the card once
    audios = []
    for r in range(REQUESTS):
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 1 + r)
        audios.append(torch.randn((BATCH, 480_000), generator=g, device="cuda") * 0.1)
    paths = [
        audio_path("greedy", params, cfg, serving, mel_frontend, audios, requests=REQUESTS),
        audio_path("beam", params, cfg, serving, mel_frontend, audios, beam=True, requests=REQUESTS),
        audio_path("int8_greedy", params, cfg, int8, mel_frontend, audios),
        audio_path("int8_beam", params, cfg, int8, mel_frontend, audios, beam=True),
        audio_path("fast_greedy", fast_params, cfg, fast, mel_frontend, audios),
        audio_path("fast_beam", fast_params, cfg, fast, mel_frontend, audios, beam=True),
        audio_path("int4self_greedy", params, cfg, int4self, mel_frontend, audios),
        audio_path("int4self_beam", params, cfg, int4self, mel_frontend, audios, beam=True),
        audio_path("mixed_greedy", params, cfg, mixed, mel_frontend, audios),
        audio_path("mixed_beam", params, cfg, mixed, mel_frontend, audios, beam=True),
    ]
    launches, counts, captured, refs = {}, {}, weakref.WeakSet(), {}

    def serve(path: MainPath, t0: float) -> None:
        """The path's requests, held to their launches, then its eager reference."""
        torch.cuda.reset_peak_memory_stats()
        launches[path.label], counts[path.label], results = run_path(path, path.cfg or cfg)
        phases[f"{path.label}_path_s"] = time.perf_counter() - t0
        log({"phase": f"{path.label}_path", "seconds": phases[f"{path.label}_path_s"],
             "launches": launches[path.label], "peak_device_bytes": torch.cuda.max_memory_allocated()})
        made = log_captures(path.label, captured)
        if path.eager is not None:
            t0 = time.perf_counter()
            line, refs[path.label] = eager_check(path, results)
            log(line)
            phases[f"{path.label}_eager_check_s"] = time.perf_counter() - t0
            made += log_captures(path.label, captured)
        # one runner serves every request of a shape: greedy and the entry
        # make one, the other paths one more for their 32-token check
        want = 1 if path.label in ("greedy", "entry") else 2
        if made != want:
            raise AssertionError(f"{path.label}: {made} runners captured, expected {want}")

    for path in paths:
        serve(path, time.perf_counter())
    t0 = time.perf_counter()
    fn, args = entry()  # the flagship step as a user calls it
    torch.cuda.synchronize()
    phases["entry_setup_s"] = time.perf_counter() - t0
    serve(MainPath("entry", lambda r: fn(*args), fast, batch=1, max_tokens=ENTRY_TOKENS, requests=REQUESTS,
                   eager=lambda r, max_tokens: eager_greedy(args[0], cfg, args[1], args[2], fast, max_tokens)), t0)
    del fn, args
    # the pipeline in the int4 self mode, and kernel D' through its op
    for label, run in (("pipeline", lambda: pipeline_path(raw, cfg, int4self)),
                       ("encoder_attention_heads", encoder_heads_path), ("medium_ffn", lambda: medium_ffn_path(cfg))):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        launches[label], counts[label] = run()
        phases[f"{label}_path_s"] = time.perf_counter() - t0
        log({"phase": f"{label}_path", "seconds": phases[f"{label}_path_s"], "launches": launches[label],
             "peak_device_bytes": torch.cuda.max_memory_allocated()})
        if log_captures(label, captured) != (2 if label == "pipeline" else 0):  # the pipeline's buckets 8 and 4
            raise AssertionError(f"{label}: runners captured other than one per batch shape")
    del raw
    torch.cuda.empty_cache()

    # phase 3a: Whisper Medium, fabricated on the card for the serving compute
    t0 = time.perf_counter()
    mcfg = WhisperConfig.medium()
    mparams = prepare_params(device_fabricated_params(mcfg, seed=SEED, device="cuda"), serving)
    mel80 = MelFrontend(n_mels=mcfg.n_mels, norm="slaney")
    mel80(torch.zeros((1, 16_000), device="cuda"))
    torch.cuda.synchronize()
    phases["medium_params_s"] = time.perf_counter() - t0
    presets = [audio_path("medium_greedy", mparams, mcfg, serving, mel80, audios),
               audio_path("medium_beam", mparams, mcfg, serving, mel80, audios, beam=True)]
    for path in presets:
        serve(path, time.perf_counter())
    # phase 3b: a Large-V3-Turbo checkpoint written, loaded cold and warm
    # through the repacked cache, then served from what it loaded
    t0 = time.perf_counter()
    tcfg = WhisperConfig.large_v3_turbo()
    TRACE_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TRACE_DIR.parent) as tmp:  # removed on the way out, failed or not
        loaded = loader_phase(Path(tmp), tcfg)
        traw = params_to_torch(loaded.params, "cuda")
        del loaded
        tparams = prepare_params(traw, serving)
        torch.cuda.synchronize()
        phases["loader_s"] = time.perf_counter() - t0
        presets += [audio_path("turbo_greedy", tparams, tcfg, serving, mel_frontend, audios),
                    audio_path("turbo_beam", tparams, tcfg, serving, mel_frontend, audios, beam=True)]
        for path in presets[2:]:
            serve(path, time.perf_counter())
        del tparams  # its paths hold it
        # phase 3c: the warm Turbo model served in process and over HTTP,
        # then the CLI on its checkpoint
        t0 = time.perf_counter()
        reply = serving_phase(Path(tmp), traw, tcfg, captured)
        phases["serving_s"] = time.perf_counter() - t0
        del traw
        # phase 3d: serve over a mesh of two ranks sharing the card, then
        # over NCCL at world 1, on the same checkpoint
        t0 = time.perf_counter()
        line = serving_mesh_phase(Path(tmp), Path(tmp) / "whisper-large-v3-turbo.gguf", tcfg, reply)
        phases["serving_mesh_s"] = time.perf_counter() - t0
        log({"phase": "serving_mesh", "seconds": phases["serving_mesh_s"], **line})
    # kernel I's second, unit-blocked copy of each decoder stack's FFN
    # weights (made at a runner's eager first step, kept while they live)
    copies = [u for _, _, u in _UNITS.values()]
    log({"phase": "kernel_i_unit_copies", "copies": [
        {"layers": u.shape[0], "k": u.shape[2] * 32, "n": u.shape[1] * 16, "bytes": u.nbytes} for u in copies]})

    # phase 7: scale-out. NCCL at the world the box has (the serving
    # runners' greedy and beam at B = 8, 224 tokens), then two ranks
    # sharing the card over gloo; their (1, 2) runs give the tp = 2 rows'
    # launches
    t0 = time.perf_counter()
    nccl_line = scaleout_nccl_phase(params, cfg, mel_frontend(audios[0]), lang_tokens(cfg, BATCH), serving)
    phases["scaleout_nccl_s"] = time.perf_counter() - t0
    log({**nccl_line, "seconds": phases["scaleout_nccl_s"]})
    t0 = time.perf_counter()
    shared_line, launches["scaleout_shared"], counts["scaleout_shared"] = scaleout_shared_phase()
    counts["tp4_shard"] = {}
    phases["scaleout_shared_s"] = time.perf_counter() - t0
    log({**shared_line, "seconds": phases["scaleout_shared_s"], "launches": launches["scaleout_shared"]})

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    rows = kernel_checks(params, cfg, gen)
    rows += beam_kernel_checks(params, cfg, gen) + mode_kernel_checks(fast_params, cfg, gen) + int4_kernel_checks(cfg, gen)
    rows += pipeline_kernel_checks(params, cfg, gen)
    rows += kernel_f_checks(cfg, gen, {**{p.label: p.compute for p in paths}, "entry": fast, "pipeline": int4self})
    rows += medium_kernel_checks(mparams, mcfg, gen, serving)
    phases["kernels_s"] = time.perf_counter() - t0
    log({"phase": "kernels", "seconds": phases["kernels_s"]})
    t0 = time.perf_counter()
    rows += tp_kernel_checks(params, cfg, gen)
    phases["tp_kernels_s"] = time.perf_counter() - t0
    log({"phase": "tp_kernels", "seconds": phases["tp_kernels_s"]})
    sigs, rows_by_key = {}, {}
    for row in rows:
        key = json.dumps(row["shape_key"])
        row["launches"] = counts[row["path"]].get(key, 0)
        if row["launches"] <= 0 and not row.get("off_path"):
            raise AssertionError(f"{row['name']} ({key}) was not launched on the {row['path']} path, "
                                 f"which launched {sorted(counts[row['path']])}")
        (sig,) = row.pop("sig")
        # a pipeline row may share its key with the row of a traced path,
        # which keeps it (the same kernel at the same shape and grid)
        sigs.setdefault(key, sig)
        rows_by_key.setdefault(key, row)

    by_label = {p.label: p for p in paths}
    traced, replays = {}, {}
    for label, tokens in (("greedy", MAX_TOKENS), ("beam", TRACED_TOKENS), ("fast_greedy", TRACED_TOKENS),
                          ("fast_beam", TRACED_TOKENS), ("int4self_greedy", TRACED_TOKENS)):
        t0 = time.perf_counter()
        *traced[label], res = traced_path(by_label[label], cfg, sigs, tokens)
        phases[f"traced_{label}_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        replays[label] = traced_replay(by_label[label], cfg, tokens, res)
        phases[f"traced_replay_{label}_s"] = time.perf_counter() - t0
        del res
    # the other beam paths' and Medium's and Turbo's replayed steps, held
    # to their eager references
    by_label.update((p.label, p) for p in presets)
    for label in ("int8_beam", "int4self_beam", "mixed_beam", *(p.label for p in presets)):
        t0 = time.perf_counter()
        path = by_label[label]
        replays[label] = traced_replay(path, path.cfg or cfg, TRACED_TOKENS, refs[label], r=path.requests - 1)
        phases[f"traced_replay_{label}_s"] = time.perf_counter() - t0
    del refs
    for row in rows:
        bound_of_pos = row.pop("bound_of_pos", None)
        key = json.dumps(row.pop("shape_key"))
        if row["path"] not in traced:
            row["ms"], row["ms_source"] = row["isolated_ms"], "isolated (no traced request on its path)"
            continue
        durations, bd = traced[row["path"]]
        parents = bd.get("distinct_parents")
        if bound_of_pos is not None and parents and key.startswith(f'["{SLOT_BEAM}"'):
            # kernel F's beam form at each traced step's slot 3 + k and parents
            per_step = [bound_of_pos(3 + k, n)[0] for k, n in enumerate(parents, 1)]
            row["bound_ms"], row["bound_by"] = sum(per_step) / len(per_step), "bytes"
        elif bound_of_pos is not None:  # the bound at the traced run's positions
            row["bound_ms"], row["bound_by"] = bound_of_pos(mean_decode_pos(bd["decode_steps"]))
        durs = durations[key]
        row["ms"], row["ms_source"] = sum(durs) / len(durs) / 1e3, "traced request"  # mean per launch
    for label, (_, bd) in traced.items():
        path = by_label[label]
        steps = launches[label][self_kernel(path.compute, path.beam)] / L
        bd["bound_ms_per_decode_step"] = sum(
            rows_by_key[k]["bound_ms"] * n for k, n in counts[label].items()
            if k in rows_by_key and is_decode_row(rows_by_key[k])
        ) / steps
        log({"phase": f"traced_{label}", "seconds": phases[f"traced_{label}_s"], **bd})
    for label, replay in replays.items():
        log({"phase": f"traced_replay_{label}", "seconds": phases[f"traced_replay_{label}_s"], **replay})
    # the encoder's device ms of each traced request: serving (greedy,
    # beam, int4self_greedy; W8A8) and fast() (fast_greedy, fast_beam)
    log({"phase": "encoder_device_ms", **{label: bd["stages"]["device_ms"]["encode"] for label, (_, bd) in traced.items()}})
    # the device memory with every cached runner alive (each holds its
    # caches, its graph's pool and its params): the RUNNERS_KEPT runners
    # used last, by the traced and replayed requests, then the runners go
    # with the params
    log({"phase": "device_memory", "runners": len(cached_runners()), "allocated_bytes": torch.cuda.memory_allocated(),
         "max_memory_allocated": torch.cuda.max_memory_allocated(),
         "cached": [{"d": r.cfg.n_text_state, "decoder_layers": r.cfg.n_text_layer, "batch": r.batch, "ctx": r.ctx,
                     "max_tokens": r.max_tokens, "beam_width": getattr(r, "beam_width", None)}
                    for r in cached_runners()]})
    clear_runners()
    del params, fast_params, mparams
    torch.cuda.empty_cache()

    for label, compute in (
        ("int4", serving.replace(w8a8=False, dtype=torch.float32)),
        ("parity", Compute.parity()),
        ("int8", Compute.fastest().replace(dtype=torch.float32)),
        ("int4self", int4self.replace(w8a8=False, dtype=torch.float32)),
        ("mixed", mixed.replace(w8a8=False, dtype=torch.float32)),
    ):
        # f32; W8A8 off: its per-row int8 rounding turns one-ulp differences
        # at a rounding tie into a whole code step (tests/test_torch_slice.py)
        t0 = time.perf_counter()
        small = small_end_to_end(compute)
        phases[f"small_e2e_{label}_s"] = time.perf_counter() - t0
        log({"phase": f"small_end_to_end_{label}", "seconds": phases[f"small_e2e_{label}_s"], **small})
    # the accuracy tooling: every serving variant teacher-forced against
    # the f32 reference at Large-V3 width and depth, held to the floors
    t0 = time.perf_counter()
    acc = accuracy_phase(cfg)
    phases["accuracy_s"] = time.perf_counter() - t0
    log({"phase": "accuracy", "seconds": phases["accuracy_s"], **acc})
    log({"phase": "device_memory", "after": "accuracy", "runners": len(cached_runners()),
         "allocated_bytes": torch.cuda.memory_allocated(), "max_memory_allocated": torch.cuda.max_memory_allocated()})
    phases["total_s"] = time.perf_counter() - t_all
    log({"phases": phases})

    rows += layer_norm_rows(gen, counts)
    log({"kernels": rows})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--rank"] else main())
