"""Device time of kernel I (the fused Q4 FFN) of this checkout beside an
older checkout's kernel I, kernel A's two launches it replaced and the
library pair, at the decode, prefill and encoder shapes of Large-V3's FFN,
on one CUDA card.

    python3 scripts/torch_ffn_times.py <older_checkout>

Builds this checkout's kernels, and the older checkout's ``csrc/ffn.cu``
into ``build/variants/`` (the C interface of the earlier split-F kernel:
``ffn_plan`` gives the splits of F and a workspace, ``fused_ffn`` takes
them with zeroed counters). For each shape it times, with CUDA events over
256 launches that cycle 32 layers of stacked weights (so the weights come
from HBM, not from L2), in this order: the older kernel I, kernel I,
kernel I again, the older kernel I again; then kernel A's two launches
(fc1 with the bias+GELU epilogue, then fc2 with +bias) and the library
pair (``torch.matmul`` on
the pre-dequantized bf16 weights of the layer, the GELU, ``torch.matmul``;
no biases). A sleep kernel queued first lets the host run ahead, so the
events bracket the launches back to back (the gap between launches, about
1.5 µs, is in the time); the host's µs to issue one call of each kernel I
are read meanwhile. x is bf16 as on the main paths; inputs come from seed
0, and both kernels' outputs are held to each other. Prints one JSON line:
the card, µs per launch by shape and form, host µs per call, each shape's
plan, and ptxas's registers and spill bytes of each kernel-I instance.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from torch_q4_matmul_times import card, ptxas_report, time_us

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

L, D, FFN = 32, 1280, 5120
# (shape, rows, K4's bias order): PERF.md's kernel-I rows
SHAPES = [("greedy_decode", 8, True), ("beam_decode", 40, True), ("entry_decode", 1, True),
          ("pipeline_decode", 4, True), ("prefill", 32, False), ("entry_prefill", 4, False),
          ("pipeline_prefill", 16, False), ("entry_encoder", 1536, False)]


def older_kernel(root: Path):
    """The older checkout's kernel I, built and bound: ``call(x, fc1, fc2,
    layer, after, out)``."""
    from whisper_burn_tpu_torch.ops import _build

    src = root / "whisper_burn_tpu_torch" / "csrc" / "ffn.cu"
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libffn_older-{hashlib.sha256(src.read_bytes()).hexdigest()[:12]}.so"
    if not lib_path.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                       capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = _build.declare(lib, "fused_ffn", [p, i, p, p, p, p, p, p, p, p, ll, p, i, i, i, i, i, i, p])
    plan = _build.declare(lib, "ffn_plan", [i, i, i, i, p])
    state = {}

    def call(x, fc1, fc2, layer, after, out):
        m = x.shape[0]
        if m not in state:
            pl = (ctypes.c_longlong * 5)()
            _build.check(plan(m, D, FFN, 1, ctypes.addressof(pl)), "ffn_plan (older)")
            state[m] = (pl[1], torch.empty((max(pl[4], 4),), device="cuda"),
                        torch.zeros((pl[2] * pl[0],), dtype=torch.int32, device="cuda"))
        nsplit, ws, counters = state[m]
        err = launch(x.data_ptr(), 1, fc1["qw"][layer].data_ptr(), fc1["scales"][layer].data_ptr(),
                     fc1["b"][layer].data_ptr(), fc2["qw"][layer].data_ptr(), fc2["scales"][layer].data_ptr(),
                     fc2["b"][layer].data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), counters.data_ptr(),
                     m, D, FFN, nsplit, 0, int(after), _build.stream_ptr(x.device))
        _build.check(err, "fused_ffn (older)")
        return out

    return call


def host_us(call, layers: int, calls: int) -> float:
    """The host's µs to issue one call while the card is busy."""
    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)
    t0 = time.perf_counter()
    for i in range(calls):
        call(i % layers)
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_ffn_times: no CUDA device", file=sys.stderr)
        return 1
    from whisper_burn_tpu_torch.ops import _build, ffn_kernel, q4_kernel

    _build.build_all()
    older = older_kernel(Path(sys.argv[1]).resolve())
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (L, k, n), generator=g, device="cuda", dtype=torch.int8),
                "scales": torch.rand((L, k // 32, n), generator=g, device="cuda") * 0.01,
                "b": torch.randn((L, n), generator=g, device="cuda") * 0.1}

    fc1, fc2 = lin(D, FFN), lin(FFN, D)
    w16 = [(q4_kernel.dequant_weight(fc1["qw"][l], fc1["scales"][l], torch.bfloat16),
            q4_kernel.dequant_weight(fc2["qw"][l], fc2["scales"][l], torch.bfloat16)) for l in range(L)]
    out = {"card": card(), "us": {}, "host_us": {}, "plans": {}, "older_max_abs_diff": {}}
    report = _build._target(ffn_kernel.LIB).with_suffix(".log")
    if report.exists():
        out["ptxas"] = ptxas_report(report.read_text())
    for shape, m, after in SHAPES:
        x = torch.randn((m, D), generator=g, device="cuda").to(torch.bfloat16)
        old_out = torch.empty((m, D), dtype=torch.bfloat16, device="cuda")

        def two_launch(layer):
            h = q4_kernel.q4_matmul(x, fc1["qw"], fc1["scales"], layer=layer, bias=fc1["b"], gelu="tanh")
            return q4_kernel.q4_matmul(h, fc2["qw"], fc2["scales"], layer=layer, bias=fc2["b"])

        def kernel_i(layer):
            return ffn_kernel.fused_ffn(x, fc1, fc2, "tanh", layer=layer, bias_after_round=after)

        def older_i(layer):
            return older(x, fc1, fc2, layer, after, old_out)

        def library(layer):
            w1, w2 = w16[layer]
            return torch.matmul(ffn_kernel.gelu(torch.matmul(x, w1), "tanh"), w2)

        diff = (kernel_i(3).float() - older_i(3).float()).abs().max().item()
        times = {}
        for form, call in (("older", older_i), ("kernel_i", kernel_i), ("kernel_i_2", kernel_i),
                           ("older_2", older_i), ("two_launch", two_launch), ("library", library)):
            times[form] = time_us(call, L, 256)
        out["us"][shape] = times
        out["host_us"][shape] = {"older": host_us(older_i, L, 64), "kernel_i": host_us(kernel_i, L, 64)}
        out["plans"][shape] = ffn_kernel._plan(x.device, m, D, FFN, True)[0]
        out["older_max_abs_diff"][shape] = diff
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
