"""Where a launch of kernel I (the fused Q4 FFN) spends its time, phase by
phase, on one CUDA card.

    python3 scripts/torch_ffn_phases.py <checkout>

Builds a copy of the checkout's ``csrc/ffn.cu`` into ``build/variants/``
with thread 0 of every block writing the card's global timer (ns) at each
phase of the kernel. Decode regime: start, copies issued, fc1 done (every
residue's sums in shared memory), g written, grid barrier passed, W2 waited
for, fc2 done (the warps' sums in shared memory), output written; the fc2
blocks and the fc1-only blocks apart. Encoder
regime: start, fc1 tiles done, grid barrier passed, fc2 tiles done. It
runs the kernel at Large-V3's FFN (1280 <-> 5120, bf16, K4's bias order) at
1, 8 and 40 rows and at 1536 (K7's order), 40 launches cycling 32 layers
each (the stamps of the last launch are kept), and times each shape with
CUDA events over 256 launches. Prints one JSON line per shape: µs per
launch, and for each phase the min, median and max over the blocks that
reach it of µs since the first block started, and their count; and the
median SM clock (MHz) over a block's launch, from ``clock64`` against the
global timer.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from torch_q4_matmul_times import card, time_us

L, D, F = 32, 1280, 5120
DECODE = ["start", "copies_issued", "fc1_done", "g_written", "barrier_passed", "w2_landed", "fc2_done",
          "out_written"]
DECODE_SLOTS = list(range(8))
ENCODER = ["start", "fc1_tiles_done", "barrier_passed", "fc2_tiles_done"]
# (code the stamp follows or precedes, slot): decode slots 0-7, encoder 8-11
AFTER = [
    ("  const DecLayout L = dec_layout(blockIdx.x, D, F, a.C, a.e);\n", 0),
    ("    __syncthreads();  // every residue's sums are in P\n", 2),
    ("  grid_sync(a.bar, target);  // all of g is written\n", 4),
    ("  mbar_wait(&bars[nparts], 0);\n", 5),
    ("      store(out + (size_t)(m0 + r) * D + n0 + c, finish<BF>(v, b2s[c], a.bias_after_round));\n    }\n", 7),
    ("  const int M = a.M, tm = (M + BM - 1) / BM;\n", 8),
    ("      grid_sync(a.bar, target);\n", 10),
    ("    gq0 += Q;\n", 11),
]
BEFORE = [
    ("  const T* x = static_cast<const T*>(a.x);\n", 1),
    ("  grid_sync(a.bar, target);  // all of g is written\n", 3),
    ("    for (int idx = tid; idx < rows * UNIT; idx += THREADS) {\n", 6),
    ("    if (phase == 1) {  // g complete in every block before any of it is read\n", 9),
]
HEADER = """
__device__ unsigned long long ffn_phase_stamp[1024][32];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
  ffn_phase_stamp[blockIdx.x][i] = t_; ffn_phase_stamp[blockIdx.x][16 + (i)] = clock64(); } } while (0)
extern "C" int ffn_phase_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, ffn_phase_stamp, sizeof(ffn_phase_stamp));
}
"""


def instrumented(src: str) -> str:
    src = src.replace("namespace {\n", HEADER + "\nnamespace {\n", 1)
    for anchor, i in AFTER + BEFORE:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_ffn_phases: anchor for slot {i} found {src.count(anchor)} times in ffn.cu")
    for anchor, i in AFTER:
        src = src.replace(anchor, anchor + f"  STAMP({i});\n")
    for anchor, i in BEFORE:
        src = src.replace(anchor, f"  STAMP({i});\n" + anchor)
    return src


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_ffn_phases: no CUDA device", file=sys.stderr)
        return 1
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    from whisper_burn_tpu_torch.ops import _build, ffn_kernel

    out_dir = root / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "ffn_phases.cu"
    src.write_text(instrumented((root / "whisper_burn_tpu_torch" / "csrc" / "ffn.cu").read_text()))
    lib_path = out_dir / "libffn_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = _build.declare(lib, "fused_ffn", [p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p])
    stamps = _build.declare(lib, "ffn_phase_stamps", [p])

    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (L, k, n), generator=g, device="cuda", dtype=torch.int8),
                "scales": torch.rand((L, k // 32, n), generator=g, device="cuda") * 0.01,
                "b": torch.randn((L, n), generator=g, device="cuda") * 0.1}

    fc1, fc2 = lin(D, F), lin(F, D)
    units = [ffn_kernel._units(fc1["qw"], fc1["scales"]), ffn_kernel._units(fc2["qw"], fc2["scales"])]
    print(json.dumps({"card": card()}), flush=True)
    for m, after in ((1, True), (8, True), (40, True), (1536, False)):
        x = torch.randn((m, D), generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty((m, D), dtype=torch.bfloat16, device="cuda")
        plan, _, _ = ffn_kernel._plan(x.device, m, D, F, True)
        scratch = torch.empty((plan["scratch"],), dtype=torch.bfloat16, device="cuda")
        barrier = torch.zeros((1,), dtype=torch.int64, device="cuda")

        def call(layer):
            err = launch(x.data_ptr(), 1, fc1["qw"][layer].data_ptr(), fc1["scales"][layer].data_ptr(),
                         fc1["b"][layer].data_ptr(), fc2["qw"][layer].data_ptr(), fc2["scales"][layer].data_ptr(),
                         fc2["b"][layer].data_ptr(), *(u[layer].data_ptr() for u in units), out.data_ptr(),
                         scratch.data_ptr(), barrier.data_ptr(),
                         m, D, F, 0, int(after), _build.stream_ptr(x.device))
            _build.check(err, "fused_ffn (phases)")

        for layer in range(40):
            torch.cuda._sleep(1_000_000)  # launches apart: each one's stamps are its own
            call(layer % L)
        torch.cuda.synchronize()
        buf = np.zeros((1024, 32), np.uint64)
        _build.check(stamps(buf.ctypes.data), "ffn_phase_stamps")
        names, slots = (ENCODER, range(8, 12)) if plan["regime"] else (DECODE, DECODE_SLOTS)
        blocks = buf[: plan["blocks"], list(slots)].astype(np.float64)
        t0 = blocks[:, 0].min()
        row = {"rows": m, "plan": plan, "us_per_launch": time_us(call, L, 256)}
        # the SM clock over each block's launch: clock64 against the global timer, first to last stamp
        last = 7 if not plan["regime"] else 11
        ns = buf[: plan["blocks"], last].astype(np.float64) - buf[: plan["blocks"], slots[0]].astype(np.float64)
        cyc = buf[: plan["blocks"], 16 + last].astype(np.float64) - buf[: plan["blocks"], 16 + slots[0]].astype(np.float64)
        ok = ns > 0
        if ok.any():
            row["sm_mhz"] = float(np.median(cyc[ok] / ns[ok] * 1e3))
        # decode: the fc2 blocks (the first D / 16) and the fc1-only blocks apart
        groups = {"all": blocks} if plan["regime"] else {"fc2_blocks": blocks[: D // 16], "fc1_blocks": blocks[D // 16:]}
        for group, rows in groups.items():
            row[group] = {}
            for k, name in enumerate(names):
                col = rows[:, k]
                col = (col[col >= t0] - t0) / 1e3  # blocks that reach the phase in the last launch
                if len(col):
                    row[group][name] = [float(np.min(col)), float(np.median(col)), float(np.max(col)), int(len(col))]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
