"""Where a launch of kernel I (the fused Q4 FFN) spends its time, phase by
phase, on one CUDA card.

    python3 scripts/torch_ffn_phases.py <checkout>

Builds a copy of the checkout's ``csrc/ffn.cu`` into ``build/variants/``
with thread 0 of every block writing the card's global timer (ns) at each
phase of the kernel: start, its warp's W1 rows landed, fc1 done, g
exchanged (the cluster barrier after GELU), G gathered, W2 rows landed,
fc2 done, its sums in shared memory, the exit barrier passed, and for the
last split to arrive the start and end of the splits' sum. It runs the
kernel at Large-V3's FFN (1280 <-> 5120, bf16, K4's bias order) at 1, 8
and 40 rows, 40 launches cycling 32 layers each (the stamps of the last
launch are kept), and times each shape with CUDA events over 256
launches. Prints one JSON line per shape: µs per launch, and for each
phase the min, median and max over the blocks of µs since the first
block started (on a block of several steps, the last step's stamps).
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
PHASES = ["start", "w1_landed", "fc1_done", "g_exchanged", "g_gathered", "w2_landed", "fc2_done",
          "sums_in_smem", "exit_barrier", "last_split_sum", "last_split_done"]
# (code the stamp follows, phase index)
AFTER = [
    ("  Smem<T, MT> sm(smem_raw, D, cs, ks);\n", 0),
    ("      wait_own(sc1w);  // W1(s)\n", 1),
    ("    cluster.sync();  // every block's g is in place (and P is read)\n", 3),
    ("    __syncthreads();  // G complete\n", 4),
    ("    wait_own(sc2w);  // W2(s)\n", 5),
    ("  __syncthreads();  // the sums are in P\n", 7),
    ('  asm volatile("barrier.cluster.wait.acquire.aligned;\\n" ::: "memory");\n', 8),
    ("  if (!*sm.flag) return;\n", 9),
]
BEFORE = [
    ("    // this warp's W1 rows are read: they take the next step's\n", 2),
    ("    // this warp's W2 rows are read: they take the next step's\n", 6),
    ("  if (tid == 0) *counter = 0u;", 10),
]
HEADER = """
__device__ unsigned long long ffn_phase_stamp[8192][16];
#define STAMP(i) do { if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
  ffn_phase_stamp[blockIdx.x + gridDim.x * blockIdx.y][i] = t_; } } while (0)
extern "C" int ffn_phase_stamps(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, ffn_phase_stamp, sizeof(ffn_phase_stamp));
}
"""


def instrumented(src: str) -> str:
    src = src.replace("namespace cg = cooperative_groups;\n", "namespace cg = cooperative_groups;\n" + HEADER, 1)
    for anchor, i in AFTER + BEFORE:  # (the W1 wait is in the bf16 and the f32 branch)
        if not src.count(anchor):
            raise SystemExit(f"torch_ffn_phases: no anchor for phase {PHASES[i]} in ffn.cu")
        stamp = f"  STAMP({i});\n"
        src = src.replace(anchor, anchor + stamp if (anchor, i) in AFTER else stamp + anchor)
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
    from whisper_burn_tpu_torch.ops import _build

    out_dir = root / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "ffn_phases.cu"
    src.write_text(instrumented((root / "whisper_burn_tpu_torch" / "csrc" / "ffn.cu").read_text()))
    lib_path = out_dir / "libffn_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = _build.declare(lib, "fused_ffn", [p, i, p, p, p, p, p, p, p, p, ll, p, i, i, i, i, i, i, p])
    plan = _build.declare(lib, "ffn_plan", [i, i, i, i, p])
    stamps = _build.declare(lib, "ffn_phase_stamps", [p])

    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (L, k, n), generator=g, device="cuda", dtype=torch.int8),
                "scales": torch.rand((L, k // 32, n), generator=g, device="cuda") * 0.01,
                "b": torch.randn((L, n), generator=g, device="cuda") * 0.1}

    fc1, fc2 = lin(D, F), lin(F, D)
    print(json.dumps({"card": card()}), flush=True)
    for m in (1, 8, 40):
        x = torch.randn((m, D), generator=g, device="cuda").to(torch.bfloat16)
        out = torch.empty((m, D), dtype=torch.bfloat16, device="cuda")
        pl = (ctypes.c_longlong * 5)()
        _build.check(plan(m, D, F, 1, ctypes.addressof(pl)), "ffn_plan")
        cs, nsplit, tiles = pl[0], pl[1], pl[2]
        ws = torch.empty((max(pl[4], 4),), device="cuda")
        counters = torch.zeros((tiles * cs,), dtype=torch.int32, device="cuda")

        def call(layer):
            err = launch(x.data_ptr(), 1, fc1["qw"][layer].data_ptr(), fc1["scales"][layer].data_ptr(),
                         fc1["b"][layer].data_ptr(), fc2["qw"][layer].data_ptr(), fc2["scales"][layer].data_ptr(),
                         fc2["b"][layer].data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(), counters.data_ptr(),
                         m, D, F, nsplit, 0, 1, _build.stream_ptr(x.device))
            _build.check(err, "fused_ffn (phases)")

        for layer in range(40):
            torch.cuda._sleep(1_000_000)  # launches apart: each one's stamps are its own
            call(layer % L)
        torch.cuda.synchronize()
        buf = np.zeros((8192, 16), np.uint64)
        _build.check(stamps(buf.ctypes.data), "ffn_phase_stamps")
        blocks = buf[: cs * nsplit * tiles, : len(PHASES)].astype(np.float64)
        t0 = blocks[:, 0].min()
        row = {"rows": m, "splits": nsplit, "us_per_launch": time_us(call, L, 256)}
        for k, name in enumerate(PHASES):
            col = blocks[:, k]
            # a phase only the last split reaches keeps older launches' stamps elsewhere
            col = (col[col >= t0] - t0) / 1e3
            if len(col):
                row[name] = [float(np.min(col)), float(np.median(col)), float(np.max(col)), int(len(col))]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
