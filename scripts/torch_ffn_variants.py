"""What each part of kernel I (the fused Q4 FFN) costs, from timing-only
variants of its source, on one CUDA card.

    python3 scripts/torch_ffn_variants.py <checkout>

Builds the checkout's ``csrc/ffn.cu`` and variants of it with one part
removed (their outputs are wrong on purpose; each is held to the plain
version only to show which are) into ``build/variants/``, all compiled
in parallel, and times each with CUDA events over 256 launches that cycle
32 layers of Large-V3's FFN (1280 <-> 5120, bf16, weights from HBM):

* decode regime, at 8 and 40 rows (K4's bias order): ``no_fc2`` (fc2's
  products skipped), ``no_fc2_loads`` (fc2's products on zero rows, g
  never read), ``no_barrier`` (the grid barrier a block barrier);
* encoder regime, at 1536 rows (K7's order): ``no_dequant``, ``no_wgmma``,
  ``no_dequant_no_wgmma`` (the TMA stream, barriers and epilogues alone).

Prints one JSON line per variant and shape: µs per launch and the error
against the plain version (relative to max|out|).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from torch_q4_matmul_times import card, time_us

L, D, F = 32, 1280, 5120
FC2 = "          gs + (size_t)m0 * F, F, rows, sm + L.w2, 0, 1, warp, WARPS, nkb2, Q, UNIT, nullptr, 1);"
BARRIER = "  grid_sync(a.bar, target);  // all of g is written"
DEQUANT = ("      dequant(slot + A_BYTES, reinterpret_cast<const float*>(slot + A_BYTES + BQ_BYTES), "
           "bbf + (q & 1) * NP * PANEL);")
WGMMA = ("      for (int kk = 0; kk < BK / 16; ++kk) wgmma_n128(acc[0], acc[1], gdesc(A + kk * 32), "
         "gdesc_n128(B + kk * 16 * 64));")
# (variant, rows it is timed at, [(code, its replacement)])
VARIANTS = [
    ("source", (8, 40, 1536), []),
    ("no_fc2", (8, 40), [("  const int nkb2 = F / 32 / WARPS;", "  const int nkb2 = 0;")]),
    ("no_fc2_loads", (8, 40), [(FC2, FC2.replace("F, rows,", "F, 0,"))]),
    ("no_barrier", (8, 40), [(BARRIER, "  __syncthreads();")]),
    ("no_dequant", (1536,), [(DEQUANT, "")]),
    ("no_wgmma", (1536,), [(WGMMA, "      for (int kk = 0; kk < BK / 16; ++kk) acc[0][kk] += 1.f;")]),
    ("no_dequant_no_wgmma", (1536,), [(DEQUANT, ""),
                                       (WGMMA, "      for (int kk = 0; kk < BK / 16; ++kk) acc[0][kk] += 1.f;")]),
]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_ffn_variants: no CUDA device", file=sys.stderr)
        return 1
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    from whisper_burn_tpu_torch.ops import _build, ffn_kernel

    source = (root / "whisper_burn_tpu_torch" / "csrc" / "ffn.cu").read_text()
    out_dir = root / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(variant):
        name, _, edits = variant
        text = source
        for code, replacement in edits:
            if text.count(code) != 1:
                raise SystemExit(f"torch_ffn_variants: {name}: the code it replaces is not in ffn.cu once")
            text = text.replace(code, replacement)
        src, lib = out_dir / f"ffn_{name}.cu", out_dir / f"libffn_{name}.so"
        src.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                       capture_output=True, text=True)
        return lib

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(build, VARIANTS))

    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (L, k, n), generator=g, device="cuda", dtype=torch.int8),
                "scales": torch.rand((L, k // 32, n), generator=g, device="cuda") * 0.01,
                "b": torch.randn((L, n), generator=g, device="cuda") * 0.1}

    fc1, fc2 = lin(D, F), lin(F, D)
    units = [ffn_kernel._units(fc1["qw"], fc1["scales"]), ffn_kernel._units(fc2["qw"], fc2["scales"])]
    print(json.dumps({"card": card()}), flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    for (name, shapes, _), lib in zip(VARIANTS, libs):
        launch = _build.declare(ctypes.CDLL(str(lib)), "fused_ffn", [p, i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, p])
        for m in shapes:
            after = m < 64  # K4's order at the decode shapes, K7's for the encoder's rows
            x = torch.randn((m, D), generator=g, device="cuda").to(torch.bfloat16)
            out = torch.empty((m, D), dtype=torch.bfloat16, device="cuda")
            plan = ffn_kernel._plan(x.device, m, D, F, True)[0]
            scratch = torch.empty((plan["scratch"],), dtype=torch.bfloat16, device="cuda")
            barrier = torch.zeros((1,), dtype=torch.int64, device="cuda")

            def call(layer):
                err = launch(x.data_ptr(), 1, *(w[k][layer].data_ptr() for w in (fc1, fc2) for k in ("qw", "scales", "b")),
                             *(u[layer].data_ptr() for u in units), out.data_ptr(), scratch.data_ptr(),
                             barrier.data_ptr(), m, D, F, 0, int(after), _build.stream_ptr(x.device))
                _build.check(err, f"fused_ffn ({name})")

            call(0)
            ref = ffn_kernel.fused_ffn_plain(x, *(w[k][0] for w in (fc1, fc2) for k in ("qw", "scales", "b")),
                                             "tanh", after)
            err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
            print(json.dumps({"variant": name, "rows": m, "us": time_us(call, L, 256), "rel_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
