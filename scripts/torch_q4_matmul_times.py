"""Device time of kernel A (the Q4 matmul) of one checkout's PyTorch/CUDA
port at every shape of PERF.md's kernel-A rows, on one CUDA card.

    python3 scripts/torch_q4_matmul_times.py <checkout> <label>

Builds the checkout's kernels, then times its ``q4_matmul`` wrapper with
CUDA events over runs of launches that cycle 32 layers of stacked Large-V3
weights (the logits: two copies of the 52224-wide embedding), so the
weights come from HBM and not from L2. A sleep kernel queued first lets the
host run ahead, so the events bracket the launches back to back and host
dispatch is not in the time. x is bf16 as on the main paths; inputs come
from seed 0, so every checkout sees the same ones. Where the checkout's
library has both regimes (``q4_matmul_in_regime``), it also times each
regime at 8, 16, 32, 40 and 63 rows of the decode shapes, which sets the row
threshold between them. Prints one JSON line: the label, the card, µs per
launch by site, the regime each site took, and, where the checkout's build
kept ptxas's report, each kernel instance's registers and spill bytes. To compare two versions,
unpack the older one into a git-ignored directory and run older, newer,
newer, older in one call.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

L, D, VOCAB = 32, 1280, 52224
# (K, N, epilogue, out dtype): the decode step's and the encoder's linears
# (the FFN is kernel I's: scripts/torch_ffn_times.py)
LINEARS = {
    "qkv": (D, 3 * D, "bias", torch.bfloat16),
    "proj": (D, D, "bias", torch.bfloat16),
    "logits": (D, VOCAB, None, torch.float32),
    "cross_kv": (D, 2 * D, "bias", torch.bfloat16),
}
# (site, rows, linear): PERF.md's kernel-A rows
SITES = (
    [(f"greedy_{n}", 8, n) for n in ("qkv", "proj", "logits")]
    + [(f"beam_{n}", 40, n) for n in ("qkv", "proj", "logits")]
    + [(f"prefill_{n}", 32, n) for n in ("qkv", "proj")]
    + [(f"entry_decode_{n}", 1, n) for n in ("qkv", "proj")]
    + [(f"entry_prefill_{n}", 4, n) for n in ("qkv", "proj")]
    + [("pipeline_logits", 4, "logits")]
    + [(f"pipeline_prefill_{n}", 16, n) for n in ("qkv", "proj")]
    + [(f"encoder_{n}", 1536, n) for n in ("qkv", "proj")]
    + [("cross_fill_kv", 1500, "cross_kv")]
)
REGIME_ROWS = (8, 16, 32, 40, 63)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel instance in ptxas's
    verbose report, by demangled name where c++filt is there."""
    out, fn = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            fn = m.group(1)
            out[fn] = {}
        elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn and (m := re.search(r"Used (\d+) registers", line)):
            out[fn]["registers"] = int(m.group(1))
    try:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True, text=True, check=True)
        # "void (anonymous namespace)::q4_matmul_kernel<0, 1, ...>(args)" -> "q4_matmul_kernel<0, 1, ...>"
        short = [re.sub(r"^void (\(anonymous namespace\)::)?|\(.*\)$", "", n) for n in names.stdout.splitlines()]
        return dict(zip(short, out.values()))
    except (OSError, subprocess.CalledProcessError):
        return out


def weights(name: str, g: torch.Generator) -> dict:
    k, n, epi, _ = LINEARS[name]
    layers = 2 if name == "logits" else L
    return {
        "qw": torch.randint(-8, 8, (layers, k, n), generator=g, device="cuda", dtype=torch.int8),
        "scales": torch.rand((layers, k // 32, n), generator=g, device="cuda") * 0.01,
        "b": None if epi is None else torch.randn((layers, n), generator=g, device="cuda") * 0.1,
    }


def time_us(call, layers: int, launches: int) -> float:
    for layer in range(4):
        call(layer % layers)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock: the host queues all launches meanwhile
    start.record()
    for i in range(launches):
        call(i % layers)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches * 1e3


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_q4_matmul_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build, q4_kernel

    _build.build_all()
    lib = _build.library(q4_kernel.NAME)
    forced = getattr(lib, "q4_matmul_in_regime", None)
    if forced is not None:
        p, i = ctypes.c_void_p, ctypes.c_int
        forced.argtypes, forced.restype = [i, p, i, p, p, p, p, i, i, i, i, i, p], i
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {"label": label, "card": card(), "us": {}, "regime": {}, "us_by_regime": {}}
    report = _build._target(q4_kernel.NAME).with_suffix(".log")
    if report.exists():
        out["ptxas"] = ptxas_report(report.read_text())
    for name in LINEARS:
        lin = weights(name, g)
        k, n, epi, out_dtype = LINEARS[name]
        layers = lin["qw"].shape[0]
        for site, m, lin_name in SITES:
            if lin_name != name:
                continue
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            call = lambda layer: q4_kernel.q4_matmul(
                x, lin["qw"], lin["scales"], layer=layer, bias=lin["b"], out_dtype=out_dtype
            )
            out["us"][site] = time_us(call, layers, 32 if m >= 1500 else 256)
            if hasattr(q4_kernel, "regime"):
                out["regime"][site] = q4_kernel.regime(m, x.dtype)
        if forced is None or name == "cross_kv":
            continue
        epi_code = 0 if epi is None else 1  # +bias
        for m in REGIME_ROWS:
            x = torch.randn((m, k), generator=g, device="cuda").to(torch.bfloat16)
            y = torch.empty((m, n), dtype=out_dtype, device="cuda")
            for reg, reg_name in enumerate(q4_kernel.REGIMES):
                def call(layer):
                    err = forced(
                        reg, x.data_ptr(), 1, lin["qw"][layer].data_ptr(), lin["scales"][layer].data_ptr(),
                        None if lin["b"] is None else lin["b"][layer].data_ptr(), y.data_ptr(),
                        int(out_dtype == torch.bfloat16), m, k, n, epi_code, _build.stream_ptr(x.device),
                    )
                    _build.check(err, "q4_matmul_in_regime")
                out["us_by_regime"][f"{name}_m{m}_{reg_name}"] = time_us(call, layers, 256)
        del lin
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
