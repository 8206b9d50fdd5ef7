"""Device time of kernel I (the fused Q4 FFN) of one checkout's PyTorch/CUDA
port beside the two launches of kernel A it replaced and the library pair,
at the decode, prefill and encoder shapes of Large-V3's FFN, on one CUDA card.

    python3 scripts/torch_ffn_times.py <checkout> <label>

Builds the checkout's kernels, then for each shape times, with CUDA events
over 256 launches that cycle 32 layers of stacked weights (so the weights
come from HBM, not from L2), in this order: kernel A's two launches (fc1
with the bias+GELU epilogue, then fc2 with +bias), kernel I, kernel I
again, the two launches again; then the library pair (``torch.matmul`` on
the pre-dequantized bf16 weights of the layer, the GELU, ``torch.matmul``;
no biases). A sleep kernel queued first lets the host run ahead, so the
events bracket the launches back to back (the gap between launches, about
1.5 µs, is in the time). x is bf16 as on the main paths; inputs come from
seed 0. Prints one JSON line: the label, the card, µs per launch by shape
and form, each shape's split of F (clusters per row tile) and ptxas's
registers and spill bytes of each kernel-I instance.
"""

from __future__ import annotations

import json
import sys

import torch

from torch_q4_matmul_times import card, ptxas_report, time_us

L, D, FFN = 32, 1280, 5120
# (shape, rows, K4's bias order): PERF.md's kernel-I rows
SHAPES = [("greedy_decode", 8, True), ("beam_decode", 40, True), ("entry_decode", 1, True),
          ("pipeline_decode", 4, True), ("prefill", 32, False), ("entry_prefill", 4, False),
          ("pipeline_prefill", 16, False), ("entry_encoder", 1536, False)]


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_ffn_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build, ffn_kernel, q4_kernel

    _build.build_all()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)

    def lin(k, n):
        return {"qw": torch.randint(-8, 8, (L, k, n), generator=g, device="cuda", dtype=torch.int8),
                "scales": torch.rand((L, k // 32, n), generator=g, device="cuda") * 0.01,
                "b": torch.randn((L, n), generator=g, device="cuda") * 0.1}

    fc1, fc2 = lin(D, FFN), lin(FFN, D)
    w16 = [(q4_kernel.dequant_weight(fc1["qw"][l], fc1["scales"][l], torch.bfloat16),
            q4_kernel.dequant_weight(fc2["qw"][l], fc2["scales"][l], torch.bfloat16)) for l in range(L)]
    out = {"label": label, "card": card(), "us": {}, "splits": {}}
    report = _build._target(ffn_kernel.LIB).with_suffix(".log")
    if report.exists():
        out["ptxas"] = ptxas_report(report.read_text())
    for shape, m, after in SHAPES:
        x = torch.randn((m, D), generator=g, device="cuda").to(torch.bfloat16)

        def two_launch(layer):
            h = q4_kernel.q4_matmul(x, fc1["qw"], fc1["scales"], layer=layer, bias=fc1["b"], gelu="tanh")
            return q4_kernel.q4_matmul(h, fc2["qw"], fc2["scales"], layer=layer, bias=fc2["b"])

        def kernel_i(layer):
            return ffn_kernel.fused_ffn(x, fc1, fc2, "tanh", layer=layer, bias_after_round=after)

        def library(layer):
            w1, w2 = w16[layer]
            return torch.matmul(ffn_kernel.gelu(torch.matmul(x, w1), "tanh"), w2)

        times = {}
        for form, call in (("two_launch", two_launch), ("kernel_i", kernel_i), ("kernel_i_2", kernel_i),
                           ("two_launch_2", two_launch), ("library", library)):
            times[form] = time_us(call, L, 256)
        out["us"][shape] = times
        out["splits"][shape] = ffn_kernel._plan(x.device, m, D, FFN, True)[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
