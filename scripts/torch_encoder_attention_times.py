"""Device time of kernels D and D' (the encoder attention) of one
checkout's PyTorch/CUDA port at the shapes of PERF.md's rows, on one CUDA
card, beside the library call.

    python3 scripts/torch_encoder_attention_times.py <checkout> <label>

Builds the checkout's encoder-attention kernels, then times in bf16, with
CUDA events over back-to-back launches (a sleep kernel queued first lets
the host run ahead, so host dispatch is not in the time): kernel D
(``encoder_attention``) on one Large-V3 encoder layer, T = 1536 with 1500
valid keys, at B = 1 (the entry), 4 (the pipeline's long audio) and 8 (the
serving paths); kernel D' (``encoder_attention_heads_kernel``) at B = 8 on
its head-major layout at Large-V3 and Medium widths; and beside each one
``scaled_dot_product_attention`` over the 1500 valid keys on the same
inputs (a yardstick: the port never calls it). Inputs come from seed 0, so
every checkout sees the same ones. Prints one JSON line: the label, the
card, µs per launch and the library's by shape, each kernel's max error
relative to max|out| of its plain version, and, where the checkout's
build kept ptxas's report, each kernel instance's registers and spill
bytes. To compare two versions, unpack the older one into a git-ignored
directory and run older, newer, newer, older in one call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_q4_matmul_times import card, ptxas_report, time_us  # noqa: E402

T, VALID = 1536, 1500
# (shape, kernel, B, D, H)
SHAPES = (
    ("D/B=1", "D", 1, 1280, 20),
    ("D/B=4", "D", 4, 1280, 20),
    ("D/B=8", "D", 8, 1280, 20),
    ("D'/Large-V3", "D'", 8, 1280, 20),
    ("D'/Medium", "D'", 8, 1024, 16),
)
LAUNCHES = 20


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_encoder_attention_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops import encoder_attention as ea

    _build.build_all((ea.NAME,))
    out = {"label": label, "card": card(), "us": {}, "library_us": {}, "rel_err": {}}
    report = _build._target(ea.NAME).with_suffix(".log")
    if report.exists():
        out["ptxas"] = ptxas_report(report.read_text())
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape, kernel, b, d, h in SHAPES:
        q, k, v = (torch.randn((b, T, d), generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
        hq, hk, hv = (x.reshape(b, T, h, 64).transpose(1, 2).contiguous() for x in (q, k, v))
        if kernel == "D":
            call = lambda: ea.encoder_attention(q, k, v, h, valid=VALID)
            ref = ea.encoder_attention_plain(q, k, v, h, VALID)
        else:
            vT = hv.transpose(2, 3).contiguous()
            call = lambda: ea.encoder_attention_heads_kernel(hq, hk, vT, VALID)
            ref = ea.encoder_attention_heads_plain(hq, hk, vT, VALID)
        got = call()
        out["rel_err"][shape] = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        del got, ref
        out["us"][shape] = time_us(lambda layer: call(), 1, LAUNCHES)
        kv = (hk[:, :, :VALID], hv[:, :, :VALID])
        out["library_us"][shape] = time_us(lambda layer: sdpa(hq, *kv), 1, LAUNCHES)
        del q, k, v, hq, hk, hv
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
