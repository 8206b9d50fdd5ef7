"""Device time of kernel C (int4 cross-attention) of one checkout's
PyTorch/CUDA port, at Large-V3 serving shapes, on one CUDA card.

    python3 scripts/torch_cross_attention_times.py <checkout> <label>

Builds the checkout's kernels, then times its ``decode_cross_attention``
with CUDA events over 256 launches cycling the 32 layers of an int4 cross
cache (8 utterances, T 1536, 1500 valid keys; 252 MB per array, so the
cache comes from HBM): at 8 query streams, and at 5 streams per utterance
(40, beam search's ``batch_groups``) where the checkout's wrapper takes
``batch_groups``. Inputs come from seed 0, so every checkout sees the
same ones. Prints one JSON line: the label, the card, and µs per launch.
To compare two versions, unpack the older one into a git-ignored
directory and run older, newer, newer, older in one call.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys

import torch

L, B, D, T, VALID, H, W, LAUNCHES = 32, 8, 1280, 1536, 1500, 20, 5, 256


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_cross_attention_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.decode_attention import decode_cross_attention

    _build.build_all()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    kT = torch.randint(0, 256, (L, B, D // 2, T), generator=g, device="cuda", dtype=torch.uint8)
    v = torch.randint(0, 256, (L, B, T // 2, D), generator=g, device="cuda", dtype=torch.uint8)
    q = (torch.randn((B * W, 1, D), generator=g, device="cuda") * 0.05).to(torch.bfloat16)
    groups = [1]
    if "batch_groups" in inspect.signature(decode_cross_attention).parameters:
        groups.append(W)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"label": label, "card": card}
    for G in groups:
        qg = q[: B * G].contiguous()
        call = (lambda layer: decode_cross_attention(qg, kT, v, layer, VALID, H, G)) if G > 1 else (
            lambda layer: decode_cross_attention(qg, kT, v, layer, VALID, H))
        for layer in range(8):
            call(layer)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(LAUNCHES):
            call(k % L)
        end.record()
        torch.cuda.synchronize()
        out[f"us_per_launch_streams_{B * G}"] = start.elapsed_time(end) / LAUNCHES * 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
