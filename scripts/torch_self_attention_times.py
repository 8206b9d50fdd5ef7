"""Device time of kernel B (merged self-attention over the int8 self cache,
row stored in place) of one checkout's PyTorch/CUDA port, at Large-V3
serving shapes, on one CUDA card.

    python3 scripts/torch_self_attention_times.py <checkout> <label>

Builds the checkout's kernels, then times its ``decode_self_attention``
with CUDA events over 256 launches cycling the 32 layers of an int8 self
cache (8 streams, ctx 256, D 1280; 84 MB per array, so the cache comes
from HBM) at cached positions 4, 115 and 227. A sleep kernel queued first
lets the host run ahead, so the events bracket the launches back to back
and host dispatch is not in the time. Inputs come from seed 0, so every
checkout sees the same ones. Prints one JSON line: the label, the card,
and µs per launch at each position. To compare two versions, unpack the
older one into a git-ignored directory and run older, newer, newer, older
in one call.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

L, B, CTX, D, H, LAUNCHES = 32, 8, 256, 1280, 20, 256
POSITIONS = (4, 115, 227)


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_self_attention_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.decode_attention import decode_self_attention

    _build.build_all()
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    kc = torch.randint(-127, 128, (L, B, CTX, D), generator=g, device="cuda", dtype=torch.int8)
    vc = torch.randint(-127, 128, (L, B, CTX, D), generator=g, device="cuda", dtype=torch.int8)
    sc = torch.rand((L, B, CTX, 2), generator=g, device="cuda") * 0.02 + 1e-3
    q, kn, vn = (torch.randn((B, 1, D), generator=g, device="cuda").to(torch.bfloat16) for _ in range(3))
    kq, vq = (torch.randint(-127, 128, (B, 1, D), generator=g, device="cuda", dtype=torch.int8) for _ in range(2))
    nsc = torch.rand((B, 1, 2), generator=g, device="cuda") * 0.02 + 1e-3
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"label": label, "card": card}
    for pos in POSITIONS:
        call = lambda layer: decode_self_attention(q, kc, vc, sc, layer, pos, H, kn, vn, kq, vq, nsc)
        for layer in range(8):
            call(layer)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)  # about 0.1 s of the card's clock: the host queues all launches meanwhile
        start.record()
        for k in range(LAUNCHES):
            call(k % L)
        end.record()
        torch.cuda.synchronize()
        out[f"us_per_launch_pos_{pos}"] = start.elapsed_time(end) / LAUNCHES * 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
