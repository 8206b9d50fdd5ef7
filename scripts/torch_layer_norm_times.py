"""Device time of kernel J (the LayerNorm, ``csrc/layer_norm.cu``) against
the eleven-launch plain chain it replaces, on one CUDA card.

    python3 scripts/torch_layer_norm_times.py

At the rows the model step norms (bf16, D 1280: the encoder's B x 1536 at
B = 32 and 8, the decode step's 32 and 40 streams; Whisper Medium's 8 x
1024), each without and with the residual add folded in, it times with
CUDA events over back-to-back calls (a sleep kernel queued first lets the
host run ahead, so host dispatch is not in the time):

* ``us``: kernel J;
* ``plain_us``: the plain chain (``layer_norm_plain``, with ``x + r``
  before it in the residual form), launched eagerly;
* ``plain_graph_us`` and ``graph_us``: the same calls captured in one CUDA
  graph and replayed, as the decode loop runs them.

Beside each, the bound: the rows read once and written once (x and r
read, s and y written with the residual) over 3.35 TB/s, and ptxas's
registers and spills of each kernel instance. Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
from torch_q4_matmul_times import card, ptxas_report  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
SHAPES = [(49152, 1280), (12288, 1280), (32, 1280), (40, 1280), (8, 1024)]
CALLS = {49152: 20, 12288: 64}  # back-to-back calls a timing; 256 for the rest


def events_us(fn, calls: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def graph_us(fn, calls: int) -> float:
    """``calls`` calls of ``fn`` captured in one graph, replayed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    return events_us(graph.replay, 4) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_layer_norm_times: no CUDA device", file=sys.stderr)
        return 1
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops.layer_norm import NAME, layer_norm, layer_norm_plain

    _build.build_all((NAME,))
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    out = {"card": card(), "torch": torch.__version__, "rows": []}
    for m, d in SHAPES:
        calls = CALLS.get(m, 256)
        for residual in (False, True):
            x = (torch.randn((m, d), generator=g, device="cuda") * 3 + 0.5).to(torch.bfloat16)
            r = torch.randn((m, d), generator=g, device="cuda").to(torch.bfloat16) if residual else None
            gamma = 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
            beta = 0.1 * torch.randn(d, generator=g, device="cuda")
            kern = lambda: layer_norm(x, gamma, beta, residual=r)
            plain = (lambda: layer_norm_plain(x + r, gamma, beta)) if residual else (
                lambda: layer_norm_plain(x, gamma, beta))
            nbytes = m * d * 2 * (4 if residual else 2)
            out["rows"].append({
                "rows": m, "d": d, "residual": residual, "bound_us": nbytes / HBM_BYTES_PER_S * 1e6,
                "us": events_us(kern, calls), "plain_us": events_us(plain, calls),
                "graph_us": graph_us(kern, min(calls, 64)), "plain_graph_us": graph_us(plain, min(calls, 64)),
            })
            del x, r
            torch.cuda.empty_cache()
    log = _build._target(NAME).with_suffix(".log")
    out["ptxas"] = ptxas_report(log.read_text()) if log.exists() else {}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
