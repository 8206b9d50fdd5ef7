"""Device time of the cross-attention kernels C (int4 cache) and C' (int8
and bf16 caches) of one checkout's PyTorch/CUDA port at Large-V3 decode
shapes, on one CUDA card, beside the library call.

    python3 scripts/torch_cross_attention_times.py <checkout> <label> [NAME=VALUE ...]

Builds the checkout's decode-attention kernels, then times its
``decode_cross_attention`` with CUDA events over 256 back-to-back launches
cycling the 32 layers of a cross cache (T 1536, 1500 valid keys, D 1280, 20
heads), so the cache comes from HBM; a sleep kernel queued first lets the
host run ahead, so host dispatch is not in the time. The shapes are the
main paths' (PERF.md's C and C' rows): C at 8 query streams (greedy), 8
utterances x 5 beams (beam search's ``batch_groups``) and 4 streams (the
pipeline); C' over the int8 cache at 8 and 8 x 5 (int8_greedy,
int8_beam), over the bf16 cache at 8, 8 x 5 (fast_greedy, fast_beam) and
1 (the entry). Beside each: ``scaled_dot_product_attention`` on the same
cache dequantized to bf16, head-major, an utterance's streams as its
queries (a yardstick: the port never calls it), and the kernel's max error
relative to max|out| of its own plain version (one launch, layer 0, bf16
query). Inputs come from seed 0, so every checkout sees the same ones.
Prints one JSON line: the label, the card, µs per launch and the
library's by shape, the errors, and, where the checkout's build kept
ptxas's report, each cross kernel instance's registers and spill bytes. To
compare two versions, unpack the older one into a git-ignored directory
and run older, newer, newer, older in one call. Each NAME=VALUE builds a
variant instead: the checkout's decode-attention source with its
``constexpr int NAME`` set to VALUE (for example X_FILL_PERCENT=50), into
``build/variants/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_q4_matmul_times import card, ptxas_report, time_us  # noqa: E402

L, T, VALID, D, H, LAUNCHES = 32, 1536, 1500, 1280, 20, 256
# (shape, cache form, cache entries, streams an entry)
SHAPES = [("C/8", "int4", 8, 1), ("C/8x5", "int4", 8, 5), ("C/4", "int4", 4, 1),
          ("C'int8/8", "int8", 8, 1), ("C'int8/8x5", "int8", 8, 5),
          ("C'bf16/8", "bf16", 8, 1), ("C'bf16/8x5", "bf16", 8, 5), ("C'bf16/1", "bf16", 1, 1)]


def build_variant(_build, da, root: str, overrides: list[str]) -> Path:
    """Build the checkout's decode-attention source with each ``NAME=VALUE``
    of ``overrides`` set, load it in place of the library, and return the
    path of ptxas's report."""
    src = (Path(root) / "whisper_burn_tpu_torch" / "csrc" / f"{da.NAME}.cu").read_text()
    for item in overrides:
        name, value = item.split("=", 1)
        src, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};", src)
        if n != 1:
            raise SystemExit(f"torch_cross_attention_times: no constexpr int {name} in the source")
    out = Path(root) / "build" / "variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"{da.NAME}-{hashlib.sha256(src.encode()).hexdigest()[:12]}"
    stem.with_suffix(".cu").write_text(src)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(stem.with_suffix(".so")), str(stem.with_suffix(".cu"))],
                         capture_output=True, text=True)
    stem.with_suffix(".log").write_text(run.stdout + run.stderr)
    if run.returncode:
        raise SystemExit(f"torch_cross_attention_times: nvcc failed:\n{run.stdout}{run.stderr}")
    _build._LIBS[da.NAME] = ctypes.CDLL(str(stem.with_suffix(".so")))
    return stem.with_suffix(".log")


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label, overrides = sys.argv[1], sys.argv[2], sys.argv[3:]
    if not torch.cuda.is_available():
        print("torch_cross_attention_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops import decode_attention as da

    if overrides:
        report = build_variant(_build, da, root, overrides)
    else:
        _build.build_all((da.NAME,))
        report = _build._target(da.NAME).with_suffix(".log")
    out = {"label": label, "card": card(), "overrides": overrides, "us": {}, "library_us": {}, "rel_err": {}}
    if report.exists():
        out["ptxas"] = {k: v for k, v in ptxas_report(report.read_text()).items() if "cross" in k}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ints = lambda lo, hi, shape, dtype: torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=dtype)
    for shape, form, e, w in SHAPES:
        if form == "int4":
            kT, v = ints(0, 256, (L, e, D // 2, T), torch.uint8), ints(0, 256, (L, e, T // 2, D), torch.uint8)
            kf = lambda l: da.unpack_int4(kT[l], 1, bf)[..., :VALID]  # [E, D, valid]
            vf = lambda l: da.unpack_int4(v[l], 1, bf)[:, :VALID]  # [E, valid, D]
            qs = 0.05
        else:
            if form == "int8":
                kT, v = ints(-127, 128, (L, e, D, T), torch.int8), ints(-127, 128, (L, e, T, D), torch.int8)
            else:
                kT, v = (torch.randn(s, generator=g, device="cuda").to(bf) for s in ((L, e, D, T), (L, e, T, D)))
            kf = lambda l: kT[l, :, :, :VALID].to(bf)
            vf = lambda l: v[l, :, :VALID].to(bf)
            qs = 0.003 if form == "int8" else 0.3
        kd = [kf(l).reshape(e, H, 64, VALID).transpose(-1, -2).contiguous() for l in range(L)]
        vd = [vf(l).reshape(e, VALID, H, 64).transpose(1, 2).contiguous() for l in range(L)]
        q = (torch.randn((e * w, 1, D), generator=g, device="cuda") * qs).to(bf)
        qh = q.reshape(e, w, H, 64).transpose(1, 2)  # an utterance's streams as its queries
        call = lambda l: da.decode_cross_attention(q, kT, v, l, VALID, H, w)
        got, ref = call(0), da.decode_cross_attention_plain(q, kT, v, 0, VALID, H, w)
        out["rel_err"][shape] = ((got - ref).abs().max() / ref.abs().max()).item()
        out["us"][shape] = time_us(call, L, LAUNCHES)
        out["library_us"][shape] = time_us(lambda l: sdpa(qh, kd[l], vd[l]), L, LAUNCHES)
        del kT, v, kd, vd, got, ref
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
