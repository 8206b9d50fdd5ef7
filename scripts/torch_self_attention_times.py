"""Device time of the self-attention kernels B, B', E, E', G and H of one
checkout's PyTorch/CUDA port at Large-V3 decode shapes, on one CUDA card,
beside the library call.

    python3 scripts/torch_self_attention_times.py <checkout> <label>

Builds the checkout's decode-attention kernels, then times each with CUDA
events over 256 back-to-back launches cycling the 32 layers of its cache
(ctx 256, D 1280, 20 heads), so the cache comes from HBM; a sleep kernel
queued first lets the host run ahead, so host dispatch is not in the time.
The shapes are the main paths' (PERF.md's rows): kernel B (int8 cache,
row stored in place; greedy, 8 streams) at cached positions 4, 115 and
227; B' (bf16 cache, fast_greedy, 8 streams), E (int8, beam, 40 streams),
E' (bf16, fast_beam, 40), G over int4 keys and values (20 scale lanes) and
over int8 keys with int4 values (mixed, 11 lanes) at 8 streams (the greedy
paths) and 4 (the pipeline), and H in both forms at 40 streams (beam), all
at position 115; and kernel F (the slot writer, ``csrc/cache_slot.cu``)
on int8, bf16 and uint8 (int4-pair) rows of 8 streams at slot 115. Beside
each: ``scaled_dot_product_attention`` on the same rows dequantized to
bf16, head-major (F: ``index_copy_`` along T; a yardstick: the port never
calls it), and the kernel's max error relative to max|out| of its plain
version (one launch, layer 0, bf16 query). A checkout whose kernels read
the position from device memory (``_build.check_position``) gets it as an
int32 on the card, an older one as a host int. Inputs come from seed 0, so every
checkout sees the same ones. Prints one JSON line: the label, the card, µs
per launch and the library's by shape, the errors, and, where the
checkout's build kept ptxas's report, each kernel instance's registers and
spill bytes. To compare two versions, unpack the older one into a
git-ignored directory and run older, newer, newer, older in one call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_q4_matmul_times import card, ptxas_report, time_us  # noqa: E402

L, CTX, D, H, LAUNCHES, POS = 32, 256, 1280, 20, 256, 115
# (shape, kernel, streams, cache form, cached position)
SHAPES = (
    [(f"B/8/pos{p}", "B", 8, "int8", p) for p in (4, POS, 227)]
    + [("B'/8", "B'", 8, "bf16", POS), ("E/40", "E", 40, "int8", POS), ("E'/40", "E'", 40, "bf16", POS)]
    + [(f"G/{form}/{b}", "G", b, form, POS) for form in ("int4", "mixed") for b in (8, 4)]
    + [(f"H/{form}/40", "H", 40, form, POS) for form in ("int4", "mixed")]
    + [(f"F/{form}/8", "F", 8, form, POS) for form in ("int8", "bf16", "uint8")]
)


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_self_attention_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.models.decoder import self_kv_groups
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops import cache as slot
    from whisper_burn_tpu_torch.ops import decode_attention as da

    _build.build_all((da.NAME, slot.NAME))
    on_device = hasattr(_build, "check_position")
    out = {"label": label, "card": card(), "us": {}, "library_us": {}, "rel_err": {}}
    report = _build._target(da.NAME).with_suffix(".log")
    if report.exists():
        out["ptxas"] = ptxas_report(report.read_text())
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ints = lambda lo, hi, shape, dtype: torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=dtype)
    rand = lambda *shape: torch.rand(shape, generator=g, device="cuda")
    heads = lambda x: x.reshape(x.shape[0], x.shape[1], H, 64).transpose(1, 2)
    for shape, kernel, b, form, p in SHAPES:
        pos = torch.tensor(p, dtype=torch.int32, device="cuda") if on_device else p
        if kernel == "F":
            width, dtype = (D // 2, torch.uint8) if form == "uint8" else (D, bf if form == "bf16" else torch.int8)
            cache = ints(0, 100, (L, b, CTX, width), torch.uint8).to(dtype)
            new = ints(0, 100, (L, b, 1, width), torch.uint8).to(dtype)
            ref = cache.clone()
            slot.write_cache_slot_plain(ref, new, pos)
            got = cache.clone()
            slot.write_cache_slot(got, new, pos)
            out["rel_err"][shape] = float(not torch.equal(got, ref))
            out["us"][shape] = time_us(lambda l: slot.write_cache_slot(cache, new, pos), L, LAUNCHES)
            idx = torch.tensor([p], device="cuda")
            out["library_us"][shape] = time_us(lambda l: cache.index_copy_(2, idx, new), L, LAUNCHES)
            del cache, new, ref, got
            continue
        q, kn, vn = (torch.randn((b, 1, D), generator=g, device="cuda").to(bf) for _ in range(3))
        merged = kernel in ("B", "B'", "G")
        n = p + merged  # the rows the library call attends over: G and B add the current token's
        if kernel == "G" or kernel == "H":
            ng = self_kv_groups(D)
            sw = 2 * ng if form == "int4" else 1 + ng
            kc = ints(0, 256, (L, b, CTX, D // 2), torch.uint8) if form == "int4" else ints(-127, 128, (L, b, CTX, D), torch.int8)
            vc = ints(0, 256, (L, b, CTX, D // 2), torch.uint8)
            sc = rand(L, b, CTX, sw) * 0.04 + 0.01
            lanes = da.int4_lanes(da.MERGED4, q, kc, vc, sc, H)
            deq = [da.dequantize_self_rows(kc[l, :, :n], vc[l, :, :n], sc[l, :, :n], lanes) for l in range(L)]
            kd, vd = [heads(k.to(bf)) for k, _ in deq], [heads(v.to(bf)) for _, v in deq]
            del deq
            if merged:
                call = lambda l: da.decode_attention_merged_int4(q, kc, vc, sc, l, pos, H, kn, vn)
                plain = lambda: da.decode_attention_merged_int4_plain(q, kc, vc, sc, 0, pos, H, kn, vn)
            else:
                call = lambda l: da.decode_attention_layer_int4(q, kc, vc, sc, l, pos, H)
                plain = lambda: da.decode_attention_layer_int4_plain(q, kc, vc, sc, 0, pos, H)
        elif form == "int8":
            kc, vc = (ints(-127, 128, (L, b, CTX, D), torch.int8) for _ in range(2))
            sc = rand(L, b, CTX, 2) * 0.02 + 1e-3
            deq = lambda c, s: heads((c[:, :n].float() * s[:, :n, None]).to(bf))
            kd = [deq(kc[l], sc[l, :, :, 0]) for l in range(L)]
            vd = [deq(vc[l], sc[l, :, :, 1]) for l in range(L)]
            if merged:
                kq, vq = (ints(-127, 128, (b, 1, D), torch.int8) for _ in range(2))
                nsc = rand(b, 1, 2) * 0.02 + 1e-3
                call = lambda l: da.decode_self_attention(q, kc, vc, sc, l, pos, H, kn, vn, kq, vq, nsc)
                plain = lambda: da.decode_self_attention_plain(
                    q, kc.clone(), vc.clone(), sc.clone(), 0, pos, H, kn, vn, kq, vq, nsc)
            else:
                call = lambda l: da.decode_attention_layer(q, kc, vc, sc, l, pos, H)
                plain = lambda: da.decode_attention_layer_plain(q, kc, vc, sc, 0, pos, H)
        else:
            kc, vc = (torch.randn((L, b, CTX, D), generator=g, device="cuda").to(bf) for _ in range(2))
            kd = [heads(kc[l, :, :n]) for l in range(L)]
            vd = [heads(vc[l, :, :n]) for l in range(L)]
            if merged:
                call = lambda l: da.decode_attention_merged(q, kc, vc, l, pos, H, kn, vn)
                plain = lambda: da.decode_attention_merged_plain(q, kc, vc, 0, pos, H, kn, vn)
            else:
                call = lambda l: da.decode_attention_layer(q, kc, vc, None, l, pos, H)
                plain = lambda: da.decode_attention_layer_plain(q, kc, vc, None, 0, pos, H)
        got, ref = call(0), plain()
        parts = lambda x: x if isinstance(x, tuple) else (x,)
        out["rel_err"][shape] = max(
            ((a - r).abs().max() / r.abs().max().clamp_min(1.0 if len(parts(ref)) > 1 else 1e-30)).item()
            for a, r in zip(parts(got), parts(ref))
        )
        out["us"][shape] = time_us(call, L, LAUNCHES)
        qh = heads(q)
        out["library_us"][shape] = time_us(lambda l: sdpa(qh, kd[l], vd[l]), L, LAUNCHES)
        del kc, vc, kd, vd, got, ref
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
