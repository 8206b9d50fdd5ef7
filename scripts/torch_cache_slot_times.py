"""Device time of kernel F's work in a decode step of one checkout's
PyTorch/CUDA port, at Large-V3's self-cache shapes, on one CUDA card.

    python3 scripts/torch_cache_slot_times.py <checkout> <label>

Builds the checkout's slot writer (``csrc/cache_slot.cu``) and times, with
CUDA events over 256 back-to-back calls (a sleep kernel queued first lets
the host run ahead, so host dispatch is not in the time), what a decode
step does to its self cache, the way the checkout does it:

* a greedy step's slot write (K, V and the f32 scale row of a quantized
  cache at the slot): one launch of the slot form where the checkout has
  it (``write_cache_slots``), else kernel F once for K, once for V and
  ``index_copy_`` for the scales; at 8 streams in each cache form that
  leaves the slot to F (bf16 as fast_greedy, int4 as int4self_greedy,
  int8 keys and int4 values as mixed_greedy) and at the entry's one bf16
  stream (ctx 64);
* a beam step's slot write and gather of the streams by parent beam (40
  streams: 8 utterances x 5 beams, random parents): one launch of the beam
  form where the checkout has it (``write_cache_slots_beam``, the other
  buffer of a pair written), else the slot write above followed by an
  ``index_select`` of each cache; at slots 4, 115 and 226 of ctx 256 in
  each beam path's cache form (int8 as beam and int8_beam, bf16, int4,
  mixed).

Beside each, the bound: the bytes moved (the rows written once and their
sources read once: a beam step's rows up to the slot, read for each
distinct parent) over 3.35 TB/s.
Inputs come from seed 0, so every checkout sees the same ones. Prints one
JSON line: the label, the card, µs by shape and the bound. To compare two
versions, unpack the older one into a git-ignored directory (``git archive
<commit> | tar -x -C build/<dir>``) and run older, newer, newer, older in
one call.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_q4_matmul_times import card, time_us  # noqa: E402

L, CTX, D, LAUNCHES, HBM_BYTES_PER_S = 32, 256, 1280, 256, 3.35e12
# cache form: (K dtype, V dtype, K width, V width, f32 scale lanes)
FORMS = {
    "bf16": (torch.bfloat16, torch.bfloat16, D, D, 0),
    "int8": (torch.int8, torch.int8, D, D, 2),
    "int4": (torch.uint8, torch.uint8, D // 2, D // 2, 20),
    "mixed": (torch.int8, torch.uint8, D, D // 2, 11),
}
# (shape, form, streams, ctx, beam slot or None for a greedy step)
SHAPES = (
    [(f"slot/{form}/8", form, 8, CTX, None) for form in ("bf16", "int4", "mixed")]
    + [("slot/bf16/1/entry", "bf16", 1, 64, None)]
    + [(f"beam/{form}/40/pos{p}", form, 40, CTX, p) for form in ("int8", "bf16", "int4", "mixed") for p in (4, 115, 226)]
)


def tensors(g, form: str, streams: int, t: int) -> list[torch.Tensor]:
    kd, vd, kw, vw, lanes = FORMS[form]

    def rand(dtype, width):
        shape = (L, streams, t, width)
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device="cuda").to(dtype)
        lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=dtype)

    return [rand(kd, kw), rand(vd, vw)] + ([rand(torch.float32, lanes)] if lanes else [])


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = sys.argv[1:]
    if not torch.cuda.is_available():
        print("torch_cache_slot_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from whisper_burn_tpu_torch.ops import _build
    from whisper_burn_tpu_torch.ops import cache as slot

    _build.build_all((slot.NAME,))
    fused = hasattr(slot, "write_cache_slots_beam")
    out = {"label": label, "card": card(), "fused_forms": fused, "us": {}, "bound_us": {}}
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for shape, form, streams, ctx, beam_pos in SHAPES:
        # a greedy step at the mean slot of its decode steps (224 tokens: 115;
        # the entry's 16: 11)
        p = beam_pos if beam_pos is not None else 115 if ctx == CTX else 11
        pos = torch.tensor(p, dtype=torch.int32, device="cuda")
        idx = torch.tensor([p], device="cuda")
        xs, news = tensors(g, form, streams, ctx), tensors(g, form, streams, 1)
        rbs = sum(x.shape[-1] * x.element_size() for x in xs)

        def slot_write():
            if fused:
                slot.write_cache_slots(list(zip(xs, news)), pos)
                return
            slot.write_cache_slot(xs[0], news[0], pos)
            slot.write_cache_slot(xs[1], news[1], pos)
            if len(xs) > 2:
                xs[2].index_copy_(2, idx, news[2])

        if beam_pos is None:
            call, nbytes = (lambda l: slot_write()), 2 * L * streams * rbs
        else:
            parent = torch.randint(0, 5, (streams // 5, 5), generator=g, device="cuda")
            src = (torch.arange(streams // 5, device="cuda")[:, None] * 5 + parent).reshape(-1)
            src32 = src.to(torch.int32)
            # the rows up to the slot, written for every stream and read
            # once for each distinct parent
            nbytes = L * (p + 1) * rbs * (streams + int(src.unique().numel()))
            if fused:
                ys = tensors(g, form, streams, ctx)
                triples = list(zip(ys, xs, news))
                call = lambda l: slot.write_cache_slots_beam(triples, src32, pos)
            else:
                call = lambda l: (slot_write(), [x.index_select(1, src) for x in xs])
        out["us"][shape] = time_us(call, L, LAUNCHES)
        out["bound_us"][shape] = nbytes / HBM_BYTES_PER_S * 1e6
        del xs, news
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
