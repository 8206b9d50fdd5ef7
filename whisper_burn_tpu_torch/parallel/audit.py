"""Collective audit of sharded decoding.

Port of ``whisper_burn_tpu/parallel/audit.py``. The JAX package counts
the collective instructions of the compiled HLO; the port has no HLO, so
it counts the collectives a decode issues (``ops/collectives.py`` counts
each by kind in ``_build.COLLECTIVES``; a CUDA graph's replay adds the
ones its capture recorded). The design claims are structural and follow
from the shapes (:func:`predicted_collectives`): data parallelism issues
nothing until the results are gathered, one all-gather per result
tensor; tensor parallelism issues only all-reduces, two per encoder
layer (attn_o, fc2) and three per decoder layer in the prompt pass (and
the language-detection pass) and in each decode step (attn_o, xattn_o,
fc2), none for the cross fill (column-parallel) or the logits
(replicated embedding).
"""

from __future__ import annotations

from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.collectives import ALL_GATHER, ALL_REDUCE, KINDS


def predicted_collectives(cfg, mesh, *, steps: int, beam: bool = False, detect: bool = False) -> dict:
    """Collectives by kind of one sharded decode of ``steps`` decode steps."""
    want = dict.fromkeys(KINDS, 0)
    if mesh.model > 1:
        want[ALL_REDUCE] = 2 * cfg.n_audio_layer + 3 * cfg.n_text_layer * (1 + steps + int(detect))
    if mesh.data > 1:
        want[ALL_GATHER] = 4 if beam else 3  # tokens, n_generated, (scores,) lang_tokens
    return want


def audit_mesh(cfg, compute, mesh, params, mel, lang_tokens, *, max_tokens: int = 8, beam_width: int = 1):
    """(collectives by kind, total) of one sharded decode of this mesh: the
    counters are reset, the decode runs, and they are read."""
    from whisper_burn_tpu_torch.parallel.sharded import sharded_beam_decode, sharded_greedy_decode

    _build.reset_launches()
    if beam_width > 1:
        sharded_beam_decode(params, cfg, mel, lang_tokens, compute, mesh, beam_width=beam_width, max_tokens=max_tokens)
    else:
        sharded_greedy_decode(params, cfg, mel, lang_tokens, compute, mesh, max_tokens=max_tokens)
    counts = {k: _build.COLLECTIVES.get(k, 0) for k in KINDS}
    return counts, sum(counts.values())
