"""Faults planted in the timed path underneath a run, which the check has
to find: ``benchmark/tests/test_bench_faults.py`` runs each cell whole
with each at tiny sizes on the CPU, and ``calibrate.py --fault`` reads them
at a cell's own size on the card. The benchmark's own runs never plant one.

- ``token``: the first stream's answer altered where it is produced;
- ``half``: the second half of the batch never decoded (empty answers);
- ``stuck``: the decode loop's step returns its state unchanged;
- ``parent``: beam search's reorder moves each stream's self cache from
  the wrong parent (the next beam of its utterance), its tokens and scores
  as they were.
"""

from __future__ import annotations

import contextlib

import torch

EOT = 50257
FAULTS = ("token", "half", "stuck", "parent")


def _broken_result(decode, fault):
    def wrapped(*args, **kwargs):
        result = decode(*args, **kwargs)
        tokens, n_gen = result.tokens.clone(), result.n_generated.clone()
        b = tokens.shape[0]
        if fault == "token":
            tokens[0, : int(n_gen[0])] = 100
        else:
            tokens[b // 2 :] = EOT
            n_gen[b // 2 :] = 0
        return result._replace(tokens=tokens, n_generated=n_gen)

    return wrapped


def patches(fault: str, beam_width: int = 1) -> list:
    """``(module, name, replacement)`` for each attribute ``fault`` replaces."""
    from whisper_burn_tpu_torch import transcribe
    from whisper_burn_tpu_torch.models import beam, whisper

    if fault in ("token", "half"):
        return [(transcribe, n, _broken_result(getattr(transcribe, n), fault)) for n in ("greedy_decode", "beam_decode")]
    if fault == "stuck":
        def greedy_step(params, cfg, state, compute):
            return torch.zeros(state.cur.shape[0], cfg.n_vocab_padded, device=state.cur.device)

        return [(whisper, "greedy_step", greedy_step), (beam, "beam_step", lambda *args, **kwargs: None)]
    if fault == "parent":
        reorder, w = beam.reorder_self_cache, beam_width

        def reorder_from_next_beam(dst, cache, rows, src, pos):
            return reorder(dst, cache, rows, (src // w) * w + (src % w + 1) % w, pos)

        return [(beam, "reorder_self_cache", reorder_from_next_beam)]
    raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")


@contextlib.contextmanager
def planted(fault: str | None, beam_width: int = 1):
    """The timed path with ``fault`` planted (nothing where None)."""
    plan = patches(fault, beam_width) if fault is not None else []
    saved = [(m, n, getattr(m, n)) for m, n, _ in plan]
    for m, n, new in plan:
        setattr(m, n, new)
    try:
        yield
    finally:
        for m, n, old in saved:
            setattr(m, n, old)
