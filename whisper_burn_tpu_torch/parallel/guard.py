"""Debug-mode replication guard across the model ranks.

Port of ``whisper_burn_tpu/parallel/guard.py``. Every model rank of one
data index must end a decode with the same results, because every
row-parallel linear sums its partial products over them; a dropped sum
would leave shard-dependent results that the token comparisons of a
given configuration might not catch. :func:`replication_mismatch`
compares each result tensor with the next model rank's (cyclic: if all
neighbouring pairs match, all ranks match) through an all-gather over the
model group (gloo carries CUDA tensors in all-gather, not in send/recv),
and sums the mismatching elements over the group, so every rank agrees
on the verdict.
"""

from __future__ import annotations

import torch

from whisper_burn_tpu_torch.ops.collectives import all_gather, all_reduce


def _tensors(result) -> list[torch.Tensor]:
    return [x for x in result if isinstance(x, torch.Tensor)]


def replication_mismatch(result, group, model: int, model_index: int) -> int:
    """Elements of ``result``'s tensors (a tuple such as ``GreedyResult``)
    that differ from the next model rank's, summed over ``group``'s ranks:
    0 iff every tensor is replicated bit for bit."""
    if model == 1:
        return 0
    nxt = (model_index + 1) % model
    total = torch.zeros((), dtype=torch.int64, device=_tensors(result)[0].device)
    for x in _tensors(result):
        theirs = all_gather(x, group)[nxt]
        # compare bits, so NaNs and signed zeros count as they are stored
        mine = x.contiguous()
        if mine.is_floating_point():
            mine, theirs = mine.view(torch.int32 if mine.element_size() == 4 else torch.int16), \
                theirs.view(torch.int32 if theirs.element_size() == 4 else torch.int16)
        total += (mine != theirs).sum()
    return int(all_reduce(total, group))


class ReplicationError(RuntimeError):
    """A result claimed replicated diverged across the model ranks."""
