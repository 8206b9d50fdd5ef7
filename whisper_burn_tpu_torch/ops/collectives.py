"""The collectives of tensor and data parallelism, each counted by kind.

Every collective the port issues goes through this module:
:func:`all_reduce` sums a row-parallel linear's partial products over the
model ranks (``ops/linear.py``), :func:`all_gather` gathers results over
the data ranks and compares them over the model ranks
(``parallel/sharded.py``, ``parallel/guard.py``). Each call adds one to
``_build.COLLECTIVES[kind]``, as a kernel's wrapper counts its launch, and
a CUDA graph's capture records it for its replays to add
(``_build.recording_launches``), so ``parallel/audit.py`` counts what a
decode issued. The group's backend and device are the caller's: NCCL
for CUDA tensors by default, gloo for CPU tensors, and gloo for CUDA
tensors where the caller asks (it goes through the host).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from whisper_burn_tpu_torch.ops import _build

ALL_REDUCE, ALL_GATHER = "all_reduce", "all_gather"
KINDS = (ALL_REDUCE, ALL_GATHER)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, in ``x``'s dtype, in place
    (a contiguous ``x`` is summed where it lies; returns it)."""
    x = x.contiguous()
    _build.count_collective(ALL_REDUCE)
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """``x`` of every rank of ``group``, in rank order."""
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _build.count_collective(ALL_GATHER)
    dist.all_gather(out, x, group=group)
    return out
