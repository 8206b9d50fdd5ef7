"""The ``(data, model)`` mesh of ranks, on ``torch.distributed``.

Port of ``whisper_burn_tpu/parallel/mesh.py``. One process per rank
(SPMD): the mesh lays the first ``data * model`` ranks out as a
``(data, model)`` grid with the model axis innermost (rank ``d * model +
m``, the order of the JAX package's ``reshape(data, model)``), so the
model ranks that sum every row-parallel linear are neighbours, and the
data ranks communicate only when the results are gathered. A
:class:`Mesh` carries the sizes, this rank's coordinates, its device and
the process groups of its model ranks and of its data ranks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


def mesh_shape(data: int | None, model: int, world: int) -> tuple[int, int]:
    """``(data, model)`` for ``world`` ranks, with the JAX ``make_mesh``'s
    errors: ``data=None`` takes every rank left after the model axis."""
    if model < 1 or world % model != 0:
        raise ValueError(f"{world} ranks not divisible by model={model}")
    if data is None:
        data = world // model
    if data < 1 or data * model > world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, have {world}")
    return data, model


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of ranks. ``data_index``/``model_index`` are
    this rank's coordinates (None for a rank outside the grid, or for a
    layout made without a process group); ``model_group`` sums the
    row-parallel linears (None at ``model = 1``), ``data_group`` gathers
    the results (None at ``data = 1``). It hashes by identity."""

    data: int
    model: int
    data_index: int | None = None
    model_index: int | None = None
    model_group: object = None
    data_group: object = None
    device: torch.device | None = None

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def in_mesh(self) -> bool:
        return self.data_index is not None

    def rows(self, n: int) -> slice:
        """This rank's rows of a batch of ``n``: the data axis splits it in
        ``data`` contiguous blocks, as ``P("data")`` does."""
        if not self.in_mesh:
            raise ValueError("this rank lies outside the mesh (or the mesh has no process group)")
        if n % self.data:
            raise ValueError(f"batch {n} not divisible by data={self.data}")
        per = n // self.data
        return slice(self.data_index * per, (self.data_index + 1) * per)


def make_mesh(data: int | None = None, model: int = 1, world: int | None = None, *,
              device: str | torch.device | None = None) -> Mesh:
    """The ``(data, model)`` mesh of the process group's ranks.

    With ``torch.distributed`` initialized (``parallel/multihost.initialize``)
    every rank must call it, in the same order as its other groups: it
    makes the model and data groups (``new_group``, of the default group's
    backend, chosen in ``multihost.initialize``) and this rank's coordinates.
    ``world`` defaults to the group's size. Without a process group it
    returns the layout alone (no coordinates, no groups) of ``world``
    ranks. ``device`` is where this rank's shard lives: ``cuda:LOCAL_RANK``
    unless the caller passes another (``multihost.rank_device``)."""
    from whisper_burn_tpu_torch.parallel.multihost import rank_device

    if not dist.is_initialized():
        if world is None:
            raise ValueError("make_mesh: no process group (parallel/multihost.initialize) and no world size")
        data, model = mesh_shape(data, model, world)
        return Mesh(data, model)
    world = dist.get_world_size() if world is None else world
    data, model = mesh_shape(data, model, world)
    rank = dist.get_rank()
    groups = {}
    # every rank makes every group, in one order, as new_group requires
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)]) if model > 1 else None
        groups[("model", d)] = g
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)]) if data > 1 else None
        groups[("data", m)] = g
    if rank >= data * model:
        return Mesh(data, model, device=rank_device(device))
    d, m = divmod(rank, model)
    return Mesh(data, model, d, m, groups[("model", d)], groups[("data", m)], rank_device(device))
