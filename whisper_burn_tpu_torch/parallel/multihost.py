"""Process-group start-up and batch distribution across ranks.

Port of ``whisper_burn_tpu/parallel/multihost.py``. The JAX package runs
one program over every chip of every host (``jax.distributed``); here
every rank is a process of its own, started by ``python -m
torch.distributed.run`` (torchrun, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) or given its
coordinator, count and index. Each rank holds its shard on its own
device: ``cuda:LOCAL_RANK`` with NCCL unless the caller asks for the CPU
(gloo). The backend is the caller's choice where it passes one (gloo
carries CUDA tensors through the host); nothing switches backend or
device on its own.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from whisper_burn_tpu_torch.ops.compute import resolve_device


def rank_device(device: str | torch.device | None = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (0 without torchrun) unless
    the caller passes another; no CUDA device raises, as every entry
    point's ``resolve_device``."""
    if device is None:
        resolve_device("cuda")
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return resolve_device(device)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str | torch.device | None = None,
               backend: str | None = None) -> torch.device:
    """Start this rank's default process group; returns its device.

    Without a coordinator it reads torchrun's environment (``env://``);
    with one it joins ``tcp://<coordinator_address>`` as rank
    ``process_id`` of ``num_processes``. The backend is NCCL for a CUDA
    device and gloo for the CPU unless ``backend`` names one. Does
    nothing but return the device if the group is already started."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no coordinator and no torchrun environment ({', '.join(missing)} unset): start the "
                "ranks with python -m torch.distributed.run, or pass coordinator_address, "
                "num_processes and process_id"
            )
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    return dev


# how long a rank waits on a message of the control group before it gives
# up on the job; a server's rank 0 speaks every serving.KEEPALIVE_S while
# it is idle
CONTROL_TIMEOUT = datetime.timedelta(minutes=10)


def control_group(timeout: datetime.timedelta = CONTROL_TIMEOUT):
    """A gloo group over every rank of the job, for messages of host
    arrays (NCCL, the default group's backend on the card, carries device
    tensors only): a server's rank 0 hands each batch to the other ranks
    through it (``serving.BatchingTranscriber``, ``serving.follow_batches``).
    Every rank must call it, in the same order relative to its other
    groups (``parallel/mesh.make_mesh``'s); a message not received within
    ``timeout`` raises on the rank that waits."""
    if not dist.is_initialized():
        raise RuntimeError("control_group: no process group (parallel/multihost.initialize)")
    return dist.new_group(backend="gloo", timeout=timeout)


def make_global_mesh(model: int = 1, *, device: str | torch.device | None = None):
    """A ``(data, model)`` mesh over every rank of the job (the model axis
    innermost: ranks of one host are consecutive under torchrun, so the
    model ranks' sums stay within a host)."""
    from whisper_burn_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(model=model, device=device)


def process_local_slice(mesh, n_global: int) -> slice:
    """Which rows of a global batch this rank loads (even split over the
    data ranks; the model ranks of one data index load the same rows)."""
    if n_global % mesh.data != 0:
        raise ValueError(f"global batch {n_global} not divisible by {mesh.data} data ranks")
    return mesh.rows(n_global)


def local_batch_to_global(mesh, local_batch: torch.Tensor) -> torch.Tensor:
    """Each rank's ``[B_local, ...]`` slice, gathered over the data ranks
    into the global ``[B_local * data, ...]`` batch on every rank."""
    from whisper_burn_tpu_torch.ops.collectives import all_gather

    if mesh.data == 1:
        return local_batch
    return torch.cat(all_gather(local_batch, mesh.data_group), dim=0)
