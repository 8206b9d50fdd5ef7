"""Scale-out on ``torch.distributed``: meshes of ranks, the Megatron
layout, and DP x TP transcription.

Port of ``whisper_burn_tpu/parallel/``. One process per rank (SPMD), each
holding its shard of the params on its own device (``cuda:LOCAL_RANK``
with NCCL unless the caller asks for the CPU, gloo):

* DP: utterance batches split over the mesh's ``data`` ranks;
* TP: Megatron weight sharding over its ``model`` ranks (q/k/v and fc1
  split by output features, attn_o, xattn_o and fc2 by input features,
  one all-reduce after each of those), every kernel at its shard's shapes.

``mesh``, ``sharding``, ``sharded``, ``multihost``, ``guard`` and
``audit`` are the JAX package's modules of the same names. No pipeline
or expert parallelism (Whisper has no experts, and its stacks fit one
card).
"""

from whisper_burn_tpu_torch.parallel.mesh import Mesh, make_mesh
from whisper_burn_tpu_torch.parallel.sharded import (
    sharded_beam_decode,
    sharded_greedy_decode,
    shard_params_tp,
    tp_compute,
    validate_tp,
)
from whisper_burn_tpu_torch.parallel.sharding import param_pspecs, shard_params

__all__ = [
    "Mesh",
    "make_mesh",
    "param_pspecs",
    "shard_params",
    "shard_params_tp",
    "sharded_greedy_decode",
    "sharded_beam_decode",
    "tp_compute",
    "validate_tp",
]
