"""Sharded transcription: utterances over the data ranks, heads and the
FFN width over the model ranks.

Port of ``whisper_burn_tpu/parallel/sharded.py``, where ``shard_map``
gives every Pallas kernel its shard's shapes. Here each rank is a process
(SPMD) that holds its shard of the params on its own device and runs the
port's own ``greedy_decode``/``beam_decode`` on its data index's rows, in
a ``Compute`` whose ``tp_group`` is its model ranks' group, so each
kernel sees its shard's shapes:

* the batch splits over the data ranks, which do not communicate until
  the results are gathered (every rank returns the whole batch);
* q/k/v and fc1 are column-parallel, attn_o, xattn_o and fc2 row-parallel
  with one all-reduce each (``ops/linear.apply_reduce_linear``): two per
  encoder layer, three per decoder layer in the prompt pass and in each
  decode step, none in the cross fill or the logits;
* the caches hold the shard's heads (``[L, B / data, T, D / model]``);
* the logits come from the replicated residual stream and the replicated
  embedding, so the argmax, the beams' top-k and the stop logic agree on
  every model rank; beams stay with their utterance's data rank.

On the card the decode loop is the runners' CUDA graphs with the
all-reduces captured in them (NCCL); a gloo group on CUDA tensors is
refused there (``models/whisper.check_capturable``).
"""

from __future__ import annotations

import torch

from whisper_burn_tpu_torch.models.beam import BeamResult, beam_decode
from whisper_burn_tpu_torch.models.config import MAX_TOKENS, WhisperConfig
from whisper_burn_tpu_torch.models.whisper import GreedyResult, greedy_decode
from whisper_burn_tpu_torch.ops.collectives import all_gather
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.parallel.guard import ReplicationError, replication_mismatch
from whisper_burn_tpu_torch.parallel.mesh import Mesh
from whisper_burn_tpu_torch.parallel.sharding import shard_params


def tp_compute(compute: Compute, mesh: Mesh) -> Compute:
    """``compute`` on this rank's shard: ``tp`` the model axis's size and
    ``tp_group`` its group (None at 1: no sum at all)."""
    return compute.replace(tp=mesh.model, tp_group=mesh.model_group if mesh.model > 1 else None)


def validate_tp(cfg: WhisperConfig, mesh: Mesh) -> int:
    """The model axis must divide the head counts (Megatron head sharding)
    and every quantized K shard must stay 32-block aligned."""
    tp = mesh.shape.get("model", 1)
    if tp == 1:
        return tp
    for name, heads in (("audio", cfg.n_audio_head), ("text", cfg.n_text_head)):
        if heads % tp:
            raise ValueError(f"model axis {tp} does not divide n_{name}_head={heads}")
    for name, k in (("state", cfg.n_audio_state), ("ffn", cfg.ffn_dim)):
        if (k // tp) % 32:
            raise ValueError(f"model axis {tp} breaks Q4 32-block alignment of {name}={k}")
    return tp


def shard_params_tp(params: dict, mesh: Mesh) -> dict:
    """This rank's shard of ``params`` (``parallel/sharding.py``). Fused
    params (``attn_qkv``, ``xattn_kv``) must have been built
    shard-interleaved (``prepare_params(..., tp=mesh.model)``)."""
    return shard_params(params, mesh)


def gather_result(result, mesh: Mesh):
    """Each tensor of ``result`` gathered over the data ranks, in data
    order: the whole batch on every rank."""
    if mesh.data == 1:
        return result
    return type(result)(*(torch.cat(all_gather(x, mesh.data_group), dim=0) for x in result))


def decode_rows(params: dict, cfg: WhisperConfig, mel: torch.Tensor, lang_tokens: torch.Tensor,
                compute: Compute, mesh: Mesh, *, beam_width: int = 1, detect: bool = False,
                max_tokens: int = MAX_TOKENS, task: str = "transcribe", length_penalty: float = 1.0,
                debug_replication: bool = False):
    """Decode this rank's rows (``mel`` and ``lang_tokens`` already its
    data index's slice) on its shard, then gather the results over the
    data ranks. ``debug_replication`` checks that the model ranks agree
    (``parallel/guard.py``) and raises :class:`ReplicationError` if not."""
    validate_tp(cfg, mesh)
    local = tp_compute(compute, mesh)
    if beam_width > 1:
        result = beam_decode(params, cfg, mel, lang_tokens, local, beam_width=beam_width, detect=detect,
                             max_tokens=max_tokens, length_penalty=length_penalty, task=task)
    else:
        result = greedy_decode(params, cfg, mel, lang_tokens, local, detect=detect, max_tokens=max_tokens, task=task)
    if debug_replication:
        mismatch = replication_mismatch(result, mesh.model_group, mesh.model, mesh.model_index)
        if mismatch:
            raise ReplicationError(
                f"results diverged across the model ranks: {mismatch} mismatching elements "
                "(a row-parallel sum is missing or broken)"
            )
    return gather_result(result, mesh)


def sharded_greedy_decode(params: dict, cfg: WhisperConfig, mel: torch.Tensor, lang_tokens: torch.Tensor,
                          compute: Compute, mesh: Mesh, *, detect: bool = False, max_tokens: int = MAX_TOKENS,
                          task: str = "transcribe", debug_replication: bool = False) -> GreedyResult:
    """DP x TP greedy decode. ``mel [B, n_mels, T]`` and ``lang_tokens
    [B]`` are the whole batch (B divisible by the data axis), the same on
    every rank; ``params`` this rank's shard (:func:`shard_params_tp`).
    Returns the whole batch's :class:`GreedyResult` on every rank."""
    rows = mesh.rows(mel.shape[0])
    return decode_rows(params, cfg, mel[rows], lang_tokens[rows], compute, mesh, detect=detect,
                       max_tokens=max_tokens, task=task, debug_replication=debug_replication)


def sharded_beam_decode(params: dict, cfg: WhisperConfig, mel: torch.Tensor, lang_tokens: torch.Tensor,
                        compute: Compute, mesh: Mesh, *, beam_width: int = 5, detect: bool = False,
                        max_tokens: int = MAX_TOKENS, length_penalty: float = 1.0, task: str = "transcribe",
                        debug_replication: bool = False) -> BeamResult:
    """DP x TP beam decode: an utterance's beams stay on its data rank, so
    the hypotheses' reorder is local (``models/beam.py``)."""
    rows = mesh.rows(mel.shape[0])
    return decode_rows(params, cfg, mel[rows], lang_tokens[rows], compute, mesh, beam_width=beam_width,
                       detect=detect, max_tokens=max_tokens, length_penalty=length_penalty, task=task,
                       debug_replication=debug_replication)
