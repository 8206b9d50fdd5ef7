"""Which axis of each parameter the model ranks split (the Megatron layout).

Port of ``whisper_burn_tpu/parallel/sharding.py``:

* ``attn_{q,k,v}``, ``attn_qkv``, ``xattn_{q,k,v}``, ``xattn_kv`` and
  ``fc1`` are column-parallel: split by output features (heads for the
  projections, the FFN width for fc1), codes, scales, biases and W8A8
  column scales alike, so attention and GELU run on the rank's shard;
* ``attn_o``, ``xattn_o`` and ``fc2`` are row-parallel: split by input
  features, their bias and W8A8 column scale replicated (the partial sums
  meet in ``ops/linear.apply_reduce_linear`` before the bias);
* everything else (embeddings, positions, convolutions, layer norms, the
  int8 logits embedding) is replicated.

A spec is a tuple with one entry per axis, ``"model"`` on the split one
and None elsewhere, as the JAX package's ``PartitionSpec``; stacked
``[L, ...]`` leaves carry a leading None. The fused projections must
have been built shard-interleaved (``models/params.fuse_attention_params``
with ``tp``).
"""

from __future__ import annotations

import numpy as np
import torch

COL_PARALLEL = {
    "attn_q", "attn_k", "attn_v", "attn_qkv",
    "xattn_q", "xattn_k", "xattn_v", "xattn_kv",
    "fc1",
}
ROW_PARALLEL = {"attn_o", "xattn_o", "fc2"}


def leaf_spec(keys: tuple, ndim: int) -> tuple:
    """The spec of the leaf at path ``keys`` with ``ndim`` axes."""
    leaf = keys[-1]
    parent = keys[-2] if len(keys) >= 2 else ""
    stacked = "blocks" in keys

    def with_l(*spec):
        return (None, *spec) if stacked else tuple(spec)

    if parent in COL_PARALLEL:
        if leaf in ("qw", "w", "qw8", "scales"):  # [L?, K, N], [L?, K/32, N]
            return with_l(None, "model")
        if leaf in ("b", "s8"):  # [L?, N]
            return with_l("model")
    if parent in ROW_PARALLEL:
        if leaf in ("qw", "w", "qw8", "scales"):
            return with_l("model", None)
        if leaf == "b":  # added after the sum: replicated
            return with_l()
        if leaf == "s8":  # a column's dequant scale: replicated
            return with_l(None)
    return with_l(*([None] * (ndim - (1 if stacked else 0))))


def param_pspecs(params: dict, _keys: tuple = ()) -> dict:
    """The spec tree matching ``params``."""
    return {k: param_pspecs(v, _keys + (k,)) if isinstance(v, dict) else leaf_spec(_keys + (k,), v.ndim)
            for k, v in params.items()}


def split_axis(spec: tuple) -> int | None:
    """The axis a spec splits over the model ranks, or None."""
    return spec.index("model") if "model" in spec else None


def shard_leaf(x, spec: tuple, model: int, index: int):
    """Model rank ``index``'s slice of ``x`` (a copy of its own), or ``x``."""
    axis = split_axis(spec)
    if axis is None or model == 1:
        return x
    n = x.shape[axis]
    if n % model:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} not divisible by model={model}")
    piece = [slice(None)] * x.ndim
    piece[axis] = slice(index * n // model, (index + 1) * n // model)
    part = x[tuple(piece)]
    return part.contiguous().clone() if isinstance(part, torch.Tensor) else np.ascontiguousarray(part)


def shard_params(params: dict, mesh) -> dict:
    """This rank's shard of ``params`` by :func:`param_pspecs` (tensors or
    numpy arrays, on their own device): the split leaves sliced to the
    rank's model index, the rest shared."""
    specs = param_pspecs(params)

    def walk(tree, spec):
        return {k: walk(v, spec[k]) if isinstance(v, dict) else shard_leaf(v, spec[k], mesh.model, mesh.model_index)
                for k, v in tree.items()}

    return walk(params, specs)
