"""Compute policy: activation dtype and quantized storage modes.

Port of ``whisper_burn_tpu/ops/compute.py``. There is no backend field: the
device of the tensors decides between a hand-written CUDA kernel (CUDA
tensors) and its plain PyTorch version (CPU tensors). Tensor parallelism is
``tp`` and ``tp_group``, the process group of the model ranks
(``parallel/mesh.py``), where the JAX package has ``tp`` and ``tp_axis``.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "whisper_burn_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def set_fp32_precision(compute: "Compute") -> None:
    """f32 compute means full f32 matmuls and convolutions on the card:
    TF32 (about three decimal digits) is turned off for both."""
    if compute.dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Compute:
    """Numerics policy threaded through the model.

    * ``parity()``: float32 activations (token-exact comparisons).
    * ``fast()``: bfloat16 activations with float32 accumulation.
    * ``fastest(kv_bits)``: bf16 + quantized cross-KV (int8, or int4 pairs
      with ``kv_bits=4``) + per-token int8 self-KV — the serving mode.
    * ``.replace(self_kv_bits=4)``: int4 self keys and values with
      per-token, per-channel-group scales; ``.replace(self_kv_vbits=4)``:
      int8 self keys, int4 values (the mixed mode).

    ``tp`` is the model axis's size: each rank holds ``n_heads // tp``
    heads and ``ffn_dim // tp`` of the FFN, and ``tp_group`` (a
    ``torch.distributed`` process group, None at ``tp = 1``) sums the
    row-parallel linears' partial products (``ops/linear.py``). The group
    hashes by identity, so a ``Compute`` stays a runner's key.
    """

    dtype: torch.dtype = torch.float32
    # cross-KV cache storage dtype; None = same as ``dtype``
    kv_dtype: torch.dtype | None = None
    # 4 packs two int4 values per stored byte; requires int8 kv_dtype
    kv_bits: int = 8
    # self-attention KV cache storage dtype; None = same as ``dtype``
    self_kv_dtype: torch.dtype | None = None
    self_kv_bits: int = 8
    self_kv_vbits: int | None = None
    # int8 tied-embedding logits (needs transcribe.prepare_params)
    quantized_logits: bool = False
    # int8 x int8 -> int32 matmuls for the encoder and the cross-KV fill
    w8a8: bool = False
    tp: int = 1
    tp_group: object = None

    @classmethod
    def parity(cls) -> "Compute":
        return cls(dtype=torch.float32)

    @classmethod
    def fast(cls) -> "Compute":
        return cls(dtype=torch.bfloat16)

    @classmethod
    def fastest(cls, kv_bits: int = 8) -> "Compute":
        return cls(
            dtype=torch.bfloat16,
            kv_dtype=torch.int8,
            kv_bits=kv_bits,
            self_kv_dtype=torch.int8,
        )

    @property
    def quantized_kv(self) -> bool:
        kv = self.dtype if self.kv_dtype is None else self.kv_dtype
        return kv == torch.int8

    @property
    def kv_packed(self) -> bool:
        return self.quantized_kv and self.kv_bits == 4

    @property
    def cross_kv_dtype(self) -> torch.dtype:
        if self.kv_packed:
            return torch.uint8  # biased-nibble pair container
        return self.dtype if self.kv_dtype is None else self.kv_dtype

    @property
    def quantized_self_kv(self) -> bool:
        kv = self.dtype if self.self_kv_dtype is None else self.self_kv_dtype
        return kv == torch.int8

    @property
    def self_kv_packed(self) -> bool:
        return self.quantized_self_kv and self.self_kv_bits == 4

    @property
    def self_v_packed(self) -> bool:
        """int4 values (the mixed int8-K / int4-V mode when keys are not)."""
        vbits = self.self_kv_bits if self.self_kv_vbits is None else self.self_kv_vbits
        return self.quantized_self_kv and vbits == 4

    @property
    def self_kv_storage_dtype(self) -> torch.dtype:
        """The self cache's key dtype: uint8 nibble pairs for int4 keys."""
        if self.self_kv_packed:
            return torch.uint8
        if self.quantized_self_kv:
            return torch.int8
        return self.dtype if self.self_kv_dtype is None else self.self_kv_dtype

    @property
    def self_v_storage_dtype(self) -> torch.dtype:
        return torch.uint8 if self.self_v_packed else self.self_kv_storage_dtype

    def __post_init__(self) -> None:
        vbits = self.self_kv_bits if self.self_kv_vbits is None else self.self_kv_vbits
        if self.self_kv_bits == 4 and vbits > 4:
            raise ValueError(
                "self_kv_vbits wider than self_kv_bits is unsupported "
                "(int4 keys require int4 values; the supported mixed mode "
                "is int8 keys + int4 values: self_kv_bits=8, self_kv_vbits=4)"
            )
        if self.tp < 1 or (self.tp > 1) != (self.tp_group is not None):
            raise ValueError(
                f"tp={self.tp} takes a model-rank process group exactly when tp > 1 "
                "(parallel/sharded.tp_compute builds it from a mesh)"
            )

    def replace(self, **kw) -> "Compute":
        return dataclasses.replace(self, **kw)
