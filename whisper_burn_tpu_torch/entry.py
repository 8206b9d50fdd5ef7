"""The flagship single-card step: the port's counterpart of the JAX
package's ``__graft_entry__.entry()``.

``entry()`` returns ``(fn, args)``: Whisper Large-V3 with the fabricated
Q4_0 fixture (the JAX package's numbers, seed 0), ``Compute.fast()`` (bf16
activations, unquantized bf16 caches, bf16 logits), and
``fn(params, mel, lang) = greedy_decode(..., max_tokens=16)`` on one
utterance of seeded random mel features. The parameters go through
``prepare_params``, which fuses the q/k/v and cross k/v projections and
casts the embedding and positions to bf16.

    fn, args = entry()
    result = fn(*args)  # GreedyResult, tokens [1, 16]

It runs on CUDA unless the caller passes another device.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import fabricated_quantized_params
from whisper_burn_tpu_torch.models.whisper import GreedyResult, greedy_decode
from whisper_burn_tpu_torch.ops.compute import Compute, resolve_device
from whisper_burn_tpu_torch.transcribe import prepare_params

MAX_TOKENS = 16


def entry(device=None):
    """``(fn, (params, mel, lang))`` for the flagship single-card step."""
    dev = resolve_device(device)
    cfg = WhisperConfig.large_v3()
    compute = Compute.fast()
    params = prepare_params(fabricated_quantized_params(cfg, seed=0, device=dev), compute)

    def fn(params: dict, mel: torch.Tensor, lang: torch.Tensor) -> GreedyResult:
        return greedy_decode(params, cfg, mel, lang, compute, max_tokens=MAX_TOKENS)

    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.standard_normal((1, cfg.n_mels, 3000)).astype(np.float32)).to(dev)
    lang = torch.full((1,), cfg.lang_token_start, dtype=torch.int32, device=dev)
    return fn, (params, mel, lang)
