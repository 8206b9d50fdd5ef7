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

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: one sharded transcription step on a
``(n // 2, 2)`` mesh of ``n`` ranks (processes started here, on
``cuda:0 .. n-1`` with NCCL, or on the CPU with gloo where the caller asks).
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


def _dryrun_rank(rank: int, n: int, port: int, device) -> None:
    from whisper_burn_tpu_torch.models.params import random_params
    from whisper_burn_tpu_torch.parallel import make_mesh, shard_params_tp, sharded_beam_decode, sharded_greedy_decode
    from whisper_burn_tpu_torch.parallel.multihost import initialize

    if device == "cpu":
        torch.set_num_threads(1)  # n ranks share the host's cores
    dev = initialize(f"localhost:{port}", n, rank, device=device if device == "cpu" else f"cuda:{rank}")
    try:
        tp = 2 if n % 2 == 0 else 1
        mesh = make_mesh(data=n // tp, model=tp, device=dev)
        # a small Whisper whose 64-wide heads every kernel takes, its
        # audio context the smallest the cross kernels tile
        cfg = WhisperConfig.tiny_test().replace(
            n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4, n_audio_ctx=128, n_text_ctx=64)
        # the serving configuration: fused shard-interleaved q/k/v, int8
        # self-KV and int4 cross-KV
        compute = Compute.fastest(kv_bits=4)
        params = shard_params_tp(prepare_params(random_params(cfg, seed=0, device=dev), compute, tp), mesh)
        batch = mesh.data * 2  # two utterances a data rank
        rng = np.random.default_rng(0)
        mel = torch.from_numpy(rng.standard_normal((batch, cfg.n_mels, cfg.n_audio_ctx * 2)).astype(np.float32)).to(dev)
        lang = torch.full((batch,), cfg.lang_token_start, dtype=torch.int32, device=dev)
        tokens = sharded_greedy_decode(params, cfg, mel, lang, compute, mesh, max_tokens=8).tokens
        assert tuple(tokens.shape) == (batch, 8), tokens.shape
        beam = sharded_beam_decode(params, cfg, mel, lang, compute, mesh, beam_width=2, max_tokens=8).tokens
        assert beam.shape[0] == batch, beam.shape
        if rank == 0:
            print(f"dryrun_multichip OK: mesh(data={mesh.data}, model={mesh.model}), fused + quantized-KV, "
                  f"greedy tokens {tuple(tokens.shape)} + beam_width=2 tokens {tuple(beam.shape)}")
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One sharded (DP x TP) transcription step, greedy then 2-beam, on
    ``n_devices`` ranks: one process per card (``device=None``, NCCL) or
    per CPU rank (``device="cpu"``, gloo). Raises if a rank fails."""
    import socket

    import torch.multiprocessing as mp

    if device is None:
        resolve_device("cuda")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"need {n_devices} CUDA devices, have {torch.cuda.device_count()}")
    elif torch.device(device).type != "cpu":
        raise ValueError("dryrun_multichip runs one rank a card (device=None) or on the CPU (device='cpu')")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    mp.spawn(_dryrun_rank, args=(n_devices, port, None if device is None else "cpu"), nprocs=n_devices)
