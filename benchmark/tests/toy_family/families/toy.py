"""A toy model family for the harness's tests: a seeded linear map from
log-power frames of the audio to logits, decoded greedily, one token a
frame. Plain torch, nothing of Whisper or the port. Its program
(``ToyProgram``) keeps to the program contract the offline traffic
drives (``transcribe_batch(audios, langs)``), in float32 over the whole
batch at once; its reference works each request out again in float64.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ToyShape:
    frame: int  # samples a frame
    vocab: int


@dataclasses.dataclass
class ToyServed:
    samples: np.ndarray
    rate: int
    tokens: list  # one id a frame
    best: list  # the program's logit of each id it served


def shape(config: dict) -> ToyShape:
    return ToyShape(config["config"]["frame"], config["config"]["vocab"])


def weights(s: ToyShape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(s.frame, s.vocab, generator=gen, device=device)


def features(frames: torch.Tensor) -> torch.Tensor:
    return torch.log(frames * frames + 1e-3)


class ToyProgram:
    def __init__(self, w: torch.Tensor, s: ToyShape, max_tokens: int):
        self.w, self.shape, self.max_tokens = w, s, max_tokens

    def transcribe_batch(self, audios, langs):
        n = self.max_tokens * self.shape.frame
        x = torch.stack([torch.as_tensor(a[:n], dtype=torch.float32) for a in audios]).to(self.w.device)
        logits = features(x.reshape(len(audios), self.max_tokens, self.shape.frame)) @ self.w
        best, tokens = logits.max(dim=-1)
        return [types.SimpleNamespace(tokens=t.cpu(), best=b.cpu()) for t, b in zip(tokens, best)]


def build(ctx) -> ToyProgram:
    return ToyProgram(weights(ctx.shape, ctx.seed, ctx.device), ctx.shape, ctx.params["max_tokens"])


def free() -> None:
    pass


def observe(program, params: dict):
    return types.SimpleNamespace(close=lambda: None)


def served(clip, result, params: dict) -> ToyServed:
    return ToyServed(clip.samples, clip.rate, result.tokens.tolist(), result.best.tolist())


def judge(ctx, sample: list, keep: bool = False) -> dict:
    """The widest gap between the program's logit of a served id and the
    reference's logit of the same id."""
    w, s = weights(ctx.shape, ctx.seed, ctx.device).double(), ctx.shape
    gaps = []
    for r in sample:
        n = len(r.tokens)
        frames = torch.as_tensor(np.asarray(r.samples[: n * s.frame], np.float64)).reshape(n, s.frame)
        logits = features(frames.to(w.device)) @ w
        ref = logits.gather(1, torch.tensor(r.tokens, device=w.device)[:, None])[:, 0]
        gaps.append((torch.tensor(r.best, dtype=torch.float64, device=w.device) - ref).abs().max())
    return {"max_logit_err": float(torch.stack(gaps).max())}


def faults(fault: str, beam_width: int = 1) -> list:
    """``token``: the first request's first id altered where it is produced."""
    if fault != "token":
        raise ValueError(f"unknown fault {fault!r}")
    transcribe = ToyProgram.transcribe_batch

    def altered(self, audios, langs):
        out = transcribe(self, audios, langs)
        out[0].tokens[0] = (out[0].tokens[0] + 1) % self.shape.vocab
        return out

    return [(ToyProgram, "transcribe_batch", altered)]
