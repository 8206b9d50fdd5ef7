"""The program's own log-probabilities of what it served, read off the
timed path by wrappers on the benchmark's side (the program is not
changed): what the check holds against the reference's.

While an ``Observer`` is installed on a pipeline, each call of its
``_decode`` (the model step of a batch) records, on the device and
without a host sync:

- greedy: for each stream and sample #k, the program's two best logits,
  the runner-up's id and the log-sum-exp of its logits, from the prompt's
  logits (``models/whisper.prompt_logits``, sample #0) and from each
  replayed step's logits (``GreedyRunner.step``, samples #1 on). In a
  sound run the best token is the one served;
- the language-detection pass (``prefill`` with ``logit_rows``): the
  same over the language logits;
- beam search: the program's length-normalized score of each returned
  hypothesis (``BeamResult.scores``).

``prepare_batch`` keeps the batch's raw clips (``Batch``: what the
reference needs to work out the batch-wide cross-KV scales again), and
``decode_batch`` hangs an ``Observed`` on each ``TranscribeResult`` it
returns, as ``result.observed``. The cost in the window: a top-2 and
a log-sum-exp over each step's logits, and three small copies.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Observed:
    """What the program said of one request it served. ``top`` holds a
    sample's two best logits, ``second`` the runner-up's id and ``lse``
    the log-sum-exp of its logits (NaN past the last step taken); the
    language's the same of the detection pass."""

    top: np.ndarray | None  # f32 [max_tokens, 2] (greedy)
    second: np.ndarray | None  # int64 [max_tokens]
    lse: np.ndarray | None  # f32 [max_tokens]
    lang_top: np.ndarray  # f32 [2] (NaN: not detected)
    lang_second: int
    lang_lse: float
    score: float  # the returned hypothesis' normalized score (beam; NaN for greedy)
    batch: "Batch | None" = None
    row: int = 0  # this request's row of ``batch``


@dataclasses.dataclass(eq=False)
class Batch:
    """The raw clips of one decoded batch, in its rows' order (the rows
    past them are silence: the pipeline pads a batch to a power of two)."""

    clips: list  # (samples, rate) a row
    rows: int  # the padded batch


class Observer:
    """Installs the wrappers on ``pipe`` (and on the program's decode
    functions) until :meth:`close`."""

    def __init__(self, pipe, max_tokens: int):
        from whisper_burn_tpu_torch.models import whisper

        self.pipe, self.max_tokens, self.whisper = pipe, max_tokens, whisper
        self.current = self.last = None
        self._decode, self._decode_batch, self._prepare = pipe._decode, pipe.decode_batch, pipe.prepare_batch
        self.clips = None
        self._step, self._prompt, self._prefill = whisper.GreedyRunner.step, whisper.prompt_logits, whisper.prefill
        pipe._decode, pipe.decode_batch, pipe.prepare_batch = self.decode, self.decode_batch, self.prepare_batch
        whisper.GreedyRunner.step = self._observed_step()
        whisper.prompt_logits = self.prompt_logits
        whisper.prefill = self.prefill

    def close(self) -> None:
        w = self.whisper
        w.GreedyRunner.step, w.prompt_logits, w.prefill = self._step, self._prompt, self._prefill
        for name in ("_decode", "decode_batch", "prepare_batch"):
            self.pipe.__dict__.pop(name, None)

    @staticmethod
    def record(logits: torch.Tensor, z: torch.Tensor, second: torch.Tensor, lse: torch.Tensor) -> None:
        """Rows of ``logits`` into ``z`` (two best), ``second`` (the
        runner-up's id) and ``lse`` (the padded vocab is at -inf in the
        program's logits, and so drops out)."""
        logits = logits.float()
        top = torch.topk(logits, 2, dim=-1)
        z.copy_(top.values)
        second.copy_(top.indices[:, 1])
        lse.copy_(torch.logsumexp(logits, dim=-1))

    def _observed_step(self):
        step, observer = self._step, self

        def observed_step(runner):
            logits = step(runner)
            cur = observer.current
            if cur is not None and cur["col"] < observer.max_tokens:
                k, b = cur["col"], cur["lse"].shape[0]
                observer.record(logits[:b], cur["z"][:, k], cur["id2"][:, k], cur["lse"][:, k])
                cur["col"] += 1
            return logits

        return observed_step

    def prompt_logits(self, *args, **kwargs):
        logits, lang_tokens = self._prompt(*args, **kwargs)
        cur = self.current
        if cur is not None:
            self.record(logits, cur["z"][:, 0], cur["id2"][:, 0], cur["lse"][:, 0])
            cur["col"] = 1
        return logits, lang_tokens

    def prefill(self, *args, **kwargs):
        logits = self._prefill(*args, **kwargs)
        cur = self.current
        if cur is not None and kwargs.get("logit_rows") is not None:  # the language-detection pass
            self.record(logits, cur["lang_z"], cur["lang_id2"], cur["lang_lse"])
        return logits

    def decode(self, samples, lang_tokens, detect):
        b, t = len(samples), self.max_tokens
        nan = lambda *shape: torch.full(shape, math.nan, device=self.pipe.device)
        ids = lambda *shape: torch.zeros(shape, dtype=torch.long, device=self.pipe.device)
        self.current = {"z": nan(b, t, 2), "id2": ids(b, t), "lse": nan(b, t), "col": 0,
                        "lang_z": nan(b, 2), "lang_id2": ids(b), "lang_lse": nan(b)}
        try:
            result = self._decode(samples, lang_tokens, detect)
        finally:
            cur, self.current = self.current, None
        cur["score"] = getattr(result, "scores", None)
        self.last = cur
        return result

    def prepare_batch(self, audios, languages=None):
        prepared = self._prepare(audios, languages)
        self.clips = [(a.samples, a.sample_rate) if hasattr(a, "sample_rate") else (np.asarray(a), 16_000)
                      for a in audios]
        return prepared

    def decode_batch(self, batch):
        clips, self.clips = self.clips, None
        out = self._decode_batch(batch)
        whole = Batch(clips, len(batch.samples)) if clips is not None else None
        cur, self.last = self.last, None
        host = {k: v.cpu().numpy() for k, v in cur.items() if isinstance(v, torch.Tensor)}
        beam = cur["score"] is not None
        for i, r in enumerate(out):
            r.observed = Observed(
                None if beam else host["z"][i], None if beam else host["id2"][i], None if beam else host["lse"][i],
                host["lang_z"][i], int(host["lang_id2"][i]), float(host["lang_lse"][i]),
                float(host["score"][i]) if beam else math.nan, whole, i)
        return out
