"""Manifest evaluation runner with per-utterance checkpoint/resume.

Port of ``whisper_burn_tpu/eval/runner.py``. Manifest = JSONL, one
``{"id": ..., "audio": "/path.wav", "text": "ref"}`` per line. Results
stream to ``<manifest>.results.jsonl`` as they complete, and a re-run
resumes from the finished ids.

Each batch is fed through the C++ host library (``native_host.load_batch``):
its files decoded, resampled to 16 kHz and padded to the pipeline's
window on their own threads. A file it cannot read fails the run, naming
the file. With ``WHISPER_TPU_NATIVE=0`` (or a pipeline without
``chunk_samples``) each file goes through ``audio.io.load_wav`` instead,
and the pipeline resamples and pads it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

from whisper_burn_tpu_torch import native_host
from whisper_burn_tpu_torch.audio.io import load_wav
from whisper_burn_tpu_torch.eval.wer import wer


@dataclass
class EvalSummary:
    n_utterances: int
    wer: float
    audio_seconds: float
    inference_seconds: float

    @property
    def rtf(self) -> float:
        """Real-time factor: audio seconds processed per wall second."""
        return self.audio_seconds / max(self.inference_seconds, 1e-9)


def read_manifest(path: str | Path) -> Iterator[dict]:
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def _feed(paths: list, chunk_samples: int | None) -> tuple[list, list[float]]:
    """One batch's audio and each file's duration in seconds: the native
    feeder's padded 16 kHz rows, or each file as loaded."""
    if chunk_samples and native_host.enabled():
        batch, statuses, lengths = native_host.load_batch(paths, chunk_samples)
        for path, status in zip(paths, statuses):
            if status != 0:
                raise ValueError(f"{path}: the native batch feeder cannot read it (status {status})")
        return list(batch), [float(n) / 16000.0 for n in lengths]
    loaded = [load_wav(p) for p in paths]
    return loaded, [a.duration_s for a in loaded]


def evaluate_manifest(
    pipeline,
    manifest_path: str | Path,
    *,
    results_path: str | Path | None = None,
    batch_size: int = 8,
    language: str | None = "en",
    resume: bool = True,
) -> EvalSummary:
    """Transcribe a manifest in fixed-size batches and report corpus WER.

    ``pipeline``: a :class:`whisper_burn_tpu_torch.transcribe.WhisperPipeline`.
    """
    manifest = list(read_manifest(manifest_path))
    if results_path is None:
        results_path = str(manifest_path) + ".results.jsonl"
    results_path = Path(results_path)

    done: dict[str, dict] = {}
    if resume and results_path.exists():
        for row in read_manifest(results_path):
            done[str(row["id"])] = row

    todo = [row for row in manifest if str(row["id"]) not in done]

    with results_path.open("a") as out:
        for start in range(0, len(todo), batch_size):
            chunk = todo[start : start + batch_size]
            audios, durations = _feed([row["audio"] for row in chunk], getattr(pipeline, "chunk_samples", None))
            results = pipeline.transcribe_batch(audios, [language] * len(chunk))
            for row, dur, res in zip(chunk, durations, results):
                rec = {
                    "id": str(row["id"]),
                    "text": res.text,
                    "ref": row.get("text", ""),
                    "audio_s": dur,
                    # TranscribeResult.inference_ms is already amortized
                    # over the real batch size (transcribe.py)
                    "inference_ms": res.inference_ms,
                }
                done[rec["id"]] = rec
                out.write(json.dumps(rec) + "\n")
            out.flush()  # checkpoint: a killed run resumes from here

    rows = [done[str(row["id"])] for row in manifest if str(row["id"]) in done]
    refs = [r["ref"] for r in rows]
    hyps = [r["text"] for r in rows]
    return EvalSummary(
        n_utterances=len(rows),
        wer=wer(refs, hyps, language=language) if rows else 0.0,
        audio_seconds=sum(r["audio_s"] for r in rows),
        inference_seconds=sum(r["inference_ms"] for r in rows) / 1000.0,
    )
