"""End-to-end transcription: audio -> mel -> encode -> decode -> text.

Port of ``whisper_burn_tpu/transcribe.py``: :func:`prepare_params`,
:func:`quantize_logit_embedding`, :func:`stitch_texts` and
:class:`WhisperPipeline`, the entry point a user calls (resample to 16 kHz
-> pad/truncate to one 30 s window -> log-mel -> greedy or beam decode ->
ids below EOT -> BPE text), with batches bucketed to powers of two and
long audio in overlapping windows.

What the JAX module has and this one does not:

* ``enable_compilation_cache``, JAX's persistent cache of compiled XLA
  programs, has no counterpart: PyTorch runs eagerly, and the CUDA kernels
  are built once per source into ``build/kernels`` (``ops/_build.py``);
* ``bucket_batches=False`` (decoding a batch at its own size) is not
  ported: every batch is bucketed, the JAX default, and serving pads its
  batches to one size itself (``serving.BatchingTranscriber``). Each
  unbucketed size would capture runners of its own.

With a ``mesh`` (``parallel/mesh.make_mesh``) the pipeline runs on every
rank of it (SPMD): each rank holds its shard of the params on its own
device, takes its data index's utterances of each batch and decodes them
on its shard (``parallel/sharded.decode_rows``), and the results are
gathered over the data ranks, so every rank returns the whole batch.
``transcribe_batch`` is ``prepare_batch`` (the host work, on one rank
where a server receives the requests) then ``decode_batch`` (on every
rank, with the batch ``serving`` hands over).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from whisper_burn_tpu_torch.audio.io import AudioBuffer
from whisper_burn_tpu_torch.audio.mel import WHISPER_HOP, MelFrontend, pad_or_trim
from whisper_burn_tpu_torch.audio.resample import resample_to_16k
from whisper_burn_tpu_torch.gguf.loader import LoadedModel
from whisper_burn_tpu_torch.languages import lang_token_id
from whisper_burn_tpu_torch.models.beam import beam_decode
from whisper_burn_tpu_torch.models.config import MAX_TOKENS, WhisperConfig
from whisper_burn_tpu_torch.models.params import attach_w8a8, fuse_attention_params
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops.compute import Compute, resolve_device
from whisper_burn_tpu_torch.tokenizer import WhisperTokenizer
from whisper_burn_tpu_torch.utils.profiling import StageTimer, ThroughputMeter

LOGIT_N_ALIGN = 512


def quantize_logit_embedding(tok_emb: torch.Tensor) -> dict:
    """int8 copy of the tied embedding for the logits matmul.

    ``tok_emb [Vp, D]`` -> ``{"qw": int8 [D, Vp512], "scales": f32
    [D/32, Vp512]}``: codes with 32-block absmax/127 scales along K=D, the
    layout kernel A takes. The vocab axis is padded to a multiple of 512
    (52224 at Large-V3); padded columns quantize to zeros and the logits
    mask them to -inf."""
    w = tok_emb.float().T  # [D, Vp]
    k, n = w.shape
    if k % 32:
        raise ValueError(f"embedding width {k} is not a multiple of 32")
    n_pad = -(-n // LOGIT_N_ALIGN) * LOGIT_N_ALIGN
    w = torch.nn.functional.pad(w, (0, n_pad - n))
    w3 = w.reshape(k // 32, 32, n_pad)
    s = torch.clamp_min(w3.abs().amax(dim=1), 1e-12) / 127.0
    qw = torch.clamp(torch.round(w3 / s[:, None, :]), -127, 127).to(torch.int8)
    return {"qw": qw.reshape(k, n_pad), "scales": s}


def prepare_params(params: dict, compute: Compute, tp: int = 1) -> dict:
    """Fuse the q/k/v projections, attach the W8A8 copies when
    ``compute.w8a8``, add the int8 logits embedding when
    ``compute.quantized_logits``, and cast dense weights, the embedding and
    the positions to the compute dtype (LayerNorm params, biases and
    quantization scales stay f32). Runs on the params' device. Under tensor
    parallelism pass ``tp``, the model axis's size: the fused N axis is
    then built shard-interleaved, for ``parallel/sharding.shard_params``
    (the W8A8 copies' column scales come from the whole K, as the JAX
    package's, before the split)."""
    params = fuse_attention_params(params, tp)
    if compute.w8a8:
        params = attach_w8a8(params)
    if compute.quantized_logits and "tok_emb_q" not in params["decoder"]:
        params = {
            **params,
            "decoder": {
                **params["decoder"],
                "tok_emb_q": quantize_logit_embedding(params["decoder"]["tok_emb"]),
            },
        }

    def cast(tree: dict) -> dict:
        out = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                out[key] = cast(v)
            elif key in ("w", "tok_emb", "pos"):
                out[key] = v.to(compute.dtype)
            else:
                out[key] = v
        return out

    return cast(params)


@dataclass
class TranscribeResult:
    text: str
    # the batch's wall time divided by its real (unpadded) size
    inference_ms: float
    tokens: np.ndarray  # generated ids (EOT-trimmed)
    lang_token: int


class PreparedBatch(NamedTuple):
    """A batch after the host work of :meth:`WhisperPipeline.prepare_batch`,
    ready for :meth:`WhisperPipeline.decode_batch` (and, in a server over a
    mesh, for the other ranks: ``serving.BatchingTranscriber``)."""

    samples: np.ndarray  # [padded B, window] float32 at 16 kHz
    lang_tokens: np.ndarray  # [padded B] int32, -1 where the language is detected
    detect: bool  # any row detects its language
    n: int  # the real utterances: the first n rows


def _norm_word(w: str) -> str:
    return w.strip(".,!?;:\"'").lower()


def stitch_texts(texts: Sequence[str], min_match: int = 2, max_match: int = 24) -> str:
    """Merge transcripts of overlapping audio windows into one text.

    Consecutive windows share ``overlap_seconds`` of audio, so the head of
    each transcript repeats the tail of the previous one. For each join,
    find the longest ``k`` (``min_match <= k <= max_match``) where the last
    ``k`` words of the accumulated text equal the first ``k`` words of the
    next transcript (case/punctuation-insensitive) and drop that duplicated
    prefix. If no aligned run exists (silence in the overlap, or decode
    divergence) the texts are joined as-is — never dropping unseen words.

    A word *split* by the previous window's hard cut is decoded whole by
    the next window; because the split fragment rarely matches, alignment
    is also attempted with the previous window's final word excluded, and
    that (likely fragmentary) word is dropped when the next window's
    overlap region covers it.
    """
    out_words: list[str] = []
    for text in texts:
        words = text.split()
        if not out_words:
            out_words = words
            continue
        if not words:
            continue

        def match_len(base: list[str]) -> int:
            limit = min(len(base), len(words), max_match)
            for k in range(limit, min_match - 1, -1):
                if [_norm_word(w) for w in base[-k:]] == [_norm_word(w) for w in words[:k]]:
                    return k
            return 0

        k = match_len(out_words)
        if k:
            out_words.extend(words[k:])
            continue
        # boundary-split word: retry with the (fragmentary) final word of
        # the previous window removed
        k = match_len(out_words[:-1])
        if k:
            out_words = out_words[:-1] + words[k:]
        else:
            out_words.extend(words)
    return " ".join(out_words).strip()


def _to_device(tree: dict, device: torch.device) -> dict:
    """Parameters (tensors or numpy arrays) on ``device``, dtypes kept."""
    return {k: _to_device(v, device) if isinstance(v, dict) else torch.as_tensor(v).to(device) for k, v in tree.items()}


class WhisperPipeline:
    """Parameters prepared once on one device, and the calls that serve
    audio through them: :meth:`transcribe`, :meth:`transcribe_batch`,
    :meth:`transcribe_long`.

    ``model`` is a :class:`LoadedModel` (``gguf.cache.load_whisper``) or
    ``(cfg, params)``, the leaves numpy arrays or tensors; the parameters
    go through :func:`prepare_params` for ``compute`` (``Compute.parity()``
    unless given) on ``device``, which is ``cuda`` unless the caller passes
    another (``resolve_device``: no CUDA device raises). ``frontend``
    "openai" takes the Slaney-normed mel and exact GELU, "reference" the
    unnormalized mel and tanh GELU. ``beam_width > 1`` decodes by beam
    search. A batch is always padded to the next power of two with silence
    and language 50259, as the JAX pipeline does: a quantized cross cache
    takes its scales over the whole batch, so the padding is part of the
    result. With a ``mesh`` the parameters are prepared for its
    model axis and sharded (``parallel/sharding.py``) on the mesh's device
    (``device`` must then be None or that device), and a batch is padded
    so that every data rank gets the same power-of-two count, as the JAX
    pipeline does. ``profile`` keeps per-stage wall times (audio prep, device
    step, detokenize) and throughput, read with :meth:`profile_report`.
    """

    def __init__(
        self,
        model: LoadedModel | tuple[WhisperConfig, dict],
        tokenizer: WhisperTokenizer | None = None,
        compute: Compute | None = None,
        frontend: str = "openai",
        max_tokens: int = MAX_TOKENS,
        beam_width: int = 1,
        task: str = "transcribe",
        mesh=None,
        profile: bool = False,
        device: str | torch.device | None = None,
    ):
        cfg, params = (model.config, model.params) if isinstance(model, LoadedModel) else model
        if frontend == "openai":
            cfg = cfg.replace(gelu="erf")
            mel_norm = "slaney"
        elif frontend == "reference":
            cfg = cfg.replace(gelu="tanh")
            mel_norm = None
        else:
            raise ValueError(f"unknown frontend {frontend!r}")
        tp = 1
        if mesh is not None:
            from whisper_burn_tpu_torch.parallel.mesh import Mesh
            from whisper_burn_tpu_torch.parallel.sharded import validate_tp

            if not isinstance(mesh, Mesh) or not mesh.in_mesh:
                raise ValueError(f"mesh must be this rank's parallel.mesh.Mesh (make_mesh), got {mesh!r}")
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            tp = validate_tp(cfg, mesh)
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self.config = cfg
        self.compute = compute or Compute.parity()
        self.tokenizer = tokenizer
        self.max_tokens = max_tokens
        self.beam_width = beam_width
        self.task = task
        self.params = prepare_params(_to_device(params, self.device), self.compute, tp)
        if mesh is not None:
            from whisper_burn_tpu_torch.parallel.sharding import shard_params

            self.params = shard_params(self.params, mesh)
        self.mel = MelFrontend(n_mels=cfg.n_mels, norm=mel_norm)
        # 30 s (480,000 samples) for real models; from the audio context so
        # small test configs work too (frames = 2 * n_audio_ctx)
        self.chunk_samples = cfg.n_audio_ctx * 2 * WHISPER_HOP
        self.profile = profile
        self.stage_timer = StageTimer(sync=True, device=self.device) if profile else None
        self.throughput = ThroughputMeter() if profile else None

    def _decode(self, samples: np.ndarray, lang_tokens: np.ndarray, detect: bool):
        if self.mesh is not None:  # this rank's utterances; the mel is per utterance
            rows = self.mesh.rows(len(samples))
            samples, lang_tokens = samples[rows], lang_tokens[rows]
        audio = torch.from_numpy(samples).to(self.device)
        langs = torch.from_numpy(lang_tokens).to(self.device)
        features = self.mel(audio)  # [B, n_mels, 2 * n_audio_ctx]
        cfg, compute = self.config, self.compute
        if self.mesh is not None:
            from whisper_burn_tpu_torch.parallel.sharded import decode_rows

            return decode_rows(
                self.params, cfg, features, langs, compute, self.mesh, beam_width=self.beam_width,
                detect=detect, max_tokens=self.max_tokens, task=self.task,
            )
        if self.beam_width > 1:
            return beam_decode(
                self.params, cfg, features, langs, compute, beam_width=self.beam_width,
                detect=detect, max_tokens=self.max_tokens, task=self.task,
            )
        return greedy_decode(
            self.params, cfg, features, langs, compute, detect=detect, max_tokens=self.max_tokens, task=self.task
        )

    # -- public API --------------------------------------------------------

    def transcribe(self, audio: AudioBuffer | np.ndarray, language: str | None = "auto") -> TranscribeResult:
        """Transcribe one utterance (<= 30 s; longer input is truncated like
        the reference — use :meth:`transcribe_long` for full coverage)."""
        return self.transcribe_batch([audio], [language])[0]

    def transcribe_batch(
        self,
        audios: Sequence[AudioBuffer | np.ndarray],
        languages: Sequence[str | None] | None = None,
    ) -> list[TranscribeResult]:
        """Transcribe a batch of utterances in one decode."""
        return self.decode_batch(self.prepare_batch(audios, languages))

    def prepare_batch(
        self,
        audios: Sequence[AudioBuffer | np.ndarray],
        languages: Sequence[str | None] | None = None,
    ) -> PreparedBatch:
        """The host part of :meth:`transcribe_batch`: each utterance
        resampled and padded or cut to one window, each language checked
        and turned into its token (an unknown one raises here, before
        anything reaches the device), and the batch padded with silence in
        language 50259 to a power of two (with a mesh: the same power of
        two on every data rank)."""
        stage = self.stage_timer.stage if self.profile else (lambda name: contextlib.nullcontext())
        if self.profile:
            self.throughput.begin()

        b = len(audios)
        if languages is None:
            languages = ["auto"] * b
        with stage("audio_prep"):
            samples = np.stack([self._prep_audio(a) for a in audios])
        lang_tokens = np.array([self._lang_token(l) for l in languages], np.int32)
        detect = bool((lang_tokens < 0).any())

        padded_b = 1 << (b - 1).bit_length()  # next power of two
        data = 1 if self.mesh is None else self.mesh.data
        if data > 1:
            # every data rank gets the same power-of-two utterance count
            per_rank = -(-padded_b // data)
            per_rank = 1 << max(0, per_rank - 1).bit_length() if per_rank > 1 else 1
            padded_b = data * per_rank
        if padded_b != b:
            pad = padded_b - b
            samples = np.concatenate([samples, np.zeros((pad,) + samples.shape[1:], samples.dtype)])
            lang_tokens = np.concatenate([lang_tokens, np.full(pad, 50259, np.int32)])
        return PreparedBatch(samples, lang_tokens, detect, b)

    def decode_batch(self, batch: PreparedBatch) -> list[TranscribeResult]:
        """The device part of :meth:`transcribe_batch`: the decode (with a
        mesh, on every rank with the same batch: each decodes its data
        index's rows, and the results are gathered), then the first
        ``batch.n`` rows detokenized. A rank that decodes only for the
        gather passes ``n = 0`` and gets an empty list."""
        stage = self.stage_timer.stage if self.profile else (lambda name: contextlib.nullcontext())
        samples, b = batch.samples, batch.n
        start = time.perf_counter()
        with stage("device_step"):
            result = self._decode(samples, batch.lang_tokens, batch.detect)
            tokens = result.tokens.cpu().numpy()  # waits for the device
        ms = (time.perf_counter() - start) * 1000.0 / max(b, 1)  # amortized per utterance
        n_gen = result.n_generated.cpu().numpy()
        langs = result.lang_tokens.cpu().numpy()

        out = []
        with stage("detokenize"):
            for i in range(b):
                ids = tokens[i, : n_gen[i]]
                text = self.tokenizer.decode_transcription(ids) if self.tokenizer else ""
                out.append(TranscribeResult(text, ms, ids, int(langs[i])))
        if self.profile and b:
            self.throughput.end(audio_seconds=b * samples.shape[1] / 16000.0, tokens=int(n_gen[:b].sum()))
        return out

    def transcribe_long(
        self,
        audio: AudioBuffer | np.ndarray,
        language: str | None = "auto",
        overlap_seconds: float = 5.0,
    ) -> TranscribeResult:
        """Chunked transcription for audio of any length.

        Windows of 30 s with ``overlap_seconds`` of shared audio between
        consecutive windows, decoded as one batch, then stitched word by
        word (:func:`stitch_texts`); ``overlap_seconds=0`` concatenates."""
        samples = self._to_16k(audio)
        n = len(samples)
        overlap = min(int(overlap_seconds * 16000), self.chunk_samples // 2)
        stride = self.chunk_samples - overlap if n > self.chunk_samples else self.chunk_samples
        starts = list(range(0, max(n - overlap, 1), stride))
        chunks = [samples[i : i + self.chunk_samples] for i in starts]
        results = self.transcribe_batch([np.asarray(c, np.float32) for c in chunks], [language] * len(chunks))
        texts = [r.text for r in results]
        text = stitch_texts(texts) if overlap and len(texts) > 1 else " ".join(t for t in texts if t).strip()
        return TranscribeResult(
            text=text,
            inference_ms=sum(r.inference_ms for r in results),
            tokens=np.concatenate([r.tokens for r in results]),
            lang_token=results[0].lang_token,
        )

    def profile_report(self) -> str:
        """Per-stage timings + throughput counters (requires profile=True)."""
        if not self.profile:
            return "profiling disabled (construct with profile=True)"
        lines = [self.stage_timer.report()]
        lines.append(
            f"throughput: {self.throughput.audio_s_per_s:.1f} audio-s/s, "
            f"{self.throughput.tokens_per_s:.1f} tok/s over "
            f"{self.throughput.wall_seconds:.2f}s"
        )
        return "\n".join(lines)

    # -- helpers -----------------------------------------------------------

    def _to_16k(self, audio: AudioBuffer | np.ndarray) -> np.ndarray:
        if isinstance(audio, AudioBuffer):
            if audio.sample_rate != 16000:
                audio = resample_to_16k(audio)
            return audio.samples
        return np.asarray(audio, np.float32)

    def _prep_audio(self, audio: AudioBuffer | np.ndarray) -> np.ndarray:
        return pad_or_trim(self._to_16k(audio), self.chunk_samples)

    def _lang_token(self, language: str | None) -> int:
        if language is None or language == "auto":
            return -1
        return lang_token_id(language, n_lang=self.config.n_lang)
