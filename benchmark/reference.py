"""The plain reference that decides ``correct``: Whisper in float32 PyTorch.

It follows the published model (openai/whisper ``model.py``): a two-layer
GELU conv stem, sinusoidal positions, pre-LayerNorm encoder blocks, a
decoder with learned positions, causal self-attention, cross-attention
over the encoder output and a tied-embedding output projection; exact
(erf) GELU, LayerNorm eps 1e-5, attention scaled by 1/sqrt(head width).
Every matrix product runs in float32 with TF32 off. It works out again
from the benchmark's own inputs everything the program derives: the Q4_0
weights are dequantized here (``W = codes x block scale``), the log-mel is
computed here (``torch.stft``, Slaney filters written from librosa's
documentation), 44.1 kHz audio is resampled here (scipy's polyphase
filter), and the numbers the configuration stores quantized (``Numerics``:
the cross and self caches, the int8 logits table, W8A8) are quantized here
from its own values, the cross caches with the scales of the whole batch
the request was decoded in. The activations it keeps in float32, where the
configuration keeps them in bf16.

It imports neither ``jax`` nor the JAX package nor anything of the port
(``benchmark/tests/test_bench_imports.py`` checks it in a fresh interpreter), and
takes nothing the program made: the caller hands it the weights drawn
again from the seed and the batches' raw audio.

What it judges is what the program served and what the program said of it
(``benchmark/observe.py``), teacher-forced over each prompt and its
served tokens: at each sample, the gap between the program's best logit
and the reference's logit of the token served (a token served that is not
the program's best, or that the reference rates otherwise than the
program does, both show), and the same of its log-probability and of its
margin over the program's runner-up; for a detected language the same
over the language logits; in beam search, the gap between the program's
normalized score of its hypothesis and the reference's mean
log-probability of the same tokens. The control (``lowered``) is this
reference with its decoder in float8, judged the same way.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.model_config import EOT, LANG_START, MIN_TOKENS, PROMPT_LEN, Q4_BLOCK, SOT, ModelShape

N_FFT, HOP, RATE = 400, 160, 16_000
LN_EPS = 1e-5
ROWS_AT_ONCE = 4  # utterances a reference pass holds at once


# -- audio -----------------------------------------------------------------


def resample_16k(samples: np.ndarray, rate: int) -> np.ndarray:
    """Polyphase resampling to 16 kHz in float64 (scipy's filter)."""
    if rate == RATE:
        return np.asarray(samples, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(rate, RATE)
    return resample_poly(np.asarray(samples, np.float64), RATE // g, rate // g).astype(np.float32)


def pad_or_trim(samples: np.ndarray, chunk: int) -> np.ndarray:
    """The window the model sees: 2 x n_audio_ctx mel frames (30 s)."""
    out = np.zeros(chunk, np.float32)
    n = min(len(samples), chunk)
    out[:n] = samples[:n]
    return out


def slaney_mel(hz: np.ndarray) -> np.ndarray:
    """Hz to mels on Slaney's scale (the Auditory Toolbox's, which librosa's
    ``hz_to_mel(htk=False)`` documents): 3 mels every 200 Hz up to 1 kHz
    (15 mels there), then 27 mels every factor of 6.4."""
    hz = np.asarray(hz, dtype=np.float64)
    log_part = 15.0 + 27.0 * np.log(np.maximum(hz, 1000.0) / 1000.0) / np.log(6.4)
    return np.where(hz < 1000.0, 3.0 * hz / 200.0, log_part)


def slaney_hz(mel: np.ndarray) -> np.ndarray:
    """The inverse of :func:`slaney_mel`."""
    mel = np.asarray(mel, dtype=np.float64)
    return np.where(mel < 15.0, 200.0 * mel / 3.0, 1000.0 * 6.4 ** ((mel - 15.0) / 27.0))


def mel_filters(n_mels: int) -> np.ndarray:
    """``[n_freqs, n_mels]``: librosa's ``filters.mel(sr=16000, n_fft=400,
    n_mels, fmin=0, fmax=8000, htk=False, norm="slaney")``, from which
    openai/whisper's ``mel_filters.npz`` was made, written from its
    documentation: ``n_mels + 2`` points evenly spaced in mels over 0-8 kHz,
    filter ``m`` a triangle over the FFT bins' frequencies rising from
    point ``m`` to 1 at point ``m + 1`` and falling to 0 at point ``m + 2``,
    scaled by ``2 / (hz[m + 2] - hz[m])`` (each filter's area is then the
    same in Hz)."""
    bins = np.linspace(0.0, RATE / 2, N_FFT // 2 + 1)
    points = slaney_hz(np.linspace(slaney_mel(0.0), slaney_mel(RATE / 2), n_mels + 2))
    out = np.zeros((len(bins), n_mels))
    for m in range(n_mels):
        lo, mid, hi = points[m : m + 3]
        rising, falling = (bins - lo) / (mid - lo), (hi - bins) / (hi - mid)
        out[:, m] = np.clip(np.minimum(rising, falling), 0.0, None) * 2.0 / (hi - lo)
    return out.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """``[B, 480000]`` float32 at 16 kHz -> ``[B, n_mels, 3000]`` (30 s): Whisper's
    log-mel (periodic Hann, reflect-padded STFT, power, Slaney filters,
    log10 floored at 1e-10 and at the utterance's max - 8, then (x + 4) / 4)."""
    window = torch.hann_window(N_FFT, periodic=True, dtype=torch.float64, device=audio.device)
    spec = torch.stft(audio.double(), N_FFT, HOP, window=window, center=True, pad_mode="reflect", return_complex=True)
    power = spec[..., :-1].abs() ** 2  # [B, n_freqs, 3000]
    fb = torch.from_numpy(mel_filters(n_mels)).double().to(audio.device)
    mel = torch.einsum("bft,fm->bmt", power, fb)
    log_spec = torch.log10(torch.clamp_min(mel, 1e-10))
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).float()


# -- model -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Numerics:
    """The stored numbers a configuration states (its file's ``compute``),
    which the reference works out again in float32 from its own inputs:
    ``cross_bits`` int4 or int8 cross keys and values with one scale a
    channel over the whole batch and every frame (absmax/7 codes in
    [-8, 7], or absmax/127 in [-127, 127]); ``self_int8`` int8 self keys
    and values with one absmax/127 scale a token, which a decode step reads
    for every earlier position (its own key and value it takes as
    computed, and the prompt's rows attend to each other as computed);
    ``logits_int8`` the tied embedding in int8 codes with an absmax/127
    scale a vocab column and 32 rows; ``w8a8`` every encoder linear and the
    cross-KV projections in int8 activations (absmax/127 a row) times int8
    weights (absmax/127 a column of the dequantized Q4 weight). The
    activations' own dtype (bf16) is not modelled: what is left between
    the program and the reference is its rounding."""

    cross_bits: int | None = None
    self_int8: bool = False
    logits_int8: bool = False
    w8a8: bool = False

    @classmethod
    def of(cls, compute: dict) -> "Numerics":
        if compute["preset"] != "fastest":
            raise ValueError(f"unknown compute preset {compute['preset']!r}")
        return cls(cross_bits=compute["kv_bits"], self_int8=True, logits_int8=compute["quantized_logits"],
                   w8a8=compute["w8a8"])


def _weight(lin: dict, layer: int) -> torch.Tensor:
    return lin["qw"][layer].float() * lin["scales"][layer].float().repeat_interleave(Q4_BLOCK, dim=0)


def _round_trip(x: torch.Tensor, scale: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), lo, hi) * scale


def _row_scale(x: torch.Tensor) -> torch.Tensor:
    """absmax/127 of each row (the last axis)."""
    return torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-8) / 127.0


def _ln(p: dict, x: torch.Tensor, layer: int | None = None) -> torch.Tensor:
    g, b = (p["g"], p["b"]) if layer is None else (p["g"][layer], p["b"][layer])
    return F.layer_norm(x, (x.shape[-1],), g.float(), b.float(), LN_EPS)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, heads, d // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    q, k, v = (_heads(x, heads) for x in (q, k, v))
    scores = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    return _merge(torch.softmax(scores, dim=-1) @ v)


def _attend_causal(q, k, v, kc, vc, heads: int) -> torch.Tensor:
    """Causal self-attention where row ``p`` past the prompt reads the
    cache's keys and values ``kc``, ``vc`` at every earlier position and
    its own ``k``, ``v`` as computed; the prompt's rows read ``k``, ``v``."""
    q, k, v, kc, vc = (_heads(x, heads) for x in (q, k, v, kc, vc))
    t = q.shape[2]
    row, col = torch.arange(t, device=q.device)[:, None], torch.arange(t, device=q.device)[None, :]
    exact = (row < PROMPT_LEN) | (row == col)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.where(exact, q @ k.transpose(-1, -2), q @ kc.transpose(-1, -2)) * scale
    probs = torch.softmax(scores.masked_fill(col > row, float("-inf")), dim=-1)
    return _merge(torch.where(exact, probs, 0.0) @ v + torch.where(exact, 0.0, probs) @ vc)


class Reference:
    """Whisper of ``shape`` in float32 over ``weights``
    (``benchmark/weights.py``), with the configuration's stored numbers
    (``numerics``; the default stores nothing quantized). ``lowered``
    makes it the control: its decoder holds every activation in float8
    e4m3, the precision below the configuration's bf16 (the encoder and
    the cross keys and values are the float32 reference's)."""

    def __init__(self, shape: ModelShape, weights: dict, numerics: Numerics = Numerics(), lowered: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.shape, self.w, self.num, self.lowered = shape, weights, numerics, lowered
        self._table = None

    def _linear(self, lin: dict, layer: int, x: torch.Tensor, w8a8: bool = False) -> torch.Tensor:
        w = _weight(lin, layer)
        if w8a8 and self.num.w8a8:
            ws = torch.clamp_min(w.abs().amax(dim=0), 1e-12) / 127.0
            xs = _row_scale(x)
            y = (torch.round(x / xs) @ torch.clamp(torch.round(w / ws), -127, 127)) * xs * ws
        else:
            y = x @ w
        return y + lin["b"][layer] if "b" in lin else y

    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """``[B, n_mels, 3000]`` -> ``[B, 1500, D]``, ``ROWS_AT_ONCE`` rows
        at a time through each layer."""
        enc = self.w["encoder"]
        chunks = []
        for m in mel.split(ROWS_AT_ONCE):
            x = _gelu(F.conv1d(m, enc["conv1"]["w"], enc["conv1"]["b"], padding=1))
            x = _gelu(F.conv1d(x, enc["conv2"]["w"], enc["conv2"]["b"], stride=2, padding=1))
            chunks.append(x.transpose(1, 2) + enc["pos"][None, : x.shape[2]])
        blocks = enc["blocks"]
        for l in range(self.shape.encoder_layers):
            for i, x in enumerate(chunks):
                h = _ln(blocks["attn_ln"], x, l)
                q, k, v = (self._linear(blocks[n], l, h, True) for n in ("attn_q", "attn_k", "attn_v"))
                x = x + self._linear(blocks["attn_o"], l, _attend(q, k, v, self.shape.heads), True)
                h = _ln(blocks["mlp_ln"], x, l)
                chunks[i] = x + self._linear(blocks["fc2"], l, _gelu(self._linear(blocks["fc1"], l, h, True)), True)
        return _ln(enc["ln_post"], torch.cat(chunks))

    def cross_kv(self, features: torch.Tensor, rows: list[int]) -> list:
        """Each decoder layer's cross keys and values ``[len(rows), 1500,
        D]`` of ``rows`` of a batch whose encoder output is ``features``
        ``[B, 1500, D]``: quantized with the batch's scales where the
        configuration stores them so."""
        blocks = self.w["decoder"]["blocks"]
        bits = self.num.cross_bits
        out = []
        for l in range(self.shape.decoder_layers):
            kv = []
            for name in ("xattn_k", "xattn_v"):
                x = self._linear(blocks[name], l, features, True)
                if bits is not None:
                    hi, lo = (7, -8) if bits == 4 else (127, -127)
                    x = _round_trip(x, torch.clamp_min(x.abs().amax(dim=(0, 1)), 1e-8) / hi, lo, hi)
                kv.append(x[rows])
            out.append(tuple(kv))
        return out

    def logits_table(self) -> torch.Tensor:
        """``[n_vocab, D]``: the tied embedding as the logits product reads it."""
        emb = self.w["decoder"]["tok_emb"][: self.shape.n_vocab].float()
        if not self.num.logits_int8:
            return emb
        v, d = emb.shape
        blocks = emb.T.reshape(d // 32, 32, v)
        return _round_trip(blocks, torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True), 1e-12) / 127.0,
                           -127, 127).reshape(d, v).T

    def logits(self, cross: list, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced logits ``[B, T, n_vocab]`` of ``tokens [B, T]``
        over ``cross`` (:meth:`cross_kv` of these B rows), and the first
        row's language logits ``[B, n_lang]``: the detection pass projects
        onto the embedding's language rows as they are, never the int8
        table."""
        dec = self.w["decoder"]
        t = tokens.shape[1]
        r = self.rounded
        x = r(dec["tok_emb"][tokens] + dec["pos"][None, :t])
        blocks = dec["blocks"]
        cached = (lambda z: _round_trip(z, _row_scale(z), -127, 127)) if self.num.self_int8 else (lambda z: z)
        for l in range(self.shape.decoder_layers):
            h = r(_ln(blocks["attn_ln"], x, l))
            q, k, v = (r(self._linear(blocks[n], l, h)) for n in ("attn_q", "attn_k", "attn_v"))
            a = r(_attend_causal(q, k, v, cached(k), cached(v), self.shape.heads))
            x = r(x + r(self._linear(blocks["attn_o"], l, a)))
            h = r(_ln(blocks["xattn_ln"], x, l))
            q = r(self._linear(blocks["xattn_q"], l, h))
            x = r(x + r(self._linear(blocks["xattn_o"], l, r(_attend(q, *cross[l], self.shape.heads)))))
            h = r(_ln(blocks["mlp_ln"], x, l))
            x = r(x + r(self._linear(blocks["fc2"], l, r(_gelu(self._linear(blocks["fc1"], l, h))))))
        if self._table is None:
            self._table = self.logits_table()
        x = r(_ln(dec["ln"], x))
        langs = dec["tok_emb"][LANG_START : LANG_START + self.shape.n_lang].float()
        return x @ self._table.T, x[:, 0] @ langs.T

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the decoder holds it: as computed, or for the control
        (``lowered``) in float8."""
        return to_float8(x) if self.lowered else x


def to_float8(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to float8 e4m3 with one scale a row (absmax to 448)."""
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


# -- the comparison --------------------------------------------------------


@dataclasses.dataclass
class Served:
    """What the program served for one request, the audio it was given and
    what the program said of it."""

    samples: np.ndarray  # mono, at ``rate``
    rate: int
    lang_token: int  # the language token the program used
    detected: bool  # the program chose it (language "auto")
    tokens: list  # the served ids, EOT trimmed
    max_tokens: int
    observed: object = None  # ``benchmark.observe.Observed``: what the program said of it


def _prompt(shape: ModelShape, lang: int) -> list:
    return [SOT, lang, shape.transcribe_token, shape.no_timestamps_token]


def _gap(program, reference: torch.Tensor) -> torch.Tensor:
    """|program - reference| in float64 on the host, infinite where either
    is not a finite number (a step the program never took, a token the
    reference rules out)."""
    prog = torch.as_tensor(program, dtype=torch.float64).cpu()
    ref = torch.as_tensor(reference).double().cpu()
    gap = (prog - ref).abs()
    return torch.where(torch.isfinite(prog) & torch.isfinite(ref), gap, torch.full_like(gap, math.inf))


def _said(top: np.ndarray, second: np.ndarray, lse: np.ndarray, ref_logits: torch.Tensor, served: torch.Tensor) -> dict:
    """Per sample, the gaps between what the program said and what the
    reference works out for the token served: its log-probability
    (``lp``), its logit (``logit``) and its margin over the program's
    runner-up (``margin``)."""
    z = torch.from_numpy(np.asarray(top, np.float64))
    runner_up = torch.from_numpy(np.asarray(second, np.int64)).to(ref_logits.device)
    ref = ref_logits.double()
    logp = torch.log_softmax(ref, dim=-1)
    valid = (served >= 0) & (served < ref.shape[-1])  # an id outside the vocabulary is infinitely wrong
    at = lambda x, ids: torch.where(valid, x.gather(-1, torch.where(valid, ids, 0)[..., None])[..., 0], -math.inf)
    z_served, z_second = at(ref, served), ref.gather(-1, runner_up.clamp(0, ref.shape[-1] - 1)[..., None])[..., 0]
    prog_lp = z[..., 0] - torch.from_numpy(np.asarray(lse, np.float64))
    return {"lp": _gap(prog_lp, at(logp, served)), "logit": _gap(z[..., 0], z_served),
            "margin": _gap(z[..., 0] - z[..., 1], z_served - z_second)}


class _Readings:
    """The gaps of one side (the program, or the control) over the
    judged requests."""

    def __init__(self):
        self.per = {"lp": [], "logit": [], "margin": []}
        self.lang, self.score = [], []

    def add(self, said: dict, lang: bool = False) -> None:
        for key in self.per:
            self.per[key].append(said[key].reshape(-1))
        if lang:
            self.lang.append(said["lp"].reshape(1))

    def summary(self) -> dict:
        out = {}
        for key, errs in self.per.items():
            flat = torch.cat(errs) if errs else None
            out[f"max_{key}_err"] = float(flat.max()) if flat is not None else None
            out[f"mean_{key}_err"] = float(flat.mean()) if flat is not None else None
        out["max_lang_err"] = float(torch.cat(self.lang).max()) if self.lang else None
        scores = torch.cat(self.score) if self.score else None
        out["max_score_err"] = float(scores.max()) if scores is not None else None
        out["mean_score_err"] = float(scores.mean()) if scores is not None else None
        return out


def _first(logits: torch.Tensor):
    """What a side that decodes ``logits`` itself says: its two best, the
    runner-up's id, its log-sum-exp and its best id."""
    top = torch.topk(logits, 2, dim=-1)
    return top.values.cpu().numpy(), top.indices[..., 1].cpu().numpy(), torch.logsumexp(logits, -1).cpu().numpy(), \
        top.indices[..., 0]


def _mean_logprob(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.double(), dim=-1)
    valid = (target >= 0) & (target < logits.shape[-1])
    got = torch.where(valid, logp.gather(1, torch.where(valid, target, 0)[:, None])[:, 0], -math.inf)
    return got.sum() / len(target)


def judge(ref: Reference, served: list[Served], device: torch.device, keep: bool = False,
          control: Reference | None = None) -> dict:
    """The reference's judgement of ``served``: over every served sample
    (and each detected language, counted as one more), the gap between
    the program's log-probability, logit and margin of its best token and
    the reference's of the token served (``max_lp_err``, ``mean_lp_err``,
    ``max_logit_err``, ...), and each beam hypothesis' score gap
    (``max_score_err``), with what they were read from. With ``control``
    (a lowered :class:`Reference`), the same gaps of the control, teacher-
    forced over the same prompts and served tokens, under ``control_``:
    of the token it puts first at each position, and of its score of each
    beam hypothesis."""
    shape = ref.shape
    prog, ctrl, flips = _Readings(), _Readings(), 0
    chunk = shape.n_audio_ctx * 2 * HOP
    batches = {}  # the judged requests by the batch they were decoded in
    for s in served:
        batch = getattr(s.observed, "batch", None)
        batches.setdefault(id(batch) if batch is not None else id(s), []).append(s)
    for group in batches.values():
        batch = getattr(group[0].observed, "batch", None)
        clips = batch.clips if batch is not None else [(group[0].samples, group[0].rate)]
        rows = [s.observed.row for s in group] if batch is not None else [0]
        audio = np.zeros((batch.rows if batch is not None else 1, chunk), np.float32)  # the pipeline's silent pad rows
        for i, (samples, rate) in enumerate(clips):
            audio[i] = pad_or_trim(resample_16k(samples, rate), chunk)
        with torch.no_grad():
            feats = ref.encode(log_mel(torch.from_numpy(audio).to(device), shape.n_mels))
            cross = ref.cross_kv(feats, rows)
            del feats
            for i, s in enumerate(group):
                # the samples judged: the served ids, and the EOT that ended a stream early
                samples = list(s.tokens) + ([EOT] if len(s.tokens) < s.max_tokens else [])
                seq = torch.tensor([_prompt(shape, s.lang_token) + samples[:-1]], device=device)
                row_cross = [(k[i : i + 1], v[i : i + 1]) for k, v in cross]
                sides = [(ref, None)] + ([(control, None)] if control is not None else [])
                sides = [(side, side.logits(row_cross, seq)) for side, _ in sides]
                (_, (logits, lang)), *lowered = sides
                judged = _judged(logits[0])
                target = torch.tensor(samples, device=device)
                flips += int((judged.gather(1, target.clamp(0, shape.n_vocab - 1)[:, None])[:, 0]
                              < judged.max(dim=-1).values).sum())
                obs, n = s.observed, len(samples)
                lang_k = torch.tensor(s.lang_token - LANG_START, device=device)
                if s.detected:  # ids within the language rows
                    prog.add(_said(obs.lang_top, obs.lang_second, obs.lang_lse, lang[0], lang_k), lang=True)
                if math.isnan(obs.score):
                    prog.add(_said(obs.top[:n], obs.second[:n], obs.lse[:n], judged, target))
                else:
                    prog.score.append(_gap(obs.score, _mean_logprob(judged, target)).reshape(1))
                for _, (c_logits, c_lang) in lowered:
                    c_judged = _judged(c_logits[0])
                    if s.detected:
                        *said, first = _first(c_lang[0])
                        ctrl.add(_said(*said, lang[0], first), lang=True)
                    if math.isnan(obs.score):
                        *said, first = _first(c_judged)
                        ctrl.add(_said(*said, judged, first))
                    else:
                        ctrl.score.append(_gap(_mean_logprob(c_judged, target), _mean_logprob(judged, target)).reshape(1))
    out = {"requests_judged": len(served), "flipped": flips, **prog.summary()}
    out["tokens_judged"] = int(torch.cat(prog.per["lp"]).numel()) if prog.per["lp"] else 0
    if control is not None:
        out.update({f"control_{k}": v for k, v in ctrl.summary().items()})
    if keep:
        out["errs"] = [x.tolist() for x in (prog.per["logit"] if prog.per["logit"] else prog.score)]
    return out


def _judged(logits: torch.Tensor) -> torch.Tensor:
    """Rows from the last prompt token on (row k predicts sample #k), the
    vocabulary alone, EOT suppressed where the decode loops suppress it."""
    judged = logits[PROMPT_LEN - 1 :, : logits.shape[-1]].clone()
    judged[:MIN_TOKENS, EOT] = float("-inf")
    return judged
