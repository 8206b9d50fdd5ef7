"""Token parity against HuggingFace Whisper, offline, at a real model's width.

Port of ``whisper_burn_tpu/eval/hf_oracle.py``. No real checkpoint can be
downloaded here, so the oracle is a random-init HF
``WhisperForConditionalGeneration`` at Large-V3 width (D 1280, 20 heads,
128 mels, vocab 51866; fewer layers) taken through the port's whole
intake path: ``gguf/convert.convert_state_dict`` -> Q4_0 GGUF ->
``gguf/loader.load_whisper_from_gguf``. The same GGUF is dequantized back
into the HF model, so both stacks run the same effective weights, and HF
``generate()`` is an implementation of the greedy protocol independent of
both packages to hold the port to, token for token.

``transformers`` is imported inside the functions only: the card's
machine has no ``transformers``, and this module is imported everywhere.
Used by ``scripts/torch_hf_realdims_parity.py`` (``HF_PARITY_TORCH.md``)
and ``tests/test_torch_hf_oracle.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_burn_tpu_torch.gguf.convert import convert_state_dict, hf_name_to_gguf
from whisper_burn_tpu_torch.gguf.loader import LoadedModel, load_whisper_from_gguf
from whisper_burn_tpu_torch.gguf.reader import GgufReader
from whisper_burn_tpu_torch.models.config import EOT, MIN_TOKENS, SOT


def build_hf_fixture(
    *,
    d_model: int = 1280,
    n_heads: int = 20,
    n_mels: int = 128,
    vocab: int = 51866,
    enc_layers: int = 4,
    dec_layers: int = 4,
    n_audio_ctx: int = 1500,
    n_text_ctx: int = 448,
    seed: int = 0,
):
    """A random HF Whisper at these dims, its decoder embeddings widened
    (the plain init gives greedy trajectories of one repeated token)."""
    import transformers

    hf_cfg = transformers.WhisperConfig(
        vocab_size=vocab,
        num_mel_bins=n_mels,
        encoder_layers=enc_layers,
        encoder_attention_heads=n_heads,
        decoder_layers=dec_layers,
        decoder_attention_heads=n_heads,
        d_model=d_model,
        encoder_ffn_dim=4 * d_model,
        decoder_ffn_dim=4 * d_model,
        max_source_positions=n_audio_ctx,
        max_target_positions=n_text_ctx,
    )
    torch.manual_seed(seed)
    hf = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    with torch.no_grad():
        hf.model.decoder.embed_tokens.weight.normal_(0, 0.2)
        hf.model.decoder.embed_positions.weight.normal_(0, 1.0)
    return hf


def convert_and_load(hf, *, n_lang: int | None = None) -> tuple[bytes, LoadedModel]:
    """HF model -> Q4_0 GGUF bytes -> the port's loader: ``(gguf_bytes,
    LoadedModel)``, the intake path end to end."""
    state = {k: v.float().numpy() for k, v in hf.state_dict().items()}
    if n_lang is None:
        n_lang = 100 if hf.config.num_mel_bins >= 128 else 99
    blob = convert_state_dict(state, n_lang=n_lang).to_bytes()
    return blob, load_whisper_from_gguf(blob)


def writeback_gguf_to_hf(hf, gguf_bytes: bytes) -> None:
    """Every GGUF tensor dequantized back into the HF model, in place: HF
    then runs the Q4_0-rounded weights the port serves, and f32 greedy
    decodes of both must match token for token."""
    r = GgufReader.from_bytes(gguf_bytes)
    state = {k: v.clone() for k, v in hf.state_dict().items()}
    for hf_name in list(state):
        gguf_name = hf_name_to_gguf(hf_name)
        if gguf_name is None:
            continue
        arr = r.tensor_f32(gguf_name)
        if tuple(arr.shape) != tuple(state[hf_name].shape):
            raise ValueError(f"{hf_name} <- {gguf_name}: shape {arr.shape}, expected {tuple(state[hf_name].shape)}")
        state[hf_name] = torch.from_numpy(np.ascontiguousarray(arr))
    # proj_out is tied to the token embedding (not stored in the GGUF):
    # keep the pair tied whatever order the load takes
    if "proj_out.weight" in state:
        state["proj_out.weight"] = state["model.decoder.embed_tokens.weight"]
    hf.load_state_dict(state)
    hf.eval()


def hf_generate_greedy(hf, cfg, mel: np.ndarray, langs: np.ndarray, *, max_new: int,
                       num_beams: int = 1) -> list[np.ndarray]:
    """HF ``generate()`` under the port's decode protocol: the forced
    prompt ``[SOT, lang, TRANSCRIBE, NO_TIMESTAMPS]``, EOT banned for the
    first ``MIN_TOKENS`` samples, greedy (or beam) search, stop at EOT.
    Returns each stream's generated ids, prompt and EOT stripped."""
    import transformers

    b = mel.shape[0]
    prompt = np.stack(
        [np.full(b, SOT), langs.astype(np.int64), np.full(b, cfg.transcribe_token),
         np.full(b, cfg.no_timestamps_token)],
        axis=1,
    )
    gc = transformers.GenerationConfig(
        do_sample=False,
        num_beams=num_beams,
        min_new_tokens=MIN_TOKENS,
        max_new_tokens=max_new,
        eos_token_id=EOT,
        pad_token_id=EOT,
        begin_suppress_tokens=None,
        forced_decoder_ids=None,
        length_penalty=1.0,
        early_stopping=False,
    )
    with torch.no_grad():
        gen = hf.generate(
            input_features=torch.from_numpy(np.asarray(mel, np.float32)),
            decoder_input_ids=torch.from_numpy(prompt),
            generation_config=gc,
        ).numpy()
    # Whisper's generate returns the generated tokens only
    return [t[: int(np.argmax(t == EOT))] if (t == EOT).any() else t for t in gen]


def agreement(ours: np.ndarray, n_gen: int, theirs: np.ndarray) -> float:
    """Per-step token agreement over the union of the generated regions."""
    n = max(int(n_gen), len(theirs))
    if n == 0:
        return 1.0
    hits = sum(1 for i in range(min(int(n_gen), len(theirs))) if int(ours[i]) == int(theirs[i]))
    return hits / n
