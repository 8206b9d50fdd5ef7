"""A configuration file of ``benchmark/configs/`` as the shapes the
benchmark, its reference and its counts read. Imports nothing of the
program."""

from __future__ import annotations

import dataclasses

# Whisper's token ids (openai/whisper tokenizer; the same in every
# multilingual checkpoint)
EOT, SOT = 50257, 50258
LANG_START = 50259
PROMPT_LEN = 4  # SOT, language, task, no-timestamps
MIN_TOKENS = 3  # EOT is suppressed for the first three samples
Q4_BLOCK = 32


@dataclasses.dataclass(frozen=True)
class ModelShape:
    name: str
    d_model: int
    encoder_layers: int
    decoder_layers: int
    heads: int
    ffn_dim: int
    n_mels: int
    n_audio_ctx: int
    n_text_ctx: int
    n_vocab: int
    n_lang: int

    @property
    def n_vocab_padded(self) -> int:
        """The embedding's rows: the vocab rounded up to 128."""
        return -(-self.n_vocab // 128) * 128

    @property
    def transcribe_token(self) -> int:
        return LANG_START + self.n_lang + 1

    @property
    def no_timestamps_token(self) -> int:
        return self.transcribe_token + 4


def model_shape(config: dict) -> ModelShape:
    """The shapes of a configuration file's ``config`` (the published
    ``config.json``'s keys, as run)."""
    c = config["config"]
    if c["encoder_attention_heads"] != c["decoder_attention_heads"] or c["encoder_ffn_dim"] != c["decoder_ffn_dim"]:
        raise ValueError(f"{config['name']}: the encoder and decoder differ in heads or FFN width")
    return ModelShape(
        name=config["name"], d_model=c["d_model"], encoder_layers=c["encoder_layers"],
        decoder_layers=c["decoder_layers"], heads=c["encoder_attention_heads"], ffn_dim=c["encoder_ffn_dim"],
        n_mels=c["num_mel_bins"], n_audio_ctx=c["max_source_positions"], n_text_ctx=c["max_target_positions"],
        n_vocab=c["vocab_size"], n_lang=config["n_lang"],
    )


def tiny_shape(n_vocab: int = 51865, n_lang: int = 99) -> ModelShape:
    """The port's ``WhisperConfig.tiny_test()`` sizes, for CPU tests."""
    return ModelShape(name="tiny", d_model=64, encoder_layers=2, decoder_layers=2, heads=2, ffn_dim=256, n_mels=8,
                      n_audio_ctx=12, n_text_ctx=16, n_vocab=n_vocab, n_lang=n_lang)
