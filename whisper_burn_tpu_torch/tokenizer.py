"""Whisper tokenizer wrapper (HF ``tokenizers`` backend).

Counterpart of the reference's src/tokenizer.rs: wraps a ``tokenizer.json``
for id->text decoding plus the special-token helpers. Unlike the reference
(which hardcodes Medium's ids, src/tokenizer.rs:24-54), model-dependent ids
(TRANSCRIBE/NO_TIMESTAMPS) are taken from :class:`WhisperConfig` so Large
V3's shifted layout is handled uniformly (src/model/config.rs:65-80).

Copy of ``whisper_burn_tpu/tokenizer.py`` on the port's config. The
``tokenizers`` package is imported by :meth:`WhisperTokenizer.from_file`
only: nothing else here needs it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence

import numpy as np

from whisper_burn_tpu_torch.languages import lang_token_id
from whisper_burn_tpu_torch.models.config import EOT, SOT, WhisperConfig


class WhisperTokenizer:
    """Decode Whisper token ids to text (src/tokenizer.rs:14-54)."""

    def __init__(self, tokenizer) -> None:
        self._tok = tokenizer

    @classmethod
    def from_file(cls, path: str | Path) -> "WhisperTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(str(path)))

    # -- decoding ----------------------------------------------------------

    def decode(self, ids: Sequence[int] | np.ndarray) -> str:
        """BPE-decode ids (caller filters specials, src/transcribe.rs:95-104)."""
        return self._tok.decode([int(i) for i in ids], skip_special_tokens=True)

    def decode_transcription(self, ids: Sequence[int] | np.ndarray) -> str:
        """Filter to text ids (< EOT) then decode + trim
        (src/transcribe.rs:94-106)."""
        text_ids = [int(i) for i in ids if 0 <= int(i) < EOT]
        return self.decode(text_ids).strip()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    # -- special tokens ----------------------------------------------------

    @property
    def sot_token(self) -> int:
        return SOT

    @property
    def eot_token(self) -> int:
        return EOT

    @staticmethod
    def lang_token(code: str) -> int:
        """Language code -> token id (src/tokenizer.rs:36-41 delegates to the
        same static table)."""
        return lang_token_id(code)

    @staticmethod
    def transcribe_token(cfg: WhisperConfig) -> int:
        return cfg.transcribe_token

    @staticmethod
    def no_timestamps_token(cfg: WhisperConfig) -> int:
        return cfg.no_timestamps_token

    @property
    def vocab_size(self) -> int:
        return self._tok.get_vocab_size()
