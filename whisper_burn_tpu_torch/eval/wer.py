"""Word error rate and text normalization.

Port of ``whisper_burn_tpu/eval/wer.py``. ``normalize_text`` applies the
Whisper English normalizer (:mod:`whisper_burn_tpu_torch.eval.english_normalizer`);
``basic=True`` takes the casefold+strip normalization (for non-English
text).
"""

from __future__ import annotations

import functools
import re
import unicodedata


@functools.lru_cache(maxsize=1)
def _english_normalizer():
    from whisper_burn_tpu_torch.eval.english_normalizer import EnglishTextNormalizer

    return EnglishTextNormalizer()


def normalize_text(text: str, basic: bool = False) -> str:
    """Whisper English normalization (default) or basic casefold+strip."""
    if not basic:
        return _english_normalizer()(text).strip()
    text = unicodedata.normalize("NFKC", text).lower()
    text = re.sub(r"[^\w\s']", " ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _use_basic(language: str | None) -> bool:
    """English-specific rules only apply to English text.

    ``None`` and ``"auto"`` both mean "language unknown" and get the same
    behavior: the full English normalizer, so that an unknown language
    does not change the metric's definition."""
    return language is not None and language.lower() not in (
        "en", "english", "auto",
    )


def word_errors(
    reference: str, hypothesis: str, *, language: str | None = "en"
) -> tuple[int, int]:
    """(edit_distance, n_reference_words) after normalization."""
    basic = _use_basic(language)
    ref = normalize_text(reference, basic=basic).split()
    hyp = normalize_text(hypothesis, basic=basic).split()
    n, m = len(ref), len(hyp)
    if n == 0:
        return (m, 0)
    # single-row Levenshtein
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            sub = prev[j - 1] + (ref[i - 1] != hyp[j - 1])
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub)
        prev = cur
    return (prev[m], n)


def wer(
    references: list[str] | str,
    hypotheses: list[str] | str,
    *,
    language: str | None = "en",
) -> float:
    """Corpus-level WER (total errors / total reference words).

    ``language``: non-English selects basic normalization so English
    contraction/number/spelling rules never touch other languages.
    """
    if isinstance(references, str):
        references, hypotheses = [references], [hypotheses]  # type: ignore[list-item]
    total_err = total_words = 0
    for ref, hyp in zip(references, hypotheses, strict=True):
        e, w = word_errors(ref, hyp, language=language)
        total_err += e
        total_words += w
    return total_err / max(total_words, 1)
