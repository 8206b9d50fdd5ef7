"""Whisper language table: 100 languages + Auto.

Same data as the reference's static table (src/lib.rs:31-165) — 99 entries
with Whisper language-token ids 50259..50357 in OpenAI list order — plus
Large-V3's 100th language (Cantonese, "yue", token 50358), which the
reference omits. Availability is gated per model by ``n_lang``
(:class:`whisper_burn_tpu_torch.models.config.WhisperConfig`), which also
shifts the TRANSCRIBE/NO_TIMESTAMPS ids (src/model/config.rs:66-80).

Copy of ``whisper_burn_tpu/languages.py`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Language:
    """A Whisper language entry (reference: src/lib.rs:31-35)."""

    code: str | None  # None = auto-detect
    name: str
    token_id: int  # 0 for auto


_TABLE: list[tuple[str | None, str, int]] = [
    (None, "Auto", 0),
    ("en", "English", 50259),
    ("zh", "Chinese", 50260),
    ("de", "German", 50261),
    ("es", "Spanish", 50262),
    ("ru", "Russian", 50263),
    ("ko", "Korean", 50264),
    ("fr", "Français", 50265),
    ("ja", "Japanese", 50266),
    ("pt", "Portuguese", 50267),
    ("tr", "Turkish", 50268),
    ("pl", "Polish", 50269),
    ("ca", "Catalan", 50270),
    ("nl", "Dutch", 50271),
    ("ar", "Arabic", 50272),
    ("sv", "Swedish", 50273),
    ("it", "Italian", 50274),
    ("id", "Indonesian", 50275),
    ("hi", "Hindi", 50276),
    ("fi", "Finnish", 50277),
    ("vi", "Vietnamese", 50278),
    ("he", "Hebrew", 50279),
    ("uk", "Ukrainian", 50280),
    ("el", "Greek", 50281),
    ("ms", "Malay", 50282),
    ("cs", "Czech", 50283),
    ("ro", "Romanian", 50284),
    ("da", "Danish", 50285),
    ("hu", "Hungarian", 50286),
    ("ta", "Tamil", 50287),
    ("no", "Norwegian", 50288),
    ("th", "Thai", 50289),
    ("ur", "Urdu", 50290),
    ("hr", "Croatian", 50291),
    ("bg", "Bulgarian", 50292),
    ("lt", "Lithuanian", 50293),
    ("la", "Latin", 50294),
    ("mi", "Maori", 50295),
    ("ml", "Malayalam", 50296),
    ("cy", "Welsh", 50297),
    ("sk", "Slovak", 50298),
    ("te", "Telugu", 50299),
    ("fa", "Persian", 50300),
    ("lv", "Latvian", 50301),
    ("bn", "Bengali", 50302),
    ("sr", "Serbian", 50303),
    ("az", "Azerbaijani", 50304),
    ("sl", "Slovenian", 50305),
    ("kn", "Kannada", 50306),
    ("et", "Estonian", 50307),
    ("mk", "Macedonian", 50308),
    ("br", "Breton", 50309),
    ("eu", "Basque", 50310),
    ("is", "Icelandic", 50311),
    ("hy", "Armenian", 50312),
    ("ne", "Nepali", 50313),
    ("mn", "Mongolian", 50314),
    ("bs", "Bosnian", 50315),
    ("kk", "Kazakh", 50316),
    ("sq", "Albanian", 50317),
    ("sw", "Swahili", 50318),
    ("gl", "Galician", 50319),
    ("mr", "Marathi", 50320),
    ("pa", "Punjabi", 50321),
    ("si", "Sinhala", 50322),
    ("km", "Khmer", 50323),
    ("sn", "Shona", 50324),
    ("yo", "Yoruba", 50325),
    ("so", "Somali", 50326),
    ("af", "Afrikaans", 50327),
    ("oc", "Occitan", 50328),
    ("ka", "Georgian", 50329),
    ("be", "Belarusian", 50330),
    ("tg", "Tajik", 50331),
    ("sd", "Sindhi", 50332),
    ("gu", "Gujarati", 50333),
    ("am", "Amharic", 50334),
    ("yi", "Yiddish", 50335),
    ("lo", "Lao", 50336),
    ("uz", "Uzbek", 50337),
    ("fo", "Faroese", 50338),
    ("ht", "Haitian Creole", 50339),
    ("ps", "Pashto", 50340),
    ("tk", "Turkmen", 50341),
    ("nn", "Nynorsk", 50342),
    ("mt", "Maltese", 50343),
    ("sa", "Sanskrit", 50344),
    ("lb", "Luxembourgish", 50345),
    ("my", "Myanmar", 50346),
    ("bo", "Tibetan", 50347),
    ("tl", "Tagalog", 50348),
    ("mg", "Malagasy", 50349),
    ("as", "Assamese", 50350),
    ("tt", "Tatar", 50351),
    ("haw", "Hawaiian", 50352),
    ("ln", "Lingala", 50353),
    ("ha", "Hausa", 50354),
    ("ba", "Bashkir", 50355),
    ("jw", "Javanese", 50356),
    ("su", "Sundanese", 50357),
    # Large-V3's 100th language (n_lang=100); models with n_lang=99 (Medium)
    # reject it via the n_lang gate in lang_token_id.
    ("yue", "Cantonese", 50358),
]

ALL_LANGUAGES: tuple[Language, ...] = tuple(Language(*row) for row in _TABLE)

_BY_CODE = {lang.code: lang for lang in ALL_LANGUAGES if lang.code is not None}


def language_from_code(code: str | None) -> Language:
    """Look up a language by ISO code; unknown/``"auto"``/None -> Auto
    (reference: src/lib.rs:53-61)."""
    if code is None or code == "auto":
        return ALL_LANGUAGES[0]
    return _BY_CODE.get(code, ALL_LANGUAGES[0])


def lang_token_id(code: str, n_lang: int | None = None) -> int:
    """Token id for an explicit language code; raises on unknown code.

    ``n_lang`` (the model's language count, src/model/config.rs:78-80)
    rejects languages the model doesn't have — e.g. Cantonese ("yue",
    token 50358) exists only on n_lang=100 models (Large-V3), so Medium
    (n_lang=99) raises instead of emitting an out-of-range token.
    """
    lang = _BY_CODE.get(code)
    if lang is None:
        raise KeyError(f"unknown Whisper language code {code!r}")
    if n_lang is not None and lang.token_id >= 50259 + n_lang:
        raise ValueError(
            f"language {code!r} (token {lang.token_id}) is outside this "
            f"model's {n_lang}-language range [50259, {50259 + n_lang})"
        )
    return lang.token_id
