"""Model artifact downloader (HF-hosted GGUF + tokenizer).

Port of ``whisper_burn_tpu/download.py``: known model variants with
filenames, sizes and URLs, skip-if-exists, atomic tmp+rename writes and
progress reporting. The tests exercise it on ``file://`` URLs only.
"""

from __future__ import annotations

import urllib.request
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

_HF_BASE = "https://huggingface.co"


@dataclass(frozen=True)
class ModelVariant:
    """A downloadable model."""

    name: str
    gguf_filename: str
    gguf_url: str
    tokenizer_url: str
    approx_bytes: int


VARIANTS: dict[str, ModelVariant] = {
    "medium": ModelVariant(
        name="medium",
        gguf_filename="whisper-medium-q4.gguf",
        gguf_url=f"{_HF_BASE}/zerr0o/whisper-burn-gguf/resolve/main/whisper-medium-q4.gguf",
        tokenizer_url=f"{_HF_BASE}/openai/whisper-medium/resolve/main/tokenizer.json",
        approx_bytes=604 * 1024 * 1024,
    ),
    "large-v3": ModelVariant(
        name="large-v3",
        gguf_filename="whisper-large-v3-q4.gguf",
        gguf_url=f"{_HF_BASE}/zerr0o/whisper-burn-gguf/resolve/main/whisper-large-v3-q4.gguf",
        tokenizer_url=f"{_HF_BASE}/openai/whisper-large-v3/resolve/main/tokenizer.json",
        approx_bytes=1024 * 1024 * 1024,
    ),
    "large-v3-turbo": ModelVariant(
        name="large-v3-turbo",
        gguf_filename="whisper-large-v3-turbo-q4.gguf",
        gguf_url=f"{_HF_BASE}/zerr0o/whisper-burn-gguf/resolve/main/whisper-large-v3-turbo-q4.gguf",
        tokenizer_url=f"{_HF_BASE}/openai/whisper-large-v3-turbo/resolve/main/tokenizer.json",
        approx_bytes=712 * 1024 * 1024,
    ),
}

_CHUNK = 64 * 1024  # 64 KiB chunks


def download_file(
    url: str,
    dest: str | Path,
    progress: Callable[[int, int | None], None] | None = None,
) -> Path:
    """Stream ``url`` to ``dest`` atomically; skip if it already exists."""
    dest = Path(dest)
    if dest.exists() and dest.stat().st_size > 0:
        return dest
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".tmp")
    with urllib.request.urlopen(url) as resp, tmp.open("wb") as out:
        total = getattr(resp, "length", None)
        received = 0
        while True:
            chunk = resp.read(_CHUNK)
            if not chunk:
                break
            out.write(chunk)
            received += len(chunk)
            if progress is not None:
                progress(received, total)
    tmp.replace(dest)  # atomic publish
    return dest


def download_model(
    variant: str,
    models_dir: str | Path = "models",
    progress: Callable[[int, int | None], None] | None = None,
) -> tuple[Path, Path]:
    """Fetch (gguf_path, tokenizer_path) for a known variant."""
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; have {sorted(VARIANTS)}")
    v = VARIANTS[variant]
    models_dir = Path(models_dir)
    tok = download_file(v.tokenizer_url, models_dir / f"tokenizer-{v.name}.json")
    gguf = download_file(v.gguf_url, models_dir / v.gguf_filename, progress)
    return gguf, tok


def list_installed_models(models_dir: str | Path = "models") -> list[tuple[Path, int]]:
    """Installed GGUFs with their sizes."""
    models_dir = Path(models_dir)
    if not models_dir.is_dir():
        return []
    return sorted(
        (p, p.stat().st_size) for p in models_dir.glob("*.gguf") if p.is_file()
    )


def delete_model(path: str | Path) -> None:
    """Remove an installed GGUF."""
    Path(path).unlink()
