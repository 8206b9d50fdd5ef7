"""Persistent user configuration for the CLI.

Port of ``whisper_burn_tpu/app_config.py``: JSON at
``<config_dir>/whisper_burn_tpu_torch/config.json`` (``$XDG_CONFIG_HOME``,
else ``~/.config``) holding the defaults that the commands read (model
path and tokenizer for ``transcribe`` and ``app``; language and models
directory for ``app``), written atomically via tmp+rename. The file has
the JAX package's format under this package's own directory name, so
neither package overwrites the other's defaults; the JAX file's beam
width, compute and frontend keys, which no command reads, are left out
(``load_config`` drops them, ``config --set`` refuses them).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from pathlib import Path


@dataclass
class AppConfig:
    model: str | None = None
    tokenizer: str | None = None
    language: str = "auto"  # auto-detect by default
    models_dir: str = "models"


def config_path() -> Path:
    base = os.environ.get("XDG_CONFIG_HOME") or os.path.join(os.path.expanduser("~"), ".config")
    return Path(base) / "whisper_burn_tpu_torch" / "config.json"


def load_config(path: str | Path | None = None) -> AppConfig:
    """The saved config; the defaults when it is missing or unreadable."""
    path = Path(path) if path is not None else config_path()
    try:
        data = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        return AppConfig()
    known = {f.name for f in dataclasses.fields(AppConfig)}
    return AppConfig(**{k: v for k, v in data.items() if k in known})


def save_config(cfg: AppConfig, path: str | Path | None = None) -> Path:
    """Atomic write via tmp+rename."""
    path = Path(path) if path is not None else config_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    tmp.replace(path)
    return path
