"""Repacked-checkpoint cache: a warm load skips the GGUF parse and repack.

Port of ``whisper_burn_tpu/gguf/cache.py`` (the port's own copy), the same
file format, so that a cache written by either package loads in the other:
the flattened parameters in one ``<gguf name>.repacked.npz`` (key paths
joined by ``::``, as tensor names hold dots) beside a JSON sidecar with
``cache_version``, the source's ``source_size`` and ``source_mtime``, and
the ``config``. The npz is written to a temporary name, then renamed. A
stale, version-mismatched or unreadable cache is a miss; saving is best
effort.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from whisper_burn_tpu_torch.gguf.loader import LoadedModel, load_whisper_from_gguf
from whisper_burn_tpu_torch.models.config import WhisperConfig

_SEP = "::"  # key path separator inside the npz (tensor names contain '.')
CACHE_VERSION = 1


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (key,))
    else:
        yield prefix, tree


def _unflatten(items) -> dict:
    root: dict = {}
    for path, value in items:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return root


def _cache_paths(gguf_path: Path, cache_dir: Path | None) -> tuple[Path, Path]:
    base = cache_dir if cache_dir is not None else gguf_path.parent
    stem = gguf_path.name + ".repacked"
    return base / (stem + ".npz"), base / (stem + ".json")


def save_repacked(model: LoadedModel, gguf_path: str | Path, cache_dir: str | Path | None = None) -> Path:
    gguf_path = Path(gguf_path)
    npz_path, meta_path = _cache_paths(gguf_path, Path(cache_dir) if cache_dir else None)
    npz_path.parent.mkdir(parents=True, exist_ok=True)

    arrays = {_SEP.join(path): np.asarray(v) for path, v in _flatten(model.params)}
    tmp = npz_path.with_suffix(".tmp.npz")
    np.savez(tmp, **arrays)
    tmp.replace(npz_path)  # atomic

    stat = gguf_path.stat()
    meta = {
        "cache_version": CACHE_VERSION,
        "source_size": stat.st_size,
        "source_mtime": stat.st_mtime,
        "config": dataclasses.asdict(model.config),
    }
    meta_path.write_text(json.dumps(meta))
    return npz_path


def load_repacked(gguf_path: str | Path, cache_dir: str | Path | None = None) -> LoadedModel | None:
    """The cached model, or None on a miss or a stale cache."""
    gguf_path = Path(gguf_path)
    npz_path, meta_path = _cache_paths(gguf_path, Path(cache_dir) if cache_dir else None)
    if not (npz_path.exists() and meta_path.exists()):
        return None
    try:
        meta = json.loads(meta_path.read_text())
        stat = gguf_path.stat()
        if (
            meta.get("cache_version") != CACHE_VERSION
            or meta.get("source_size") != stat.st_size
            or meta.get("source_mtime") != stat.st_mtime
        ):
            return None
        cfg = WhisperConfig(**meta["config"])
        with np.load(npz_path) as data:
            params = _unflatten((tuple(key.split(_SEP)), data[key]) for key in data.files)
        return LoadedModel(config=cfg, params=params)
    except (ValueError, KeyError, json.JSONDecodeError, OSError):
        return None


def load_whisper(gguf_path: str | Path, cache_dir: str | Path | None = None) -> LoadedModel:
    """The GGUF loader with the repacked cache in front of it."""
    cached = load_repacked(gguf_path, cache_dir)
    if cached is not None:
        return cached
    model = load_whisper_from_gguf(gguf_path)
    try:
        save_repacked(model, gguf_path, cache_dir)
    except OSError:
        pass  # the cache is best effort
    return model
