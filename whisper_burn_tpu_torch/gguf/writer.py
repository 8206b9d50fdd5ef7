"""GGUF v3 writer.

Port of ``whisper_burn_tpu/gguf/writer.py`` (the port's own copy), the same
bytes for the same calls: a v3 header, typed metadata, the tensor index
with reversed dims and offsets aligned to ``alignment`` (32), and the data
section on the next ``alignment`` boundary after the index. ``write``
streams each tensor to the file; ``to_bytes`` holds the whole container
in memory.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from whisper_burn_tpu_torch.gguf.quant import quantize_q4_0
from whisper_burn_tpu_torch.gguf.reader import DEFAULT_ALIGNMENT, GGUF_MAGIC, GgmlDtype

_TYPE_U32 = 4
_TYPE_F32 = 6
_TYPE_BOOL = 7
_TYPE_STRING = 8
_TYPE_U64 = 10


@dataclass
class _Entry:
    name: str
    gguf_dims: tuple[int, ...]
    dtype: GgmlDtype
    offset: int
    data: memoryview


class GgufWriter:
    """Tensors and metadata, added in order, then one GGUF v3 container."""

    def __init__(self, alignment: int = DEFAULT_ALIGNMENT):
        self.alignment = alignment
        self._metadata: list[tuple[str, int, object]] = []
        self._entries: list[_Entry] = []
        self._offset = 0

    def add_string(self, key: str, value: str) -> None:
        self._metadata.append((key, _TYPE_STRING, value))

    def add_u32(self, key: str, value: int) -> None:
        self._metadata.append((key, _TYPE_U32, value))

    def add_u64(self, key: str, value: int) -> None:
        self._metadata.append((key, _TYPE_U64, value))

    def add_f32(self, key: str, value: float) -> None:
        self._metadata.append((key, _TYPE_F32, value))

    def add_bool(self, key: str, value: bool) -> None:
        self._metadata.append((key, _TYPE_BOOL, value))

    def add_tensor(self, name: str, array: np.ndarray, quantize: bool = False) -> None:
        """Add a float tensor, stored Q4_0 with ``quantize`` and F32 otherwise."""
        array = np.ascontiguousarray(array, dtype=np.float32)
        if quantize:
            self.add_raw_tensor(name, array.shape, GgmlDtype.Q4_0, quantize_q4_0(array))
        else:
            self.add_raw_tensor(name, array.shape, GgmlDtype.F32, array.astype("<f4").tobytes())

    def add_raw_tensor(self, name: str, shape: tuple[int, ...], dtype: GgmlDtype, data) -> None:
        """Add encoded tensor bytes (``bytes`` or a contiguous array, kept
        without a copy) of row-major ``shape``."""
        view = memoryview(data).cast("B")
        offset = _align_up(self._offset, self.alignment)
        self._entries.append(_Entry(name, tuple(reversed(shape)), dtype, offset, view))
        self._offset = offset + view.nbytes

    def _header(self) -> bytes:
        """Everything before the data section, padded to its start."""
        out = bytearray(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._entries), len(self._metadata)))
        for key, vtype, value in self._metadata:
            out += _pack_string(key) + struct.pack("<I", vtype)
            if vtype == _TYPE_STRING:
                out += _pack_string(value)  # type: ignore[arg-type]
            elif vtype == _TYPE_U32:
                out += struct.pack("<I", value)
            elif vtype == _TYPE_U64:
                out += struct.pack("<Q", value)
            elif vtype == _TYPE_F32:
                out += struct.pack("<f", value)
            else:  # _TYPE_BOOL: the add_* methods make no other type
                out += struct.pack("<B", 1 if value else 0)
        for e in self._entries:
            out += _pack_string(e.name)
            out += struct.pack("<I", len(e.gguf_dims))
            out += struct.pack(f"<{len(e.gguf_dims)}Q", *e.gguf_dims)
            out += struct.pack("<IQ", int(e.dtype), e.offset)
        return bytes(out) + b"\x00" * (_align_up(len(out), self.alignment) - len(out))

    def _chunks(self):
        """The container's bytes, piece by piece."""
        yield self._header()
        pos = 0
        for e in self._entries:
            yield b"\x00" * (e.offset - pos)
            yield e.data
            pos = e.offset + e.data.nbytes

    def to_bytes(self) -> bytes:
        return b"".join(self._chunks())

    def write(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("wb") as f:
            for chunk in self._chunks():
                f.write(chunk)


def _align_up(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


def _pack_string(s: str) -> bytes:
    encoded = s.encode("utf-8")
    return struct.pack("<Q", len(encoded)) + encoded
