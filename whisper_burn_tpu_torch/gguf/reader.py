"""GGUF v2/v3 container parser (numpy, on the host).

Port of ``whisper_burn_tpu/gguf/reader.py`` (the port's own copy):

* magic ``0x46554747`` ("GGUF" little-endian), versions 2 and 3;
* header: magic u32, version u32, tensor_count u64, metadata_kv_count u64;
* metadata: key = string (u64 length + utf8), value_type u32, value; all
  13 GGUF value types are read and kept (``general.alignment`` may be
  among them);
* tensor index entry: name string, n_dims u32, dims u64 x n (innermost
  first, the reverse of the row-major shape), dtype u32, offset u64 from
  the data section;
* the data section starts at the next ``alignment`` boundary (32 unless
  the metadata says otherwise) after the index;
* dtypes F32 = 0, F16 = 1, Q4_0 = 2.
"""

from __future__ import annotations

import enum
import io
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from whisper_burn_tpu_torch.gguf.quant import dequantize_q4_0, q4_0_nbytes

GGUF_MAGIC = 0x46554747
DEFAULT_ALIGNMENT = 32


class GgmlDtype(enum.IntEnum):
    """The GGML tensor dtypes a Whisper checkpoint uses."""

    F32 = 0
    F16 = 1
    Q4_0 = 2

    def nbytes(self, n_elements: int) -> int:
        if self is GgmlDtype.F32:
            return 4 * n_elements
        if self is GgmlDtype.F16:
            return 2 * n_elements
        return q4_0_nbytes(n_elements)


# GGUF metadata value-type codes
_SCALAR_FMT = {
    0: "<B",  # u8
    1: "<b",  # i8
    2: "<H",  # u16
    3: "<h",  # i16
    4: "<I",  # u32
    5: "<i",  # i32
    6: "<f",  # f32
    10: "<Q",  # u64
    11: "<q",  # i64
    12: "<d",  # f64
}
_TYPE_BOOL = 7
_TYPE_STRING = 8
_TYPE_ARRAY = 9


@dataclass(frozen=True)
class GgufTensorInfo:
    """Index entry of one tensor."""

    name: str
    gguf_dims: tuple[int, ...]  # as stored: innermost first
    dtype: GgmlDtype
    offset: int  # from the start of the data section

    @property
    def shape(self) -> tuple[int, ...]:
        """Row-major shape (the stored dims reversed)."""
        return tuple(reversed(self.gguf_dims))

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.gguf_dims:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.dtype.nbytes(self.n_elements)


@dataclass
class GgufReader:
    """A parsed GGUF container over a file path or bytes in memory."""

    version: int
    metadata: dict[str, Any]
    tensors: dict[str, GgufTensorInfo]
    alignment: int
    data_start: int
    _source: bytes | Path = field(repr=False)

    @classmethod
    def open(cls, path: str | Path) -> "GgufReader":
        path = Path(path)
        with path.open("rb") as f:
            reader = cls._parse(f)
        reader._source = path
        return reader

    @classmethod
    def from_bytes(cls, data: bytes) -> "GgufReader":
        reader = cls._parse(io.BytesIO(data))
        reader._source = data
        return reader

    @classmethod
    def _parse(cls, f: BinaryIO) -> "GgufReader":
        magic, version = struct.unpack("<II", _read_exact(f, 8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"bad GGUF magic 0x{magic:08x}")
        if version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {version} (want 2 or 3)")
        tensor_count, kv_count = struct.unpack("<QQ", _read_exact(f, 16))

        metadata: dict[str, Any] = {}
        for _ in range(kv_count):
            key = _read_string(f)
            metadata[key] = _read_value(f, _read_u32(f))
        alignment = int(metadata.get("general.alignment", DEFAULT_ALIGNMENT))

        tensors: dict[str, GgufTensorInfo] = {}
        for _ in range(tensor_count):
            name = _read_string(f)
            n_dims = _read_u32(f)
            dims = struct.unpack(f"<{n_dims}Q", _read_exact(f, 8 * n_dims))
            dtype_code = _read_u32(f)
            try:
                dtype = GgmlDtype(dtype_code)
            except ValueError as e:
                raise ValueError(f"tensor {name!r}: unsupported ggml dtype {dtype_code}") from e
            offset = struct.unpack("<Q", _read_exact(f, 8))[0]
            tensors[name] = GgufTensorInfo(name, tuple(dims), dtype, offset)

        return cls(version=version, metadata=metadata, tensors=tensors, alignment=alignment,
                   data_start=_align_up(f.tell(), alignment), _source=b"")

    def tensor_info(self, name: str) -> GgufTensorInfo:
        try:
            return self.tensors[name]
        except KeyError as e:
            raise KeyError(f"tensor {name!r} not in GGUF (have {len(self.tensors)})") from e

    def tensor_data(self, name: str) -> bytes:
        """Raw bytes of a tensor."""
        info = self.tensor_info(name)
        start = self.data_start + info.offset
        if isinstance(self._source, Path):
            with self._source.open("rb") as f:
                f.seek(start)
                return _read_exact(f, info.nbytes)
        return bytes(self._source[start : start + info.nbytes])

    def tensor_f32(self, name: str) -> np.ndarray:
        """A tensor as float32 in its row-major shape: F16 widened, Q4_0
        dequantized."""
        info = self.tensor_info(name)
        raw = self.tensor_data(name)
        if info.dtype is GgmlDtype.F32:
            arr = np.frombuffer(raw, dtype="<f4", count=info.n_elements).copy()
        elif info.dtype is GgmlDtype.F16:
            arr = np.frombuffer(raw, dtype="<f2", count=info.n_elements).astype(np.float32)
        else:
            arr = dequantize_q4_0(raw, info.n_elements)
        return arr.reshape(info.shape)


def _align_up(offset: int, alignment: int) -> int:
    return (offset + alignment - 1) // alignment * alignment


def _read_exact(f: BinaryIO, n: int) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise EOFError(f"GGUF truncated: wanted {n} bytes, got {len(data)}")
    return data


def _read_u32(f: BinaryIO) -> int:
    return struct.unpack("<I", _read_exact(f, 4))[0]


def _read_string(f: BinaryIO) -> str:
    (length,) = struct.unpack("<Q", _read_exact(f, 8))
    return _read_exact(f, length).decode("utf-8")


def _read_value(f: BinaryIO, value_type: int) -> Any:
    if value_type in _SCALAR_FMT:
        fmt = _SCALAR_FMT[value_type]
        return struct.unpack(fmt, _read_exact(f, struct.calcsize(fmt)))[0]
    if value_type == _TYPE_BOOL:
        return _read_exact(f, 1)[0] != 0
    if value_type == _TYPE_STRING:
        return _read_string(f)
    if value_type == _TYPE_ARRAY:
        elem_type = _read_u32(f)
        (count,) = struct.unpack("<Q", _read_exact(f, 8))
        return [_read_value(f, elem_type) for _ in range(count)]
    raise ValueError(f"unknown GGUF metadata value type {value_type}")
