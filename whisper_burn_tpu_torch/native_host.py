"""ctypes bindings of the C++ host library (``native/whisper_host.cpp``).

Port of ``whisper_burn_tpu/native_host.py``: WAV decode, polyphase
resampling, the multithreaded Q4_0 repack and the parallel batch feeder
of the eval runner, behind the signatures of the Python paths they
replace (``audio/io.load_wav``, ``audio/resample.resample``,
``gguf/repack.repack_q4_0``, ``eval/runner.evaluate_manifest``).

The library is built at first use from the source in ``native/`` with the
flags of ``native/Makefile`` into ``build/native/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source, the flags and
the host's CPU model (``-march=native`` code runs only where it was
built). ``WHISPER_TPU_NATIVE=0`` selects the Python paths, read at each
call. Otherwise a build or load error raises, and so does a call the
library refuses: nothing falls back to the Python path quietly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "whisper_host.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra")  # native/Makefile's
LDFLAGS = ("-shared", "-pthread")
VERSION = 2  # wh_version() of the source this wraps

_LIB: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def enabled() -> bool:
    """Whether the native paths serve (``WHISPER_TPU_NATIVE`` is not "0")."""
    return os.environ.get("WHISPER_TPU_NATIVE", "1") != "0"


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def target() -> Path:
    """The library's path for this source, these flags and this host."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    h.update(f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD_DIR / f"libwhisper_host-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless this source's is there; raises with the
    compiler's output if the build fails."""
    out = target()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build native/whisper_host.cpp; WHISPER_TPU_NATIVE=0 "
                           "selects the Python paths")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building native/whisper_host.cpp failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # several processes may build at once: the last rename wins, all equal
    return out


def _declare(lib: ctypes.CDLL, name: str, restype, argtypes: list) -> None:
    fn = getattr(lib, name)
    fn.restype, fn.argtypes = restype, argtypes


def library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            _declare(lib, "wh_version", ctypes.c_int, [])
            _declare(lib, "wh_repack_q4", ctypes.c_int, [p, i64, i64, p, p, ctypes.c_int])
            _declare(lib, "wh_load_wav", i64, [ctypes.c_char_p, p, i64, ctypes.POINTER(i32)])
            _declare(lib, "wh_resample_poly", i64, [p, i64, i32, i32, p, i64])
            _declare(lib, "wh_load_batch", ctypes.c_int,
                     [ctypes.POINTER(ctypes.c_char_p), i64, i64, p, p, p, ctypes.c_int])
            if lib.wh_version() != VERSION:
                raise RuntimeError(f"native library version {lib.wh_version()}, expected {VERSION}")
            _LIB = lib
        return _LIB


def version() -> int:
    return library().wh_version()


def repack_q4_0(raw: bytes | np.ndarray, n_out: int, k_in: int) -> tuple[np.ndarray, np.ndarray]:
    """Q4_0 unpack and transpose of an ``[n_out, k_in]`` tensor on all host
    cores: ``(qw int8 [K, N], scales f32 [K/32, N])``."""
    lib = library()
    buf = np.frombuffer(raw, np.uint8) if not isinstance(raw, np.ndarray) else raw
    nbytes = (n_out * k_in // 32) * 18
    if k_in % 32 or buf.size < nbytes:
        raise ValueError(f"Q4_0 repack of [{n_out}, {k_in}] from {buf.size} bytes: K must divide by 32")
    buf = np.ascontiguousarray(buf[:nbytes])
    qw = np.empty((k_in, n_out), np.int8)
    scales = np.empty((k_in // 32, n_out), np.float32)
    rc = lib.wh_repack_q4(buf.ctypes.data, n_out, k_in, qw.ctypes.data, scales.ctypes.data, 0)
    if rc != 0:
        raise ValueError(f"wh_repack_q4 refused [{n_out}, {k_in}]: {rc}")
    return qw, scales


def load_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """WAV decode: ``(float32 mono samples, sample rate)``."""
    lib = library()
    rate = ctypes.c_int32(0)
    name = str(path).encode()
    n = lib.wh_load_wav(name, None, 0, ctypes.byref(rate))
    if n < 0:
        if n == -1:
            raise FileNotFoundError(f"cannot open {path}")
        raise ValueError(f"{path}: not a WAV file the native decoder reads ({n})")
    out = np.empty(n, np.float32)
    got = lib.wh_load_wav(name, out.ctypes.data, n, ctypes.byref(rate))
    if got != n:
        raise ValueError(f"{path}: native decode returned {got} of {n} samples")
    return out, int(rate.value)


def resample_poly(samples: np.ndarray, up: int, down: int) -> np.ndarray:
    """Polyphase resampling by ``up / down`` (Kaiser beta 5, scipy's filter
    design), ``ceil(n * up / down)`` samples."""
    lib = library()
    x = np.ascontiguousarray(samples, np.float32)
    n_out = lib.wh_resample_poly(x.ctypes.data, len(x), up, down, None, 0)
    if n_out < 0:
        raise ValueError(f"wh_resample_poly refused up={up}, down={down}: {n_out}")
    out = np.empty(n_out, np.float32)
    got = lib.wh_resample_poly(x.ctypes.data, len(x), up, down, out.ctypes.data, n_out)
    if got != n_out:
        raise ValueError(f"wh_resample_poly wrote {got} of {n_out} samples")
    return out


def load_batch(paths: list[str | Path], target_samples: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The parallel batch feeder: each WAV decoded, resampled to 16 kHz and
    padded or cut to ``target_samples`` on its own thread, into one
    ``[N, target_samples]`` f32 array. Returns ``(batch, statuses int32
    [N], lengths int64 [N])``: a file's status is 0 or its decoder error,
    its length the 16 kHz sample count before the cut."""
    lib = library()
    n = len(paths)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    out = np.empty((n, target_samples), np.float32)
    statuses = np.zeros(n, np.int32)
    lengths = np.zeros(n, np.int64)
    lib.wh_load_batch(names, n, target_samples, out.ctypes.data, statuses.ctypes.data, lengths.ctypes.data, 0)
    return out, statuses, lengths
