"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. Builds
go to ``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the source so an edited source is rebuilt; they happen
at first use, or all at once (one ``nvcc`` per source, run in parallel)
through :func:`build_all`.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else, so a run can show that it went through the kernels.
While ``LAUNCH_LOG`` is a list, each launch also appends its
``(kernel, shape)`` there in launch order, so the kernels of a profiler
trace can be matched to their shapes one by one. A CUDA graph's capture
launches nothing: inside :func:`recording_launches` the wrappers' calls
are recorded instead of counted, and each replay of the graph adds the
recording with :func:`add_launches`, so the counts stay exact.

The collectives of tensor and data parallelism (``ops/collectives.py``)
are counted the same way, by kind in ``COLLECTIVES``: a capture records
them beside the launches and each replay adds them.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("q4_matmul", "ffn", "decode_attention", "encoder_attention", "cache_slot")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()
# the same launches keyed by (kernel, shape), so a run can attribute them
LAUNCH_SHAPES: collections.Counter = collections.Counter()
LAUNCH_LOG: list | None = None
COLLECTIVES: collections.Counter = collections.Counter()
COLLECTIVE = "collective"  # a recorded collective's name; its kind stands where a launch has its shape
# a capture's launches, in order, per thread: a capture records only the
# launches of the thread that captures, the other threads' are counted
_RECORDING = threading.local()
_COUNT_LOCK = threading.Lock()  # several threads may launch at once
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    with _COUNT_LOCK:
        LAUNCHES.clear()
        LAUNCH_SHAPES.clear()
        COLLECTIVES.clear()


def count_launch(name: str, shape: tuple) -> None:
    recording = getattr(_RECORDING, "launches", None)
    if recording is not None:
        recording.append((name, shape))
        return
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        LAUNCH_SHAPES[(name, shape)] += 1
        if LAUNCH_LOG is not None:
            LAUNCH_LOG.append((name, shape))


def count_collective(kind: str) -> None:
    """One collective of ``kind`` issued (recorded while a graph captures)."""
    recording = getattr(_RECORDING, "launches", None)
    if recording is not None:
        recording.append((COLLECTIVE, kind))
        return
    with _COUNT_LOCK:
        COLLECTIVES[kind] += 1


@contextlib.contextmanager
def recording_launches():
    """While a CUDA graph captures on this thread: yields the list that
    this thread's launches are recorded into, ``(name, shape)`` in order,
    in place of counting them (a capture runs nothing)."""
    if getattr(_RECORDING, "launches", None) is not None:
        raise RuntimeError("launches are already being recorded")
    _RECORDING.launches = []
    try:
        yield _RECORDING.launches
    finally:
        _RECORDING.launches = None


class LaunchTally:
    """A recording of :func:`recording_launches`, summed once so that a
    replay adds it in a few dictionary updates."""

    def __init__(self, recorded: list):
        self.log = [e for e in recorded if e[0] != COLLECTIVE]
        self.names = collections.Counter(name for name, _ in self.log)
        self.shapes = collections.Counter(self.log)
        self.collectives = collections.Counter(kind for name, kind in recorded if name == COLLECTIVE)


def add_launches(tally: LaunchTally) -> None:
    """Count one replay of a captured graph: every launch it recorded."""
    with _COUNT_LOCK:
        LAUNCHES.update(tally.names)
        LAUNCH_SHAPES.update(tally.shapes)
        COLLECTIVES.update(tally.collectives)
        if LAUNCH_LOG is not None:
            LAUNCH_LOG.extend(tally.log)


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds; raises with the compiler's output
    if a build fails. The ptxas report goes to ``<lib>.log``."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _LIBS:
        build_all((name,))
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def declare(lib: ctypes.CDLL, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return f


def check(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_position(fn: str, pos, device: torch.device) -> None:
    """A kernel's position is one int32 on its inputs' device, which the
    kernel reads from device memory (so a captured graph replays it at
    each value); it is never read on the host here."""
    if not (isinstance(pos, torch.Tensor) and pos.dtype == torch.int32 and pos.dim() == 0 and pos.device == device):
        got = f"{pos.dtype} {tuple(pos.shape)} on {pos.device}" if isinstance(pos, torch.Tensor) else type(pos).__name__
        raise TypeError(f"{fn}: the position must be a 0-d int32 tensor on {device}, got {got}")


def require_cuda(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel inputs must all be CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
