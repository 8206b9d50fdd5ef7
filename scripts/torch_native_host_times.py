"""Host seconds of each C++ host-library path of the PyTorch/CUDA port
against its Python path, on the workload each path serves.

    python3 scripts/torch_native_host_times.py [--repeats 3] [--seed 0]

Three workloads, each timed with ``WHISPER_TPU_NATIVE`` set to 1 (the
library, ``native_host``) and to 0 (the Python path), alternating, the
best of ``--repeats`` kept:

* ``repack``: ``gguf/repack.repack_q4_0`` over every Q4 linear of
  Large-V3-Turbo (32 encoder layers of four 1280 x 1280 projections and
  the 1280 <-> 5120 FFN; 4 decoder layers with the cross-attention's four
  more), from Q4_0 blocks of seeded random codes and f16 scales: the
  repack of a cold load;
* ``wav_resample``: ``audio/io.load_wav`` then ``audio/resample.resample``
  to 16 kHz on 32 WAV files like the serving phase's request bodies
  (5-30 s of noise or a tone, every third at 44.1 kHz stereo, the rest
  16 kHz mono): a server's intake;
* ``manifest_batch``: the eval runner's feeder on batches of 8 of those
  files: ``native_host.load_batch`` (each file decoded, resampled and
  padded to 30 s on its own thread) against ``load_wav`` per file, then
  the pipeline's ``resample_to_16k`` and ``pad_or_trim``.

The library is built before any timing. The outputs of the two paths are
compared: repack and decode bit for bit, resampling by its max abs
difference. Host only: no device is used. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from whisper_burn_tpu_torch import native_host  # noqa: E402
from whisper_burn_tpu_torch.audio.io import load_wav  # noqa: E402
from whisper_burn_tpu_torch.audio.mel import pad_or_trim  # noqa: E402
from whisper_burn_tpu_torch.audio.resample import resample, resample_to_16k  # noqa: E402
from whisper_burn_tpu_torch.gguf.quant import Q4_BLOCK_BYTES, Q4_BLOCK_SIZE  # noqa: E402
from whisper_burn_tpu_torch.gguf.repack import repack_q4_0  # noqa: E402

D, F, ENC_LAYERS, DEC_LAYERS = 1280, 5120, 32, 4  # Large-V3-Turbo
CHUNK = 480_000  # 30 s at 16 kHz
FILES, BATCH = 32, 8


def turbo_shapes() -> list[tuple[int, int]]:
    """``(n_out, k_in)`` of every Q4 linear of Large-V3-Turbo."""
    block = [(D, D)] * 4 + [(F, D), (D, F)]
    return block * ENC_LAYERS + (block + [(D, D)] * 4) * DEC_LAYERS


def q4_blocks(rng: np.random.Generator, n_out: int, k_in: int) -> np.ndarray:
    """Q4_0 bytes of an ``[n_out, k_in]`` tensor: random nibbles, f16
    scales in [1e-3, 1e-1)."""
    nb = n_out * k_in // Q4_BLOCK_SIZE
    raw = rng.integers(0, 256, (nb, Q4_BLOCK_BYTES), dtype=np.uint8)
    raw[:, :2] = rng.uniform(1e-3, 1e-1, nb).astype("<f2").view(np.uint8).reshape(nb, 2)
    return raw.reshape(-1)


def write_wavs(root: Path, rng: np.random.Generator) -> list[Path]:
    paths = []
    for i in range(FILES):
        stereo = i % 3 == 2
        rate, channels = (44_100, 2) if stereo else (16_000, 1)
        n = int(rng.uniform(5, 30) * rate)
        if rng.random() < 0.5:
            x = rng.standard_normal(n) * 0.1
        else:
            x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 1000) * np.arange(n) / rate)
        pcm = (np.clip(x, -1, 1) * 32767).astype("<i2")
        path = root / f"utt{i:02d}.wav"
        with wave.open(str(path), "wb") as f:
            f.setnchannels(channels)
            f.setsampwidth(2)
            f.setframerate(rate)
            f.writeframes(np.repeat(pcm[:, None], channels, axis=1).tobytes())
        paths.append(path)
    return paths


def timed(fn, native: bool):
    os.environ["WHISPER_TPU_NATIVE"] = "1" if native else "0"
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def compare(fn, repeats: int) -> tuple[dict, object, object]:
    """Best seconds of ``fn`` on each path (native, python, python,
    native, ...) and each path's last output."""
    secs = {"native": [], "python": []}
    outs = {}
    for r in range(repeats):
        for native in ((True, False) if r % 2 == 0 else (False, True)):
            s, outs[native] = timed(fn, native)
            secs["native" if native else "python"].append(s)
    best = {k: min(v) for k, v in secs.items()}
    return {"native_s": best["native"], "python_s": best["python"], "speedup": best["python"] / best["native"],
            "native_all_s": secs["native"], "python_all_s": secs["python"]}, outs[True], outs[False]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    native_host.library()
    build_s = time.perf_counter() - t0

    shapes = turbo_shapes()
    raws = [q4_blocks(rng, n, k) for n, k in shapes]
    repack, ours, theirs = compare(lambda: [repack_q4_0(r, n, k) for r, (n, k) in zip(raws, shapes)], args.repeats)
    repack["weights"] = sum(n * k for n, k in shapes)
    repack["bit_equal"] = all(np.array_equal(a.qw, b.qw) and np.array_equal(a.scales, b.scales)
                              for a, b in zip(ours, theirs))
    del raws, ours, theirs

    with tempfile.TemporaryDirectory() as tmp:
        paths = write_wavs(Path(tmp), rng)

        def intake():
            return [resample(load_wav(p), 16_000).samples for p in paths]

        wav, ours, theirs = compare(intake, args.repeats)
        wav["files"], wav["audio_s"] = FILES, sum(len(x) for x in theirs) / 16_000
        wav["resample_max_abs_diff"] = max(float(np.abs(a - b).max()) for a, b in zip(ours, theirs))
        os.environ["WHISPER_TPU_NATIVE"] = "1"
        raw_n = [load_wav(p).samples for p in paths]
        os.environ["WHISPER_TPU_NATIVE"] = "0"
        raw_p = [load_wav(p).samples for p in paths]
        wav["decode_bit_equal"] = all(np.array_equal(a, b) for a, b in zip(raw_n, raw_p))

        def feed():
            rows = []
            for i in range(0, FILES, BATCH):
                batch = paths[i: i + BATCH]
                if native_host.enabled():
                    out, statuses, _ = native_host.load_batch(batch, CHUNK)
                    assert not statuses.any(), statuses
                    rows.append(out)
                else:
                    rows.append(np.stack([pad_or_trim(resample_to_16k(load_wav(p)).samples, CHUNK) for p in batch]))
            return np.concatenate(rows)

        manifest, ours, theirs = compare(feed, args.repeats)
        manifest["batches"], manifest["batch"] = FILES // BATCH, BATCH
        manifest["max_abs_diff"] = float(np.abs(ours - theirs).max())
    os.environ.pop("WHISPER_TPU_NATIVE", None)

    print(json.dumps({"host": f"{platform.machine()}, {os.cpu_count()} cores, {native_host._cpu_model()}",
                      "native_build_s": build_s, "repeats": args.repeats, "repack": repack,
                      "wav_resample": wav, "manifest_batch": manifest}))
    return 0 if repack["bit_equal"] and wav["decode_bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
