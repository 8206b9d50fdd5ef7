"""The port's bindings of the C++ host library (``native_host``) against
the Python paths and the JAX package's bindings, on the CPU.

The library is built at first use from ``native/whisper_host.cpp`` into
``build/native/``; the JAX package's bindings are pointed at that build.
Repack and WAV decode equal the Python paths bit for bit, resampling
stays within 2e-3 of scipy, the batch feeder equals the per-file path,
and ``WHISPER_TPU_NATIVE=0`` selects the Python paths. The JAX
``tests/test_native_host.py``'s ``test.wav`` case needs a reference file
that is not in the repository and has no counterpart here.
"""

import json

import numpy as np
import pytest

from whisper_burn_tpu_torch import native_host
from whisper_burn_tpu_torch.audio import io as audio_io
from whisper_burn_tpu_torch.audio.io import AudioBuffer, load_wav, save_wav
from whisper_burn_tpu_torch.audio.mel import pad_or_trim
from whisper_burn_tpu_torch.audio.resample import resample_to_16k
from whisper_burn_tpu_torch.gguf.quant import quantize_q4_0, unpack_q4_0
from whisper_burn_tpu_torch.gguf.repack import repack_q4_0

@pytest.fixture
def jax_native(monkeypatch):
    """The JAX package's bindings, loading the library the port built."""
    from whisper_burn_tpu import native_host as j_native

    monkeypatch.setattr(j_native, "_LIB_PATHS", [native_host.build()])
    monkeypatch.setattr(j_native, "_lib", None)
    assert j_native.available()
    yield j_native
    j_native._lib = None


def _python_path(monkeypatch):
    monkeypatch.setenv("WHISPER_TPU_NATIVE", "0")


def _wavs(tmp_path, rates=(16000, 8000, 22050), lengths=(12000, 5000, 40000)):
    rng = np.random.default_rng(7)
    paths = []
    for i, (rate, n) in enumerate(zip(rates, lengths)):
        p = tmp_path / f"a{i}.wav"
        save_wav(p, AudioBuffer(samples=(rng.standard_normal(n) * 0.3).astype(np.float32), sample_rate=rate))
        paths.append(p)
    return paths


def test_library_builds_into_build_native():
    lib = native_host.library()
    assert native_host.version() == native_host.VERSION == 2
    path = native_host.target()
    assert path.exists() and path.parent == native_host.BUILD_DIR and lib is native_host.library()
    assert path.name.startswith("libwhisper_host-")


@pytest.mark.parametrize("n_out,k_in", [(96, 160), (1280, 64), (5, 32)])
def test_repack_bit_exact(monkeypatch, n_out, k_in):
    """Against the codes and scales of the raw blocks, and the numpy path."""
    w = np.random.default_rng(0).standard_normal((n_out, k_in)).astype(np.float32)
    raw = quantize_q4_0(w)
    qw, sc = native_host.repack_q4_0(raw, n_out, k_in)
    q, d = unpack_q4_0(raw, n_out * k_in)
    np.testing.assert_array_equal(qw, q.reshape(n_out, k_in).T)
    np.testing.assert_array_equal(sc, d.reshape(n_out, k_in // 32).T)
    ours = repack_q4_0(raw, n_out, k_in)
    _python_path(monkeypatch)
    ref = repack_q4_0(raw, n_out, k_in)
    np.testing.assert_array_equal(ours.qw, ref.qw)
    np.testing.assert_array_equal(ours.scales, ref.scales)


def test_repack_rejects_bad_k():
    with pytest.raises(ValueError):
        native_host.repack_q4_0(b"\x00" * 18, 1, 33)
    with pytest.raises(ValueError):
        repack_q4_0(b"\x00" * 18, 1, 33)


def _pcm_wav(path, samples_int, width, rate, channels):
    import wave

    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(samples_int.tobytes())


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (1, 1), (3, 1), (3, 2)])
def test_wav_matches_python(monkeypatch, tmp_path, width, channels):
    """8, 16 and 24-bit PCM, mono and stereo: the stdlib path's samples."""
    rng = np.random.default_rng(width * 10 + channels)
    n = 3200 * channels
    if width == 1:
        data = rng.integers(0, 256, n).astype(np.uint8)
    elif width == 2:
        data = rng.integers(-32768, 32768, n).astype("<i2")
    else:
        v = rng.integers(-(1 << 23), 1 << 23, n).astype(np.int32)
        data = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255], axis=1).astype(np.uint8)
    p = tmp_path / "x.wav"
    _pcm_wav(p, data, width, 22050, channels)
    ours = load_wav(p)
    assert ours.sample_rate == 22050
    _python_path(monkeypatch)
    ref = load_wav(p)
    assert ref.sample_rate == 22050
    np.testing.assert_array_equal(ours.samples, ref.samples)


def test_wav_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_wav(tmp_path / "nope.wav")
    (tmp_path / "bad.wav").write_bytes(b"not a wav at all")
    with pytest.raises(ValueError):
        native_host.load_wav(tmp_path / "bad.wav")


def test_resample_close_to_scipy():
    from scipy.signal import resample_poly as sp

    t = np.arange(44100) / 44100
    tone = np.sin(2 * np.pi * 440 * t).astype(np.float32)
    ours = native_host.resample_poly(tone, 160, 441)
    theirs = sp(tone.astype(np.float64), 160, 441)
    assert len(ours) == len(theirs)
    assert np.abs(ours - theirs).max() < 2e-3


@pytest.mark.parametrize("rate", [8000, 22050, 44100])
def test_resample_to_16k_takes_the_native_path(monkeypatch, rate):
    """``resample_to_16k`` is the native resampler's output, and within
    scipy's tolerance of the Python path's."""
    samples = np.random.default_rng(rate).standard_normal(rate // 2).astype(np.float32) * 0.3
    g = np.gcd(rate, 16000)
    out = resample_to_16k(AudioBuffer(samples, rate))
    np.testing.assert_array_equal(out.samples, native_host.resample_poly(samples, 16000 // g, rate // g))
    _python_path(monkeypatch)
    ref = resample_to_16k(AudioBuffer(samples, rate))
    assert out.sample_rate == ref.sample_rate == 16000 and len(out.samples) == len(ref.samples)
    assert np.abs(out.samples - ref.samples).max() < 2e-3


def test_load_batch_parallel_feeder(tmp_path):
    """N files decoded, resampled and framed in parallel: the per-file
    Python path (load_wav -> resample_to_16k -> pad_or_trim), the true
    16 kHz lengths, and a missing file's own nonzero status."""
    paths = _wavs(tmp_path)
    target = 16000
    batch, statuses, lengths = native_host.load_batch(paths, target)
    assert batch.shape == (3, target)
    np.testing.assert_array_equal(statuses, 0)
    assert lengths[0] == 12000 and lengths[1] == 10000
    assert abs(lengths[2] - 40000 * 16000 // 22050) <= 2
    for i, p in enumerate(paths):
        audio = load_wav(p)
        if audio.sample_rate != 16000:
            audio = resample_to_16k(audio)
        np.testing.assert_array_equal(batch[i], pad_or_trim(audio.samples, target))
    _, statuses2, _ = native_host.load_batch([paths[0], tmp_path / "nope.wav"], target)
    assert statuses2[0] == 0 and statuses2[1] != 0


def test_bindings_match_the_jax_bindings(jax_native, tmp_path):
    """The same C interface through both packages' bindings: equal repack,
    WAV, resample and batch outputs."""
    w = np.random.default_rng(4).standard_normal((64, 96)).astype(np.float32)
    raw = quantize_q4_0(w)
    for a, b in zip(native_host.repack_q4_0(raw, 64, 96), jax_native.repack_q4_0(raw, 64, 96)):
        np.testing.assert_array_equal(a, b)
    paths = _wavs(tmp_path)
    for p in paths:
        (s1, r1), (s2, r2) = native_host.load_wav(p), jax_native.load_wav(p)
        assert r1 == r2
        np.testing.assert_array_equal(s1, s2)
    tone = np.sin(np.arange(8000) * 0.05).astype(np.float32)
    np.testing.assert_array_equal(native_host.resample_poly(tone, 2, 1), jax_native.resample_poly(tone, 2, 1))
    for a, b in zip(native_host.load_batch(paths, 20000), jax_native.load_batch(paths, 20000)):
        np.testing.assert_array_equal(a, b)


def test_switch_selects_the_python_paths(monkeypatch, tmp_path):
    """With WHISPER_TPU_NATIVE=0 nothing calls the library."""
    _python_path(monkeypatch)

    def refuse(*args, **kwargs):
        raise AssertionError("the native library was called")

    for name in ("library", "repack_q4_0", "load_wav", "resample_poly", "load_batch"):
        monkeypatch.setattr(native_host, name, refuse)
    (p,) = _wavs(tmp_path, rates=(8000,), lengths=(4000,))
    audio = audio_io.load_wav(p)
    assert audio.sample_rate == 8000
    assert resample_to_16k(audio).sample_rate == 16000
    raw = quantize_q4_0(np.ones((2, 32), np.float32))
    assert repack_q4_0(raw, 2, 32).qw.shape == (32, 2)


class _Pipeline:
    """A stand-in pipeline that keeps the audio it is handed."""

    def __init__(self, chunk_samples):
        self.chunk_samples = chunk_samples
        self.seen = []

    def transcribe_batch(self, audios, languages):
        from types import SimpleNamespace

        self.seen.append(audios)
        return [SimpleNamespace(text="x", inference_ms=1.0) for _ in audios]


def test_runner_feeds_batches_natively(monkeypatch, tmp_path):
    """evaluate_manifest hands the pipeline the feeder's padded 16 kHz rows
    and the true durations; the per-file path with WHISPER_TPU_NATIVE=0; a
    file the feeder cannot read fails the run."""
    from whisper_burn_tpu_torch.eval.runner import evaluate_manifest

    paths = _wavs(tmp_path)
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("".join(json.dumps({"id": i, "audio": str(p), "text": "x"}) + "\n"
                                for i, p in enumerate(paths)))
    pipe = _Pipeline(16000)
    summary = evaluate_manifest(pipe, manifest, results_path=tmp_path / "r.jsonl", batch_size=3)
    assert summary.n_utterances == 3 and summary.wer == 0.0
    (batch,) = pipe.seen
    want, _, lengths = native_host.load_batch(paths, 16000)
    for row, ref in zip(batch, want):
        np.testing.assert_array_equal(row, ref)
    assert abs(summary.audio_seconds - float(lengths.sum()) / 16000.0) < 1e-9

    _python_path(monkeypatch)
    pipe = _Pipeline(16000)
    evaluate_manifest(pipe, manifest, results_path=tmp_path / "r2.jsonl", batch_size=3)
    assert all(isinstance(a, AudioBuffer) for a in pipe.seen[0])
    monkeypatch.delenv("WHISPER_TPU_NATIVE")

    manifest.write_text(json.dumps({"id": 9, "audio": str(tmp_path / "nope.wav"), "text": "x"}) + "\n")
    with pytest.raises(ValueError, match="nope.wav"):
        evaluate_manifest(_Pipeline(16000), manifest, results_path=tmp_path / "r3.jsonl")
