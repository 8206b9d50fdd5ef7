"""The port's serving layer (``whisper_burn_tpu_torch/serving.py``) and its
runners under concurrent requests, against the JAX package, on the CPU at
``WhisperConfig.tiny_test()`` in f32 (``Compute.parity()``; the JAX side
on its XLA backend, as tests/test_serving.py builds it), 6 tokens.

Several threads decoding one shape at once share its cached runner: each
request holds the runner's lock from its start until its tokens are
copied out (``models/whisper.py``, ``models/beam.py``), so threaded
requests give the sequential tokens. Then the batching transcriber
against the JAX one, its backpressure, shutdown and stats, the HTTP
server, and ``utils.profiling.trace``."""

import io
import json
import sys
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

from whisper_burn_tpu.gguf.loader import LoadedModel as JLoadedModel
from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
import whisper_burn_tpu.serving as jserving
import whisper_burn_tpu.transcribe as jtr

from whisper_burn_tpu_torch import serving
from whisper_burn_tpu_torch.gguf.loader import LoadedModel
from whisper_burn_tpu_torch.models import whisper as w
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import WhisperPipeline
from whisper_burn_tpu_torch.utils.profiling import trace

MAX_TOKENS = 6


@pytest.fixture(scope="module")
def pipeline():
    cfg = WhisperConfig.tiny_test()
    return WhisperPipeline(LoadedModel(cfg, random_params(cfg, seed=0, device="cpu")), None, compute=Compute.parity(),
                           max_tokens=MAX_TOKENS, device="cpu")


@pytest.fixture(scope="module")
def jax_pipeline():
    cfg = JConfig.tiny_test()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "enable_compilation_cache", lambda path=None: None)
        yield jtr.WhisperPipeline(JLoadedModel(cfg, j_random_params(cfg, seed=0)), None,
                                  compute=JCompute.parity().replace(backend=KernelBackend.XLA), max_tokens=MAX_TOKENS)


def _tone(hz=440.0, seconds=0.5):
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.3 * np.sin(2 * np.pi * hz * t)).astype(np.float32)


def _noisy(seed: int, seconds: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (_tone(150 + 40 * seed, seconds) + 0.1 * rng.standard_normal(int(seconds * 16000))).astype(np.float32)


def _wav_bytes(samples: np.ndarray, rate: int = 16000, channels: int = 1) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(2)
        f.setframerate(rate)
        pcm = np.repeat(samples[:, None], channels, axis=1) if channels > 1 else samples
        f.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


# --------------------------------------------------------------------------
# the runners under several threads


@pytest.mark.parametrize("beam_width", [1, 3], ids=["greedy", "beam"])
def test_threads_on_one_runner_match_sequential(pipeline, beam_width, monkeypatch):
    """Six threads, each transcribing three batches of two utterances of its
    own, through one runner (one shape): each batch gives the tokens and
    language tokens that it gives alone. Without the runner's lock the
    threads advance one shared ``k`` and mix their tokens (greedy: an
    IndexError past the token buffer's end)."""
    monkeypatch.setattr(pipeline, "beam_width", beam_width)
    w.clear_runners()
    batches = [[(_noisy(2 * t), "en"), (_noisy(2 * t + 1), "de" if t % 3 == 0 else "auto")] for t in range(6)]
    want = [pipeline.transcribe_batch([a for a, _ in b], [l for _, l in b]) for b in batches]
    assert len(w.cached_runners()) == 1
    got, errors = {}, []

    def client(t):
        try:
            audios, langs = [a for a, _ in batches[t]], [l for _, l in batches[t]]
            got[t] = [pipeline.transcribe_batch(audios, langs) for _ in range(3)]
        except Exception as e:  # re-raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often, so that an unguarded runner interleaves
    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    if errors:
        raise errors[0]
    assert not any(th.is_alive() for th in threads) and len(got) == 6
    for t in range(6):
        for results in got[t]:
            for r, o in zip(want[t], results):
                np.testing.assert_array_equal(o.tokens, r.tokens)
                assert o.lang_token == r.lang_token
    assert len(w.cached_runners()) == 1
    w.clear_runners()


def test_runner_cache_from_threads_keeps_one_runner_a_shape():
    """Threads asking for runners of a few shapes at once: one runner per
    shape, the cache bounded, no runner made twice for one key."""
    w.clear_runners()
    made = []

    def make(key):
        made.append(key)
        return object()

    def ask(i):
        for j in range(50):
            key = ("shape", (i + j) % 4)
            w.cached_runner(key, lambda key=key: make(key))

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert sorted(made) == sorted(("shape", s) for s in range(4))
    assert len(w.cached_runners()) == 4
    w.clear_runners()


def test_capture_records_only_its_own_threads_launches():
    """While one thread records a capture's launches, another thread's
    launches are counted, not recorded, and it may record a capture of its
    own at the same time."""
    _build.reset_launches()
    recorded, inside, done = {}, threading.Barrier(2), threading.Event()

    def capture(name):
        with _build.recording_launches() as launches:
            inside.wait(timeout=60)
            _build.count_launch(name, (1,))
            inside.wait(timeout=60)
        recorded[name] = list(launches)

    threads = [threading.Thread(target=capture, args=(n,)) for n in ("first", "second")]
    for th in threads:
        th.start()
    counter = threading.Thread(target=lambda: [_build.count_launch("eager", (2,)) for _ in range(5)] and done.set())
    counter.start()
    for th in threads + [counter]:
        th.join(timeout=60)
    assert done.is_set() and recorded == {"first": [("first", (1,))], "second": [("second", (1,))]}
    assert dict(_build.LAUNCHES) == {"eager": 5}
    _build.reset_launches()


# --------------------------------------------------------------------------
# the batching transcriber


def test_batching_transcriber_matches_jax(pipeline, jax_pipeline):
    """The same five requests, in order from one thread, batch size 8 (three
    1 s silences in "en" pad the batch): the JAX transcriber's tokens and
    language tokens, and the port pipeline's own batch of the eight."""
    requests = [(_noisy(i), lang) for i, lang in enumerate(["en", "auto", "de", "auto", "fr"])]
    results = {}
    for name, mod, pipe in (("jax", jserving, jax_pipeline), ("torch", serving, pipeline)):
        server = mod.BatchingTranscriber(pipe, batch_size=8, max_wait_ms=500)
        try:
            reqs = [server.submit(a, lang) for a, lang in requests]
            results[name] = [r.wait(timeout=300) for r in reqs]
            snap = server.stats.snapshot()
        finally:
            server.shutdown()
        assert (snap["completed"], snap["batches"], snap["mean_batch_fill"]) == (5, 1, 5.0)
    silence = np.zeros(16000, np.float32)
    direct = pipeline.transcribe_batch([a for a, _ in requests] + [silence] * 3,
                                       [lang for _, lang in requests] + ["en"] * 3)
    for r, o, d in zip(results["jax"], results["torch"], direct):
        np.testing.assert_array_equal(o.tokens, np.asarray(r.tokens))
        np.testing.assert_array_equal(o.tokens, d.tokens)
        assert o.lang_token == r.lang_token == d.lang_token
    assert results["torch"][0].lang_token == 50259 and results["torch"][2].lang_token == 50261


def test_backpressure_bounded_queue(pipeline):
    """Past max_pending, submit raises ServerOverloadedError and the stats
    count it as rejected; the accepted requests complete."""
    server = serving.BatchingTranscriber(pipeline, batch_size=2, max_wait_ms=10, max_pending=3)
    try:
        reqs, overloaded = [], 0
        for i in range(64):
            try:
                reqs.append(server.submit(_tone(hz=200 + i), "en"))
            except serving.ServerOverloadedError:
                overloaded += 1
        assert overloaded > 0, "queue never filled: the bound is not enforced"
        for r in reqs:
            r.wait(timeout=300)
    finally:
        final = server.shutdown()
    assert final["rejected"] == overloaded and final["completed"] == len(reqs)


def test_graceful_shutdown_drains_inflight(pipeline):
    """shutdown() completes the accepted requests, then refuses new ones."""
    server = serving.BatchingTranscriber(pipeline, batch_size=2, max_wait_ms=10)
    reqs = [server.submit(_tone(hz=300 + 10 * i), "en") for i in range(5)]
    final = server.shutdown(timeout=300)
    assert all(r.result is not None for r in reqs)
    assert final["completed"] == 5 and not server._worker.is_alive()
    with pytest.raises(RuntimeError):
        server.submit(_tone(), "en")


def test_errors_reach_every_waiter(pipeline):
    """An unknown language fails the batch: each of its requests raises."""
    server = serving.BatchingTranscriber(pipeline, batch_size=2, max_wait_ms=200)
    try:
        reqs = [server.submit(_tone(), "en"), server.submit(_tone(), "xx")]
        for r in reqs:
            with pytest.raises(KeyError):
                r.wait(timeout=300)
    finally:
        final = server.shutdown()
    assert final["failed"] == 2


def test_serving_stats_match_jax():
    """The same latencies and batches: the JAX snapshot, key for key (the
    request rate aside, which reads the clock)."""
    rng = np.random.default_rng(0)
    ours, ref = serving.ServingStats(window=64), jserving.ServingStats(window=64)
    for i, lat in enumerate(rng.exponential(0.2, 100)):
        for s in (ours, ref):
            s.record_done(float(lat), ok=i % 7 != 0)
            if i % 3 == 0:
                s.record_batch(1 + i % 5)
            if i % 11 == 0:
                s.record_rejected()
    a, b = ours.snapshot(), ref.snapshot()
    assert a.pop("requests_per_s") > 0 and b.pop("requests_per_s") > 0
    assert a == b
    assert serving.ServingStats().snapshot()["latency_ms"]["p50"] == 0.0


# --------------------------------------------------------------------------
# HTTP


@pytest.fixture
def http(pipeline):
    server, transcriber = serving.serve_http(pipeline, port=0, batch_size=2)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    host, port = server.server_address
    try:
        yield f"http://{host}:{port}"
    finally:
        server.shutdown()
        server.server_close()
        transcriber.shutdown()


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, headers=headers or {}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


def test_http_roundtrip_and_errors(http, pipeline):
    """/healthz; a mono 16 kHz and a stereo 44.1 kHz WAV transcribe as the
    pipeline does (the stereo one downmixed and resampled); a wrong path
    404, a malformed body 400 with a JSON error; /stats counts them."""
    with urllib.request.urlopen(f"{http}/healthz", timeout=30) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    tone = _tone()
    status, body = _post(f"{http}/v1/transcribe", _wav_bytes(tone), {"X-Language": "en"})
    assert status == 200 and body["lang_token"] == 50259 and body["text"] == ""
    stereo = _wav_bytes(_tone(330, 0.4), rate=44100, channels=2)
    status, body = _post(f"{http}/v1/transcribe/", stereo)
    parsed = serving._parse_wav_bytes(stereo)
    assert parsed.sample_rate == 44100 and parsed.samples.ndim == 1
    direct = pipeline.transcribe_batch([parsed, np.zeros(16000, np.float32)], ["auto", "en"])[0]
    assert status == 200 and body["lang_token"] == direct.lang_token
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{http}/nope", timeout=30)
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{http}/v1/nope", b"x")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{http}/v1/transcribe", b"not a wav")
    assert e.value.code == 400 and "error" in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{http}/v1/transcribe", _wav_bytes(tone), {"X-Language": "xx"})
    assert e.value.code == 400
    with urllib.request.urlopen(f"{http}/stats", timeout=30) as resp:
        snap = json.loads(resp.read())
    assert (snap["completed"], snap["failed"]) == (2, 1)
    assert snap["latency_ms"]["p50"] > 0 and snap["batches"] == 3


def test_parse_wav_matches_jax():
    """16-bit PCM bodies, mono and stereo: the JAX parser's samples and rate."""
    for rate, channels in ((16000, 1), (44100, 2), (8000, 3)):
        body = _wav_bytes(_noisy(rate % 7), rate=rate, channels=channels)
        ours, ref = serving._parse_wav_bytes(body), jserving._parse_wav_bytes(body)
        assert ours.sample_rate == ref.sample_rate == rate
        np.testing.assert_array_equal(ours.samples, ref.samples)


# --------------------------------------------------------------------------
# trace


def test_trace_writes_a_chrome_trace(pipeline, tmp_path):
    """``trace`` around a request writes one Chrome trace that parses and
    holds the decode's stage ranges; a second trace gets its own file."""
    _build.reset_launches()
    with trace(tmp_path / "tr") as path:
        pipeline.transcribe(_tone(), "en")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"greedy_decode.encode", "greedy_decode.decode"} <= names
    with trace(tmp_path / "tr") as second:
        pass
    assert second != path and second.exists()
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: no kernel launched
