"""Dynamic-batching transcription server.

Port of ``whisper_burn_tpu/serving.py``. Requests queue up, a single
worker thread drains them into fixed-size batches padded with silence (so
every batch decodes through the same cached runner and its CUDA graph),
and each caller gets its result back.

Two surfaces:

* :class:`BatchingTranscriber` — in-process, thread-safe ``submit()``
  returning a ``Future``-like handle; the building block.
* :func:`serve_http` — a stdlib HTTP server: ``POST /v1/transcribe`` with a
  WAV body (-> JSON), ``GET /healthz`` and ``GET /stats``.

Only the worker thread touches the device: the HTTP handler threads parse
WAV bodies in numpy, and the pipeline copies a batch to the device on the
worker. A runner's first batch captures its step as a CUDA graph there,
and no other thread may use CUDA while it captures.
"""

from __future__ import annotations

import collections
import io
import json
import queue
import threading
import time
import wave
from dataclasses import dataclass, field

import numpy as np

from whisper_burn_tpu_torch.audio.io import AudioBuffer
from whisper_burn_tpu_torch.transcribe import TranscribeResult, WhisperPipeline


class ServerOverloadedError(RuntimeError):
    """The pending-request queue is full (HTTP 503)."""


class ServingStats:
    """Request-latency and throughput counters (thread-safe): the
    queue-plus-device latency of every request and the batches' fill."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self._latencies: collections.deque[float] = collections.deque(maxlen=window)
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.batches = 0
        self.batched_requests = 0  # sum of real (unpadded) batch occupancy
        self._t0 = time.perf_counter()

    def record_batch(self, n_requests: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += n_requests

    def record_done(self, latency_s: float, ok: bool) -> None:
        with self._lock:
            self._latencies.append(latency_s)
            if ok:
                self.completed += 1
            else:
                self.failed += 1

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def snapshot(self) -> dict:
        with self._lock:
            lats = sorted(self._latencies)
            elapsed = max(time.perf_counter() - self._t0, 1e-9)

            def pct(p: float) -> float:
                if not lats:
                    return 0.0
                return lats[min(len(lats) - 1, int(p * (len(lats) - 1) + 0.5))]

            return {
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "requests_per_s": round(self.completed / elapsed, 3),
                "latency_ms": {
                    "p50": round(pct(0.50) * 1e3, 2),
                    "p90": round(pct(0.90) * 1e3, 2),
                    "p95": round(pct(0.95) * 1e3, 2),
                    "p99": round(pct(0.99) * 1e3, 2),
                    "max": round((lats[-1] if lats else 0.0) * 1e3, 2),
                },
                "batches": self.batches,
                "mean_batch_fill": round(self.batched_requests / self.batches, 3) if self.batches else 0.0,
            }


@dataclass
class _Request:
    audio: AudioBuffer | np.ndarray
    language: str | None
    event: threading.Event = field(default_factory=threading.Event)
    result: TranscribeResult | None = None
    error: Exception | None = None
    submitted_at: float = field(default_factory=time.perf_counter)

    def wait(self, timeout: float | None = None) -> TranscribeResult:
        if not self.event.wait(timeout):
            raise TimeoutError("transcription timed out")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


class BatchingTranscriber:
    """Queue requests; one worker drains them in fixed-size batches.

    ``batch_size`` is the padded batch (requests beyond it wait for the
    next drain; a partial batch pads with 1 s of silence in ``"en"``, so
    the batch's shape, and the runner that serves it, never change).
    ``max_wait_ms`` bounds how long each further request is waited for
    once a batch has its first. ``max_pending`` bounds the queue: past it,
    ``submit`` raises :class:`ServerOverloadedError`.
    """

    def __init__(
        self,
        pipeline: WhisperPipeline,
        batch_size: int = 8,
        max_wait_ms: float = 50.0,
        max_pending: int = 256,
    ):
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.stats = ServingStats()
        self._queue: queue.Queue[_Request | None] = queue.Queue(maxsize=max_pending)
        self._accepting = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, audio: AudioBuffer | np.ndarray, language: str | None = "auto") -> _Request:
        if not self._accepting:
            raise RuntimeError("transcriber is shutting down")
        req = _Request(audio=audio, language=language)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            self.stats.record_rejected()
            raise ServerOverloadedError(f"pending queue full ({self._queue.maxsize} requests)") from None
        return req

    def transcribe(self, audio, language="auto", timeout=None) -> TranscribeResult:
        return self.submit(audio, language).wait(timeout)

    def shutdown(self, timeout: float = 30.0) -> dict:
        """Stop accepting, drain everything already queued, then join the
        worker: in-flight requests still get their results. Returns the
        final stats snapshot."""
        self._accepting = False
        self._queue.put(None)  # the sentinel lands after every accepted request
        self._worker.join(timeout=timeout)
        return self.stats.snapshot()

    # -- worker ------------------------------------------------------------

    def _drain(self) -> list[_Request] | None:
        first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        deadline = self.max_wait_ms / 1000.0
        while len(batch) < self.batch_size:
            try:
                nxt = self._queue.get(timeout=deadline)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-post the shutdown sentinel
                break
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        silence = np.zeros(16000, np.float32)
        while True:
            batch = self._drain()
            if batch is None:
                return
            audios = [r.audio for r in batch]
            langs = [r.language for r in batch]
            # pad to the batch size, so that one runner serves every batch
            while len(audios) < self.batch_size:
                audios.append(silence)
                langs.append("en")
            self.stats.record_batch(len(batch))
            try:
                results = self.pipeline.transcribe_batch(audios, langs)
                now = time.perf_counter()
                for req, res in zip(batch, results):
                    req.result = res
                    self.stats.record_done(now - req.submitted_at, ok=True)
                    req.event.set()
            except Exception as e:  # propagate to all waiters
                now = time.perf_counter()
                for req in batch:
                    req.error = e
                    self.stats.record_done(now - req.submitted_at, ok=False)
                    req.event.set()


def _parse_wav_bytes(data: bytes) -> AudioBuffer:
    """A 16-bit PCM WAV body as mono float32 (channels averaged), numpy only."""
    with wave.open(io.BytesIO(data), "rb") as w:
        n_channels = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    samples = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if n_channels > 1:
        samples = samples.reshape(-1, n_channels).mean(axis=1)
    return AudioBuffer(samples=np.ascontiguousarray(samples), sample_rate=rate)


def serve_http(
    pipeline: WhisperPipeline,
    host: str = "127.0.0.1",
    port: int = 8000,
    batch_size: int = 8,
):
    """A stdlib HTTP server over a :class:`BatchingTranscriber`; returns the
    (server, transcriber) pair without serving yet (call
    ``server.serve_forever()``). With ``port=0`` the bound port is in
    ``server.server_address``."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    transcriber = BatchingTranscriber(pipeline, batch_size=batch_size)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                body = b'{"status":"ok"}'
            elif self.path == "/stats":
                body = json.dumps(transcriber.stats.snapshot()).encode()
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply(self, status: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            if self.path.rstrip("/") != "/v1/transcribe":
                self.send_error(404)
                return
            # 400 = malformed request, 503 = backpressure, 504 = timeout, 500 = server fault
            try:
                length = int(self.headers.get("Content-Length", "0"))
                language = self.headers.get("X-Language", "auto")
                audio = _parse_wav_bytes(self.rfile.read(length))
            except Exception as e:
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                result = transcriber.transcribe(audio, language, timeout=600)
            except ServerOverloadedError as e:
                self._reply(503, {"error": str(e)})
                return
            except TimeoutError as e:
                self._reply(504, {"error": str(e)})
                return
            except (KeyError, ValueError) as e:
                self._reply(400, {"error": str(e)})  # e.g. an unknown language
                return
            except Exception as e:
                self._reply(500, {"error": str(e)})
                return
            self._reply(
                200,
                {
                    "text": result.text,
                    "inference_ms": round(result.inference_ms, 2),
                    "lang_token": result.lang_token,
                },
            )

    server = ThreadingHTTPServer((host, port), Handler)
    server.transcriber = transcriber  # type: ignore[attr-defined]
    return server, transcriber
