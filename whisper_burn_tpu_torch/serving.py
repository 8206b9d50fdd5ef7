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

Over a mesh of ranks (``WhisperPipeline(mesh=...)``, one process a rank)
the requests reach rank 0 alone. Its worker does each batch's host work
(``WhisperPipeline.prepare_batch``: an unknown language fails the batch
there), then hands the batch to every other rank over the job's gloo
control group (``parallel/multihost.control_group``) and decodes its own
share; every other rank runs :func:`follow_batches`, which decodes each
batch it is handed for the gather and returns on rank 0's stop. A fault
after the hand-off ends the job: the batch's requests fail (HTTP 500),
rank 0 stops accepting, and the server stops (:func:`run_until_interrupted`
returns 1); no rank serves on without the others.

The worker's cycle runs inside the recorder's spans (``utils/profiling.py``;
kept while the launch log is on): ``serving.wait`` (blocked for a batch's
first request), ``serving.collect`` (from it to the batch's closing), the
pipeline's ``pipeline.prepare``, ``serving.handoff`` (over a mesh),
``pipeline.device_step`` and ``pipeline.detokenize``, then
``serving.reply`` (results set, waiters woken); and for each request a
``serving.queued`` span from its submit to its batch's closing, with the
request's id and its batch's as ``parent``.
"""

from __future__ import annotations

import collections
import io
import itertools
import json
import queue
import signal
import threading
import time
import wave
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from whisper_burn_tpu_torch.audio.io import AudioBuffer
from whisper_burn_tpu_torch.transcribe import PreparedBatch, TranscribeResult, WhisperPipeline
from whisper_burn_tpu_torch.utils.profiling import add_span, span

# while its queue is empty, a meshed server's rank 0 tells the other ranks
# it is alive this often (they give up after the control group's timeout)
KEEPALIVE_S = 30.0
_STOP, _BATCH, _KEEPALIVE = 0, 1, 2  # the kinds of rank 0's messages


class ServerOverloadedError(RuntimeError):
    """The pending-request queue is full (HTTP 503)."""


class RankFailureError(RuntimeError):
    """A rank failed after a batch was handed to the others: the job stops
    (HTTP 500)."""


def _send(group, kind: int, batch: PreparedBatch | None = None) -> None:
    """Rank 0's message to every rank of ``group``: a header (kind, padded
    B, window samples, detect), then for a batch its samples and language
    tokens. Every rank receives the whole batch and decodes its rows."""
    b, s = batch.samples.shape if batch is not None else (0, 0)
    detect = int(batch.detect) if batch is not None else 0
    dist.broadcast(torch.tensor([kind, b, s, detect], dtype=torch.int64), 0, group=group)
    if batch is not None:
        dist.broadcast(torch.from_numpy(batch.samples), 0, group=group)
        dist.broadcast(torch.from_numpy(batch.lang_tokens), 0, group=group)


def _receive(group) -> tuple[int, PreparedBatch | None]:
    """The other side of :func:`_send`: the kind and, for a batch, the
    batch with ``n = 0`` (this rank keeps no result)."""
    header = torch.zeros(4, dtype=torch.int64)
    dist.broadcast(header, 0, group=group)
    kind, b, s, detect = header.tolist()
    if kind != _BATCH:
        return kind, None
    samples = torch.empty((b, s), dtype=torch.float32)
    lang_tokens = torch.empty(b, dtype=torch.int32)
    dist.broadcast(samples, 0, group=group)
    dist.broadcast(lang_tokens, 0, group=group)
    return kind, PreparedBatch(samples.numpy(), lang_tokens.numpy(), bool(detect), 0)


def follow_batches(pipeline: WhisperPipeline, group) -> int:
    """Every rank but 0 of a meshed server: decode each batch rank 0 hands
    over (``pipeline`` is this rank's, on the same mesh; the result goes to
    rank 0 through the gather and is dropped here) until rank 0 stops.
    Returns the number of batches. SIGINT is ignored meanwhile (in the main
    thread): a Ctrl-C reaches every rank (from the terminal, or forwarded
    by ``torch.distributed.run``), and the stop must come from rank 0, or a
    rank would leave inside a collective. A fault raises:
    this rank's own, or the group's error or timeout when another rank
    failed."""
    restore = None
    if threading.current_thread() is threading.main_thread():
        restore = signal.signal(signal.SIGINT, signal.SIG_IGN)
    try:
        n = 0
        while True:
            kind, batch = _receive(group)
            if kind == _STOP:
                return n
            if kind == _BATCH:
                pipeline.decode_batch(batch)
                n += 1
    finally:
        if restore is not None:
            signal.signal(signal.SIGINT, restore)


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
    id: int = -1  # the transcriber's count of its requests

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

    Over a mesh of more than one rank, this is rank 0's and ``group`` is
    the job's control group (``parallel/multihost.control_group``): each
    batch goes to the other ranks (:func:`follow_batches`) after its host
    work, ``shutdown`` stops them after the last, and an idle queue sends
    them a keep-alive every ``KEEPALIVE_S``. A failure after the hand-off
    is fatal: ``fault`` holds it, the batch and every queued request fail
    with :class:`RankFailureError`, ``submit`` refuses, the worker ends
    and ``on_fault`` (if set) is called with the error. ``handoffs``
    counts the batches handed over, ``handoff_s`` their seconds.
    """

    def __init__(
        self,
        pipeline: WhisperPipeline,
        batch_size: int = 8,
        max_wait_ms: float = 50.0,
        max_pending: int = 256,
        group=None,
    ):
        mesh = pipeline.mesh
        ranks = 1 if mesh is None else mesh.data * mesh.model
        if ranks > 1 and group is None:
            raise ValueError(f"a pipeline over {ranks} ranks needs the control group "
                             "(parallel/multihost.control_group) to hand its batches to the other ranks")
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.max_wait_ms = max_wait_ms
        self.stats = ServingStats()
        self.fault: Exception | None = None
        self.on_fault = None
        self.handoffs, self.handoff_s = 0, 0.0
        self._group = group if ranks > 1 else None  # at one rank nothing is sent
        self._queue: queue.Queue[_Request | None] = queue.Queue(maxsize=max_pending)
        self._ids = itertools.count()
        self._lock = threading.Lock()  # orders submit against a fault's drain
        self._accepting = True
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, audio: AudioBuffer | np.ndarray, language: str | None = "auto") -> _Request:
        req = _Request(audio=audio, language=language, id=next(self._ids))
        with self._lock:
            if not self._accepting:
                raise RuntimeError("transcriber is shutting down" if self.fault is None
                                   else f"transcriber stopped: {self.fault}")
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
        worker: in-flight requests still get their results (and over a
        mesh the other ranks their stop). Returns the final stats
        snapshot."""
        with self._lock:
            self._accepting = False
        self._queue.put(None)  # the sentinel lands after every accepted request
        self._worker.join(timeout=timeout)
        return self.stats.snapshot()

    # -- worker ------------------------------------------------------------

    def _next(self) -> _Request | None:
        """The next request or the shutdown sentinel; over a mesh, a
        keep-alive to the other ranks for every KEEPALIVE_S without one."""
        while True:
            try:
                return self._queue.get(timeout=None if self._group is None else KEEPALIVE_S)
            except queue.Empty:
                _send(self._group, _KEEPALIVE)

    def _drain(self, batch_id: int) -> list[_Request] | None:
        with span("serving.wait", batch=batch_id, profiler_range=False):
            first = self._next()
        if first is None:
            return None
        batch = [first]
        deadline = self.max_wait_ms / 1000.0
        with span("serving.collect", batch=batch_id, profiler_range=False) as collect:
            while len(batch) < self.batch_size:
                try:
                    nxt = self._queue.get(timeout=deadline)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post the shutdown sentinel
                    break
                batch.append(nxt)
        if collect is not None:
            for req in batch:
                add_span("serving.queued", int(req.submitted_at * 1e9), collect.end_ns, request=req.id, parent=batch_id)
        return batch

    def _fail(self, batch: list[_Request], error: Exception) -> None:
        now = time.perf_counter()
        for req in batch:
            req.error = error
            self.stats.record_done(now - req.submitted_at, ok=False)
            req.event.set()

    def _run(self) -> None:
        try:
            self._serve()
        except Exception as e:  # a rank failed after a hand-off: the job stops
            with self._lock:
                self._accepting = False
                self.fault = e
            queued = []
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req is not None:
                    queued.append(req)
            self._fail(queued, RankFailureError(f"a rank failed: {e}"))
            if self.on_fault is not None:
                self.on_fault(e)

    def _serve(self) -> None:
        silence = np.zeros(16000, np.float32)
        for batch_id in itertools.count():
            batch = self._drain(batch_id)
            if batch is None:
                if self._group is not None:
                    _send(self._group, _STOP)
                return
            audios = [r.audio for r in batch]
            langs = [r.language for r in batch]
            # pad to the batch size, so that one runner serves every batch
            while len(audios) < self.batch_size:
                audios.append(silence)
                langs.append("en")
            self.stats.record_batch(len(batch))
            try:  # the host work: a bad request fails its batch, on this rank alone
                prepared = self.pipeline.prepare_batch(audios, langs)
            except Exception as e:  # propagate to all waiters
                self._fail(batch, e)
                continue
            try:
                if self._group is not None:
                    with span("serving.handoff", batch=batch_id, profiler_range=False):
                        t0 = time.perf_counter()
                        _send(self._group, _BATCH, prepared)
                        self.handoff_s += time.perf_counter() - t0
                        self.handoffs += 1
                results = self.pipeline.decode_batch(prepared)
            except Exception as e:
                if self._group is not None:  # fatal: the ranks no longer agree
                    self._fail(batch, RankFailureError(f"a rank failed after the hand-off: {e}"))
                    raise
                self._fail(batch, e)  # propagate to all waiters
                continue
            with span("serving.reply", batch=batch_id, profiler_range=False):
                now = time.perf_counter()
                for req, res in zip(batch, results):
                    req.result = res
                    self.stats.record_done(now - req.submitted_at, ok=True)
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
    group=None,
):
    """A stdlib HTTP server over a :class:`BatchingTranscriber`; returns the
    (server, transcriber) pair without serving yet (call
    ``server.serve_forever()``, or :func:`run_until_interrupted`). With
    ``port=0`` the bound port is in ``server.server_address``. Over a mesh
    this is rank 0's, ``group`` the control group, and the other ranks run
    :func:`follow_batches`; a rank's fault stops the server."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    transcriber = BatchingTranscriber(pipeline, batch_size=batch_size, group=group)

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
    # shutdown() waits for serve_forever to return, so never on the worker
    transcriber.on_fault = lambda e: threading.Thread(target=server.shutdown, daemon=True).start()
    return server, transcriber


def run_until_interrupted(server, transcriber: BatchingTranscriber) -> int:
    """Serve until SIGINT (KeyboardInterrupt) or a rank's fault, then stop
    the server and drain the transcriber (a second SIGINT is ignored
    meanwhile, so that the other ranks still get their stop). Returns 0,
    or 1 after a fault. Call it from the main thread."""
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        previous = signal.signal(signal.SIGINT, signal.SIG_IGN)
        try:
            server.shutdown()
            server.server_close()
            transcriber.shutdown()
        finally:
            signal.signal(signal.SIGINT, previous)
    return 0 if transcriber.fault is None else 1
