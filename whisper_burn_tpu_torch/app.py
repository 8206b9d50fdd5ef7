"""Interactive push-to-talk transcription app (terminal front end).

Port of ``whisper_burn_tpu/app.py``: a screen state machine, a background
model load, a dedicated inference worker thread and the
record -> transcribe loop, in a terminal. Screens and transitions:

    CheckModel → ChooseModel → ConfirmDownload → Downloading
              ↘ LoadingModel → Ready ↔ Recording → Transcribing → Ready
    plus ModelManager (list/delete installed GGUFs)

The state machine is a plain object driven by ``update()`` polls with all
side effects injected, so its transitions are testable without a device,
a microphone or the network.
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np


class AppScreen(enum.Enum):
    CHECK_MODEL = "check_model"
    CHOOSE_MODEL = "choose_model"
    CONFIRM_DOWNLOAD = "confirm_download"
    DOWNLOADING = "downloading"
    LOADING_MODEL = "loading_model"
    READY = "ready"
    RECORDING = "recording"
    TRANSCRIBING = "transcribing"
    MODEL_MANAGER = "model_manager"
    ERROR = "error"


@dataclass
class InferenceRequest:
    """A request to the inference worker thread."""

    audio: np.ndarray
    sample_rate: int
    language: str | None = None


@dataclass
class InferenceResponse:
    """Either ``text`` and its timing, or an error string."""

    text: str | None = None
    inference_ms: float = 0.0
    error: str | None = None


class InferenceWorker:
    """Dedicated transcription thread.

    Owns the transcribe function; requests and responses flow over
    queues, one request at a time, as the push-to-talk flow needs.
    """

    def __init__(self, transcribe_fn: Callable[[InferenceRequest], tuple[str, float]]):
        self._fn = transcribe_fn
        self.requests: queue.Queue[InferenceRequest | None] = queue.Queue()
        self.responses: queue.Queue[InferenceResponse] = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            req = self.requests.get()
            if req is None:
                return
            try:
                text, ms = self._fn(req)
                self.responses.put(InferenceResponse(text=text, inference_ms=ms))
            except Exception as e:  # stringified over the queue
                self.responses.put(InferenceResponse(error=str(e)))

    def submit(self, req: InferenceRequest) -> None:
        self.requests.put(req)

    def shutdown(self) -> None:
        self.requests.put(None)
        self._thread.join(timeout=5)


@dataclass
class AppState:
    screen: AppScreen = AppScreen.CHECK_MODEL
    status: str = ""
    last_text: str | None = None
    last_ms: float = 0.0
    error: str | None = None
    download_progress: tuple[int, int] | None = None  # (received, total)


class PushToTalkApp:
    """The app's state machine, side effects injected.

    ``model_present``   () -> bool
    ``load_model``      () -> transcribe_fn          — runs on a thread
    ``download_model``  (progress_cb) -> None        — runs on a thread
    ``capture``         AudioCapture-like
    """

    def __init__(
        self,
        *,
        model_present: Callable[[], bool],
        load_model: Callable[[], Callable[[InferenceRequest], tuple[str, float]]],
        download_model: Callable[[Callable[[int, int], None]], None] | None = None,
        capture=None,
        language: str | None = None,
    ) -> None:
        self.state = AppState()
        self._model_present = model_present
        self._load_model = load_model
        self._download_model = download_model
        self._capture = capture
        self._language = language
        self._worker: InferenceWorker | None = None
        self._load_result: queue.Queue = queue.Queue()
        self._download_done: queue.Queue = queue.Queue()
        self._recorded: list[np.ndarray] = []

    # -- polling update (once per frame) --------------------------------

    def update(self) -> AppState:
        s = self.state
        if s.screen is AppScreen.CHECK_MODEL:
            if self._model_present():
                self._start_model_load()
            else:
                s.screen = AppScreen.CHOOSE_MODEL
        elif s.screen is AppScreen.LOADING_MODEL:
            self._poll_load()
        elif s.screen is AppScreen.DOWNLOADING:
            self._poll_download()
        elif s.screen is AppScreen.RECORDING:
            if self._capture is not None:
                self._recorded.append(self._capture.take_samples())
        elif s.screen is AppScreen.TRANSCRIBING:
            self._poll_inference()
        return s

    # -- transitions ------------------------------------------------------

    def _start_model_load(self) -> None:
        self.state.screen = AppScreen.LOADING_MODEL
        self.state.status = "loading model"

        def run():
            try:
                self._load_result.put(("ok", self._load_model()))
            except Exception as e:
                self._load_result.put(("err", str(e)))

        threading.Thread(target=run, daemon=True).start()

    def _poll_load(self) -> None:
        try:
            kind, payload = self._load_result.get_nowait()
        except queue.Empty:
            return
        if kind == "err":  # load-thread crash -> error screen
            self.state.screen = AppScreen.ERROR
            self.state.error = payload
            return
        self._worker = InferenceWorker(payload)
        self.state.screen = AppScreen.READY
        self.state.status = "ready"

    def confirm_download(self) -> None:
        if self._download_model is None:
            raise RuntimeError("no downloader configured")
        self.state.screen = AppScreen.DOWNLOADING

        def progress(received: int, total: int) -> None:
            self.state.download_progress = (received, total)

        def run():
            try:
                self._download_model(progress)
                self._download_done.put(("ok", None))
            except Exception as e:
                self._download_done.put(("err", str(e)))

        threading.Thread(target=run, daemon=True).start()

    def _poll_download(self) -> None:
        try:
            kind, payload = self._download_done.get_nowait()
        except queue.Empty:
            return
        if kind == "err":  # back to the confirm screen
            self.state.screen = AppScreen.CONFIRM_DOWNLOAD
            self.state.error = payload
        else:
            self._start_model_load()

    def start_recording(self) -> None:
        if self.state.screen is not AppScreen.READY:
            raise RuntimeError(f"cannot record from {self.state.screen}")
        self._recorded = []
        if self._capture is not None:
            self._capture.start()
        self.state.screen = AppScreen.RECORDING
        self.state.status = "recording"

    def stop_recording(self) -> None:
        """Push-to-talk release: capture -> inference request."""
        if self.state.screen is not AppScreen.RECORDING:
            return
        rate = 16_000
        if self._capture is not None:
            self._recorded.append(self._capture.stop())
            rate = self._capture.sample_rate
        audio = (
            np.concatenate(self._recorded)
            if self._recorded
            else np.zeros(0, np.float32)
        )
        assert self._worker is not None
        self._worker.submit(InferenceRequest(audio, rate, self._language))
        self.state.screen = AppScreen.TRANSCRIBING
        self.state.status = "transcribing"

    def _poll_inference(self) -> None:
        assert self._worker is not None
        try:
            resp = self._worker.responses.get_nowait()
        except queue.Empty:
            return
        if resp.error is not None:
            self.state.error = resp.error
        else:
            self.state.last_text = resp.text
            self.state.last_ms = resp.inference_ms
        self.state.screen = AppScreen.READY
        self.state.status = "ready"

    def open_model_manager(self) -> None:
        self.state.screen = AppScreen.MODEL_MANAGER

    def close(self) -> None:
        if self._worker is not None:
            self._worker.shutdown()


def run_terminal(args) -> int:  # pragma: no cover — interactive front end
    """Terminal push-to-talk loop: Enter toggles recording, q quits.

    A portable terminal sees only its own stdin, so the push-to-talk
    trigger is the Enter key. Runs on ``--device`` (``cuda`` unless given).
    """
    from whisper_burn_tpu_torch.app_config import load_config
    from whisper_burn_tpu_torch.audio.capture import AudioCapture
    from whisper_burn_tpu_torch.download import list_installed_models

    cfg = load_config()
    model = args.model or cfg.model
    tokenizer = args.tokenizer or cfg.tokenizer
    language = args.language or (None if cfg.language == "auto" else cfg.language)

    def model_present() -> bool:
        return model is not None and Path(model).exists()

    def load_model():
        from whisper_burn_tpu_torch.cli import build_pipeline

        pipe = build_pipeline(model, tokenizer, args)

        def transcribe(req: InferenceRequest) -> tuple[str, float]:
            t0 = time.perf_counter()
            from whisper_burn_tpu_torch.audio.io import AudioBuffer

            result = pipe.transcribe(
                AudioBuffer(req.audio, req.sample_rate), language=req.language
            )
            return result.text, (time.perf_counter() - t0) * 1e3

        return transcribe

    if not model_present():
        installed = list_installed_models(cfg.models_dir)
        print(f"model not found: {model!r}")
        if installed:
            print("installed models:")
            for p, size in installed:
                print(f"  {p}  ({size / 1e6:.0f} MB)")
        print("download one with: python -m whisper_burn_tpu_torch.cli download large-v3")
        return 1

    app = PushToTalkApp(
        model_present=model_present,
        load_model=load_model,
        capture=AudioCapture(),
        language=language,
    )
    print("loading model ...")
    try:
        while True:
            state = app.update()
            if state.screen is AppScreen.ERROR:
                print(f"error: {state.error}")
                return 1
            if state.screen is AppScreen.READY:
                if state.last_text is not None:
                    print(f"[{state.last_ms:.0f} ms] {state.last_text}")
                    state.last_text = None
                cmd = input("press Enter to record (q to quit) > ").strip()
                if cmd == "q":
                    return 0
                app.start_recording()
                input("recording... press Enter to stop > ")
                app.stop_recording()
            else:
                time.sleep(0.05)
    finally:
        app.close()
