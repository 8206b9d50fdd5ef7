"""The port's user surfaces that need no model, against the JAX package's,
on the CPU: the English normalizer, ``normalize_text``, ``word_errors``
and ``wer`` (tests/test_normalizer.py's tricky phrases and generated
number phrases and sentences); the manifest runner and its resume; the
downloader on ``file://`` URIs; the saved CLI config; and the push-to-talk
app's state machine, worker and capture (tests/test_app.py on the port's
modules, with ``FakeCaptureBackend``)."""

import json
import time

import numpy as np
import pytest

from whisper_burn_tpu.eval import english_normalizer as jnorm
from whisper_burn_tpu.eval import normalize_text as j_normalize_text
from whisper_burn_tpu.eval import wer as j_wer
from whisper_burn_tpu.eval import word_errors as j_word_errors
from whisper_burn_tpu.eval.runner import evaluate_manifest as j_evaluate_manifest

from whisper_burn_tpu_torch import app_config, download
from whisper_burn_tpu_torch.app import AppScreen, InferenceRequest, InferenceWorker, PushToTalkApp
from whisper_burn_tpu_torch.audio.capture import (
    AudioCapture,
    CaptureBackendUnavailable,
    FakeCaptureBackend,
    SounddeviceBackend,
)
from whisper_burn_tpu_torch.audio.io import AudioBuffer, save_wav
from whisper_burn_tpu_torch.eval import english_normalizer as norm
from whisper_burn_tpu_torch.eval import normalize_text, wer, word_errors
from whisper_burn_tpu_torch.eval.runner import EvalSummary, evaluate_manifest, read_manifest
from tests.test_normalizer import TRICKY

# --------------------------------------------------------------------------
# normalizer and WER


@pytest.mark.parametrize("text", TRICKY)
def test_english_normalizer_matches_jax(text):
    ours = norm.EnglishTextNormalizer(norm.DEFAULT_SPELLING_MAPPING)
    ref = jnorm.EnglishTextNormalizer(jnorm.DEFAULT_SPELLING_MAPPING)
    assert ours(text) == ref(text)
    assert norm.EnglishTextNormalizer()(text) == jnorm.EnglishTextNormalizer()(text)
    for basic in (False, True):
        assert normalize_text(text, basic=basic) == j_normalize_text(text, basic=basic)


def _phrases(vocab: list, n: int, most: int, seed: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(vocab, size=int(rng.integers(1, most)))) for _ in range(n)]


def test_number_normalizer_matches_jax_on_generated_phrases():
    ones = ["one", "two", "three", "four", "five", "six", "seven", "eight", "nine", "ten", "eleven", "twelve",
            "thirteen", "nineteen"]
    vocab = ones + ["twenty", "thirty", "forty", "fifty", "ninety", "hundred", "thousand", "million", "billion",
                    "and", "point", "oh", "dollars", "cents", "percent", "minus", "cat", "the", "7", "3.5"]
    ours, ref = norm.EnglishNumberNormalizer(), jnorm.EnglishNumberNormalizer()
    for phrase in _phrases(vocab, 400, 9, 0):
        assert ours(phrase) == ref(phrase), phrase


def test_wer_matches_jax_on_generated_sentences():
    """Pairs of generated sentences: the JAX word errors and corpus WER, in
    English, with the language unknown and in German (basic rules)."""
    words = ["the", "quick", "colour", "won't", "it's", "twenty", "one", "hundred", "and", "dollars", "Mr.",
             "first", "7", "point", "five", "uh", "[noise]", "(ok)", "don't", "we'll", "half", "a"]
    refs, hyps = _phrases(words, 150, 12, 1), _phrases(words, 150, 12, 2)
    for language in ("en", None, "auto", "de"):
        for r, h in zip(refs, hyps):
            assert word_errors(r, h, language=language) == j_word_errors(r, h, language=language)
        assert wer(refs, hyps, language=language) == j_wer(refs, hyps, language=language)
    assert wer("Mr. Brown owes one hundred and fifty dollars", "mister brown owes $150") == 0.0
    assert word_errors("", "x y") == (2, 0)


# --------------------------------------------------------------------------
# the manifest runner


class _FakeResult:
    def __init__(self, text):
        self.text = text
        self.inference_ms = 10.0
        self.tokens = np.array([1, 2])
        self.lang_token = 50259


class _FakePipeline:
    def __init__(self):
        self.calls = 0
        self.seen = []

    def transcribe_batch(self, audios, languages):
        self.calls += 1
        self.seen.append(list(languages))
        return [_FakeResult("hello world" if len(a.samples) % 2 else "hello word") for a in audios]


def _manifest(tmp_path, n=5) -> str:
    manifest = tmp_path / "manifest.jsonl"
    with manifest.open("w") as f:
        for i in range(n):
            p = tmp_path / f"{i}.wav"
            save_wav(p, AudioBuffer(np.zeros(1600 + i, np.float32), 16000))
            f.write(json.dumps({"id": i, "audio": str(p), "text": "hello world"}) + "\n")
        f.write("\n")  # blank lines are skipped
    return str(manifest)


def test_evaluate_manifest_matches_jax_and_resumes(tmp_path):
    """Five utterances in batches of two: the JAX runner's summary (the
    per-file path: the fake pipeline has no chunk size); a re-run
    transcribes nothing; a cut results file resumes from the ids left."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    jm, tm = _manifest(tmp_path / "jax"), _manifest(tmp_path / "torch")
    jp, tp = _FakePipeline(), _FakePipeline()
    ref = j_evaluate_manifest(jp, jm, batch_size=2)
    summary = evaluate_manifest(tp, tm, batch_size=2)
    assert isinstance(summary, EvalSummary)
    assert (summary.n_utterances, summary.wer, summary.audio_seconds, summary.inference_seconds) == (
        ref.n_utterances, ref.wer, ref.audio_seconds, ref.inference_seconds)
    assert summary.n_utterances == 5 and summary.wer == pytest.approx(0.3) and summary.rtf > 0
    assert tp.calls == jp.calls == 3 and tp.seen[0] == ["en", "en"]
    results = tm + ".results.jsonl"
    assert [r["id"] for r in read_manifest(results)] == [str(i) for i in range(5)]

    again = _FakePipeline()
    assert evaluate_manifest(again, tm, batch_size=2).n_utterances == 5 and again.calls == 0

    lines = open(results).read().splitlines()
    open(results, "w").write("\n".join(lines[:2]) + "\n")  # a run killed after its first batch
    resumed = _FakePipeline()
    out = evaluate_manifest(resumed, tm, batch_size=2, language="auto")
    assert resumed.calls == 2 and resumed.seen[0] == ["auto", "auto"]
    assert out.n_utterances == 5 and out.audio_seconds == pytest.approx(ref.audio_seconds)
    fresh = _FakePipeline()
    assert evaluate_manifest(fresh, tm, batch_size=4, resume=False).n_utterances == 5 and fresh.calls == 2


# --------------------------------------------------------------------------
# download


def test_download_file_atomic_and_skip(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(b"x" * 200_000)
    dest = tmp_path / "models" / "m.gguf"
    seen = []
    out = download.download_file(src.as_uri(), dest, progress=lambda r, t: seen.append((r, t)))
    assert out.read_bytes() == b"x" * 200_000
    assert [r for r, _ in seen] == [65536, 131072, 196608, 200000]  # 64 KiB chunks
    assert not dest.with_suffix(".gguf.tmp").exists()
    src.write_bytes(b"y" * 5)  # an existing file is not fetched again
    download.download_file(src.as_uri(), dest)
    assert out.read_bytes() == b"x" * 200_000

    (tmp_path / "models" / "notes.txt").write_text("not a model")
    assert download.list_installed_models(tmp_path / "models") == [(dest, 200_000)]
    assert download.list_installed_models(tmp_path / "absent") == []
    download.delete_model(dest)
    assert download.list_installed_models(tmp_path / "models") == []


def test_download_model_variants(tmp_path, monkeypatch):
    """A variant's tokenizer and GGUF land under the models dir (its URLs
    pointed at local files); an unknown variant raises."""
    (tmp_path / "gguf").write_bytes(b"g" * 100)
    (tmp_path / "tok").write_text("{}")
    v = download.VARIANTS["large-v3-turbo"]
    monkeypatch.setitem(download.VARIANTS, "large-v3-turbo", download.ModelVariant(
        v.name, v.gguf_filename, (tmp_path / "gguf").as_uri(), (tmp_path / "tok").as_uri(), v.approx_bytes))
    gguf, tok = download.download_model("large-v3-turbo", tmp_path / "models")
    assert gguf == tmp_path / "models" / "whisper-large-v3-turbo-q4.gguf" and gguf.read_bytes() == b"g" * 100
    assert tok == tmp_path / "models" / "tokenizer-large-v3-turbo.json"
    assert sorted(download.VARIANTS) == ["large-v3", "large-v3-turbo", "medium"]
    with pytest.raises(KeyError):
        download.download_model("tiny", tmp_path / "models")


# --------------------------------------------------------------------------
# the saved config


def test_app_config_roundtrip(tmp_path, monkeypatch):
    from whisper_burn_tpu.app_config import AppConfig as JAppConfig
    from whisper_burn_tpu.app_config import config_path as j_config_path

    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    assert app_config.config_path() == tmp_path / "xdg" / "whisper_burn_tpu_torch" / "config.json"
    assert app_config.config_path() != j_config_path()  # neither package overwrites the other's
    ours, theirs = app_config.AppConfig().__dict__, JAppConfig().__dict__
    assert ours == {k: theirs[k] for k in ours}  # the JAX defaults of the keys a command reads
    assert app_config.load_config() == app_config.AppConfig()  # missing -> defaults
    cfg = app_config.AppConfig(model="m.gguf", language="fr", models_dir="mm")
    p = app_config.save_config(cfg)
    assert p == app_config.config_path() and not p.with_suffix(".json.tmp").exists()
    assert app_config.load_config() == cfg
    p.write_text("{not json")
    assert app_config.load_config(p) == app_config.AppConfig()
    p.write_text('{"language": "de", "bogus": 1}')
    assert app_config.load_config(p).language == "de"
    p.write_text(json.dumps(JAppConfig(model="j.gguf", beam_width=5, compute="fastest").__dict__))
    assert app_config.load_config(p) == app_config.AppConfig(model="j.gguf")  # the JAX file's format reads


# --------------------------------------------------------------------------
# the push-to-talk app


def _wait_for(app, screen, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        state = app.update()
        if state.screen is screen:
            return state
        time.sleep(0.005)
    raise AssertionError(f"never reached {screen}, stuck at {app.state.screen}")


def _fake_transcriber(req: InferenceRequest):
    return f"{len(req.audio)} samples @ {req.sample_rate} in {req.language}", 1.5


def test_full_record_transcribe_cycle():
    samples = np.linspace(-0.5, 0.5, 4000, dtype=np.float32)
    capture = AudioCapture(FakeCaptureBackend(samples, sample_rate=16_000))
    app = PushToTalkApp(model_present=lambda: True, load_model=lambda: _fake_transcriber, capture=capture,
                        language="de")
    assert app.state.screen is AppScreen.CHECK_MODEL
    app.update()
    assert app.state.screen is AppScreen.LOADING_MODEL
    _wait_for(app, AppScreen.READY)
    app.stop_recording()  # not recording: nothing happens
    assert app.state.screen is AppScreen.READY
    app.start_recording()
    assert app.state.screen is AppScreen.RECORDING
    with pytest.raises(RuntimeError, match="cannot record"):
        app.start_recording()
    app.update()  # drains the capture buffer mid-recording
    app.stop_recording()
    assert app.state.screen is AppScreen.TRANSCRIBING
    state = _wait_for(app, AppScreen.READY)
    assert state.last_text == "4000 samples @ 16000 in de" and state.last_ms == 1.5
    app.open_model_manager()
    assert app.state.screen is AppScreen.MODEL_MANAGER
    app.close()


def test_missing_model_goes_to_chooser_and_download_flow():
    calls = []

    def fetch(progress):
        progress(50, 100)
        calls.append("downloaded")

    app = PushToTalkApp(model_present=lambda: len(calls) > 0, load_model=lambda: _fake_transcriber,
                        download_model=fetch)
    app.update()
    assert app.state.screen is AppScreen.CHOOSE_MODEL
    app.confirm_download()
    assert app.state.screen is AppScreen.DOWNLOADING
    _wait_for(app, AppScreen.READY)
    assert calls == ["downloaded"] and app.state.download_progress == (50, 100)
    app.close()
    with pytest.raises(RuntimeError, match="no downloader"):
        PushToTalkApp(model_present=lambda: False, load_model=lambda: _fake_transcriber).confirm_download()


def test_download_failure_returns_to_confirm_screen():
    def fetch(progress):
        raise OSError("network down")

    app = PushToTalkApp(model_present=lambda: False, load_model=lambda: _fake_transcriber, download_model=fetch)
    app.update()
    app.confirm_download()
    state = _wait_for(app, AppScreen.CONFIRM_DOWNLOAD)
    assert "network down" in state.error


def test_load_failure_shows_error_screen():
    def bad_load():
        raise ValueError("corrupt gguf")

    app = PushToTalkApp(model_present=lambda: True, load_model=bad_load)
    app.update()
    state = _wait_for(app, AppScreen.ERROR)
    assert "corrupt gguf" in state.error


def test_inference_error_is_stringified_and_recovers():
    def boom(req):
        if req.language == "boom":
            raise RuntimeError("device lost")
        return "ok", 2.0

    worker = InferenceWorker(boom)
    worker.submit(InferenceRequest(np.zeros(10, np.float32), 16_000, "boom"))
    assert worker.responses.get(timeout=5).error == "device lost"
    worker.submit(InferenceRequest(np.zeros(10, np.float32), 16_000))
    resp = worker.responses.get(timeout=5)
    assert (resp.text, resp.inference_ms, resp.error) == ("ok", 2.0, None)
    worker.shutdown()


def test_capture_downmix_and_drain():
    stereo = np.stack([np.ones(100, np.float32), np.zeros(100, np.float32)], axis=1)

    class StereoBackend(FakeCaptureBackend):
        def start(self, callback):
            callback(stereo)

    cap = AudioCapture(StereoBackend(np.zeros(0), sample_rate=48_000))
    cap.start()
    assert cap.recording
    got = cap.stop()
    np.testing.assert_allclose(got, np.full(100, 0.5))  # channel mean
    assert cap.take_samples().size == 0 and not cap.recording
    assert cap.sample_rate == 48_000

    chunked = AudioCapture(FakeCaptureBackend(np.arange(2500, dtype=np.float32), chunk=1024))
    chunked.start()
    np.testing.assert_array_equal(chunked.take_samples(), np.arange(2500, dtype=np.float32))


def test_sounddevice_backend_unavailable_without_the_package():
    try:
        import sounddevice  # noqa: F401
    except ImportError:
        with pytest.raises(CaptureBackendUnavailable, match="sounddevice"):
            SounddeviceBackend()
        with pytest.raises(CaptureBackendUnavailable):
            AudioCapture()
    else:
        pytest.skip("sounddevice is installed: the backend is available")
