"""The PyTorch port's ``WhisperPipeline`` and its helpers against the JAX
package's, on the CPU in f32, at the small config of
tests/test_torch_slice.py (the smallest whose 64-wide heads the port's
kernels take): the same tokens and language tokens from a bucketed batch,
with a fixed language and auto-detected, in ``Compute.parity()`` and in
the int4 self-KV mode; the same windows and tokens from long audio; the
same stitched text, tokenizer text, resampled audio and WAV samples."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import whisper_burn_tpu.transcribe as jtr
from whisper_burn_tpu.audio.io import AudioBuffer as JAudioBuffer
from whisper_burn_tpu.audio.io import load_wav as j_load_wav
from whisper_burn_tpu.audio.io import save_wav as j_save_wav
from whisper_burn_tpu.audio.resample import resample_to_16k as j_resample_to_16k
from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.tokenizer import WhisperTokenizer as JTokenizer

from whisper_burn_tpu_torch.audio.io import AudioBuffer, load_wav, save_wav
from whisper_burn_tpu_torch.audio.resample import resample_to_16k
from whisper_burn_tpu_torch.languages import lang_token_id
from whisper_burn_tpu_torch.models.config import EOT, WhisperConfig
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.tokenizer import WhisperTokenizer
from whisper_burn_tpu_torch.transcribe import WhisperPipeline, stitch_texts

SMALL = dict(
    n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4,
    n_audio_ctx=128, n_text_ctx=64,
)
JCFG = JConfig.tiny_test().replace(**SMALL)
CFG = WhisperConfig.tiny_test().replace(**SMALL)
MODES = {  # name: (JAX compute, port compute), both in f32
    # float caches: the JAX package's XLA path computes its flash path's function
    "parity": (JCompute.parity().replace(backend=KernelBackend.XLA), Compute.parity()),
    # a quantized self cache: the JAX flash path (the raw current token
    # merged), Pallas in interpret mode
    "int4self": (
        JCompute.fastest(kv_bits=4).replace(
            self_kv_bits=4, dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS,
        ),
        Compute.fastest(kv_bits=4).replace(self_kv_bits=4, dtype=torch.float32),
    ),
}
MAX_TOKENS = 8
CHUNK = CFG.n_audio_ctx * 2 * 160  # one window: 40,960 samples


def _utterances():
    """Three utterances of 1, 2 and 3 s (the last cut to one window)."""
    rng = np.random.default_rng(5)
    out = []
    for i, seconds in enumerate((1.0, 2.0, 3.0)):
        t = np.arange(int(seconds * 16000)) / 16000
        tone = 0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t)
        out.append((tone + 0.05 * rng.standard_normal(t.shape)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def pipelines():
    """Both sides' pipelines by mode, from the same numpy weights; the JAX
    side's persistent compilation cache stays off."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "enable_compilation_cache", lambda path=None: None)
        out = {}
        for name, (jc, tc) in MODES.items():
            jp = jtr.WhisperPipeline((JCFG, j_random_params(JCFG, seed=0)), compute=jc, max_tokens=MAX_TOKENS)
            tp = WhisperPipeline(
                (CFG, random_params(CFG, seed=0, device="cpu")), compute=tc, max_tokens=MAX_TOKENS, device="cpu"
            )
            out[name] = (jp, tp)
        yield out


@pytest.mark.parametrize("language", ["auto", "de"])
@pytest.mark.parametrize("mode", list(MODES))
def test_transcribe_batch_matches_jax(pipelines, mode, language):
    """Three utterances bucketed to four (silence, language 50259): the same
    tokens and language tokens as the JAX pipeline."""
    jp, tp = pipelines[mode]
    audios = _utterances()
    ref = jp.transcribe_batch(audios, [language] * 3)
    _build.reset_launches()
    out = tp.transcribe_batch(audios, [language] * 3)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    assert len(out) == len(ref) == 3
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, np.asarray(r.tokens))
        assert o.lang_token == r.lang_token
        assert o.text == "" and o.inference_ms > 0
    if language != "auto":
        assert all(o.lang_token == lang_token_id(language) for o in out)


def test_transcribe_long_matches_jax(pipelines):
    """2.5 windows of audio with the default overlap (capped at half a
    window): the same windows, the same tokens and language token."""
    jp, tp = pipelines["int4self"]
    rng = np.random.default_rng(6)
    audio = (0.2 * rng.standard_normal(int(2.5 * CHUNK))).astype(np.float32)
    seen = {}

    def capture(side, pipe):
        batch = pipe.transcribe_batch

        def run(audios, languages):
            seen[side] = [np.asarray(a) for a in audios]
            return batch(audios, languages)

        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jp, "transcribe_batch", capture("jax", jp))
        mp.setattr(tp, "transcribe_batch", capture("torch", tp))
        ref = jp.transcribe_long(audio, language="en")
        out = tp.transcribe_long(audio, language="en")
    assert len(seen["torch"]) == len(seen["jax"]) == 4  # starts 0, 0.5, 1, 1.5 windows
    for a, r in zip(seen["torch"], seen["jax"]):
        np.testing.assert_array_equal(a, r)
    np.testing.assert_array_equal(out.tokens, np.asarray(ref.tokens))
    assert out.lang_token == ref.lang_token == 50259


@pytest.mark.parametrize("texts", [
    ["hello world this is", "this is a test"],
    ["a b c", "d e f"],
    ["the quick bro", "quick brown fox jumps over"],
    ["Hello, World.", "world. Again and again"],
    ["", "x y", "x y z", ""],
    ["one two three four", "three four five", "five six"],
    ["solo"],
], ids=["overlap", "disjoint", "split-word", "case-punct", "empties", "chain", "single"])
def test_stitch_texts_matches_jax(texts):
    assert stitch_texts(texts) == jtr.stitch_texts(texts)


@pytest.fixture(scope="module")
def tokenizer_file(tmp_path_factory):
    """The minimal byte-level BPE tokenizer of tests/test_pipeline.py."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(["hello world this is a tiny whisper test corpus"] * 8, BpeTrainer(vocab_size=400, special_tokens=[]))
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    tok.save(str(path))
    return path


def test_transcribe_batch_beam_matches_jax(tokenizer_file):
    """``beam_width=5`` in ``Compute.parity()``, both sides with the same
    tokenizer: three utterances bucketed to four, one language fixed, one
    detected, one another: the same tokens, language tokens and text as
    the JAX pipeline's beam search (the port's beam loop through its
    runner on the CPU)."""
    jc, tc = MODES["parity"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "enable_compilation_cache", lambda path=None: None)
        jp = jtr.WhisperPipeline((JCFG, j_random_params(JCFG, seed=0)), JTokenizer.from_file(tokenizer_file),
                                 compute=jc, max_tokens=MAX_TOKENS, beam_width=5)
        languages = ["en", "auto", "de"]
        ref = jp.transcribe_batch(_utterances(), languages)
    tp = WhisperPipeline((CFG, random_params(CFG, seed=0, device="cpu")), WhisperTokenizer.from_file(tokenizer_file),
                         compute=tc, max_tokens=MAX_TOKENS, beam_width=5, device="cpu")
    _build.reset_launches()
    out = tp.transcribe_batch(_utterances(), languages)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    assert len(out) == len(ref) == 3
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, np.asarray(r.tokens))
        assert o.lang_token == r.lang_token
        assert o.text == r.text
    assert out[0].lang_token == lang_token_id("en") and out[2].lang_token == lang_token_id("de")


def test_tokenizer_matches_jax(tokenizer_file):
    ours, ref = WhisperTokenizer.from_file(tokenizer_file), JTokenizer.from_file(tokenizer_file)
    ids = ref.encode("hello world this is a tiny test") + [EOT, 50259, 50360]
    assert ours.decode_transcription(ids) == ref.decode_transcription(ids) == "hello world this is a tiny test"
    assert ours.encode("tiny whisper") == ref.encode("tiny whisper")
    assert ours.vocab_size == ref.vocab_size
    assert ours.lang_token("de") == ref.lang_token("de") == 50261


@pytest.mark.parametrize("rate", [8000, 22050, 44100, 16000])
def test_resample_to_16k_matches_jax(rate, monkeypatch):
    """The scipy paths of both packages: each one's C++ resampler, which
    designs its filter apart, is turned off here (the port's with
    ``WHISPER_TPU_NATIVE=0``; tests/test_torch_native_host.py holds the two
    C++ paths to each other)."""
    import whisper_burn_tpu.native_host as native_host

    monkeypatch.setattr(native_host, "resample_poly", lambda samples, up, down: None)
    monkeypatch.setenv("WHISPER_TPU_NATIVE", "0")
    samples = np.random.default_rng(rate).standard_normal(rate // 2).astype(np.float32) * 0.3
    out = resample_to_16k(AudioBuffer(samples, rate))
    ref = j_resample_to_16k(JAudioBuffer(samples, rate))
    assert out.sample_rate == ref.sample_rate == 16000
    np.testing.assert_array_equal(out.samples, ref.samples)


def test_wav_roundtrip_matches_jax(tmp_path):
    """16-bit PCM written by either side reads back the same on both."""
    samples = np.random.default_rng(2).uniform(-1.2, 1.2, 3000).astype(np.float32)
    save_wav(tmp_path / "ours.wav", AudioBuffer(samples, 16000))
    j_save_wav(tmp_path / "ref.wav", JAudioBuffer(samples, 16000))
    assert (tmp_path / "ours.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()
    ours, ref = load_wav(tmp_path / "ours.wav"), j_load_wav(tmp_path / "ours.wav")
    assert ours.sample_rate == ref.sample_rate == 16000
    np.testing.assert_allclose(ours.samples, ref.samples, atol=1e-6, rtol=0)


def test_pipeline_runs_on_cuda_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        WhisperPipeline((CFG, random_params(CFG, seed=0, device="cpu")))


def test_pipeline_mesh_waits_for_item_15():
    """A mesh is served since scale-out was ported; one that is not this
    rank's ``parallel.mesh.Mesh`` (here a layout without a process group)
    is refused."""
    from whisper_burn_tpu_torch.parallel import make_mesh

    for mesh in (object(), make_mesh(2, 1, world=2)):
        with pytest.raises(ValueError, match="this rank's parallel.mesh.Mesh"):
            WhisperPipeline((CFG, {}), mesh=mesh, device="cpu")


def test_profile_report_counts_stages():
    """profile=True times the stages and the throughput of each batch."""
    tp = WhisperPipeline(
        (CFG, random_params(CFG, seed=0, device="cpu")), compute=Compute.parity(), max_tokens=4,
        profile=True, device="cpu",
    )
    tp.transcribe(_utterances()[0], language="en")
    report = tp.profile_report()
    for stage in ("audio_prep", "device_step", "detokenize", "audio-s/s"):
        assert stage in report
    assert tp.throughput.audio_seconds == CHUNK / 16000
