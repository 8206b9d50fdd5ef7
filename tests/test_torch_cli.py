"""The port's command line (``python -m whisper_burn_tpu_torch.cli``) against
the JAX package's, on the CPU (``--device cpu``), on one GGUF that the
port's converter writes (D 256, 4 heads, 128 audio frames, 448 text
positions, one layer a side; Q4_0 matrices, F32 for the rest) and the
synthetic byte-level BPE tokenizer of tests/test_torch_pipeline.py:
``info`` prints the same lines; the converter writes the JAX converter's
bytes, from a state dict and from a local HF checkpoint; ``transcribe``
and ``eval`` give the JAX CLI's text, token counts and WER in f32 on 16 kHz
WAVs; ``parity`` records, passes, fails on a divergence, skips without
weights and records its offline intake chain; ``config`` saves under
``XDG_CONFIG_HOME``; ``serve`` maps its options to the JAX CLI's compute
and serves over HTTP until SIGINT, on one rank and on two (``--dp 2``,
rank 0 serving, rank 1 following); ``transcribe --tp 2`` under
``torch.distributed.run`` gives the JAX CLI's mesh text; meshes one rank
cannot hold raise; without a card and without ``--device cpu`` the
commands refuse. Every path is under a
temporary directory."""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import whisper_burn_tpu.cli as jcli
import whisper_burn_tpu.gguf.convert as jconvert
import whisper_burn_tpu.transcribe as jtr

from whisper_burn_tpu_torch import cli
from whisper_burn_tpu_torch.audio.io import AudioBuffer, save_wav
from whisper_burn_tpu_torch.gguf import convert
from tests.test_torch_gguf import _state

ROOT = pathlib.Path(__file__).resolve().parents[1]
MAX_TOKENS = "8"


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """Saved CLI defaults under the test's directory; the JAX pipelines'
    persistent compilation cache off."""
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path / "xdg"))
    monkeypatch.setattr(jtr, "enable_compilation_cache", lambda path=None: None)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The GGUF, the tokenizer and four 16 kHz WAVs (1 to 2.5 s of tones and
    noise) with a manifest of them."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from tokenizers.trainers import BpeTrainer

    d = tmp_path_factory.mktemp("cli")
    gguf = d / "model-q4.gguf"
    convert.convert_state_dict(_state(n_text_ctx=448), n_lang=99).write(gguf)
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(["hello world this is a tiny whisper test corpus"] * 8,
                            BpeTrainer(vocab_size=400, special_tokens=[]))
    tok.save(str(d / "tokenizer.json"))
    rng = np.random.default_rng(9)
    wavs = []
    for i, seconds in enumerate((1.0, 1.5, 2.0, 2.5)):
        t = np.arange(int(seconds * 16000)) / 16000
        audio = 0.3 * np.sin(2 * np.pi * (200 + 90 * i) * t) + 0.05 * rng.standard_normal(t.shape)
        wavs.append(d / f"u{i}.wav")
        save_wav(wavs[-1], AudioBuffer(audio.astype(np.float32), 16000))
    return {"gguf": str(gguf), "tokenizer": str(d / "tokenizer.json"), "wavs": [str(p) for p in wavs]}


def _run(main, argv, capsys) -> tuple[int, str, str]:
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# --------------------------------------------------------------------------
# info and convert


def test_info_matches_jax(files, capsys):
    rc, ours, _ = _run(cli.main, ["info", "--model", files["gguf"]], capsys)
    jrc, ref, _ = _run(jcli.main, ["info", "--model", files["gguf"]], capsys)
    assert rc == jrc == 0 and ours == ref
    assert "model: d=256 heads=4 enc_layers=1 dec_layers=1 mels=8 vocab=51865 n_lang=99" in ours


def test_convert_state_dict_bytes_equal_jax():
    state = _state(d=256, n_text_ctx=64, enc_layers=2, dec_layers=1)
    ours = convert.convert_state_dict(state, model_name="m", n_lang=100, extra_metadata=[("x.y", 3)])
    ref = jconvert.convert_state_dict(state, model_name="m", n_lang=100, extra_metadata=[("x.y", 3)])
    assert ours.to_bytes() == ref.to_bytes()
    for name, value in state.items():
        assert convert.hf_name_to_gguf(name) == jconvert.hf_name_to_gguf(name)
        gguf = convert.hf_name_to_gguf(name) or name
        assert convert.should_quantize(gguf, value.shape) == jconvert.should_quantize(gguf, value.shape)
    assert convert.hf_name_to_gguf("proj_out.weight") is None


def _hf_checkpoint(path: pathlib.Path) -> pathlib.Path:
    transformers = pytest.importorskip("transformers")
    cfg = transformers.WhisperConfig(
        vocab_size=51865, num_mel_bins=8, encoder_layers=1, encoder_attention_heads=2, decoder_layers=1,
        decoder_attention_heads=2, d_model=128, encoder_ffn_dim=512, decoder_ffn_dim=512,
        max_source_positions=16, max_target_positions=64,
    )
    torch.manual_seed(0)
    transformers.WhisperForConditionalGeneration(cfg).eval().save_pretrained(path)
    return path


def test_convert_hf_model_matches_jax(tmp_path, capsys):
    """A random-init HF checkpoint in a local directory: the ``convert``
    command writes the JAX converter's bytes."""
    hf = _hf_checkpoint(tmp_path / "hf")
    rc, out, _ = _run(cli.main, ["convert", "--hf-model", str(hf), "--output", str(tmp_path / "ours.gguf")], capsys)
    assert rc == 0 and out.strip() == f"wrote {tmp_path / 'ours.gguf'}"
    jconvert.convert_hf_model(str(hf), str(tmp_path / "ref.gguf"))
    assert (tmp_path / "ours.gguf").read_bytes() == (tmp_path / "ref.gguf").read_bytes()


# --------------------------------------------------------------------------
# transcribe and eval against the JAX CLI


def _json_lines(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("language", ["auto", "de"])
def test_transcribe_json_matches_jax(files, language, capsys, tmp_path):
    """Two WAVs, ``--json``: one line per file with the JAX CLI's file,
    text, token count and language token (f32, ``Compute.parity()``)."""
    argv = ["transcribe", *files["wavs"][:2], "--model", files["gguf"], "--tokenizer", files["tokenizer"],
            "--json", "--max-tokens", MAX_TOKENS, "--language", language]
    rc, ours, err = _run(cli.main, argv + ["--device", "cpu", "--trace", str(tmp_path / "tr")], capsys)
    jrc, ref, _ = _run(jcli.main, argv, capsys)
    assert rc == jrc == 0
    ours, ref = _json_lines(ours), _json_lines(ref)
    assert len(ours) == len(ref) == 2
    for o, r in zip(ours, ref):
        assert {k: o[k] for k in ("file", "text", "n_tokens", "lang_token")} == {
            k: r[k] for k in ("file", "text", "n_tokens", "lang_token")}
        assert o["n_tokens"] == int(MAX_TOKENS) and o["inference_ms"] > 0
    (trace,) = (tmp_path / "tr").glob("trace-*.json")
    assert f"written to {trace}" in err
    assert "greedy_decode.decode" in {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}


def test_transcribe_under_torchrun_matches_jax_mesh(files, capsys):
    """``transcribe --tp 2`` on two CPU ranks under ``torch.distributed.run``
    (rank 0 alone prints) against the JAX CLI's ``--tp 2`` mesh run."""
    argv = ["transcribe", *files["wavs"][:2], "--model", files["gguf"], "--tokenizer", files["tokenizer"],
            "--json", "--max-tokens", MAX_TOKENS, "--language", "en", "--tp", "2"]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                           "-m", "whisper_burn_tpu_torch.cli", *argv, "--device", "cpu"],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    jrc, ref, _ = _run(jcli.main, argv, capsys)
    ours, ref = _json_lines(proc.stdout), _json_lines(ref)
    assert jrc == 0 and len(ours) == len(ref) == 2  # one rank's lines
    for o, r in zip(ours, ref):
        assert {k: o[k] for k in ("file", "text", "n_tokens", "lang_token")} == {
            k: r[k] for k in ("file", "text", "n_tokens", "lang_token")}


def test_transcribe_plain_output_and_saved_defaults(files, capsys, tmp_path):
    """``config --set`` saves the model and tokenizer under
    ``XDG_CONFIG_HOME`` (the JAX package's file untouched) and refuses keys
    that no command reads; ``transcribe`` without ``--model`` takes them,
    and prints ``path: text [ms]``."""
    rc, out, _ = _run(cli.main, ["config", "--set", f"model={files['gguf']}", f"tokenizer={files['tokenizer']}"],
                      capsys)
    saved = tmp_path / "xdg" / "whisper_burn_tpu_torch" / "config.json"
    assert rc == 0 and out.startswith(f"saved {saved}") and json.loads(saved.read_text())["model"] == files["gguf"]
    assert not (tmp_path / "xdg" / "whisper_burn_tpu").exists()
    for key in ("bogus", "beam_width", "compute", "frontend"):
        assert _run(cli.main, ["config", "--set", f"{key}=1"], capsys)[0] == 2
    rc, out, _ = _run(cli.main, ["transcribe", files["wavs"][0], "--device", "cpu", "--max-tokens", "4"], capsys)
    assert rc == 0 and out.startswith(f"{files['wavs'][0]}: ") and out.rstrip().endswith("ms]")
    json.loads(_run(cli.main, ["config"], capsys)[1])  # shows the saved config


def test_transcribe_without_a_model_refuses(capsys):
    rc, out, _ = _run(cli.main, ["transcribe", "x.wav", "--device", "cpu"], capsys)
    assert rc == 2 and "no --model" in out


def test_eval_matches_jax(files, capsys, tmp_path):
    """A four-row manifest (one copy each, so neither run resumes from the
    other's results): the JAX CLI's n, WER and audio seconds, and the same
    text per id."""
    manifests = {}
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        manifests[side] = tmp_path / side / "m.jsonl"
        manifests[side].write_text("".join(
            json.dumps({"id": f"u{i}", "audio": p, "text": "hello world"}) + "\n" for i, p in enumerate(files["wavs"])))
    argv = ["eval", "--model", files["gguf"], "--tokenizer", files["tokenizer"], "--batch", "4"]
    rc, ours, _ = _run(cli.main, argv + ["--manifest", str(manifests["torch"]), "--device", "cpu"], capsys)
    jrc, ref, _ = _run(jcli.main, argv + ["--manifest", str(manifests["jax"])], capsys)
    assert rc == jrc == 0
    (ours,), (ref,) = _json_lines(ours), _json_lines(ref)
    assert {k: ours[k] for k in ("n", "wer", "audio_s")} == {k: ref[k] for k in ("n", "wer", "audio_s")}
    assert ours["n"] == 4 and ours["audio_s"] == 7.0
    texts = {side: {r["id"]: r["text"] for r in map(json.loads, open(f"{m}.results.jsonl"))}
             for side, m in manifests.items()}
    assert texts["torch"] == texts["jax"] and len(texts["torch"]) == 4


# --------------------------------------------------------------------------
# parity


def _parity(files, tmp_path, *extra) -> list[str]:
    return ["parity", "--model", files["gguf"], "--audio", files["wavs"][1], "--max-tokens", "6",
            "--expected", str(tmp_path / "expected.json"), "--status-out", str(tmp_path / "status.json"), *extra]


def test_parity_record_then_pass_then_divergence(files, capsys, tmp_path):
    """Record (the JAX CLI records the same tokens from the same GGUF), then
    PASS; a tampered baseline FAILs with exit 1. No baseline: NO-BASELINE."""
    rc, out, _ = _run(cli.main, _parity(files, tmp_path, "--record", "--device", "cpu"), capsys)
    expected = json.loads((tmp_path / "expected.json").read_text())
    assert rc == 0 and "recorded expected sequence" in out and len(expected["tokens"]) == 6
    (tmp_path / "jax").mkdir()
    jrc, _, _ = _run(jcli.main, _parity(files, tmp_path / "jax", "--record"), capsys)
    assert jrc == 0 and json.loads((tmp_path / "jax" / "expected.json").read_text()) == expected

    rc, out, _ = _run(cli.main, _parity(files, tmp_path, "--device", "cpu"), capsys)
    status = json.loads((tmp_path / "status.json").read_text())
    assert rc == 0 and "PASS" in out and (status["status"], status["tokens"]) == ("PASS", 6)

    expected["tokens"][2] += 1
    (tmp_path / "expected.json").write_text(json.dumps(expected))
    rc, out, _ = _run(cli.main, _parity(files, tmp_path, "--device", "cpu"), capsys)
    status = json.loads((tmp_path / "status.json").read_text())
    assert rc == 1 and "diverge at position 2" in out and status["status"] == "FAIL"

    (tmp_path / "expected.json").unlink()
    rc, out, _ = _run(cli.main, _parity(files, tmp_path, "--device", "cpu"), capsys)
    assert rc == 0 and json.loads((tmp_path / "status.json").read_text())["status"] == "NO-BASELINE"


def test_parity_skips_when_weights_missing(files, capsys, tmp_path):
    argv = _parity(files, tmp_path, "--device", "cpu")
    argv[argv.index("--model") + 1] = str(tmp_path / "nope.gguf")
    rc, out, _ = _run(cli.main, argv, capsys)
    status = json.loads((tmp_path / "status.json").read_text())
    assert rc == 0 and out.startswith("SKIP") and status["status"] == "SKIP"


def test_parity_offline_status_records_the_intake_chain(files, capsys, tmp_path, monkeypatch):
    """No --model, the download stubbed to fail and an empty HF cache: SKIP
    (exit 0) with every step tried in the status record."""
    from whisper_burn_tpu_torch import download

    def offline(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(download, "download_model", offline)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    argv = _parity(files, tmp_path, "--models-dir", str(tmp_path / "models"))
    del argv[1:3]  # no --model
    rc, out, _ = _run(cli.main, argv, capsys)
    status = json.loads((tmp_path / "status.json").read_text())
    assert rc == 0 and "download unavailable" in out
    assert status["status"] == "SKIP" and status["error_type"] == "OSError"
    assert [s["step"] for s in status["attempted"]] == ["download", "hf_cache_scan"]


def test_parity_converts_an_hf_cache_snapshot(files, capsys, tmp_path, monkeypatch):
    """Offline with a checkpoint in the HF hub cache: converted in-process,
    then recorded; the chain lists download, then the cache's conversion."""
    from whisper_burn_tpu_torch import download

    def offline(*a, **k):
        raise OSError("no network")

    monkeypatch.setattr(download, "download_model", offline)
    snap = tmp_path / "hf_home" / "hub" / "models--openai--whisper-large-v3-turbo" / "snapshots" / "abc"
    _hf_checkpoint(snap)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    argv = _parity(files, tmp_path, "--models-dir", str(tmp_path / "models"), "--variant", "large-v3-turbo",
                   "--device", "cpu", "--record")
    del argv[1:3]
    argv[argv.index("--max-tokens") + 1] = "4"
    rc, out, _ = _run(cli.main, argv, capsys)
    assert rc == 0 and "recorded" in out
    assert [p.name for p in (tmp_path / "models").glob("*.gguf")] == ["abc-q4.gguf"]


# --------------------------------------------------------------------------
# serve, the mesh options and the device


SERVE_OPTIONS = [[], ["--compute", "parity"], ["--compute", "fast"], ["--self-kv", "int4"],
                 ["--w8a8", "--int8-logits"], ["--compute", "fast", "--int8-logits", "--self-kv", "int4"]]


def _served_compute(module_cli, transcribe_mod, serving_mod, cache_mod, argv, monkeypatch):
    """The compute that ``serve`` builds its pipeline with (the model load,
    the pipeline and the server stubbed)."""
    seen = {}

    class Pipeline:
        def __init__(self, model, tokenizer, compute, **kw):
            seen["compute"], seen["kw"] = compute, kw

    class Stop(Exception):
        pass

    def serve_http(*a, **k):
        raise Stop

    monkeypatch.setattr(cache_mod, "load_whisper", lambda path: None)
    monkeypatch.setattr(transcribe_mod, "WhisperPipeline", Pipeline)
    monkeypatch.setattr(serving_mod, "serve_http", serve_http)
    with pytest.raises(Stop):
        module_cli.main(argv)
    return seen["compute"]


@pytest.mark.parametrize("options", SERVE_OPTIONS, ids=lambda o: " ".join(o) or "default")
def test_serve_compute_mapping_matches_jax(options, monkeypatch):
    import whisper_burn_tpu.gguf.cache as jcache
    import whisper_burn_tpu.serving as jserving

    import whisper_burn_tpu_torch.gguf.cache as cache
    import whisper_burn_tpu_torch.serving as serving
    import whisper_burn_tpu_torch.transcribe as transcribe

    argv = ["serve", "--model", "m.gguf", *options]
    ours = _served_compute(cli, transcribe, serving, cache, argv + ["--device", "cpu"], monkeypatch)
    ref = _served_compute(jcli, jtr, jserving, jcache, argv, monkeypatch)
    name = lambda dt: None if dt is None else str(np.dtype(dt)) if not isinstance(dt, torch.dtype) else str(dt)[6:]
    fields = ("kv_bits", "self_kv_bits", "self_kv_vbits", "quantized_logits", "w8a8")
    assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    for f in ("dtype", "kv_dtype", "self_kv_dtype"):
        assert name(getattr(ours, f)) == name(getattr(ref, f)), f


def _serve(files, tmp_path, ranks: int, *options) -> tuple[dict, list[str]]:
    """``python -m whisper_burn_tpu_torch.cli serve`` on port 0 in ``ranks``
    processes of its own (more than one: with torchrun's environment, set
    here, and the mesh ``options``): /healthz, one POST of a WAV, then
    SIGINT to every rank, as a terminal's Ctrl-C sends it; every rank must
    exit 0. Returns the reply and each rank's stderr."""
    tmp_path.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT), XDG_CONFIG_HOME=str(tmp_path / "xdg"))
    envs = [env]
    if ranks > 1:
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        envs = [dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)) for r in range(ranks)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "whisper_burn_tpu_torch.cli", "serve", "--model", files["gguf"], "--device", "cpu",
         "--port", "0", "--batch", "2", "--compute", "parity", *options],
        cwd=tmp_path, env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for e in envs]
    watchdog = threading.Timer(240, lambda: [p.kill() for p in procs])  # a server that never answers
    watchdog.start()
    try:
        line = procs[0].stdout.readline()
        assert line.startswith("serving on http://127.0.0.1:"), line + procs[0].stderr.read()
        base = line.split()[-1]
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as resp:
            assert json.loads(resp.read()) == {"status": "ok"}
        req = urllib.request.Request(f"{base}/v1/transcribe", data=pathlib.Path(files["wavs"][0]).read_bytes(),
                                     headers={"X-Language": "en"}, method="POST")
        with urllib.request.urlopen(req, timeout=300) as resp:
            body = json.loads(resp.read())
        assert resp.status == 200
        for p in procs:
            p.send_signal(signal.SIGINT)
        errs = [p.communicate(timeout=60)[1] for p in procs]
        assert [p.returncode for p in procs] == [0] * ranks, errs
    finally:
        watchdog.cancel()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
            p.stderr.close()
    return body, errs


@pytest.fixture(scope="module")
def one_rank_reply(files, tmp_path_factory):
    return _serve(files, tmp_path_factory.mktemp("serve"), 1)[0]


def test_serve_answers_over_http_until_sigint(one_rank_reply):
    """``python -m whisper_burn_tpu_torch.cli serve`` on port 0 in its own
    process: /healthz, one POST of a WAV, then SIGINT: exit 0."""
    assert one_rank_reply["lang_token"] == 50259 and one_rank_reply["text"] == ""


def test_serve_on_two_ranks_until_sigint(files, tmp_path, one_rank_reply):
    """``serve --dp 2`` on two CPU ranks with torchrun's environment: rank 0
    serves /healthz and the POST, rank 1 decodes its half of the batch; the
    reply equals the one-rank server's; SIGINT to both ranks ends each
    with exit 0 (rank 1 ignores it and leaves on rank 0's stop)."""
    body, errs = _serve(files, tmp_path, 2, "--dp", "2")
    assert {k: body[k] for k in ("text", "lang_token")} == {k: one_rank_reply[k] for k in ("text", "lang_token")}
    assert "rank 0 of 2: mesh 2x1 over gloo" in errs[0]
    assert "rank 1: followed 1 batches" in errs[1]


@pytest.mark.parametrize("command", ["transcribe", "serve"])
@pytest.mark.parametrize("mesh", [["--dp", "2"], ["--tp", "2"], ["--dp", "1", "--tp", "4"]])
def test_mesh_options_raise(files, command, mesh):
    """``transcribe`` and ``serve`` run a mesh, but one rank (no
    ``torch.distributed.run``) holds none of these, and the shape is
    refused before any process group starts."""
    argv = ["transcribe", files["wavs"][0]] if command == "transcribe" else ["serve"]
    with pytest.raises(ValueError, match="ranks"):
        cli.main(argv + ["--model", files["gguf"], "--device", "cpu", *mesh])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("argv", [["transcribe", "x.wav", "--model", "m.gguf"], ["serve", "--model", "m.gguf"],
                                  ["eval", "--model", "m.gguf", "--manifest", "m.jsonl"], ["app"]],
                         ids=["transcribe", "serve", "eval", "app"])
def test_commands_refuse_without_a_card(argv, capsys):
    """The default device is ``cuda``: without one the command exits 2 with
    resolve_device's message, before it loads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    rc, _, err = _run(cli.main, argv, capsys)
    assert rc == 2 and "no CUDA device is available" in err


def test_models_and_download_commands_match_jax(tmp_path, capsys, monkeypatch):
    import whisper_burn_tpu.download as jdownload

    from whisper_burn_tpu_torch import download

    (tmp_path / "g").write_bytes(b"g" * 3_000_000)
    (tmp_path / "t").write_text("{}")
    for mod in (download, jdownload):
        v = mod.VARIANTS["medium"]
        monkeypatch.setitem(mod.VARIANTS, "medium", mod.ModelVariant(
            v.name, v.gguf_filename, (tmp_path / "g").as_uri(), (tmp_path / "t").as_uri(), v.approx_bytes))
    models = str(tmp_path / "models")
    rc, out, _ = _run(cli.main, ["download", "medium", "--models-dir", models], capsys)
    assert rc == 0 and out.strip().splitlines()[-2:] == [f"{models}/whisper-medium-q4.gguf",
                                                         f"{models}/tokenizer-medium.json"]
    rc, ours, _ = _run(cli.main, ["models", "--models-dir", models], capsys)
    jrc, ref, _ = _run(jcli.main, ["models", "--models-dir", models], capsys)
    assert rc == jrc == 0 and ours == ref == f"{models}/whisper-medium-q4.gguf  3.0 MB\n"
