"""The port's GGUF layer (``whisper_burn_tpu_torch/gguf``) against the JAX
package's, on the CPU: the same metadata, index and tensors from the
reader on containers the JAX writer made; the same Q4_0 codes, scales and
repacked layout; the same bytes from the writer; the same config and
arrays from the loader, from a path and from bytes; a repacked cache that
either package reads; and a loaded model that decodes, and transcribes
through ``WhisperPipeline``, token for token as the JAX package does."""

import dataclasses
import json
import os
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import whisper_burn_tpu.native_host as native_host
import whisper_burn_tpu.transcribe as jtr
from whisper_burn_tpu.gguf import GgmlDtype as JDtype
from whisper_burn_tpu.gguf import GgufReader as JReader
from whisper_burn_tpu.gguf import GgufWriter as JWriter
from whisper_burn_tpu.gguf import quant as jquant
from whisper_burn_tpu.gguf import repack as jrepack
from whisper_burn_tpu.gguf.cache import load_repacked as j_load_repacked
from whisper_burn_tpu.gguf.cache import load_whisper as j_load_whisper
from whisper_burn_tpu.gguf.convert import convert_state_dict, hf_name_to_gguf, should_quantize
from whisper_burn_tpu.gguf.loader import infer_config as j_infer_config
from whisper_burn_tpu.gguf.loader import load_whisper_from_gguf as j_load
from whisper_burn_tpu.models.whisper import greedy_decode as j_greedy
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.tokenizer import WhisperTokenizer as JTokenizer

from whisper_burn_tpu_torch.gguf import GgmlDtype, GgufReader, GgufWriter, quant, repack
from whisper_burn_tpu_torch.gguf.cache import CACHE_VERSION, load_repacked, load_whisper, save_repacked
from whisper_burn_tpu_torch.gguf.loader import LoadedModel, infer_config, load_whisper_from_gguf
from whisper_burn_tpu_torch.models.params import _rand_linear, params_to_torch
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.tokenizer import WhisperTokenizer
from whisper_burn_tpu_torch.transcribe import WhisperPipeline, prepare_params


# --------------------------------------------------------------------------
# containers


def _raw_gguf(version: int, metadata: list, tensors: list, alignment: int = 32) -> bytes:
    """A GGUF container built field by field: ``metadata`` as (key, type
    code, value) with every GGUF value type, ``tensors`` as (name, shape,
    dtype code, data)."""

    def string(s):
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def value(t, v):
        fmt = {0: "<B", 1: "<b", 2: "<H", 3: "<h", 4: "<I", 5: "<i", 6: "<f", 10: "<Q", 11: "<q", 12: "<d"}
        if t in fmt:
            return struct.pack(fmt[t], v)
        if t == 7:
            return struct.pack("<B", int(v))
        if t == 8:
            return string(v)
        elem, items = v  # 9: an array of one element type
        return struct.pack("<IQ", elem, len(items)) + b"".join(value(elem, x) for x in items)

    out = struct.pack("<IIQQ", 0x46554747, version, len(tensors), len(metadata))
    for key, t, v in metadata:
        out += string(key) + struct.pack("<I", t) + value(t, v)
    offset, blobs = 0, []
    for name, shape, code, data in tensors:
        offset = -(-offset // alignment) * alignment
        out += string(name) + struct.pack(f"<I{len(shape)}Q", len(shape), *reversed(shape)) + struct.pack("<IQ", code, offset)
        blobs.append((offset, data))
        offset += len(data)
    out += b"\0" * (-len(out) % alignment)
    start = len(out)
    for off, data in blobs:
        out += b"\0" * (start + off - len(out)) + data
    return out


def _assert_readers_agree(ours: GgufReader, ref: JReader) -> None:
    assert (ours.version, ours.alignment, ours.data_start) == (ref.version, ref.alignment, ref.data_start)
    assert ours.metadata == ref.metadata
    assert list(ours.tensors) == list(ref.tensors)
    for name, info in ref.tensors.items():
        mine = ours.tensor_info(name)
        assert (mine.name, mine.gguf_dims, int(mine.dtype), mine.offset) == (
            info.name, info.gguf_dims, int(info.dtype), info.offset)
        assert (mine.shape, mine.n_elements, mine.nbytes) == (info.shape, info.n_elements, info.nbytes)
        assert ours.tensor_data(name) == ref.tensor_data(name)
        a, r = ours.tensor_f32(name), ref.tensor_f32(name)
        assert a.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(a, r)


def _writer_calls(writer, alignment: int, rng: np.random.Generator) -> None:
    """The same calls on either package's writer: every metadata type and
    F32, Q4_0 and raw F16 tensors."""
    writer.add_string("general.architecture", "whisper")
    writer.add_u32("general.alignment", alignment)
    writer.add_u64("whisper.big", 1 << 40)
    writer.add_f32("whisper.scale", 0.125)
    writer.add_bool("whisper.flag", True)
    writer.add_bool("whisper.off", False)
    writer.add_tensor("a.weight", rng.standard_normal((3, 5)).astype(np.float32))
    writer.add_tensor("b.weight", rng.standard_normal((4, 64)).astype(np.float32), quantize=True)
    half = rng.standard_normal((2, 7)).astype(np.float16)
    dtype = GgmlDtype.F16 if isinstance(writer, GgufWriter) else JDtype.F16
    writer.add_raw_tensor("c.weight", (2, 7), dtype, half.tobytes())
    writer.add_tensor("d.bias", rng.standard_normal(9).astype(np.float32))


@pytest.mark.parametrize("alignment", [32, 64, 256])
def test_writer_bytes_equal_jax(alignment, tmp_path):
    ours, ref = GgufWriter(alignment), JWriter(alignment)
    _writer_calls(ours, alignment, np.random.default_rng(alignment))
    _writer_calls(ref, alignment, np.random.default_rng(alignment))
    blob = ref.to_bytes()
    assert ours.to_bytes() == blob
    ours.write(tmp_path / "sub" / "ours.gguf")  # streamed, tensor by tensor
    assert (tmp_path / "sub" / "ours.gguf").read_bytes() == blob


@pytest.mark.parametrize("alignment", [32, 64, 256])
def test_reader_matches_jax_on_jax_written(alignment, tmp_path):
    w = JWriter(alignment)
    _writer_calls(w, alignment, np.random.default_rng(1))
    blob = w.to_bytes()
    _assert_readers_agree(GgufReader.from_bytes(blob), JReader.from_bytes(blob))
    (tmp_path / "m.gguf").write_bytes(blob)
    _assert_readers_agree(GgufReader.open(tmp_path / "m.gguf"), JReader.open(tmp_path / "m.gguf"))


@pytest.mark.parametrize("version", [2, 3])
def test_reader_every_metadata_type(version):
    """All 13 GGUF value types (arrays of scalars and of strings among them),
    in a v2 and a v3 container with a declared alignment of 64."""
    rng = np.random.default_rng(version)
    meta = [
        ("u8", 0, 200), ("i8", 1, -100), ("u16", 2, 60000), ("i16", 3, -30000), ("u32", 4, 4_000_000_000),
        ("i32", 5, -2_000_000_000), ("f32", 6, 1.5), ("bool", 7, True), ("str", 8, "héllo"),
        ("arr", 9, (4, [1, 2, 3])), ("strs", 9, (8, ["a", "bc"])), ("u64", 10, 1 << 62), ("i64", 11, -(1 << 62)),
        ("f64", 12, 2.25), ("general.alignment", 4, 64),
    ]
    f32 = rng.standard_normal((3, 4)).astype("<f4")
    f16 = rng.standard_normal((5,)).astype("<f2")
    q4 = jquant.quantize_q4_0(rng.standard_normal((2, 32)).astype(np.float32))
    blob = _raw_gguf(version, meta, [("t.f32", (3, 4), 0, f32.tobytes()), ("t.f16", (5,), 1, f16.tobytes()),
                                     ("t.q4", (2, 32), 2, q4)], alignment=64)
    ours, ref = GgufReader.from_bytes(blob), JReader.from_bytes(blob)
    _assert_readers_agree(ours, ref)
    assert ours.version == version and ours.alignment == 64 and ours.data_start % 64 == 0
    assert ours.metadata["strs"] == ["a", "bc"] and ours.metadata["f64"] == 2.25
    np.testing.assert_array_equal(ours.tensor_f32("t.f16"), f16.astype(np.float32))


@pytest.mark.parametrize("blob", [
    b"garbage-not-gguf" * 4,
    struct.pack("<IIQQ", 0x46554747, 1, 0, 0),
    struct.pack("<IIQQ", 0x46554747, 4, 0, 0),
    _raw_gguf(3, [], [("x", (2,), 7, b"\0" * 8)]),  # an unsupported ggml dtype
], ids=["magic", "v1", "v4", "dtype"])
def test_reader_refuses_as_jax(blob):
    with pytest.raises(ValueError) as ref:
        JReader.from_bytes(blob)
    with pytest.raises(ValueError) as ours:
        GgufReader.from_bytes(blob)
    assert str(ours.value) == str(ref.value)


# --------------------------------------------------------------------------
# Q4_0


def _q4_inputs() -> np.ndarray:
    """Seeded blocks, an all-zero block, a block whose values lie on
    rounding ties of v / d (d = 1: amax 7, halves between codes), and the
    ±7·d ends."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 32)).astype(np.float32) * 0.05
    x[1] = 0.0
    x[2] = np.array([7.0, -6.5, -5.5, -4.5, -3.5, -2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, -7.0] * 2,
                    np.float32)
    x[3, :] = 0.25
    x[3, 5] = -7 * 0.25  # amax on the negative side: the code -7
    x[4] = np.linspace(-7, 7, 32, dtype=np.float32) * 1e-3
    return x


def test_quantize_unpack_dequantize_equal_jax():
    x = _q4_inputs()
    raw = quant.quantize_q4_0(x)
    assert raw == jquant.quantize_q4_0(x)
    assert quant.q4_0_nbytes(x.size) == jquant.q4_0_nbytes(x.size) == len(raw)
    (q, d), (jq, jd) = quant.unpack_q4_0(raw, x.size), jquant.unpack_q4_0(raw, x.size)
    assert q.dtype == jq.dtype == np.int8 and d.dtype == jd.dtype == np.float32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_array_equal(d, np.frombuffer(raw, np.uint8).reshape(-1, 18)[:, :2].copy().view("<f2")[:, 0])
    np.testing.assert_array_equal(quant.dequantize_q4_0(raw, x.size), jquant.dequantize_q4_0(raw, x.size))
    np.testing.assert_array_equal(q[32:64], 0)  # the zero block: codes 0, scale 0
    assert d[1] == 0
    # ties round half to even: 6.5 -> 6, -5.5 -> -6, 2.5 -> 2, 0.5 -> 0
    np.testing.assert_array_equal(q[64:80], [7, -6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4, 4, 6, 6, -7])
    with pytest.raises(ValueError):
        quant.q4_0_nbytes(33)


@pytest.mark.parametrize("n, k", [(1, 32), (6, 64), (384, 256), (512, 1024)])
@pytest.mark.parametrize("native", [True, False], ids=["jax_native", "jax_numpy"])
def test_repack_equals_jax(n, k, native, monkeypatch):
    """The port's repack against the JAX package's, its C++ fast path and
    its numpy path, on random bytes (every nibble and f16 scale) and on a
    quantized weight."""
    if not native:
        monkeypatch.setattr(native_host, "repack_q4_0", lambda raw, n_out, k_in: None)
    rng = np.random.default_rng(n + k)
    raw = np.frombuffer(rng.bytes(quant.q4_0_nbytes(n * k)), np.uint8).copy()
    blocks = raw.reshape(-1, 18)
    blocks[:, :2] = (rng.uniform(-2, 2, len(blocks)).astype(np.float16)).view(np.uint8).reshape(-1, 2)
    for src in (raw, raw.tobytes(), quant.quantize_q4_0(rng.standard_normal((n, k)).astype(np.float32))):
        ours, ref = repack.repack_q4_0(src, n, k), jrepack.repack_q4_0(src, n, k)
        for a, r in ((ours.qw, ref.qw), (ours.scales, ref.scales)):
            assert a.dtype == r.dtype and a.flags.c_contiguous
            np.testing.assert_array_equal(a, r)
        assert (ours.k, ours.n) == (k, n)
        np.testing.assert_array_equal(ours.dequantize(), ref.dequantize())
        flat = src if isinstance(src, bytes) else src.tobytes()
        np.testing.assert_array_equal(ours.dequantize().T, jquant.dequantize_q4_0(flat, n * k).reshape(n, k))
    with pytest.raises(ValueError, match="not divisible"):
        repack.repack_q4_0(raw, 1, 48)


def test_params_repack_f32_goes_through_gguf():
    """The fixtures' Q4 weights (``models.params``) come from the gguf
    layer's quantize + repack, which is the JAX package's."""
    w = _q4_inputs().reshape(12, 16).repeat(4, axis=1)  # [N 12, K 64]
    ours, ref = repack.repack_f32(w), jrepack.repack_f32(w)
    np.testing.assert_array_equal(ours.qw, ref.qw)
    np.testing.assert_array_equal(ours.scales, ref.scales)
    lin = _rand_linear(np.random.default_rng(4), 64, 12, quantized=True, bias=False)
    drawn = repack.repack_f32(np.random.default_rng(4).standard_normal((12, 64)).astype(np.float32) * 0.05)
    np.testing.assert_array_equal(lin["qw"], drawn.qw)
    np.testing.assert_array_equal(lin["scales"], drawn.scales)


# --------------------------------------------------------------------------
# the loader


def _state(d=256, n_mels=8, n_audio_ctx=128, n_text_ctx=64, enc_layers=1, dec_layers=1, vocab=51865, seed=0):
    """An HF-style Whisper state dict (numpy), Q4_0 for its matrices once
    d >= 256, and a tied output projection that the converter drops."""
    rng = np.random.default_rng(seed)
    f, s = 4 * d, {}

    def lin(prefix, n, k, bias=True):
        s[f"{prefix}.weight"] = rng.standard_normal((n, k)).astype(np.float32) * 0.05
        if bias:
            s[f"{prefix}.bias"] = rng.standard_normal(n).astype(np.float32) * 0.01

    def ln(prefix):
        s[f"{prefix}.weight"] = 1.0 + rng.standard_normal(d).astype(np.float32) * 0.02
        s[f"{prefix}.bias"] = rng.standard_normal(d).astype(np.float32) * 0.02

    s["model.encoder.conv1.weight"] = rng.standard_normal((d, n_mels, 3)).astype(np.float32) * 0.05
    s["model.encoder.conv1.bias"] = np.zeros(d, np.float32)
    s["model.encoder.conv2.weight"] = rng.standard_normal((d, d, 3)).astype(np.float32) * 0.02
    s["model.encoder.conv2.bias"] = np.zeros(d, np.float32)
    s["model.encoder.embed_positions.weight"] = rng.standard_normal((n_audio_ctx, d)).astype(np.float32) * 0.01
    s["model.decoder.embed_positions.weight"] = rng.standard_normal((n_text_ctx, d)).astype(np.float32) * 0.01
    s["model.decoder.embed_tokens.weight"] = rng.standard_normal((vocab, d)).astype(np.float32) * 0.02
    for side, n_layers, cross in (("encoder", enc_layers, False), ("decoder", dec_layers, True)):
        for i in range(n_layers):
            p = f"model.{side}.layers.{i}"
            ln(f"{p}.self_attn_layer_norm")
            lin(f"{p}.self_attn.q_proj", d, d)
            lin(f"{p}.self_attn.k_proj", d, d, bias=False)
            lin(f"{p}.self_attn.v_proj", d, d)
            lin(f"{p}.self_attn.out_proj", d, d)
            if cross:
                ln(f"{p}.encoder_attn_layer_norm")
                lin(f"{p}.encoder_attn.q_proj", d, d)
                lin(f"{p}.encoder_attn.k_proj", d, d, bias=False)
                lin(f"{p}.encoder_attn.v_proj", d, d)
                lin(f"{p}.encoder_attn.out_proj", d, d)
            ln(f"{p}.final_layer_norm")
            lin(f"{p}.fc1", f, d)
            lin(f"{p}.fc2", d, f)
    ln("model.encoder.layer_norm")
    ln("model.decoder.layer_norm")
    s["proj_out.weight"] = s["model.decoder.embed_tokens.weight"]
    return s


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _assert_models_equal(ours, ref) -> None:
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(ref.config)
    a, r = _flat(ours.params), _flat(ref.params)
    assert sorted(a) == sorted(r)  # jax.tree.map, which stacks the JAX blocks, sorts their keys
    for key in r:
        assert isinstance(a[key], np.ndarray), key
        assert a[key].dtype == r[key].dtype and a[key].shape == r[key].shape, key
        np.testing.assert_array_equal(a[key], r[key], err_msg=key)


@pytest.fixture(scope="module")
def small_gguf(tmp_path_factory):
    """The small model of tests/test_torch_pipeline.py (D 256, 4 heads, 128
    audio frames, 64 text positions) with 2 + 2 layers, as the JAX
    converter writes it: Q4_0 matrices, F32 for the rest."""
    path = tmp_path_factory.mktemp("gguf") / "small.gguf"
    convert_state_dict(_state(enc_layers=2, dec_layers=2), n_lang=99).write(path)
    return path


@pytest.mark.parametrize("d", [256, 64], ids=["q4_0", "dense_f32"])
def test_loader_matches_jax(d, tmp_path):
    """From bytes and from a path: the JAX loader's config and every key,
    dtype and array bit for bit, Q4_0 repacked (d = 256) or dense F32
    transposed (d = 64, below the converter's threshold)."""
    blob = convert_state_dict(_state(d=d, vocab=600), n_lang=99).to_bytes()
    (tmp_path / "m.gguf").write_bytes(blob)
    ref = j_load(blob)
    for source in (blob, tmp_path / "m.gguf", str(tmp_path / "m.gguf")):
        ours = load_whisper_from_gguf(source)
        assert isinstance(ours, LoadedModel)
        _assert_models_equal(ours, ref)
    blocks = ours.params["decoder"]["blocks"]
    assert ("qw" in blocks["fc1"]) == (d == 256) and "b" not in blocks["attn_k"]
    assert ours.params["decoder"]["tok_emb"].shape == (ours.config.n_vocab_padded, d)
    assert not ours.params["decoder"]["tok_emb"][600:].any()


def _gguf_without_counts(state, n_lang=None) -> bytes:
    """The converter's tensors with no layer-count metadata."""
    w = JWriter()
    w.add_string("general.architecture", "whisper")
    if n_lang is not None:
        w.add_u32("whisper.n_lang", n_lang)
    for hf_name, value in sorted(state.items()):
        name = hf_name_to_gguf(hf_name)
        if name is not None:
            w.add_tensor(name, value, quantize=should_quantize(name, value.shape))
    return w.to_bytes()


@pytest.mark.parametrize("n_mels, n_lang", [(128, 100), (80, 99)])
@pytest.mark.parametrize("counts", [True, False], ids=["layer_count_metadata", "counted_blocks"])
def test_infer_config_matches_jax(n_mels, n_lang, counts):
    """Unequal stacks (3 encoder, 1 decoder layers, as Turbo's are unequal),
    the layer counts from the metadata or counted, ``n_lang`` from the mel
    bins where the metadata has none."""
    state = _state(d=64, n_mels=n_mels, enc_layers=3, dec_layers=1, vocab=300)
    blob = convert_state_dict(state).to_bytes() if counts else _gguf_without_counts(state)
    cfg = infer_config(GgufReader.from_bytes(blob))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_infer_config(JReader.from_bytes(blob)))
    assert (cfg.n_mels, cfg.n_lang, cfg.n_audio_layer, cfg.n_text_layer) == (n_mels, n_lang, 3, 1)
    assert (cfg.n_audio_state, cfg.n_audio_head, cfg.n_vocab, cfg.n_audio_ctx, cfg.n_text_ctx) == (64, 1, 300, 128, 64)
    # metadata wins over the mel-bin rule
    cfg = infer_config(GgufReader.from_bytes(_gguf_without_counts(state, n_lang=7)))
    assert cfg.n_lang == 7 and cfg.n_audio_layer == 3


# --------------------------------------------------------------------------
# the repacked cache


def test_cache_cold_warm_and_stale(small_gguf, tmp_path):
    cache = tmp_path / "cache"
    assert load_repacked(small_gguf, cache) is None  # cold: a miss
    cold = load_whisper(small_gguf, cache_dir=cache)
    npz, meta = cache / "small.gguf.repacked.npz", cache / "small.gguf.repacked.json"
    assert npz.exists() and meta.exists() and not list(cache.glob("*.tmp.npz"))
    _assert_models_equal(cold, load_whisper_from_gguf(small_gguf))
    warm = load_repacked(small_gguf, cache)
    _assert_models_equal(warm, cold)
    _assert_models_equal(load_whisper(small_gguf, cache_dir=cache), cold)
    record = json.loads(meta.read_text())
    assert record["cache_version"] == CACHE_VERSION and record["config"] == dataclasses.asdict(cold.config)

    # a changed mtime, a changed size, another version: misses
    stat = small_gguf.stat()
    os.utime(small_gguf, (stat.st_atime, stat.st_mtime + 10))
    assert load_repacked(small_gguf, cache) is None
    os.utime(small_gguf, (stat.st_atime, stat.st_mtime))
    assert load_repacked(small_gguf, cache) is not None
    meta.write_text(json.dumps({**record, "source_size": record["source_size"] + 1}))
    assert load_repacked(small_gguf, cache) is None
    meta.write_text(json.dumps({**record, "cache_version": CACHE_VERSION + 1}))
    assert load_repacked(small_gguf, cache) is None
    meta.write_text("{not json")
    assert load_repacked(small_gguf, cache) is None
    meta.write_text(json.dumps(record))
    npz.write_bytes(b"not an npz")
    assert load_repacked(small_gguf, cache) is None
    # beside the checkpoint when no directory is given
    save_repacked(cold, small_gguf)
    _assert_models_equal(load_repacked(small_gguf), cold)


def test_cache_is_shared_with_jax(small_gguf, tmp_path):
    """A cache the JAX package wrote loads in the port to the same arrays,
    and the reverse."""
    j_cold = j_load_whisper(small_gguf, cache_dir=tmp_path / "jax")
    ours = load_repacked(small_gguf, tmp_path / "jax")
    assert ours is not None
    _assert_models_equal(ours, j_cold)
    save_repacked(load_whisper_from_gguf(small_gguf), small_gguf, tmp_path / "torch")
    ref = j_load_repacked(small_gguf, tmp_path / "torch")
    assert ref is not None
    _assert_models_equal(load_repacked(small_gguf, tmp_path / "torch"), ref)


def test_cache_save_is_best_effort(small_gguf, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("a file where the cache directory would go")
    model = load_whisper(small_gguf, cache_dir=blocker)  # the save fails, the load does not
    _assert_models_equal(model, load_whisper_from_gguf(small_gguf))


# --------------------------------------------------------------------------
# a loaded model end to end

PARITY = (JCompute.parity().replace(backend=KernelBackend.XLA), Compute.parity())
MAX_TOKENS = 8


def test_loaded_model_greedy_matches_jax(small_gguf):
    """The loaded model's greedy tokens in f32 (``Compute.parity()``)."""
    jc, tc = PARITY
    ref_model, model = j_load(small_gguf), load_whisper_from_gguf(small_gguf)
    cfg = model.config
    mel = np.random.default_rng(3).standard_normal((2, cfg.n_mels, 2 * cfg.n_audio_ctx)).astype(np.float32)
    lang = np.full(2, cfg.lang_token_start, np.int32)
    jparams = jtr.prepare_params(ref_model.params, jc)
    ref = j_greedy(jparams, ref_model.config, jnp.asarray(mel), jnp.asarray(lang), jc, max_tokens=MAX_TOKENS)
    params = prepare_params(params_to_torch(model.params, "cpu"), tc)
    _build.reset_launches()
    out = greedy_decode(params, cfg, torch.from_numpy(mel), torch.from_numpy(lang), tc, max_tokens=MAX_TOKENS)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))


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


def test_pipeline_on_loaded_model_matches_jax(small_gguf, tokenizer_file, tmp_path):
    """``WhisperPipeline(LoadedModel)`` on the same GGUF (the port's through
    its repacked cache) as the JAX pipeline: three utterances, one language
    detected, bucketed to four, the same tokens, language tokens and
    text."""
    jc, tc = PARITY
    rng = np.random.default_rng(5)
    audios = [(0.1 * rng.standard_normal(int(s * 16000))).astype(np.float32) for s in (1.0, 2.0, 2.5)]
    languages = ["en", "auto", "de"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "enable_compilation_cache", lambda path=None: None)
        jp = jtr.WhisperPipeline(j_load(small_gguf), JTokenizer.from_file(tokenizer_file), compute=jc,
                                 max_tokens=MAX_TOKENS)
        ref = jp.transcribe_batch(audios, languages)
    model = load_whisper(small_gguf, cache_dir=tmp_path)
    tp = WhisperPipeline(model, WhisperTokenizer.from_file(tokenizer_file), compute=tc, max_tokens=MAX_TOKENS,
                         device="cpu")
    assert tp.config == model.config.replace(gelu="erf")
    seen = []
    decode = tp._decode
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp, "_decode", lambda samples, langs, detect: seen.append(len(samples)) or decode(samples, langs, detect))
        out = tp.transcribe_batch(audios, languages)
    assert seen == [4]
    assert len(out) == len(ref) == 3
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.tokens, np.asarray(r.tokens))
        assert o.lang_token == r.lang_token and o.text == r.text
