"""Scale-out (``whisper_burn_tpu_torch/parallel/``) against the JAX package's
``parallel/`` on the CPU, at ``tiny_test().replace(n_audio_ctx=16)``.

Four gloo ranks (``tests/torch_parallel_worker.py``, started once for the
module) load the JAX package's ``random_params`` from an npz written here
and run the port's sharded entry points; they import neither JAX nor the
JAX package. The JAX side runs in this process on the conftest's eight
virtual devices, while the ranks work. Held equal: the mesh's shapes and
errors, the leaf specs, each rank's shard against the JAX array's
addressable shard of device (d, m), the interleaved fused q/k/v, at
(data 2, model 2) the greedy tokens in ``Compute.parity()``, in
``Compute.fastest(kv_bits=4)`` (f32, W8A8 off) and in the serving compute
(bf16, W8A8 with its row scale over the local K shard, the sums in bf16,
int8 logits), the 2-beam tokens and
scores, and the pipeline's tokens on a batch of 6 (padded to 8). The
serving round: rank 0's batching transcriber over the (2, 2) pipeline,
the other ranks following, against the JAX package's transcriber over
its mesh, then rank 0's HTTP server (an unknown language 400 on rank 0
alone); a killed follower ends the job non-zero. The
W8A8 row-parallel linear on identical local inputs is held at 1e-5; the
replication guard must raise when the sums are dropped; the collective
counts must be the shapes' prediction. Kernels G and H at an odd head
count (a shard's) against K11 in interpret mode, and an int4 cross cache
at an odd head count against K3; kernel I's plain version with fc2's bias
left out (the sharded FFN's call) against a zero bias."""

import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.params import fuse_attention_params as j_fuse
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.ops.linear import w8a8_matmul as j_w8a8
from whisper_burn_tpu.ops.pallas_attention import decode_attention_kT as j_cross
from whisper_burn_tpu.ops.pallas_attention import decode_attention_layer as j_layer
from whisper_burn_tpu.ops.pallas_attention import decode_attention_merged as j_merged
from whisper_burn_tpu.parallel import make_mesh as j_make_mesh
from whisper_burn_tpu.parallel import shard_params_tp as j_shard
from whisper_burn_tpu.parallel import sharded_beam_decode as j_sharded_beam
from whisper_burn_tpu.parallel import sharded_greedy_decode as j_sharded_greedy
from whisper_burn_tpu.parallel.sharding import param_pspecs as j_pspecs
from whisper_burn_tpu.serving import BatchingTranscriber as JTranscriber
from whisper_burn_tpu.transcribe import WhisperPipeline as JPipeline
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models import decoder
from whisper_burn_tpu_torch.models.config import WhisperConfig
from whisper_burn_tpu_torch.models.params import fuse_attention_params, params_to_torch
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.decode_attention import (
    decode_attention_layer_int4,
    decode_attention_merged_int4,
    decode_cross_attention,
)
from whisper_burn_tpu_torch.ops.ffn_kernel import fused_ffn
from whisper_burn_tpu_torch.parallel import Mesh, make_mesh, param_pspecs, shard_params, validate_tp
from whisper_burn_tpu_torch.parallel.audit import predicted_collectives

ROOT = Path(__file__).resolve().parents[1]
JCFG = JConfig.tiny_test().replace(n_audio_ctx=16)
CFG = WhisperConfig.tiny_test().replace(n_audio_ctx=16)
WORLD, B = 4, 8
J_PARITY = JCompute.parity().replace(backend=KernelBackend.XLA)
J_FASTEST = JCompute.fastest(kv_bits=4).replace(
    w8a8=False, dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS)
J_SERVING = JCompute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True, backend=KernelBackend.PALLAS)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _inputs():
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((B, CFG.n_mels, CFG.n_audio_ctx * 2)).astype(np.float32)
    lang = np.full((B,), CFG.lang_token_start, np.int32)
    audio = (np.random.default_rng(0).standard_normal((6, CFG.n_audio_ctx * 2 * 160)) * 0.1).astype(np.float32)
    w8a8_x = np.random.default_rng(2).standard_normal((5, CFG.n_audio_state)).astype(np.float32)
    t = np.arange(int(0.2 * 16000)) / 16000  # the five tones of tests/test_serving.py's mesh test
    tones = np.stack([(0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t)).astype(np.float32) for i in range(5)])
    return mel, lang, audio, w8a8_x, tones


@pytest.fixture(scope="module")
def jparams():
    return j_random_params(JCFG, seed=0, quantized=True)


@pytest.fixture(scope="module")
def ranks(jparams, tmp_path_factory):
    """Start the four ranks, compute the JAX side while they run, then
    collect both: ``(outputs by rank, infos by rank, JAX results)``."""
    tmp = tmp_path_factory.mktemp("parallel")
    mel, lang, audio, w8a8_x, tones = _inputs()
    np.savez(tmp / "params.npz", **_flatten(jparams), **{"input/mel": mel, "input/lang": lang, "input/audio": audio,
                                                        "input/w8a8_x": w8a8_x, "input/tones": tones})
    port, env = _free_port(), _worker_env()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(r), str(WORLD),
                               str(port), str(tmp / "params.npz"), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        jax_side = _jax_side(jparams, mel, lang, audio, tones)
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    outs = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]
    infos = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return outs, infos, jax_side


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _worker_env() -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(ROOT)
    return env


def _jax_side(jparams, mel, lang, audio, tones) -> dict:
    """The JAX package's sharded results at (data 2, model 2)."""
    mesh = j_make_mesh(data=2, model=2)
    mel_j, lang_j = jnp.asarray(mel), jnp.asarray(lang)
    out = {}
    for name, compute in (("parity", J_PARITY), ("fastest", J_FASTEST), ("serving", J_SERVING)):
        sharded = j_shard(j_prepare(jparams, compute, tp=2), mesh)
        res = j_sharded_greedy(sharded, JCFG, mel_j, lang_j, compute, mesh, max_tokens=8)
        out[f"greedy_{name}"], out[f"greedy_{name}_n"] = np.asarray(res.tokens), np.asarray(res.n_generated)
        if name == "parity":
            beam = j_sharded_beam(sharded, JCFG, mel_j, lang_j, compute, mesh, beam_width=2, max_tokens=6)
            out["beam_tokens"], out["beam_scores"] = np.asarray(beam.tokens), np.asarray(beam.scores)
    pipe = JPipeline((JCFG, jparams), compute=J_PARITY, max_tokens=8, mesh=mesh)
    out["pipeline"] = [np.asarray(r.tokens) for r in pipe.transcribe_batch(list(audio), ["en"] * len(audio))]
    server = JTranscriber(pipe, batch_size=3, max_wait_ms=100)
    try:
        reqs = [server.submit(t, "en") for t in tones]
        out["serving"] = [np.asarray(r.wait(timeout=600).tokens) for r in reqs]
        out["serving_batches"] = server.stats.snapshot()["batches"]
    finally:
        server.shutdown()
    return out


# --------------------------------------------------------------------------
# the mesh, the specs and the shards (this process: a mesh's layout alone)


def test_mesh_shapes_and_errors(ranks):
    _, infos, _ = ranks
    assert [i["mesh"] for i in infos] == [[2, 2, d, m] for d in range(2) for m in range(2)]
    assert all(i["all_data"] == [4, 1] for i in infos)
    assert all("not divisible by model=3" in i["bad_mesh"] for i in infos)
    assert [i["local_slice"] for i in infos] == [[0, 4], [0, 4], [4, 8], [4, 8]]
    # the layout without a process group, and the JAX mesh's errors
    assert make_mesh(4, 2, world=8).shape == j_make_mesh(data=4, model=2).shape
    assert make_mesh(model=1, world=8).shape == {"data": 8, "model": 1}
    for args in ((5, 3), (8, 2)):
        with pytest.raises(ValueError):
            j_make_mesh(*args)
        with pytest.raises(ValueError):
            make_mesh(*args, world=8)


def test_gathered_rows(ranks):
    """``local_batch_to_global``: each rank's slice, in data order."""
    outs, _, _ = ranks
    for r, out in enumerate(outs):  # the data group of model index m: ranks m and 2 + m
        m = r % 2
        np.testing.assert_array_equal(out["gathered_rows"], [m, m, 2 + m, 2 + m])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_param_specs_match_jax(jparams, fused):
    params = j_fuse(jparams, tp=2) if fused else jparams
    jspecs = dict(_leaves(j_pspecs(params)))
    specs = dict(_leaves(param_pspecs(_to_torch(params))))
    assert specs.keys() == jspecs.keys()
    for path, spec in specs.items():
        assert spec == tuple(jspecs[path]), path


def _to_torch(tree):
    return params_to_torch(jax.tree.map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("d,m", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shards_match_jax_addressable_shards(jparams, d, m):
    """Each leaf of the shard of rank (d, m) against the JAX sharded
    array's shard on device (d, m) of the mesh."""
    mesh = j_make_mesh(data=2, model=2)
    params = j_fuse(jparams, tp=2)
    jsharded = j_shard(params, mesh)
    device = mesh.devices[d, m]
    ours = shard_params(_to_torch(params), Mesh(2, 2, d, m))
    theirs = dict(_leaves(jsharded))
    for path, leaf in _leaves(ours):
        (shard,) = [s for s in theirs[path].addressable_shards if s.device == device]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(shard.data), err_msg=str(path))


def test_fused_qkv_interleaved_matches_jax(jparams):
    ours = fuse_attention_params(_to_torch(jparams), tp=2)
    theirs = j_fuse(jparams, tp=2)
    for stack, names in (("encoder", ("attn_qkv",)), ("decoder", ("attn_qkv", "xattn_kv"))):
        for name in names:
            for key, leaf in ours[stack]["blocks"][name].items():
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(theirs[stack]["blocks"][name][key]))


def test_validate_tp_refuses_tp4_at_two_heads():
    with pytest.raises(ValueError, match="does not divide n_audio_head=2"):
        validate_tp(CFG, make_mesh(1, 4, world=4))
    assert validate_tp(CFG, make_mesh(2, 2, world=4)) == 2


# --------------------------------------------------------------------------
# the sharded decodes at (data 2, model 2), against the JAX package's


@pytest.mark.parametrize("mode", ["parity", "fastest", "serving"])
def test_sharded_greedy_matches_jax(ranks, mode):
    outs, _, jax_side = ranks
    for out in outs:  # every rank returns the whole batch
        np.testing.assert_array_equal(out[f"greedy_{mode}"], jax_side[f"greedy_{mode}"])
        np.testing.assert_array_equal(out[f"greedy_{mode}_n"], jax_side[f"greedy_{mode}_n"])


def test_sharded_beam_matches_jax(ranks):
    outs, _, jax_side = ranks
    for out in outs:
        np.testing.assert_array_equal(out["beam_tokens"], jax_side["beam_tokens"])
        np.testing.assert_allclose(out["beam_scores"], jax_side["beam_scores"], rtol=1e-5, atol=1e-5)


def test_pipeline_mesh_matches_jax(ranks):
    """A batch of 6 on 2 data ranks, padded to 8 (4 a rank)."""
    outs, _, jax_side = ranks
    for out in outs:
        assert len([k for k in out if k.startswith("pipeline_")]) == 6
        for i, ref in enumerate(jax_side["pipeline"]):
            np.testing.assert_array_equal(out[f"pipeline_{i}"], ref)


def test_serving_over_mesh_matches_jax(ranks):
    """Rank 0's ``BatchingTranscriber`` (batch 3, 100 ms) over the (2, 2)
    pipeline, the other three ranks following it: for the five tones of
    tests/test_serving.py's mesh test, in drains of 3 and 2, the JAX
    package's transcriber over its (2, 2) mesh, request for request."""
    outs, infos, jax_side = ranks
    serving = infos[0]["serving"]
    assert serving["stats"]["completed"] == 5 and serving["stats"]["batches"] == serving["handoffs"] == 2
    assert jax_side["serving_batches"] == 2 and serving["lang_tokens"] == [50259] * 5
    for i, ref in enumerate(jax_side["serving"]):
        np.testing.assert_array_equal(outs[0][f"serving_{i}"], ref)


def test_serving_followers_follow_every_handoff(ranks):
    """Over HTTP on rank 0 (batch 3): a POST in "en" 200; one in an unknown
    language 400, on rank 0 alone (its batch fails before the hand-off);
    the next 200. Each other rank decoded every batch handed over and no
    other, skipped rank 0's keep-alives, and left each serving on rank
    0's stop."""
    _, infos, _ = ranks
    http = infos[0]["http"]
    (s0, b0), (s1, b1), (s2, b2) = http["replies"]
    assert (s0, s1, s2) == (200, 400, 200), http["replies"]
    assert b0["lang_token"] == b2["lang_token"] == 50259 and "xx" in b1["error"]
    assert (http["handoffs"], http["stats"]["batches"], http["stats"]["failed"]) == (2, 3, 1)
    sent = http["sent"]  # rank 0's messages of both rounds, keep-alives while idle (every 50 ms here) among them
    assert (sent["_BATCH"], sent["_STOP"]) == (2 + 2, 1 + 1) and sent["_KEEPALIVE"] >= 1
    for info in infos[1:]:
        assert info["followed"] == [infos[0]["serving"]["handoffs"], http["handoffs"]] == [2, 2]


def _wav(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.round(samples * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_killed_follower_ends_the_job(jparams, tmp_path):
    """Two ranks serve at mesh (2, 1) with a 10 s control-group timeout
    (``torch_parallel_worker.py ... fault``); rank 1 is killed while rank 0
    serves. Rank 0's next request gets a 500 or its connection closes,
    never a reply from rank 0 alone, and rank 0 exits non-zero: all within
    60 s."""
    end = time.monotonic() + 60
    np.savez(tmp_path / "params.npz", **_flatten(jparams))
    port, env = _free_port(), _worker_env()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"), str(r), "2", str(port),
                               str(tmp_path / "params.npz"), str(tmp_path), "fault"],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        while not ((tmp_path / "port").exists() and (tmp_path / "following").exists()):
            assert all(p.poll() is None for p in procs), [p.communicate(timeout=10)[0][-3000:] for p in procs]
            assert time.monotonic() < end - 30, "the ranks did not start serving"
            time.sleep(0.05)
        procs[1].kill()
        procs[1].wait(timeout=10)
        base = f"http://127.0.0.1:{(tmp_path / 'port').read_text()}"
        req = urllib.request.Request(f"{base}/v1/transcribe", data=_wav(_inputs()[4][0]),
                                     headers={"X-Language": "en"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=end - time.monotonic() - 10) as resp:
                status = resp.status
        except urllib.error.HTTPError as e:
            status = e.code
        except (urllib.error.URLError, ConnectionError) as e:  # the connection closed
            status = type(e).__name__
        log = procs[0].communicate(timeout=max(1.0, end - time.monotonic()))[0]
        assert status in (500, "URLError", "RemoteDisconnected", "ConnectionResetError"), (status, log[-3000:])
        assert procs[0].returncode not in (0, None), log[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    assert time.monotonic() < end


def test_w8a8_row_parallel_linear_matches_jax(ranks, jparams):
    """The row-parallel W8A8 linear (encoder attn_o, layer 1): each rank's
    per-row scale from its own K shard, the shards' sum, then the bias."""
    outs, _, _ = ranks
    p = j_prepare(jparams, JCompute.parity().replace(w8a8=True), tp=2)["encoder"]["blocks"]["attn_o"]
    x = _inputs()[3]
    parts = [np.asarray(j_w8a8(jnp.asarray(x[:, 32 * m:32 * (m + 1)]), p["qw8"][1][32 * m:32 * (m + 1)], p["s8"][1],
                               JCompute.parity())) for m in range(2)]
    ref = parts[0] + parts[1] + np.asarray(p["b"][1])
    for out in outs:
        np.testing.assert_allclose(out["w8a8_y"], ref, rtol=1e-5, atol=1e-5)


def test_replication_guard_raises_without_the_sums(ranks):
    _, infos, _ = ranks
    for info in infos:
        assert info["guard"].startswith("ReplicationError"), info["guard"]


@pytest.mark.parametrize("label", ["dp", "dptp"])
def test_collective_audit_matches_the_shapes(ranks, label):
    """DP issues nothing but the result gather (an all-gather a result
    tensor); TP only all-reduces, as many as the shapes predict."""
    _, infos, _ = ranks
    for info in infos:
        audit = info[f"audit_{label}"]
        assert audit["counts"] == audit["predicted"]
        assert audit["total"] == sum(audit["predicted"].values())
    want = predicted_collectives(CFG, make_mesh(*((4, 1) if label == "dp" else (2, 2)), world=4), steps=7)
    assert want["all_gather"] == 3
    assert want["all_reduce"] == (0 if label == "dp" else 2 * 2 + 3 * 2 * 8)


# --------------------------------------------------------------------------
# kernels G and H at a shard's odd head count, against K11 in interpret mode


@pytest.fixture(autouse=True)
def _no_launches():
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


def _close_to_scale(a, ref, tol):
    a, ref = np.asarray(a, np.float32), np.asarray(ref, np.float32)
    assert np.abs(a - ref).max() <= tol * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("fmt", ["groups", "mixed", "scalar", "unscaled"])
@pytest.mark.parametrize("d,h", [(320, 5), (192, 3)])
def test_int4_self_attention_odd_heads_matches_pallas(fmt, d, h):
    """Large-V3's 5 heads a shard over 4 model ranks (10 groups of 32
    channels, narrower than a head) and 3 heads: G and H over the int4
    and the mixed self caches."""
    rng = np.random.default_rng(31)
    l_dim, b, ctx, layer, pos = 2, 2, 64, 1, 37
    ng = decoder.self_kv_groups(d)
    v = rng.integers(0, 256, (l_dim, b, ctx, d // 2), dtype=np.uint8)
    if fmt == "mixed":
        k, sw = rng.integers(-127, 128, (l_dim, b, ctx, d), dtype=np.int8), 1 + ng
    else:
        k, sw = rng.integers(0, 256, (l_dim, b, ctx, d // 2), dtype=np.uint8), {"groups": 2 * ng, "scalar": 2,
                                                                                 "unscaled": 0}[fmt]
    sc = rng.uniform(0.01, 0.05, (l_dim, b, ctx, sw)).astype(np.float32) if sw else None
    q, kn, vn = (rng.standard_normal((b, 1, d)).astype(np.float32) * (0.1 if fmt == "unscaled" else 1.0)
                 for _ in range(3))
    jsc = None if sc is None else jnp.asarray(sc)
    tsc = None if sc is None else torch.from_numpy(sc)
    ref = j_merged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(pos), h,
                   jnp.asarray(kn), jnp.asarray(vn), kv_scale4=jsc, interpret=True)
    out = decode_attention_merged_int4(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tsc, layer,
                                       torch.tensor(pos, dtype=torch.int32), h, torch.from_numpy(kn),
                                       torch.from_numpy(vn))
    _close_to_scale(out, ref, 1e-5)
    ref = j_layer(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(pos), h,
                  kv_scale4=jsc, interpret=True)
    outs = decode_attention_layer_int4(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tsc, layer,
                                       torch.tensor(pos, dtype=torch.int32), h)
    for a, r in zip(outs, ref):
        _close_to_scale(a, r, 1e-5)


def _pack4(codes, axis):
    lo, hi = np.split((codes + 8).astype(np.uint8), 2, axis=axis)
    return lo | (hi << 4)


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("d,h", [(320, 5), (192, 3)])
def test_int4_cross_attention_odd_heads_matches_pallas(d, h, groups):
    """The int4 cross cache of a shard with an odd head count, in the JAX
    package's layout (channels j and j + D/2 share a byte, so heads h and
    h + H/2 share none): kernel C's plain version against K3."""
    rng = np.random.default_rng(41)
    l_dim, b, t, layer, valid = 2, 2, 128, 1, 100
    kc = rng.integers(-8, 8, (l_dim, b, d, t), dtype=np.int8)
    vc = rng.integers(-8, 8, (l_dim, b, t, d), dtype=np.int8)
    q = (rng.standard_normal((b * groups, 1, d)) * 0.3).astype(np.float32)
    kT, v = _pack4(kc, 2), _pack4(vc, 2)  # [L, B, D/2, T], [L, B, T/2, D]
    ref, _, _ = j_cross(jnp.asarray(q), jnp.asarray(kT), jnp.asarray(v), jnp.asarray(layer), jnp.asarray(valid), h,
                        batch_groups=groups, interpret=True, normalized=True)
    out = decode_cross_attention(torch.from_numpy(q), torch.from_numpy(kT), torch.from_numpy(v), layer, valid, h,
                                 groups)
    assert out.shape == (b * groups, 1, d)
    _close_to_scale(out, ref, 1e-5)


@pytest.mark.parametrize("order", [True, False], ids=["K4", "K7"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_without_fc2_bias_is_a_zero_bias(order, dtype):
    """Kernel I's plain version with fc2's bias left out (the sharded
    FFN's call, its bias added after the sum) equals it with a zero bias,
    bit for bit, in both bias orders."""
    g = torch.Generator().manual_seed(3)
    d, f = 64, 512
    lin = lambda k, n: {"qw": torch.randint(-8, 8, (2, k, n), generator=g, dtype=torch.int8),
                        "scales": torch.rand((2, k // 32, n), generator=g) * 0.01,
                        "b": torch.randn((2, n), generator=g) * 0.1}
    fc1, fc2 = lin(d, f), lin(f, d)
    x = torch.randn((5, d), generator=g).to(dtype)
    unbiased = {k: v for k, v in fc2.items() if k != "b"}
    zero = {**fc2, "b": torch.zeros_like(fc2["b"])}
    out = fused_ffn(x, fc1, unbiased, "erf", layer=1, bias_after_round=order)
    assert torch.equal(out, fused_ffn(x, fc1, zero, "erf", layer=1, bias_after_round=order))


def test_dryrun_multichip_on_cpu_ranks(capfd):
    """``entry.dryrun_multichip``: a (1, 2) mesh of two CPU ranks, greedy
    and 2-beam, the serving configuration."""
    from whisper_burn_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip OK: mesh(data=1, model=2)" in capfd.readouterr().out
