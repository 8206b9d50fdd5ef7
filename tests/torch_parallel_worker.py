"""One rank of ``tests/test_torch_parallel.py``'s gloo group on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD PORT PARAMS.npz OUT_DIR [fault]

It loads the numpy parameters the test wrote (the JAX package's
``random_params`` at ``tiny_test().replace(n_audio_ctx=16)``, flattened
with "/" between keys) and the inputs beside them, runs the port's
sharded entry points at the test's meshes, then a server over the (2, 2)
mesh (rank 0 serves, the others follow), and writes what it got to
``OUT_DIR/rank<RANK>.npz`` and ``.json``. With ``fault`` it only serves,
on two ranks at mesh (2, 1) with a short control-group timeout, for the
test to kill rank 1 under it. It imports torch and the port only."""

from __future__ import annotations

import collections
import datetime
import io
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from whisper_burn_tpu_torch.models.config import WhisperConfig  # noqa: E402
from whisper_burn_tpu_torch.models.params import params_to_torch  # noqa: E402
from whisper_burn_tpu_torch import serving  # noqa: E402
from whisper_burn_tpu_torch.ops import _build, linear  # noqa: E402
from whisper_burn_tpu_torch.ops.compute import Compute  # noqa: E402
from whisper_burn_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    shard_params_tp,
    sharded_beam_decode,
    sharded_greedy_decode,
)
from whisper_burn_tpu_torch.parallel.audit import audit_mesh, predicted_collectives  # noqa: E402
from whisper_burn_tpu_torch.parallel.guard import ReplicationError  # noqa: E402
from whisper_burn_tpu_torch.parallel.multihost import (  # noqa: E402
    control_group,
    initialize,
    local_batch_to_global,
    process_local_slice,
)
from whisper_burn_tpu_torch.serving import (  # noqa: E402
    BatchingTranscriber,
    follow_batches,
    run_until_interrupted,
    serve_http,
)
from whisper_burn_tpu_torch.transcribe import WhisperPipeline, prepare_params  # noqa: E402

CFG = WhisperConfig.tiny_test().replace(n_audio_ctx=16)
COMPUTES = {
    "parity": Compute.parity(),
    # f32 with W8A8 off: its per-row int8 rounding turns one-ulp ties into code steps
    "fastest": Compute.fastest(kv_bits=4).replace(dtype=torch.float32),
    # the serving compute: bf16, W8A8 (its row scale over the local K
    # shard), the bf16 sums, int8 logits
    "serving": Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True),
}


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    params_path, out_dir = Path(sys.argv[4]), Path(sys.argv[5])
    torch.set_num_threads(1)  # the ranks share the host's cores
    initialize(f"localhost:{port}", world, rank, device="cpu")
    data = dict(np.load(params_path))
    inputs = {k[len("input/"):]: data.pop(k) for k in list(data) if k.startswith("input/")}
    raw = unflatten(data)
    mel, lang = torch.from_numpy(inputs["mel"]), torch.from_numpy(inputs["lang"])
    out, info = {}, {}

    # the mesh's coordinates, and its errors
    mesh = make_mesh(2, 2, device="cpu")
    info["mesh"] = [mesh.data, mesh.model, mesh.data_index, mesh.model_index]
    full = make_mesh(device="cpu")
    info["all_data"] = [full.data, full.model]
    try:
        make_mesh(5, 3, device="cpu")
    except ValueError as e:
        info["bad_mesh"] = str(e)
    info["local_slice"] = [process_local_slice(mesh, 8).start, process_local_slice(mesh, 8).stop]
    out["gathered_rows"] = local_batch_to_global(mesh, torch.full((2,), rank, dtype=torch.int32)).numpy()

    for name, compute in COMPUTES.items():
        params = shard_params_tp(prepare_params(params_to_torch(raw, "cpu"), compute, tp=2), mesh)
        res = sharded_greedy_decode(params, CFG, mel, lang, compute, mesh, max_tokens=8, debug_replication=True)
        out[f"greedy_{name}"], out[f"greedy_{name}_n"] = res.tokens.numpy(), res.n_generated.numpy()
        if name == "parity":
            beam = sharded_beam_decode(params, CFG, mel, lang, compute, mesh, beam_width=2, max_tokens=6)
            out["beam_tokens"], out["beam_scores"] = beam.tokens.numpy(), beam.scores.numpy()
            # the collectives: pure DP (4, 1), then DP x TP (2, 2)
            dp = make_mesh(4, 1, device="cpu")
            dp_params = shard_params_tp(prepare_params(params_to_torch(raw, "cpu"), compute), dp)
            for label, m, p in (("dp", dp, dp_params), ("dptp", mesh, params)):
                counts, total = audit_mesh(CFG, compute, m, p, mel, lang, max_tokens=8)
                info[f"audit_{label}"] = {"counts": counts, "total": total,
                                          "predicted": predicted_collectives(CFG, m, steps=7)}
            # the guard, with the row-parallel sums dropped
            linear.all_reduce, saved = (lambda x, group: x), linear.all_reduce
            try:
                sharded_greedy_decode(params, CFG, mel, lang, compute, mesh, max_tokens=6, debug_replication=True)
                info["guard"] = "no error"
            except ReplicationError as e:
                info["guard"] = f"ReplicationError: {e}"
            finally:
                linear.all_reduce = saved

    # the W8A8 row-parallel linear on this rank's shard of identical inputs
    compute = Compute.parity().replace(w8a8=True)
    w8 = shard_params_tp(prepare_params(params_to_torch(raw, "cpu"), compute, tp=2), mesh)
    x = torch.from_numpy(inputs["w8a8_x"])[:, mesh.model_index * 32:(mesh.model_index + 1) * 32]
    from whisper_burn_tpu_torch.parallel import tp_compute

    out["w8a8_y"] = linear.apply_reduce_linear(
        w8["encoder"]["blocks"]["attn_o"], x, tp_compute(compute, mesh), layer=1).numpy()

    # the pipeline, a batch of 6 (padded to 8: 4 a data rank)
    audios = [a for a in inputs["audio"]]
    pipe = WhisperPipeline((CFG, raw), compute=Compute.parity(), max_tokens=8, mesh=mesh)
    for i, r in enumerate(pipe.transcribe_batch(audios, ["en"] * len(audios))):
        out[f"pipeline_{i}"] = np.asarray(r.tokens)

    serve(rank, pipe, control_group(), inputs["tones"], out, info)
    _build.reset_launches()
    np.savez(out_dir / f"rank{rank}.npz", **out)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(info))
    torch.distributed.destroy_process_group()
    return 0


def wav_bytes(samples: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(np.round(np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def post(base: str, samples: np.ndarray, language: str) -> tuple[int, dict]:
    req = urllib.request.Request(f"{base}/v1/transcribe", data=wav_bytes(samples), headers={"X-Language": language},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def serve(rank: int, pipe: WhisperPipeline, group, tones: np.ndarray, out: dict, info: dict) -> None:
    """Rank 0: a ``BatchingTranscriber`` (batch 3, 100 ms) over the meshed
    pipeline given the five tones in order, then ``serve_http`` (batch 3),
    idle for 0.3 s, given a POST in "en", one in an unknown language and
    one more in "en", each stopped in turn; every other rank follows each
    of the two. The keep-alive comes every 50 ms here, and rank 0 counts
    its messages by kind."""
    serving.KEEPALIVE_S = 0.05
    if rank != 0:
        info["followed"] = [follow_batches(pipe, group), follow_batches(pipe, group)]
        return
    sent, send = collections.Counter(), serving._send

    def counting(group, kind, batch=None):
        sent[kind] += 1
        send(group, kind, batch)

    serving._send = counting
    transcriber = BatchingTranscriber(pipe, batch_size=3, max_wait_ms=100, group=group)
    try:
        results = [r.wait(timeout=120) for r in [transcriber.submit(t, "en") for t in tones]]
    finally:
        snap = transcriber.shutdown(timeout=120)
    for i, r in enumerate(results):
        out[f"serving_{i}"] = np.asarray(r.tokens)
    info["serving"] = {"stats": snap, "handoffs": transcriber.handoffs, "lang_tokens": [r.lang_token for r in results]}
    server, transcriber = serve_http(pipe, port=0, batch_size=3, group=group)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        time.sleep(0.3)
        replies = [post(base, tones[0], "en"), post(base, tones[1], "xx"), post(base, tones[2], "en")]
    finally:
        server.shutdown()
        server.server_close()
        snap = transcriber.shutdown(timeout=120)
        thread.join(timeout=60)
    info["http"] = {"replies": replies, "stats": snap, "handoffs": transcriber.handoffs,
                    "sent": {name: sent[getattr(serving, name)] for name in ("_BATCH", "_STOP", "_KEEPALIVE")}}


FAULT_TIMEOUT = datetime.timedelta(seconds=10)


def fault(rank: int, world: int, port: int, params_path: Path, out_dir: Path) -> int:
    """Serve at mesh (2, 1), the control group's timeout FAULT_TIMEOUT:
    rank 0 writes its port to ``OUT_DIR/port`` and serves until a fault;
    rank 1 writes ``OUT_DIR/following`` and follows (the test kills it)."""
    torch.set_num_threads(1)
    initialize(f"localhost:{port}", world, rank, device="cpu")
    mesh = make_mesh(2, 1, device="cpu")
    group = control_group(timeout=FAULT_TIMEOUT)
    pipe = WhisperPipeline((CFG, unflatten(dict(np.load(params_path)))), compute=Compute.parity(), max_tokens=8,
                           mesh=mesh)
    if rank != 0:
        (out_dir / "following").touch()
        follow_batches(pipe, group)
        return 0
    server, transcriber = serve_http(pipe, port=0, batch_size=2, group=group)
    (out_dir / "port.tmp").write_text(str(server.server_address[1]))
    (out_dir / "port.tmp").rename(out_dir / "port")
    rc = run_until_interrupted(server, transcriber)
    print(f"rank 0: run_until_interrupted returned {rc}: {transcriber.fault!r}", flush=True)
    return rc


if __name__ == "__main__":
    if sys.argv[6:] == ["fault"]:
        sys.exit(fault(*(int(a) for a in sys.argv[1:4]), Path(sys.argv[4]), Path(sys.argv[5])))
    sys.exit(main())
