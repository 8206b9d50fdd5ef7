"""One rank of ``tests/test_torch_parallel.py``'s gloo group on the CPU.

    python tests/torch_parallel_worker.py RANK WORLD PORT PARAMS.npz OUT_DIR

It loads the numpy parameters the test wrote (the JAX package's
``random_params`` at ``tiny_test().replace(n_audio_ctx=16)``, flattened
with "/" between keys) and the inputs beside them, runs the port's
sharded entry points at the test's meshes and writes what it got to
``OUT_DIR/rank<RANK>.npz``. It imports torch and the port only."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from whisper_burn_tpu_torch.models.config import WhisperConfig  # noqa: E402
from whisper_burn_tpu_torch.models.params import params_to_torch  # noqa: E402
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
from whisper_burn_tpu_torch.parallel.multihost import initialize, local_batch_to_global, process_local_slice  # noqa: E402
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

    _build.reset_launches()
    np.savez(out_dir / f"rank{rank}.npz", **out)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(info))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
