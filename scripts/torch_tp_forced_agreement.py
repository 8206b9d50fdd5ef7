"""Teacher-forced agreement of the serving compute at mesh (1, 2) against
one rank, on one card, for each weight fixture.

    python scripts/torch_tp_forced_agreement.py [--fixtures random fabricated]

Two processes share the card over an explicit gloo group, as
``chip_smoke.py``'s ``scaleout_shared`` phase runs them: Large-V3 at full
width and depth from seed 0, B = 8 x 30 s of seeded audio, the serving
compute (``Compute.fastest(kv_bits=4)`` with int8 logits and W8A8), the
loop body driven step by step, 32 tokens. Rank 0 decodes greedily
alone; then both ranks decode at (1, 2) teacher-forced along that
trajectory, and the script prints, per fixture, the share of steps
before each stream's EOT at which the sharded argmax is the one-rank
token, with the one-rank run's median top-2 logit gap. Beside it, as
the fixture's own sensitivity to rounding, the same share for one rank's
serving compute teacher-forced along one rank's ``Compute.parity()``
(f32, TF32 off) trajectory: the measure the accuracy floors are set on.
``random`` is ``device_random_params`` (the accuracy sweep's iid fixture,
on which q4_int8kv's floor was set), ``fabricated`` is
``device_fabricated_params``. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


TOKENS = 32


def agreement(agree: list, n_gen: torch.Tensor) -> tuple[float, int]:
    """The share of steps k before each stream's EOT (k < n_generated) at
    which the argmax was the forced token; step k's row of ``agree`` is
    k - 1."""
    valid = torch.arange(1, TOKENS, device=n_gen.device)[:, None] < n_gen[None, :]
    return float(torch.stack(agree)[valid].float().mean()), int(valid.sum())


def rank_main(rank: int, port: int, fixture: str, out: Path) -> None:
    from chip_smoke import BATCH, SEED, eager_greedy
    from whisper_burn_tpu_torch.audio.mel import MelFrontend
    from whisper_burn_tpu_torch.models import params as P
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.parallel import make_mesh, shard_params_tp, tp_compute
    from whisper_burn_tpu_torch.parallel.multihost import initialize
    from whisper_burn_tpu_torch.transcribe import prepare_params

    dev = initialize(f"localhost:{port}", 2, rank, device="cuda:0", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = WhisperConfig.large_v3()
    serving = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=True)
    make = P.device_random_params if fixture == "random" else P.device_fabricated_params
    raw = make(cfg, seed=SEED, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    mel = MelFrontend(n_mels=cfg.n_mels, norm="slaney")(torch.randn((BATCH, 480_000), generator=g, device=dev) * 0.1)
    lang = torch.full((BATCH,), cfg.lang_token_start, dtype=torch.int32, device=dev)
    report = {"fixture": fixture}
    if rank == 0:
        gaps, agree = [], []

        def on_logits(k, logits):
            v = logits.topk(2, dim=-1).values
            gaps.extend((v[:, 0] - v[:, 1]).tolist())

        sparams = prepare_params(raw, serving)
        ref = eager_greedy(sparams, cfg, mel, lang, serving, TOKENS, on_logits=on_logits)
        report["one_rank_top2_gap_median"] = sorted(gaps)[len(gaps) // 2]
        parity = Compute.parity()
        f32 = eager_greedy(prepare_params(raw, parity), cfg, mel, lang, parity, TOKENS)
        eager_greedy(sparams, cfg, mel, lang, serving, TOKENS, forced=f32.tokens.long(),
                     on_logits=lambda k, lg: agree.append(lg.argmax(dim=-1) == f32.tokens[:, k]))
        report["one_rank_serving_vs_f32"] = agreement(agree, f32.n_generated)[0]
        del sparams
        forced = torch.cat([ref.tokens.long(), ref.n_generated.long()[:, None]], dim=1)
    else:
        forced = torch.zeros((BATCH, TOKENS + 1), dtype=torch.long, device=dev)
    torch.distributed.broadcast(forced, 0)
    forced, n_gen = forced[:, :TOKENS].contiguous(), forced[:, TOKENS]
    mesh = make_mesh(1, 2, device=dev)
    params = shard_params_tp(prepare_params(raw, serving, 2), mesh)
    agree = []
    eager_greedy(params, cfg, mel, lang, tp_compute(serving, mesh), TOKENS, forced=forced,
                 on_logits=lambda k, lg: agree.append(lg.argmax(dim=-1) == forced[:, k]))
    report["agreement"], report["steps"] = agreement(agree, n_gen)
    (out / f"rank{rank}.json").write_text(json.dumps(report))
    torch.distributed.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fixtures", nargs="+", default=["random", "fabricated"], choices=["random", "fabricated"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    for fixture in args.fixtures:
        with tempfile.TemporaryDirectory() as tmp, socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
            sock.close()
            procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r), str(port), fixture, tmp])
                     for r in range(2)]
            try:
                rcs = [p.wait(timeout=600) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if any(rcs):
                print(f"{fixture}: ranks exited {rcs}", file=sys.stderr)
                return 1
            reports = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(2)]
            print(json.dumps({**reports[0], "agreement_by_rank": [r["agreement"] for r in reports]}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], Path(sys.argv[5]))
        sys.exit(0)
    sys.exit(main())
