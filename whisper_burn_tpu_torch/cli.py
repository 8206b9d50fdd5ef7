"""Command-line interface: transcribe, serve, evaluate, inspect, convert.

Port of ``whisper_burn_tpu/cli.py``, every subcommand with its options,
plus ``--device`` on the commands that build a pipeline: ``cuda`` by
default, ``cpu`` for the plain PyTorch versions (the tests' choice).
Without a CUDA device and without ``--device cpu`` those commands exit
with code 2 and ``resolve_device``'s message; nothing falls back to the
CPU. ``transcribe --dp/--tp`` runs on a ``(data, model)`` mesh of ranks,
one process each, started by ``torch.distributed.run`` (each rank on
``cuda:LOCAL_RANK`` with NCCL, or the CPU with gloo under ``--device
cpu``; rank 0 alone prints); ``--dp 0`` takes every rank left after
``--tp``. ``serve --dp/--tp`` runs the same way: rank 0 serves HTTP and
hands each batch to the other ranks, which follow it until it stops.

Usage:
    python -m whisper_burn_tpu_torch.cli transcribe audio.wav \\
        --model model-q4.gguf [--tokenizer tokenizer.json] [--language en]
    python -m torch.distributed.run --nproc-per-node 2 -m whisper_burn_tpu_torch.cli \\
        transcribe audio.wav --model model-q4.gguf --tp 2
    python -m whisper_burn_tpu_torch.cli serve --model model-q4.gguf --port 8000
    python -m torch.distributed.run --nproc-per-node 2 -m whisper_burn_tpu_torch.cli \\
        serve --model model-q4.gguf --dp 2
    python -m whisper_burn_tpu_torch.cli eval --model model-q4.gguf --manifest m.jsonl
    python -m whisper_burn_tpu_torch.cli info --model model-q4.gguf
    python -m whisper_burn_tpu_torch.cli convert --hf-model ./whisper-large-v3 \\
        --output model-q4.gguf
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _no_device(args: argparse.Namespace) -> bool:
    """True, with ``resolve_device``'s message on stderr, when ``--device``
    names no usable device (``cuda`` without a card)."""
    from whisper_burn_tpu_torch.ops.compute import resolve_device

    try:
        resolve_device(getattr(args, "device", None))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return True
    return False


def _mesh(args: argparse.Namespace):
    """The ``(data, model)`` mesh that ``--dp``/``--tp`` ask for, or None.
    Its shape is checked against the ranks (``WORLD_SIZE``, 1 outside
    ``torch.distributed.run``) before any process group starts, then this
    rank's group starts (``parallel/multihost.initialize``: torchrun's
    environment, or a one-rank group on a free local port) and the mesh
    is made on ``--device`` (``cuda`` means ``cuda:LOCAL_RANK``)."""
    dp, tp = getattr(args, "dp", 0), getattr(args, "tp", 0)
    if not (dp or tp):
        return None
    import os

    from whisper_burn_tpu_torch.parallel.mesh import make_mesh, mesh_shape
    from whisper_burn_tpu_torch.parallel.multihost import initialize

    mesh_shape(dp or None, tp or 1, int(os.environ.get("WORLD_SIZE", "1")))
    device = getattr(args, "device", None)
    device = None if device == "cuda" else device
    if "RANK" in os.environ:
        initialize(device=device)
    else:
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        initialize(f"localhost:{port}", 1, 0, device=device)
    return make_mesh(data=dp or None, model=tp or 1, device=device)


def build_pipeline(model_path: str, tokenizer_path: str | None, args: argparse.Namespace):
    """GGUF path (+ options namespace) -> ready WhisperPipeline on
    ``args.device``; shared by the transcribe, eval, parity and app commands."""
    from whisper_burn_tpu_torch.gguf.cache import load_whisper
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.tokenizer import WhisperTokenizer
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    model = load_whisper(model_path)  # repacked-cache-aware loader
    tokenizer = WhisperTokenizer.from_file(tokenizer_path) if tokenizer_path else None
    compute = Compute.fast() if getattr(args, "bf16", False) else Compute.parity()
    mesh = _mesh(args)
    return WhisperPipeline(
        model, tokenizer, compute=compute,
        frontend=getattr(args, "frontend", "openai"),
        beam_width=getattr(args, "beam", 1),
        max_tokens=getattr(args, "max_tokens", 224),
        profile=getattr(args, "profile", False),
        mesh=mesh,
        device=getattr(args, "device", None) if mesh is None else None,  # a mesh's: cuda:LOCAL_RANK
    )


def _cmd_transcribe(args: argparse.Namespace) -> int:
    if not (getattr(args, "dp", 0) or getattr(args, "tp", 0)):
        return _transcribe(args)
    import torch.distributed as dist

    started = not dist.is_initialized()
    try:
        return _transcribe(args)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _transcribe(args: argparse.Namespace) -> int:
    import contextlib

    from whisper_burn_tpu_torch.app_config import load_config
    from whisper_burn_tpu_torch.audio.io import load_wav

    # saved defaults fill in anything not given on the command line
    defaults = load_config()
    args.model = args.model or defaults.model
    args.tokenizer = args.tokenizer or defaults.tokenizer
    if args.model is None:
        print("no --model given and no saved default (see `config --set`)")
        return 2
    if _no_device(args):
        return 2

    pipe = build_pipeline(args.model, args.tokenizer, args)
    if pipe.mesh is not None:  # every rank decodes its share; rank 0 alone prints
        import torch.distributed as dist

        if dist.get_rank() != 0:
            args.json, args.profile, args.trace = False, False, None
            sys.stdout = open(os.devnull, "w")

    trace_cm = contextlib.nullcontext()
    if args.trace:
        from whisper_burn_tpu_torch.utils.profiling import trace

        trace_cm = trace(args.trace)

    with trace_cm as trace_path:
        results = []
        for path in args.audio:
            audio = load_wav(path)
            if args.long:
                results.append(pipe.transcribe_long(audio, language=args.language))
            else:
                results.append(pipe.transcribe(audio, language=args.language))

    if args.profile:
        print(pipe.profile_report(), file=sys.stderr)
    if args.trace:
        print(f"Chrome trace (torch.profiler) written to {trace_path}", file=sys.stderr)

    for path, result in zip(args.audio, results):
        if args.json:
            print(
                json.dumps(
                    {
                        "file": str(path),
                        "text": result.text,
                        "inference_ms": round(result.inference_ms, 2),
                        "lang_token": result.lang_token,
                        "n_tokens": len(result.tokens),
                    }
                )
            )
        else:
            print(f"{path}: {result.text}  [{result.inference_ms:.0f} ms]")
    return 0


def _cmd_info(args: argparse.Namespace) -> int:
    from whisper_burn_tpu_torch.gguf.loader import infer_config
    from whisper_burn_tpu_torch.gguf.reader import GgufReader

    r = GgufReader.open(args.model)
    cfg = infer_config(r)
    print(f"GGUF v{r.version}, {len(r.tensors)} tensors, align {r.alignment}")
    for k, v in r.metadata.items():
        print(f"  meta {k} = {v}")
    print(
        f"model: d={cfg.n_audio_state} heads={cfg.n_audio_head} "
        f"enc_layers={cfg.n_audio_layer} dec_layers={cfg.n_text_layer} "
        f"mels={cfg.n_mels} vocab={cfg.n_vocab} n_lang={cfg.n_lang}"
    )
    by_dtype: dict[str, int] = {}
    for info in r.tensors.values():
        by_dtype[info.dtype.name] = by_dtype.get(info.dtype.name, 0) + info.nbytes
    for dtype, nbytes in sorted(by_dtype.items()):
        print(f"  {dtype}: {nbytes / 1e6:.1f} MB")
    return 0


def _cmd_eval(args: argparse.Namespace) -> int:
    if _no_device(args):
        return 2
    from whisper_burn_tpu_torch.eval.runner import evaluate_manifest

    pipe = build_pipeline(args.model, args.tokenizer, args)
    summary = evaluate_manifest(pipe, args.manifest, batch_size=args.batch, language=args.language)
    print(
        json.dumps(
            {
                "n": summary.n_utterances,
                "wer": round(summary.wer, 4),
                "audio_s": round(summary.audio_seconds, 1),
                "rtf": round(summary.rtf, 2),
            }
        )
    )
    return 0


def _cmd_download(args: argparse.Namespace) -> int:
    from whisper_burn_tpu_torch.download import download_model

    def progress(received, total):
        if total:
            print(f"\r{received / 1e6:.0f}/{total / 1e6:.0f} MB", end="", flush=True)

    gguf, tok = download_model(args.variant, args.models_dir, progress)
    print(f"\n{gguf}\n{tok}")
    return 0


def _cmd_models(args: argparse.Namespace) -> int:
    from whisper_burn_tpu_torch.download import list_installed_models

    for path, size in list_installed_models(args.models_dir):
        print(f"{path}  {size / 1e6:.1f} MB")
    return 0


def serving_compute(args: argparse.Namespace):
    """``serve``'s compute: ``--compute`` (parity, fast, fastest), then
    ``--self-kv int4`` (int4 self keys and values), ``--w8a8`` (int8 x int8
    encoder matmuls) and ``--int8-logits`` (the int8 tied-embedding logits)."""
    from whisper_burn_tpu_torch.ops.compute import Compute

    compute = {"parity": Compute.parity, "fast": Compute.fast, "fastest": Compute.fastest}[args.compute]()
    if getattr(args, "self_kv", None) == "int4":
        compute = compute.replace(self_kv_bits=4)
    if getattr(args, "w8a8", False):
        compute = compute.replace(w8a8=True)
    if getattr(args, "int8_logits", False):
        compute = compute.replace(quantized_logits=True)
    return compute


def _cmd_serve(args: argparse.Namespace) -> int:
    if _no_device(args):
        return 2
    import torch.distributed as dist

    mesh = _mesh(args)
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None and dist.is_initialized():
            dist.destroy_process_group()


def _serve(args: argparse.Namespace, mesh) -> int:
    """``serve`` on this rank: without a mesh, or on a mesh's rank 0, the
    HTTP server until SIGINT (exit 1 if a rank failed); on every other rank
    of the mesh, :func:`serving.follow_batches` until rank 0 stops."""
    from whisper_burn_tpu_torch.gguf.cache import load_whisper
    from whisper_burn_tpu_torch.serving import follow_batches, run_until_interrupted, serve_http
    from whisper_burn_tpu_torch.tokenizer import WhisperTokenizer
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    group, rank = None, 0
    if mesh is not None:  # every rank makes it, right after the mesh's groups
        import torch.distributed as dist

        from whisper_burn_tpu_torch.parallel.multihost import control_group

        group, rank = control_group(), dist.get_rank()
        print(f"rank {rank} of {dist.get_world_size()}: mesh {mesh.data}x{mesh.model} over "
              f"{dist.get_backend()}", file=sys.stderr, flush=True)
    model = load_whisper(args.model)
    tokenizer = WhisperTokenizer.from_file(args.tokenizer) if args.tokenizer else None
    pipe = WhisperPipeline(
        model, tokenizer, compute=serving_compute(args), beam_width=args.beam, mesh=mesh,
        device=args.device if mesh is None else None,
    )
    if rank != 0:
        n = follow_batches(pipe, group)
        print(f"rank {rank}: followed {n} batches", file=sys.stderr, flush=True)
        return 0
    server, transcriber = serve_http(pipe, host=args.host, port=args.port, batch_size=args.batch, group=group)
    print(f"serving on http://{server.server_address[0]}:{server.server_address[1]}", flush=True)
    rc = run_until_interrupted(server, transcriber)
    if rc:
        print(f"error: serving stopped: {transcriber.fault!r}", file=sys.stderr)
    return rc


def _cmd_config(args: argparse.Namespace) -> int:
    import dataclasses

    from whisper_burn_tpu_torch.app_config import config_path, load_config, save_config

    cfg = load_config()
    if args.set:
        for pair in args.set:
            key, _, value = pair.partition("=")
            if not hasattr(cfg, key):
                print(f"unknown config key {key!r}")
                return 2
            field_type = type(getattr(cfg, key) or "")
            setattr(cfg, key, int(value) if field_type is int else value)
        save_config(cfg)
        print(f"saved {config_path()}")
    print(json.dumps(dataclasses.asdict(cfg), indent=2))
    return 0


def _cmd_convert(args: argparse.Namespace) -> int:
    from whisper_burn_tpu_torch.gguf.convert import convert_hf_model

    convert_hf_model(args.hf_model, args.output)
    print(f"wrote {args.output}")
    return 0


def _cmd_app(args: argparse.Namespace) -> int:
    if _no_device(args):
        return 2
    from whisper_burn_tpu_torch.app import run_terminal

    return run_terminal(args)


def _cmd_parity(args: argparse.Namespace) -> int:
    """Real-weights readiness harness.

    One command: resolve weights (path or download) -> transcribe
    ``--audio`` with parity numerics -> diff tokens against a recorded
    expected sequence -> optional WER manifest run. Missing weights or no
    network is SKIP (exit 0), a token mismatch is FAIL (exit 1).
    ``--record`` writes the expected file from the current run (once, on
    a machine that has the real checkpoint).

    Every outcome (PASS / FAIL / NO-BASELINE / SKIP+reason) is also written
    to ``--status-out`` as a dated machine-readable record, with every
    weight-intake step tried.
    """
    import datetime
    import os

    def _write_status(status: str, reason: str, extra: dict | None = None) -> None:
        if not args.status_out:
            return
        payload = {
            "status": status,
            "reason": reason,
            "date": datetime.datetime.now(datetime.timezone.utc).isoformat(timespec="seconds"),
            "audio": str(args.audio),
            "variant": args.variant,
            "expected": str(args.expected),
            **(extra or {}),
        }
        with open(args.status_out, "w") as f:
            json.dump(payload, f, indent=1)

    # weight intake: GGUF path -> local HF checkpoint dir (converted
    # in-process) -> download -> HF hub cache scan
    chain: list[dict] = []

    def _convert_hf_dir(hf_dir: str) -> tuple[str, str | None]:
        """Convert a local HF Whisper checkpoint dir to Q4_0 GGUF."""
        from whisper_burn_tpu_torch.gguf.convert import convert_hf_model

        tag = os.path.basename(os.path.normpath(hf_dir)) or "hf"
        out = os.path.join(args.models_dir, f"{tag}-q4.gguf")
        os.makedirs(args.models_dir, exist_ok=True)
        if not os.path.exists(out):
            convert_hf_model(hf_dir, out)
        tok = os.path.join(hf_dir, "tokenizer.json")
        return out, (tok if os.path.exists(tok) else None)

    def _scan_hf_cache() -> str | None:
        """Find a whisper checkpoint snapshot in the HF hub cache."""
        import glob

        hub = os.path.join(os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface")), "hub")
        # the exact repo name: a substring test would let large-v3 match
        # large-v3-turbo (and medium match medium.en)
        want = f"whisper-{args.variant.replace('_', '-')}"
        for repo in sorted(glob.glob(os.path.join(hub, "models--*whisper*"))):
            name = os.path.basename(repo).split("--")[-1]
            if name != want:
                continue
            for snap in sorted(glob.glob(os.path.join(repo, "snapshots", "*"))):
                if os.path.exists(os.path.join(snap, "config.json")):
                    return snap
        return None

    model_path, tokenizer_path = args.model, args.tokenizer
    if model_path is not None and os.path.isdir(model_path):
        try:
            model_path, tok = _convert_hf_dir(model_path)
            tokenizer_path = tokenizer_path or tok
            chain.append({"step": "convert_hf_dir", "outcome": model_path})
        except Exception as e:
            print(f"SKIP: HF dir conversion failed ({e})")
            chain.append({"step": "convert_hf_dir", "outcome": f"error: {e}"})
            _write_status("SKIP", f"HF dir conversion failed: {e}", {"attempted": chain})
            return 0
    if model_path is None:
        try:
            from whisper_burn_tpu_torch import download

            model_path, tokenizer_path = download.download_model(args.variant, args.models_dir)
            chain.append({"step": "download", "outcome": str(model_path)})
        except Exception as e:
            chain.append({"step": "download", "outcome": f"{type(e).__name__}: {e}"})
            snap = _scan_hf_cache()
            if snap is None:
                chain.append({"step": "hf_cache_scan", "outcome": "no snapshot"})
                print(f"SKIP: no --model and download unavailable ({e})")
                _write_status(
                    "SKIP", f"no --model and download unavailable: {e}",
                    {"attempted": chain, "error_type": type(e).__name__},
                )
                return 0
            try:
                model_path, tok = _convert_hf_dir(snap)
                tokenizer_path = tokenizer_path or tok
                chain.append({"step": "hf_cache_convert", "outcome": model_path})
            except Exception as e2:
                chain.append({"step": "hf_cache_convert", "outcome": f"error: {e2}"})
                print(f"SKIP: HF cache conversion failed ({e2})")
                _write_status("SKIP", f"HF cache conversion failed: {e2}", {"attempted": chain})
                return 0
    if not os.path.exists(model_path):
        print(f"SKIP: model not found at {model_path}")
        _write_status("SKIP", f"model not found at {model_path}", {"attempted": chain})
        return 0
    if _no_device(args):
        return 2

    pipe = build_pipeline(str(model_path), tokenizer_path and str(tokenizer_path), args)
    from whisper_burn_tpu_torch.audio.io import load_wav

    audio = load_wav(args.audio)
    result = pipe.transcribe(audio, language=args.language)
    tokens = [int(t) for t in result.tokens]
    print(f"transcribed {args.audio}: {len(tokens)} tokens, {result.inference_ms:.0f} ms\n  text: {result.text!r}")

    if args.record:
        payload = {"audio": str(args.audio), "language": args.language, "tokens": tokens, "text": result.text}
        with open(args.expected, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"recorded expected sequence -> {args.expected}")
        return 0

    status = 0
    if not os.path.exists(args.expected):
        print(f"NO-BASELINE: {args.expected} not recorded yet (use --record once on a machine with the real "
              "checkpoint)")
        _write_status(
            "NO-BASELINE", f"{args.expected} not recorded yet", {"tokens_produced": len(tokens), "attempted": chain}
        )
    else:
        with open(args.expected) as f:
            expected = json.load(f)
        if expected["tokens"] == tokens:
            print(f"PASS: token-exact match ({len(tokens)} tokens)")
            _write_status("PASS", "token-exact match", {"tokens": len(tokens), "attempted": chain})
        else:
            exp = expected["tokens"]
            diverge = next((i for i, (a, b) in enumerate(zip(exp, tokens)) if a != b), min(len(exp), len(tokens)))
            print(f"FAIL: tokens diverge at position {diverge} (expected {len(exp)} tokens, got {len(tokens)})")
            _write_status(
                "FAIL", f"tokens diverge at position {diverge}",
                {"expected_tokens": len(exp), "got_tokens": len(tokens), "attempted": chain},
            )
            status = 1

    if args.manifest:
        from whisper_burn_tpu_torch.eval.runner import evaluate_manifest

        summary = evaluate_manifest(pipe, args.manifest, batch_size=args.batch, language=args.language)
        print(json.dumps({"n": summary.n_utterances, "wer": round(summary.wer, 4), "rtf": round(summary.rtf, 2)}))
        if args.wer_max is not None and summary.wer > args.wer_max:
            print(f"FAIL: WER {summary.wer:.4f} > --wer-max {args.wer_max}")
            status = 1
    return status


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", help="torch device (cpu runs the plain PyTorch versions)")


def _add_mesh(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", type=int, default=0, help="data-parallel mesh axis (0 = every rank after --tp)")
    p.add_argument("--tp", type=int, default=0, help="tensor-parallel mesh axis")


def build_parser() -> argparse.ArgumentParser:
    """Every subcommand with its options; each parsed namespace carries
    its command's function as ``fn``."""
    parser = argparse.ArgumentParser(prog="whisper_burn_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("transcribe", help="transcribe WAV files")
    t.add_argument("audio", nargs="+")
    t.add_argument("--model", default=None, help="GGUF checkpoint path")
    t.add_argument("--tokenizer", default=None, help="tokenizer.json path")
    t.add_argument("--language", default="auto")
    t.add_argument("--frontend", choices=["openai", "reference"], default="openai")
    t.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    t.add_argument("--beam", type=int, default=1, help="beam width (1 = greedy)")
    t.add_argument("--max-tokens", type=int, default=224, help="decode cap")
    t.add_argument("--long", action="store_true", help="30s-chunked long audio")
    t.add_argument("--json", action="store_true")
    t.add_argument("--profile", action="store_true",
                   help="print each span's host ms (device ms where it has them) and the throughput to stderr; "
                        "turns the launch log on for each call, adds no synchronize")
    t.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace (Perfetto-viewable) into DIR, with the program's "
                        "spans of every thread (category program_span); turns the launch log on")
    _add_mesh(t)
    _add_device(t)
    t.set_defaults(fn=_cmd_transcribe)

    i = sub.add_parser("info", help="inspect a GGUF checkpoint")
    i.add_argument("--model", required=True)
    i.set_defaults(fn=_cmd_info)

    c = sub.add_parser("convert", help="HF checkpoint -> Q4_0 GGUF")
    c.add_argument("--hf-model", required=True, help="a local HF checkpoint dir or a locally cached name")
    c.add_argument("--output", required=True)
    c.set_defaults(fn=_cmd_convert)

    e = sub.add_parser("eval", help="WER over a JSONL manifest (resumable)")
    e.add_argument("--model", required=True)
    e.add_argument("--tokenizer", default=None, help="tokenizer.json path (without one every text is empty)")
    e.add_argument("--manifest", required=True)
    e.add_argument("--language", default="en")
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--beam", type=int, default=1)
    e.add_argument("--bf16", action="store_true")
    _add_device(e)
    e.set_defaults(fn=_cmd_eval)

    d = sub.add_parser("download", help="fetch a model variant from HF")
    d.add_argument("variant", choices=["medium", "large-v3", "large-v3-turbo"])
    d.add_argument("--models-dir", default="models")
    d.set_defaults(fn=_cmd_download)

    m = sub.add_parser("models", help="list installed GGUFs")
    m.add_argument("--models-dir", default="models")
    m.set_defaults(fn=_cmd_models)

    sv = sub.add_parser("serve", help="HTTP transcription server (dynamic batching)")
    sv.add_argument("--model", required=True)
    sv.add_argument("--tokenizer", default=None)
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8000)
    sv.add_argument("--batch", type=int, default=8)
    sv.add_argument("--beam", type=int, default=1)
    sv.add_argument("--compute", choices=["parity", "fast", "fastest"], default="fastest")
    _add_mesh(sv)
    sv.add_argument("--self-kv", choices=["int8", "int4"], default="int8",
                    help="self-KV cache precision (int4 = packed keys and values)")
    sv.add_argument("--w8a8", action="store_true", help="int8 x int8 encoder matmuls")
    sv.add_argument("--int8-logits", action="store_true", help="int8 tied-embedding logits matmul")
    _add_device(sv)
    sv.set_defaults(fn=_cmd_serve)

    ap = sub.add_parser("app", help="interactive push-to-talk transcription")
    ap.add_argument("--model", default=None)
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--language", default=None)
    ap.add_argument("--frontend", choices=["openai", "reference"], default="openai")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--beam", type=int, default=1)
    ap.add_argument("--max-tokens", type=int, default=224)
    _add_device(ap)
    ap.set_defaults(fn=_cmd_app)

    pr = sub.add_parser("parity", help="real-weights token-parity harness (skips if offline)")
    pr.add_argument("--model", default=None, help="GGUF path (else download)")
    pr.add_argument("--tokenizer", default=None)
    pr.add_argument("--variant", default="large-v3", choices=["medium", "large-v3", "large-v3-turbo"])
    pr.add_argument("--models-dir", default="models")
    pr.add_argument("--audio", required=True, help="the WAV whose tokens are compared")
    pr.add_argument("--language", default="en")
    pr.add_argument("--expected", default="tests/data/parity_expected.json")
    pr.add_argument("--record", action="store_true", help="write the expected token sequence from this run")
    pr.add_argument("--manifest", default=None, help="JSONL manifest for WER")
    pr.add_argument("--wer-max", type=float, default=None)
    pr.add_argument("--batch", type=int, default=8)
    pr.add_argument("--max-tokens", type=int, default=224)
    pr.add_argument("--status-out", default="PARITY_STATUS.json",
                    help="machine-readable outcome record ('' disables)")
    _add_device(pr)
    pr.set_defaults(fn=_cmd_parity, frontend="openai", bf16=False, beam=1)

    cf = sub.add_parser("config", help="show or persist CLI defaults")
    cf.add_argument("--set", nargs="*", metavar="KEY=VALUE", default=[])
    cf.set_defaults(fn=_cmd_config)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
