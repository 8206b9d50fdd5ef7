"""The control: the reference put in the program's place, its decoder
holding every activation in float8 e4m3, the precision below the
configuration's bf16 (its file's ``control``), read over the same prompts
and served tokens. The check has to fail it.

On the CPU at ``tiny_test()`` sizes the control runs through the whole
harness and, in the greedy cells, reads more than the program does. At the cell's own size on
the card (``python -m pytest benchmark/tests -k card``, one seed a cell;
``benchmark/calibrate.py`` with ``"control": true`` reads many) its run
comes out not correct."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.bench_tiny import tiny_run

CELLS = ["large-v3.offline-greedy", "turbo.serve-poisson", "large-v3.offline-beam5", "turbo.offline-greedy"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control's reading at the cell's own size")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_more_than_the_program_on_tiny(cell):
    out = tiny_run(cell, 2**31 + 4242, control=True)
    assert out["ctx"].control == out["ctx"].config["control"] == {"reference": "float8_e4m3fn"}
    r = out["readings"]
    if "beam" in cell:  # eight tokens a hypothesis: the tiny beam's score moves too little to order; the card's does
        assert r["control_max_score_err"] is not None and r["max_score_err"] is not None
    else:
        assert r["control_mean_logit_err"] > r["mean_logit_err"]


@pytest.mark.parametrize("kind", ["int4", "float8_e4m3fn"])
def test_the_lowered_logits_tables(kind):
    from types import SimpleNamespace

    gen = torch.Generator().manual_seed(3)
    emb = torch.randn(1024, 64, generator=gen) * 0.02
    from whisper_burn_tpu_torch.transcribe import quantize_logit_embedding

    dec = {"tok_emb": emb.clone().bfloat16(), "tok_emb_q": quantize_logit_embedding(emb)}
    whisper = harness.family_module("whisper")
    whisper.lower(SimpleNamespace(control={"logits": kind}), SimpleNamespace(params={"decoder": dec}))
    if kind == "int4":
        assert dec["tok_emb_q"]["qw"].abs().max() <= 7 and dec["tok_emb_q"]["qw"].dtype == torch.int8
        w = dec["tok_emb_q"]["qw"].float().reshape(2, 32, -1) * dec["tok_emb_q"]["scales"][:, None, :]
        err = (w.reshape(64, -1)[:, :1024] - emb.T).abs().max() / emb.abs().max()
        assert 1 / 64 < err <= 1 / 14 + 1e-3  # int4's rounding, not int8's
    else:
        rel = ((dec["tok_emb"].float() - emb).abs().max() / emb.abs().max()).item()
        assert 2**-9 < rel <= 2**-4 + 2**-8  # float8 e4m3's rounding, above bf16's


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_check_on_the_card(card, cell):
    from benchmark.run import run_cell

    out = run_cell(cell, 2**31 + 4243, 10.0, False, "cuda", control=True)
    assert not out["result"]["correct"], out["readings"]
