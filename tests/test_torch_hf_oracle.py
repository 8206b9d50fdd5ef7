"""The port's HF oracle (``eval/hf_oracle.py``) at the toy dims of
``tests/test_hf_oracle.py`` (D 256, so the Q4_0 policy quantizes): the
GGUF write-back lands the dequantized Q4 weights in the HF model, HF
``generate()`` and the port's f32 greedy decode then agree token for
token, and the port's intake path loads the parameters the JAX one loads,
bit for bit. ``scripts/torch_hf_realdims_parity.py`` runs the protocol at
Large-V3 width."""

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from whisper_burn_tpu.eval.hf_oracle import convert_and_load as j_convert_and_load

from whisper_burn_tpu_torch.eval.hf_oracle import (
    agreement,
    build_hf_fixture,
    convert_and_load,
    hf_generate_greedy,
    writeback_gguf_to_hf,
)
from whisper_burn_tpu_torch.models.params import params_to_torch
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import prepare_params

DIMS = dict(d_model=256, n_heads=4, n_mels=8, vocab=51865, enc_layers=2, dec_layers=2, n_audio_ctx=16,
            n_text_ctx=64)


@pytest.fixture(scope="module")
def oracle():
    hf = build_hf_fixture(**DIMS)
    before = hf.model.encoder.layers[0].self_attn.q_proj.weight.detach().clone()
    blob, loaded = convert_and_load(hf)
    writeback_gguf_to_hf(hf, blob)
    return hf, before, blob, loaded


def test_writeback_applies_quantization(oracle):
    hf, before, _, _ = oracle
    after = hf.model.encoder.layers[0].self_attn.q_proj.weight.detach()
    assert not torch.equal(before, after)  # a 256-wide matrix went through Q4_0...
    assert (before - after).abs().max() < 0.1  # ...and moved by the quantization error only
    emb = hf.model.decoder.embed_tokens.weight.detach()
    assert torch.equal(emb, hf.proj_out.weight.detach())  # the tie holds


def test_post_writeback_generate_matches_ours(oracle):
    """Both stacks run the same effective weights: token-exact in f32."""
    hf, _, _, loaded = oracle
    cfg = loaded.config.replace(gelu="erf")
    mel = np.random.default_rng(3).standard_normal((2, cfg.n_mels, cfg.n_audio_ctx * 2)).astype(np.float32)
    langs = np.array([50259, 50261], np.int32)
    theirs = hf_generate_greedy(hf, cfg, mel, langs, max_new=16)
    params = prepare_params(params_to_torch(loaded.params, "cpu"), Compute.parity())
    res = greedy_decode(params, cfg, torch.from_numpy(mel), torch.from_numpy(langs), Compute.parity(),
                        max_tokens=16)
    ours, n_gen = res.tokens.numpy(), res.n_generated.numpy()
    for i in range(2):
        np.testing.assert_array_equal(ours[i][: n_gen[i]], theirs[i])
        assert agreement(ours[i], n_gen[i], theirs[i]) == 1.0


def test_convert_and_load_matches_jax(oracle):
    """The JAX intake path on the same HF model: the same GGUF bytes, the
    same config and every parameter bit for bit."""
    hf, _, blob, loaded = oracle
    j_blob, j_loaded = j_convert_and_load(hf)
    assert blob == j_blob
    assert loaded.config.__dict__ == j_loaded.config.__dict__

    def walk(a, b, path=()):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + (k,))
            else:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=str(path + (k,)))

    walk(loaded.params, j_loaded.params)


def test_agreement_counts_the_union():
    assert agreement(np.array([1, 2, 3]), 3, np.array([1, 2, 3])) == 1.0
    assert agreement(np.array([1, 2, 3]), 3, np.array([1, 9])) == 1 / 3
    assert agreement(np.array([1, 2]), 2, np.array([1, 2, 3, 4])) == 0.5
    assert agreement(np.array([]), 0, np.array([])) == 1.0
