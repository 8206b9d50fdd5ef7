"""At ``tiny_test()`` sizes on the CPU the plain reference agrees with the
port in ``Compute.parity()`` (float32): its log-mel with the port's
frontend, its teacher-forced logits with the port's, and a greedy
request's served tokens lie at its best logits."""

import numpy as np
import pytest
import torch

from benchmark import model_config, reference
from benchmark.weights import make_weights

S = model_config.tiny_shape()
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def setup():
    from whisper_burn_tpu_torch.models.config import WhisperConfig
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.transcribe import prepare_params

    weights = make_weights(S, SEED, "cpu")
    cfg = WhisperConfig.tiny_test().replace(gelu="erf")
    rng = np.random.default_rng(5)
    audio = (rng.standard_normal((2, S.n_audio_ctx * 2 * reference.HOP)) * 0.1).astype(np.float32)
    return weights, cfg, prepare_params(weights, Compute.parity()), torch.from_numpy(audio)


def test_log_mel_matches_the_port(setup):
    from whisper_burn_tpu_torch.audio.mel import MelFrontend

    _, _, _, audio = setup
    got = reference.log_mel(audio, S.n_mels)
    want = MelFrontend(n_mels=S.n_mels, norm="slaney")(audio)
    assert got.shape == want.shape == (2, S.n_mels, 2 * S.n_audio_ctx)
    assert (got - want).abs().max().item() < 1e-4


def test_teacher_forced_logits_match_the_port(setup):
    from whisper_burn_tpu_torch.eval.quant_accuracy import forced_logits
    from whisper_burn_tpu_torch.ops.compute import Compute

    weights, cfg, params, audio = setup
    mel = reference.log_mel(audio, S.n_mels)
    langs = torch.tensor([50259, 50300], dtype=torch.int32)
    steps = 6
    tokens = torch.tensor([[11, 400, 7, 51000, 9], [3, 3, 50000, 12, 100]])
    port = forced_logits(params, cfg, mel, langs, tokens, Compute.parity(), steps, graph=False)  # [steps, B, Vp]
    ref = reference.Reference(S, weights)
    with torch.no_grad():
        feats = ref.encode(mel)
        for b in range(2):
            seq = [model_config.SOT, int(langs[b]), S.transcribe_token, S.no_timestamps_token] + tokens[b, : steps - 1].tolist()
            got = ref.logits(ref.cross_kv(feats, [b]), torch.tensor([seq]))[0][0, model_config.PROMPT_LEN - 1 :]
            want = port[:, b, : S.n_vocab]
            assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item() + 1e-5


def test_greedy_tokens_of_the_port_lie_at_the_reference_best(setup):
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    from benchmark.observe import Observer

    weights, cfg, _, audio = setup
    pipe = WhisperPipeline((cfg, weights), compute=Compute.parity(), max_tokens=8, device="cpu")
    observer = Observer(pipe, 8)
    try:
        results = pipe.transcribe_batch([a.numpy() for a in audio], ["auto", "en"])
    finally:
        observer.close()
    served = [reference.Served(a.numpy(), 16000, r.lang_token, i == 0, r.tokens.tolist(), 8, r.observed)
              for i, (a, r) in enumerate(zip(audio, results))]
    got = reference.judge(reference.Reference(S, weights), served, torch.device("cpu"))
    assert got["tokens_judged"] >= 16 and got["flipped"] == 0
    assert got["max_lp_err"] < 1e-4 and got["max_lang_err"] < 1e-4


def test_beam_scores_of_the_port_are_the_reference_sums(setup):
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    from benchmark.observe import Observer

    weights, cfg, _, audio = setup
    pipe = WhisperPipeline((cfg, weights), compute=Compute.parity(), max_tokens=8, beam_width=3, device="cpu")
    observer = Observer(pipe, 8)
    try:
        results = pipe.transcribe_batch([a.numpy() for a in audio], ["en", "en"])
    finally:
        observer.close()
    served = [reference.Served(a.numpy(), 16000, r.lang_token, False, r.tokens.tolist(), 8, r.observed)
              for a, r in zip(audio, results)]
    got = reference.judge(reference.Reference(S, weights), served, torch.device("cpu"))
    assert got["requests_judged"] == 2 and got["max_score_err"] < 1e-4


def test_mel_filters_are_slaney_triangles():
    fb = reference.mel_filters(S.n_mels)  # [201, n_mels]
    assert fb.shape == (reference.N_FFT // 2 + 1, S.n_mels) and (fb >= 0).all()
    assert reference.slaney_mel(1000.0) == pytest.approx(15.0) and reference.slaney_hz(42.0) == pytest.approx(6400.0)
    hz = np.linspace(0.0, reference.RATE / 2, reference.N_FFT // 2 + 1)
    # each filter's area in Hz is 1 (Slaney's norm), up to the bins' coarse sampling of its triangle
    area = (fb * (hz[1] - hz[0])).sum(axis=0)
    assert np.allclose(area, 1.0, atol=0.15)


NUMERICS = {  # the port's compute at f32 activations, and what the reference works out again of it
    "int8 self cache": ({"self_kv_dtype": torch.int8}, {"self_int8": True}),
    "int8 cross cache": ({"kv_dtype": torch.int8}, {"cross_bits": 8}),
    "int4 cross cache": ({"kv_dtype": torch.int8, "kv_bits": 4}, {"cross_bits": 4}),
    "int8 logits": ({"quantized_logits": True}, {"logits_int8": True}),
    "w8a8": ({"w8a8": True}, {"w8a8": True}),
    "all": ({"self_kv_dtype": torch.int8, "kv_dtype": torch.int8, "kv_bits": 4, "quantized_logits": True, "w8a8": True},
            {"cross_bits": 4, "self_int8": True, "logits_int8": True, "w8a8": True}),
}


@pytest.mark.parametrize("case", list(NUMERICS))
def test_the_reference_works_out_the_stored_numbers_again(setup, case):
    """With the port's activations in f32, the reference that models the
    configuration's stored numbers (``Numerics``) reads what the port
    says to within the summation order (the int8 logits table to 2e-4), and
    a reference that does not model them reads more."""
    from whisper_burn_tpu_torch.ops.compute import Compute
    from whisper_burn_tpu_torch.transcribe import WhisperPipeline

    from benchmark.observe import Observer

    weights, cfg, _, audio = setup
    change, numerics = NUMERICS[case]
    pipe = WhisperPipeline((cfg, weights), compute=Compute.parity().replace(**change), max_tokens=8, device="cpu")
    observer = Observer(pipe, 8)
    try:
        results = pipe.transcribe_batch([a.numpy() for a in audio], ["auto", "en"])
    finally:
        observer.close()
    served = [reference.Served(a.numpy(), 16000, r.lang_token, i == 0, r.tokens.tolist(), 8, r.observed)
              for i, (a, r) in enumerate(zip(audio, results))]
    modelled = reference.judge(reference.Reference(S, weights, reference.Numerics(**numerics)), served, torch.device("cpu"))
    plain = reference.judge(reference.Reference(S, weights), served, torch.device("cpu"))
    assert modelled["max_logit_err"] < 5e-4 and modelled["max_lang_err"] < 1e-5
    assert plain["mean_logit_err"] > 10 * modelled["mean_logit_err"]
