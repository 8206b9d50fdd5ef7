"""Beam search of the PyTorch port against the JAX package's, on the CPU in
f32, at the small config of tests/test_torch_slice.py, through the plain
versions (no kernel launch).

Random weights never rank EOT high, so every hypothesis would run to the
token cap and the banked pool would never decide. Both sides scale the EOT
row of the token embedding by EOT_SCALE (before the int8 logits copy is
made), so hypotheses are banked and the utterances finish before the cap.
The done heuristic compares scores that agree between the two packages to
about 1e-5; EOT_SCALE = 3.0 puts one of its comparisons within 6e-6 of a
tie with W8A8 off (the two sides then stop at different steps), 2.5 does
not.

The port runs on one CPU thread here. Its f32 products split their sums
by the thread count (the best score read -9.4005680 at 8 threads and
-9.4005795 at 1, against the JAX package's -9.4005785), and the BLAS
library may lower the count at run time on a loaded machine; a one-ulp
change at an int8 rounding tie of the self cache then moves later scores
by up to about 3e-4, which failed the 1e-4 limit in one of a dozen runs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from whisper_burn_tpu.models import WhisperConfig as JConfig
from whisper_burn_tpu.models.beam import beam_decode as j_beam
from whisper_burn_tpu.models.params import random_params as j_random_params
from whisper_burn_tpu.ops import Compute as JCompute
from whisper_burn_tpu.ops.compute import KernelBackend
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models import beam
from whisper_burn_tpu_torch.models.beam import beam_decode
from whisper_burn_tpu_torch.models.config import EOT, WhisperConfig
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.models.whisper import greedy_decode
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import prepare_params

SMALL = dict(
    n_audio_state=256, n_text_state=256, n_audio_head=4, n_text_head=4,
    n_audio_ctx=128, n_text_ctx=64,
)
JCFG = JConfig.tiny_test().replace(**SMALL)
CFG = WhisperConfig.tiny_test().replace(**SMALL)
JC = JCompute.fastest(kv_bits=4).replace(
    quantized_logits=True, w8a8=False, dtype=jnp.float32,
    precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS,
)
TC = Compute.fastest(kv_bits=4).replace(quantized_logits=True, w8a8=False, dtype=torch.float32)
B, W, STEPS = 2, 3, 10
EOT_SCALE = 2.5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mel():
    return np.random.default_rng(1).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def _lang():
    return np.full(B, CFG.lang_token_start, np.int32)


def _params(w8a8: bool):
    jparams = j_random_params(JCFG, seed=0)
    jparams["decoder"]["tok_emb"][EOT] *= EOT_SCALE
    params = random_params(CFG, seed=0, device="cpu")
    params["decoder"]["tok_emb"][EOT] *= EOT_SCALE
    return (
        j_prepare(jparams, JC.replace(w8a8=w8a8)),
        prepare_params(params, TC.replace(w8a8=w8a8)),
    )


@pytest.fixture(scope="module")
def params():
    return _params(False)[1]


@pytest.mark.parametrize("w8a8,early_stopping,length_penalty", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 0.5),
])
def test_beam_decode_matches_jax(mel, w8a8, early_stopping, length_penalty):
    """W=3: the same tokens, lengths and language tokens; scores to 1e-4
    (run with -s for the readings). The third case stops an utterance once
    its pool is full and normalizes by the square root of the length."""
    jparams, params = _params(w8a8)
    kw = dict(beam_width=W, max_tokens=STEPS, early_stopping=early_stopping, length_penalty=length_penalty)
    ref = j_beam(jparams, JCFG, jnp.asarray(mel), jnp.asarray(_lang()), JC.replace(w8a8=w8a8), **kw)
    _build.reset_launches()
    out = beam_decode(params, CFG, torch.from_numpy(mel), torch.from_numpy(_lang()), TC.replace(w8a8=w8a8), **kw)
    assert sum(_build.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
    np.testing.assert_array_equal(out.lang_tokens.numpy(), np.asarray(ref.lang_tokens))
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(ref.scores), rtol=0, atol=1e-4)
    assert (out.n_generated < STEPS).all()  # banked hypotheses won, before the cap
    print(f"w8a8={w8a8} early_stopping={early_stopping} length_penalty={length_penalty}: "
          f"tokens {out.n_generated.tolist()}, scores differ by {np.abs(out.scores.numpy() - np.asarray(ref.scores)).max():.3g}")


def test_beam_width_1_matches_greedy(params, mel):
    """W=1 beam search is greedy search, EOT stops included."""
    args = (params, CFG, torch.from_numpy(mel), torch.from_numpy(_lang()), TC)
    g = greedy_decode(*args, max_tokens=STEPS)
    b = beam_decode(*args, beam_width=1, max_tokens=STEPS)
    np.testing.assert_array_equal(g.tokens.numpy(), b.tokens.numpy())
    np.testing.assert_array_equal(g.n_generated.numpy(), b.n_generated.numpy())
    assert (g.n_generated < STEPS).all()


def test_beam_result_independent_of_done_check_interval(params, mel, monkeypatch):
    """Done utterances freeze, so the steps run after every utterance is
    done (until the loop reads the flag) change nothing: checking every
    step and every 16 steps give the same result."""
    steps = []

    def counted(*args, **kw):
        steps.append(args[3])
        return decode_step(*args, **kw)

    decode_step = beam.decode_step
    monkeypatch.setattr(beam, "decode_step", counted)
    runs = {}
    for every in (1, 16):
        monkeypatch.setattr(beam, "DONE_CHECK_EVERY", every)
        steps.clear()
        runs[every] = beam_decode(params, CFG, torch.from_numpy(mel), torch.from_numpy(_lang()), TC,
                                  beam_width=W, max_tokens=20), len(steps)
    (one, n_one), (sixteen, n_sixteen) = runs[1], runs[16]
    assert n_one < n_sixteen == 15  # the interval-1 loop stopped early
    for a, b in zip(one, sixteen):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
