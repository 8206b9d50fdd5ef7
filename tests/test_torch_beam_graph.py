"""Kernel F's two forms and the beam loop's body as a function of device
state, against the JAX package, on the CPU.

* The slot form's plain version, the self K, V and scale rows in one call,
  against the Pallas slot writer (K9) in interpret mode plus the JAX
  package's ``dynamic_update_slice`` of the scales, in each self-cache
  form (int8, uint8 int4 pairs, the mixed int8 / uint8, bf16, f32) at
  positions 0, 7, 8 and T - 1: exact.
* The beam form's plain version against K9 followed by ``jnp.take`` of
  the three caches by parent stream (the JAX beam body's reorder), with
  random parents, identity parents and frozen utterances (identity for
  some, random for the others): exact on the rows up to the position.
* ``beam_decode`` through its runner's eager path (``models/beam.py``:
  ``beam_step`` over ``BeamState``, the self caches a pair of buffers)
  against the JAX ``beam_decode`` at ``WhisperConfig.tiny_test()``, in
  the serving compute (int4 cross, int8 self, int8 logits) in f32: at 2,
  3 and 4 tokens and at an even and an odd count of steps past
  MIN_TOKENS (both buffers of the pair end current), length penalties
  1.0 and 0.6, ``early_stopping`` both ways, W8A8 off and on: tokens,
  lengths and language tokens equal, scores within 1e-5.
* One cached runner serves two requests, its state and both buffers of
  the pair (the rows past each position too) poisoned with finite values
  in between: JAX's results both times.
"""

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
from whisper_burn_tpu.ops.pallas_cache import write_cache_slot as j_write_slot
from whisper_burn_tpu.transcribe import prepare_params as j_prepare

from whisper_burn_tpu_torch.models import beam
from whisper_burn_tpu_torch.models import whisper as w
from whisper_burn_tpu_torch.models.config import EOT, MIN_TOKENS, WhisperConfig
from whisper_burn_tpu_torch.models.params import random_params
from whisper_burn_tpu_torch.ops import _build
from whisper_burn_tpu_torch.ops.cache import write_cache_slots, write_cache_slots_beam
from whisper_burn_tpu_torch.ops.compute import Compute
from whisper_burn_tpu_torch.transcribe import prepare_params

L, STREAMS, T = 2, 6, 16
# self-cache forms: (K storage, V storage, K width, V width, scale lanes)
FORMS = {
    "int8": (np.int8, np.int8, 256, 256, 2),
    "int4": (np.uint8, np.uint8, 128, 128, 8),
    "mixed": (np.int8, np.uint8, 256, 128, 5),
    "bf16": ("bf16", "bf16", 256, 256, 0),
    "f32": (np.float32, np.float32, 256, 256, 0),
}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    _build.reset_launches()
    yield
    assert sum(_build.LAUNCHES.values()) == 0


def _array(rng, dtype, shape) -> np.ndarray:
    """Random values of a storage dtype; bf16 as its int16 bit patterns."""
    if dtype == "bf16":
        return (rng.standard_normal(shape).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16).view(np.int16)
    if dtype == np.float32:
        return rng.standard_normal(shape).astype(np.float32)
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape, dtype=dtype)


def _torch(a: np.ndarray, dtype) -> torch.Tensor:
    t = torch.from_numpy(a.copy())
    return t.view(torch.bfloat16) if dtype == "bf16" else t


def _jax(a: np.ndarray, dtype):
    x = jnp.asarray(a)
    return jax.lax.bitcast_convert_type(x, jnp.bfloat16) if dtype == "bf16" else x


def _back(x, dtype) -> np.ndarray:
    """A JAX array as the numpy form of :func:`_array`."""
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.int16) if dtype == "bf16" else x)


def _ours(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _caches(rng, form: str, streams: int):
    """Numpy caches ``[L, streams, T, W]`` and new rows ``[L, streams, 1,
    W]`` with their dtypes: K, V and (quantized forms) the f32 scales."""
    kd, vd, kw, vw, lanes = FORMS[form]
    out = [(_array(rng, kd, (L, streams, T, kw)), _array(rng, kd, (L, streams, 1, kw)), kd),
           (_array(rng, vd, (L, streams, T, vw)), _array(rng, vd, (L, streams, 1, vw)), vd)]
    if lanes:
        out.append((_array(rng, np.float32, (L, streams, T, lanes)), _array(rng, np.float32, (L, streams, 1, lanes)),
                    np.float32))
    return out


def _j_slot(cache, new, pos: int, dtype):
    """The JAX decode step's slot write: K9 (interpret mode) where it takes
    the shape, else ``dynamic_update_slice`` (the scale rows)."""
    c, n = _jax(cache, dtype), _jax(new, dtype)
    out = j_write_slot(c, n, jnp.asarray(pos, jnp.int32), interpret=True)
    if out is None:
        assert dtype == np.float32 and cache.shape[-1] < 128  # only the scale rows leave K9
        out = jax.lax.dynamic_update_slice(c, n, (0, 0, pos, 0))
    return out


@pytest.mark.parametrize("pos", [0, 7, 8, T - 1])
@pytest.mark.parametrize("form", list(FORMS))
def test_slot_form_matches_pallas(form, pos):
    """One call writes K, V and the scale row exactly where the JAX step
    writes them, and nothing else."""
    rng = np.random.default_rng(pos)
    pairs = _caches(rng, form, STREAMS)
    ours = [(_torch(c, dt), _torch(n, dt)) for c, n, dt in pairs]
    write_cache_slots(ours, torch.tensor(pos, dtype=torch.int32))
    for (cache, _), (c, n, dt) in zip(ours, pairs):
        np.testing.assert_array_equal(_ours(cache), _back(_j_slot(c, n, pos, dt), dt))


PARENTS = ["random", "identity", "frozen"]


def _parents(kind: str, rng, b: int = 2, width: int = 3) -> np.ndarray:
    """Each stream's parent stream: a beam of its own utterance."""
    own = np.arange(b * width).reshape(b, width)
    parent = rng.integers(0, width, (b, width)) + np.arange(b)[:, None] * width
    if kind == "identity":
        parent = own
    elif kind == "frozen":  # the first utterance done: its gather is the identity
        parent[0] = own[0]
    return parent.reshape(-1).astype(np.int32)


@pytest.mark.parametrize("pos", [0, 8, T - 1])
@pytest.mark.parametrize("parents", PARENTS)
@pytest.mark.parametrize("form", list(FORMS))
def test_beam_form_matches_pallas_and_take(form, parents, pos):
    """The other buffer of the pair holds, up to the position, what K9 and
    the JAX body's ``jnp.take`` make of the step's buffer."""
    rng = np.random.default_rng(100 + pos)
    triples = _caches(rng, form, STREAMS)
    src = _parents(parents, rng)
    ours = [(_torch(_array(rng, dt, c.shape), dt), _torch(c, dt), _torch(n, dt)) for c, n, dt in triples]
    write_cache_slots_beam(ours, torch.from_numpy(src), torch.tensor(pos, dtype=torch.int32))
    for (y, _, _), (c, n, dt) in zip(ours, triples):
        ref = _back(jnp.take(_j_slot(c, n, pos, dt), jnp.asarray(src), axis=1), dt)
        np.testing.assert_array_equal(_ours(y)[:, :, : pos + 1], ref[:, :, : pos + 1])


# --------------------------------------------------------------------------
# the beam loop's body through the runner, against the JAX beam_decode

JCFG, CFG = JConfig.tiny_test(), WhisperConfig.tiny_test()
JC = JCompute.fastest(kv_bits=4).replace(
    quantized_logits=True, dtype=jnp.float32, precision=jax.lax.Precision.HIGHEST, backend=KernelBackend.PALLAS
)
TC = Compute.fastest(kv_bits=4).replace(quantized_logits=True, dtype=torch.float32)
B, W = 2, 3
EOT_SCALE = 2.5  # hypotheses are banked before the cap (tests/test_torch_beam.py)
# (max_tokens, length_penalty, early_stopping, W8A8): 1, 2 and 3 steps, then
# an even (8) and an odd (11) count past MIN_TOKENS
CASES = [(2, 1.0, False, False), (3, 0.6, True, False), (4, 1.0, False, True), (9, 0.6, False, False),
         (12, 1.0, True, True), (12, 0.6, False, True)]


@pytest.fixture(autouse=True)
def _one_thread():
    """tests/test_torch_beam.py says why: split f32 sums move a score."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mel(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((B, CFG.n_mels, 2 * CFG.n_audio_ctx)).astype(np.float32)


def _lang() -> np.ndarray:
    return np.full(B, CFG.lang_token_start, np.int32)


def _params(w8a8: bool):
    jparams = j_random_params(JCFG, seed=0)
    jparams["decoder"]["tok_emb"][EOT] *= EOT_SCALE
    params = random_params(CFG, seed=0, device="cpu")
    params["decoder"]["tok_emb"][EOT] *= EOT_SCALE
    return j_prepare(jparams, JC.replace(w8a8=w8a8)), prepare_params(params, TC.replace(w8a8=w8a8))


def _same(out, ref) -> float:
    np.testing.assert_array_equal(out.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(out.n_generated.numpy(), np.asarray(ref.n_generated))
    np.testing.assert_array_equal(out.lang_tokens.numpy(), np.asarray(ref.lang_tokens))
    gap = np.abs(out.scores.numpy() - np.asarray(ref.scores)).max()
    assert gap <= 1e-5, gap
    return gap


@pytest.mark.parametrize("max_tokens,length_penalty,early_stopping,w8a8", CASES)
def test_beam_body_matches_jax(max_tokens, length_penalty, early_stopping, w8a8):
    """The runner's eager body, step by step: JAX's beam tokens, lengths
    and language tokens, scores within 1e-5 (run with -s for the gaps);
    after max_tokens - 1 steps the buffer of the pair that the last step
    wrote is the current one, the first or the second by the case."""
    jparams, params = _params(w8a8)
    compute = TC.replace(w8a8=w8a8)
    kw = dict(beam_width=W, max_tokens=max_tokens, length_penalty=length_penalty, early_stopping=early_stopping)
    ref = j_beam(jparams, JCFG, jnp.asarray(_mel(1)), jnp.asarray(_lang()), JC.replace(w8a8=w8a8), **kw)
    w.clear_runners()
    out = beam.beam_decode(params, CFG, torch.from_numpy(_mel(1)), torch.from_numpy(_lang()), compute, **kw)
    gap = _same(out, ref)
    (runner,) = w.cached_runners()
    # every step ran (no done check below DONE_CHECK_EVERY): the last one
    # wrote buffer (max_tokens - 1) % 2 of the pair
    assert isinstance(runner, beam.BeamRunner) and int(runner.state.k) == max_tokens < w.DONE_CHECK_EVERY
    print(f"max_tokens={max_tokens} lp={length_penalty} early={early_stopping} w8a8={w8a8}: "
          f"n_generated {out.n_generated.tolist()}, scores differ by {gap:.3g}")
    w.clear_runners()


def test_beam_steps_by_hand_match_jax():
    """A fresh state stepped by hand with the module's functions (the
    eager reference that chip_smoke.py holds replays to), both buffers of
    the pair taken in turn, past MIN_TOKENS: JAX's results."""
    jparams, params = _params(False)
    kw = dict(beam_width=W, max_tokens=5)
    ref = j_beam(jparams, JCFG, jnp.asarray(_mel(1)), jnp.asarray(_lang()), JC.replace(w8a8=False), **kw)
    state = beam.new_beam_state(CFG, TC, B, W, w.self_cache_len(CFG, 5), 5, "cpu")
    lang = beam.start_beam_request(params, CFG, torch.from_numpy(_mel(1)), torch.from_numpy(_lang()), TC, state,
                                   detect=False, task="transcribe")
    for k in range(1, 5):
        assert int(state.k) == k
        beam.beam_step(params, CFG, state, TC, (k - 1) % 2, length_penalty=1.0, early_stopping=False)
    assert MIN_TOKENS < 5
    _same(beam.BeamResult(*beam.select_best(state, 1.0), lang), ref)


def test_reused_beam_runner_gives_jax_results_twice():
    """The second request reuses the first one's runner after its state,
    both buffers of the self-cache pair (every row, those past the
    positions too), the prompt's self cache and the cross cache were set
    to finite garbage: both give the JAX package's beam results."""
    jparams, params = _params(False)
    kw = dict(beam_width=W, max_tokens=12)
    w.clear_runners()
    runners = []
    for r, seed in enumerate((7, 8)):
        ref = j_beam(jparams, JCFG, jnp.asarray(_mel(seed)), jnp.asarray(_lang()), JC.replace(w8a8=False), **kw)
        out = beam.beam_decode(params, CFG, torch.from_numpy(_mel(seed)), torch.from_numpy(_lang()), TC, **kw)
        _same(out, ref)
        (runner,) = w.cached_runners()
        runners.append(runner)
        s = runner.state
        assert out.tokens.data_ptr() != s.tokens.data_ptr()  # the result outlives the runner's buffers
        if r == 0:
            s.k.fill_(40)
            s.cur.fill_(7)
            s.tokens.fill_(3)
            s.scores.fill_(-2.0)
            s.pool_scores.fill_(-1.0)
            s.pool_tokens.fill_(5)
            s.pool_ngen.fill_(2)
            s.done.fill_(True)
            for c in (*s.caches, s.prompt_cache):
                for t in (c.self_k, c.self_v, c.self_kv_scale, c.cross_k, c.cross_v, c.cross_k_scale, c.cross_v_scale):
                    if t is not None:
                        t.fill_(9)
    assert runners[0] is runners[1]
    w.clear_runners()
