"""The port's decode loop against the JAX engine's (`_get_decode_loop`,
fish_speech_tpu/generate/engine.py:585-711) at the same decode_unroll:
the counterpart of tests/test_decode_unroll.py's eight cases, each run at
U in {1, 2, 4} on that file's tiny config (float32, temp 0.7 / top_p 0.8
/ top_k 16 / rep-pen 1.3, the static engines' own key chains).

The port draws the JAX engine's Gumbel noise (`JaxStaticKeys` below, in
place of the engine's torch.Generator) and runs eagerly on the CPU, the
same `_decode_body` its CUDA graphs capture. Tokens, valid flags, steps,
done flags and positions are compared exactly; the hidden trace within
1e-5 (float32 products summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.engine import LMEngine as JaxEngine
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.generate.frame import FrameNoise
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.ops.sampling import SamplingArgs

torch.set_num_threads(1)

KW = dict(vocab_size=256, n_layer=2, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=32, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=41)
KNOBS = dict(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.3)
UNROLLS = (1, 2, 4)
HIDDEN_TOL = 1e-5


class JaxStaticKeys:
    """The draws of the JAX static engine's one key chain (engine.py:464,
    522; generate/frame.py:162, 223): each frame splits (chain, frame
    key), the frame key splits (rest, semantic key), the rest into one
    key a codebook step; each key gives Gumbel draws of the top-k width.
    Set as an engine's `_noise`."""

    def __init__(self, seed: int, head_width: int):
        self.key = jax.random.PRNGKey(seed)
        self.head_width = head_width

    def __call__(self, state, sampling, rows):
        self.key, frame_key = jax.random.split(self.key)
        rest, sem_key = jax.random.split(frame_key)
        b, k = len(rows), sampling.top_k
        sem = jax.random.gumbel(sem_key, (b, min(k, self.head_width)), jnp.float32)
        cbs = [jax.random.gumbel(cb, (b, min(k, KW["codebook_size"])), jnp.float32)
               for cb in jax.random.split(rest, KW["num_codebooks"])]
        return FrameNoise(semantic=torch.from_numpy(np.array(sem)),
                          codebooks=[torch.from_numpy(np.array(c)) for c in cbs])


@pytest.fixture(scope="module")
def params():
    jparams = init_dual_ar_params(jax.random.PRNGKey(0), jcfg.DualARConfig(**KW),
                                  dtype=jnp.float32)
    return jparams, dual_ar_params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def engines(params):
    """(JAX engine, port engine) by (unroll, batch, int8), made once: the
    JAX engines keep their compiled loops across the cases."""
    made = {}

    def get(unroll, batch=1, int8=False):
        key = (unroll, batch, int8)
        if key not in made:
            kw = dict(batch_size=batch, cache_len=64, max_frames=24, prompt_buckets=(16,),
                      decode_unroll=unroll, quantize_int8=int8)
            made[key] = (
                JaxEngine(params[0], jcfg.DualARConfig(**KW), jcfg.TokenConfig(**TOK),
                          jcfg.WhichLM.FISH_1_5, dtype=jnp.float32, **kw),
                LMEngine(params[1], tcfg.DualARConfig(**KW), tcfg.TokenConfig(**TOK),
                         tcfg.WhichLM.FISH_1_5, dtype=torch.float32, device="cpu", **kw))
        return made[key]
    return get


def _prompt(seed, n=8):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(TOK["semantic_start_id"], TOK["semantic_end_id"],
                                        size=(1, n)),
                           np.zeros((KW["num_codebooks"], n), np.int64)]).astype(np.int32)


def _port(engine, seed):
    """The port engine drawing the JAX chain of `seed`."""
    engine._noise = JaxStaticKeys(seed, engine.head_width)
    return engine


def _generate(engines, unroll, prompt, max_new, seed, int8=False, collect_hidden=False):
    jeng, teng = engines(unroll, int8=int8)
    ref, _ = jeng.generate(prompt, max_new_tokens=max_new, sampling=JaxSampling(**KNOBS),
                           seed=seed, collect_hidden=collect_hidden)
    got, _ = _port(teng, seed).generate(prompt, max_new_tokens=max_new,
                                        sampling=SamplingArgs(**KNOBS), seed=seed,
                                        collect_hidden=collect_hidden)
    return got, ref


def _same_result(got, ref):
    np.testing.assert_array_equal(got.semantic, ref.semantic)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    assert (got.frames, got.hit_max) == (ref.frames, ref.hit_max)


def _same_chunk(got, ref):
    """(out, valid, steps) of the port and JAX: valid and steps exactly,
    the frames up to steps exactly (past it JAX's loop has stopped and
    left zeros; the port ran on and wrote EOS frames, all invalid)."""
    (out, valid, steps), (jout, jvalid, jsteps) = got, ref
    assert int(steps) == int(jsteps)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(out[:int(steps)].numpy(), np.asarray(jout)[:int(steps)])


@pytest.mark.parametrize("unroll", UNROLLS)
@pytest.mark.parametrize("max_new", [3, 4, 5, 8, 9])
def test_generate_matches_jax(engines, unroll, max_new):
    """generate() at step counts off and on the unroll boundary."""
    _same_result(*_generate(engines, unroll, _prompt(3), max_new, seed=7))


@pytest.mark.parametrize("unroll", UNROLLS)
def test_decode_chunk_carried_state(engines, unroll):
    """Three chunks of 4 frames on a carried state: each chunk's frames,
    valid flags and steps, then the carried pos, prev and done."""
    jeng, teng = engines(unroll)
    jstate = jeng.init_state(seed=5)
    jstate, jframe, _ = jeng.prefill(jstate, _prompt(9)[None], JaxSampling(**KNOBS))
    teng = _port(teng, 5)
    state = teng.init_state(seed=5)
    state, frame, _ = teng.prefill(state, _prompt(9)[None], SamplingArgs(**KNOBS))
    np.testing.assert_array_equal(frame.numpy(), np.asarray(jframe))
    for _ in range(3):
        jstate, jout, jvalid, jsteps = jeng.decode_chunk(jstate, JaxSampling(**KNOBS), 4)
        state, out, valid, steps = teng.decode_chunk(state, SamplingArgs(**KNOBS), 4)
        _same_chunk((out, valid, steps), (jout, jvalid, jsteps))
    for got, ref in ((state.pos, jstate.pos), (state.prev, jstate.prev),
                     (state.done, jstate.done)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("unroll", UNROLLS)
def test_already_done_state(engines, unroll):
    """A state that is done already: steps 0 and no valid frame, as in
    JAX, whose loop does not start."""
    jeng, teng = engines(unroll)
    jstate = jeng.init_state(seed=1)
    jstate, _, _ = jeng.prefill(jstate, _prompt(2)[None], JaxSampling(**KNOBS))
    jstate = jstate._replace(done=jnp.ones((1,), bool))
    _, jout, jvalid, jsteps = jeng.decode_chunk(jstate, JaxSampling(**KNOBS), 8)
    teng = _port(teng, 1)
    state = teng.init_state(seed=1)
    state, _, _ = teng.prefill(state, _prompt(2)[None], SamplingArgs(**KNOBS))
    state = state._replace(done=torch.ones((1,), dtype=torch.bool))
    _, out, valid, steps = teng.decode_chunk(state, SamplingArgs(**KNOBS), 8)
    assert int(steps) == int(jsteps) == 0 and not valid.any()
    _same_chunk((out, valid, steps), (jout, jvalid, jsteps))


@pytest.fixture(scope="module")
def mid_group_eos(engines):
    """A seed whose generation (budget 16) ends in an EOS at a step that
    is not a multiple of 4, found on the JAX unroll-1 engine as
    tests/test_decode_unroll.py finds it."""
    jeng, _ = engines(1)
    for seed in range(60):
        res, _ = jeng.generate(_prompt(seed), max_new_tokens=17,
                               sampling=JaxSampling(**KNOBS), seed=seed)
        s_eos = res.frames - 1
        if not res.hit_max and 0 < s_eos < 16 and s_eos % 4:
            return seed
    raise AssertionError("no mid-group EOS in 60 seeds")


@pytest.mark.parametrize("unroll", UNROLLS)
def test_eos_mid_group_matches_jax(engines, mid_group_eos, unroll):
    """EOS inside an unrolled group: the group's remaining sub-steps run
    (their frames invalid), and the reported stream is JAX's."""
    seed = mid_group_eos
    got, ref = _generate(engines, unroll, _prompt(seed), 17, seed=seed)
    _same_result(got, ref)
    assert not got.hit_max and got.frames < 17


@pytest.mark.parametrize("unroll", UNROLLS)
def test_batch_rows_finish_staggered(engines, unroll):
    """Batch 2, row 1 done before the chunk: its lanes stay invalid, row
    0's frames, the flags and steps are JAX's."""
    jeng, teng = engines(unroll, batch=2)
    prompts = np.stack([_prompt(1), _prompt(2)], axis=0)
    jstate = jeng.init_state(seed=4)
    jstate, _, _ = jeng.prefill(jstate, prompts, JaxSampling(**KNOBS))
    jstate = jstate._replace(done=jnp.asarray([False, True]))
    jstate, jout, jvalid, jsteps = jeng.decode_chunk(jstate, JaxSampling(**KNOBS), 8)
    teng = _port(teng, 4)
    state = teng.init_state(seed=4)
    state, _, _ = teng.prefill(state, prompts, SamplingArgs(**KNOBS))
    state = state._replace(done=torch.tensor([False, True]))
    state, out, valid, steps = teng.decode_chunk(state, SamplingArgs(**KNOBS), 8)
    _same_chunk((out, valid, steps), (jout, jvalid, jsteps))
    assert not valid[:, 1].any()
    np.testing.assert_array_equal(state.done.numpy(), np.asarray(jstate.done))


@pytest.mark.parametrize("unroll", UNROLLS)
def test_int8_engine_matches_jax(engines, unroll):
    """quantize_int8 engines: the int8 stacks run through the same loop."""
    _same_result(*_generate(engines, unroll, _prompt(3), 8, seed=7, int8=True))


@pytest.mark.parametrize("unroll", UNROLLS)
def test_collect_hidden_matches_jax(engines, unroll):
    """generate(collect_hidden=True): the hidden state of every kept frame."""
    got, ref = _generate(engines, unroll, _prompt(6), 6, seed=3, collect_hidden=True)
    _same_result(got, ref)
    assert got.hidden.shape == ref.hidden.shape == (got.frames, KW["dim"])
    np.testing.assert_allclose(got.hidden, ref.hidden, rtol=HIDDEN_TOL, atol=HIDDEN_TOL)


@pytest.mark.parametrize("unroll", [2, 4])
def test_indivisible_horizon_rejected(engines, unroll):
    """A horizon that is not a multiple of the unroll would let the carried
    state run ahead of the reported frames: refused, as JAX asserts;
    multiples pass."""
    _, teng = engines(unroll)
    teng = _port(teng, 5)
    state = teng.init_state(seed=5)
    state, _, _ = teng.prefill(state, _prompt(9)[None], SamplingArgs(**KNOBS))
    with pytest.raises(ValueError, match="multiple of"):
        teng.decode_chunk(state, SamplingArgs(**KNOBS), 6 if unroll == 4 else 3)
    teng.decode_chunk(state, SamplingArgs(**KNOBS), 8)
