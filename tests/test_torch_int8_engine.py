"""The port's int8 engines against the JAX package's `quantize_int8=True`
engines at a tiny float32 config on the CPU: the batch-1 `generate`
(unfused, and the fused path's plain versions) in argmax mode, and the
dynamic engine's `generate_batch` and chunked `decode_chunk` fed the JAX
engine's own per-row draws (`JaxRowNoise`). Token streams must be
exactly equal. Also: the engine quantizes after the head gather and
keeps no dense stack, a tree quantized by the JAX package through the
converter runs as `quantize_int8=True` does, and the batcher decodes
with its engine's int8 weights."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.engine import LMEngine as JaxEngine
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.ops.quant import is_quantized
from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
from test_torch_dynamic_sampling import JaxRowNoise

torch.set_num_threads(1)

KW = dict(vocab_size=300, n_layer=2, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=128,
          codebook_size=128, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=137)
B = 4
COMMON = dict(batch_size=B, cache_len=64, max_frames=12, prompt_buckets=(16, 32),
              rep_pen_window=BATCHED_REP_PEN_WINDOW, dynamic_sampling=True)
SAMPLED = dict(temp=0.8, top_p=0.9, top_k=32, repetition_penalty=1.3)
ARGMAX = dict(temp=0.0, top_p=0.8, top_k=256, repetition_penalty=1.4)
STOPPING_ROWS = [(ARGMAX, 5), (dict(SAMPLED, temp=0.3), 6), (dict(ARGMAX, top_k=4), 8)]
WAIT = 60.0


@pytest.fixture(scope="module")
def models():
    """Float32 weights whose im_end column is 2.5x the column of semantic
    token 5 (rows stop at frames that depend on their data), as the JAX
    tree and as the port's dense copy."""
    jc = jcfg.DualARConfig(**KW)
    params = dict(jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32))
    col = 2.5 * params["output"][:, TOK["semantic_start_id"] + 5]
    params["output"] = params["output"].at[:, TOK["im_end_id"]].set(col)
    return jc, tcfg.DualARConfig(**KW), params, dual_ar_params_from_numpy(
        jax.tree.map(np.asarray, params))


def _prompts(seed, lens=(7, 12, 5, 16)):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.integers(10, 138, (1, n)), rng.integers(0, 128, (4, n))]
                           ).astype(np.int32) for n in lens]


def _codes(res):
    return np.concatenate([res.semantic[None], res.tokens])


def _jax_engine(jc, params, **kw):
    return JaxEngine(params, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                     attention_impl="xla", prefill_impl="xla", slow_impl="xla",
                     fast_frame_impl="xla", dtype=jnp.float32, quantize_int8=True, **kw)


def _engine(tc, tparams, impl="xla", **kw):
    return LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                    dtype=torch.float32, device="cpu", slow_impl=impl, fast_frame_impl=impl,
                    quantize_int8=True, **kw)


def _inject(engine):
    """Make the engine's states draw the JAX engine's per-row keys."""
    make = engine.init_state

    def init_state(seed=None):
        return make(seed)._replace(rng=JaxRowNoise(engine.batch_size, seed))
    engine.init_state = init_state
    return engine


BATCH1 = dict(cache_len=64, max_frames=12, prompt_buckets=(16, 32))


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_batch1_generate_matches_jax(models, impl):
    """Argmax with repetition penalty: the int8 batch-1 engine's codes
    equal the JAX int8 engine's, on the unfused path and on the plain
    versions of the fused slow step and fast frame."""
    jc, tc, params, tparams = models
    prompt = _prompts(1, (11,))[0]
    ref, _ = _jax_engine(jc, params, **BATCH1).generate(
        prompt, max_new_tokens=12, sampling=JaxSampling(**ARGMAX), seed=0)
    engine = _engine(tc, tparams, impl, **BATCH1)
    assert (engine.use_fused_slow, engine.use_fused_fast) == ((impl == "fused",) * 2)
    got, _ = engine.generate(prompt, max_new_tokens=12, sampling=SamplingArgs(**ARGMAX), seed=0)
    assert got.frames == ref.frames
    np.testing.assert_array_equal(_codes(got), _codes(ref))


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("mode", ["argmax", "sampled"])
def test_generate_batch_matches_jax(models, impl, mode):
    jc, tc, params, tparams = models
    knobs = ARGMAX if mode == "argmax" else SAMPLED
    ref = _jax_engine(jc, params, **COMMON).generate_batch(
        _prompts(1), max_new_tokens=12, sampling=JaxSampling(**knobs), seed=3)
    got = _inject(_engine(tc, tparams, impl, **COMMON)).generate_batch(
        _prompts(1), max_new_tokens=12, sampling=SamplingArgs(**knobs), seed=3)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_codes(g), _codes(r))
        assert (g.frames, g.hit_max) == (r.frames, r.hit_max)
    assert min(r.frames for r in ref) < 12  # some row stopped early


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_decode_chunks_match_jax(models, impl):
    """After a mixed admission (an argmax row and sampled rows), three
    chunks of 4 frames equal the JAX int8 engine's, `steps` included."""
    jc, tc, params, tparams = models
    prompts = _prompts(5, (8, 11, 6))
    jengine = _jax_engine(jc, params, **COMMON)
    jstate, _, _ = jengine.prefill_rows(jengine.init_state(seed=11), prompts, JaxSampling(), 0,
                                        per_row=[(JaxSampling(**k), s) for k, s in STOPPING_ROWS])
    jstate = jstate._replace(done=jstate.done.at[3].set(True))  # row 3 stays idle
    engine = _inject(_engine(tc, tparams, impl, **COMMON))
    state, _, _ = engine.prefill_rows(engine.init_state(11), prompts, SamplingArgs(), 0,
                                      per_row=[(SamplingArgs(**k), s) for k, s in STOPPING_ROWS])
    state = state._replace(done=state.done.clone().index_fill_(0, torch.tensor([3]), True))
    for _ in range(3):
        jstate, j_out, j_valid, j_steps = jengine.decode_chunk(jstate, JaxSampling(), 4)
        state, out, valid, steps = engine.decode_chunk(state, SamplingArgs(), 4)
        assert int(steps) == int(j_steps)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
        np.testing.assert_array_equal(out[:int(steps)].numpy(), np.asarray(j_out)[:int(steps)])


def test_engine_quantizes_after_the_head_gather(models):
    """The stacks are int8 with bf16 scales and no dense copy is kept;
    the gathered head, embeddings and norms stay as they were; a tree
    quantized by the JAX package runs as quantize_int8=True does; a
    quantized tree is not quantized again."""
    jc, tc, params, tparams = models
    engine = _engine(tc, tparams, **BATCH1)
    assert engine.quantize_int8
    for stack in ("slow", "fast"):
        for k, v in engine.params[stack].items():
            assert is_quantized(v) == (k in ("wqkv", "wo", "w1", "w3", "w2"))
        assert engine.params[stack]["attention_norm"].dtype == torch.float32
    assert engine.params["output"].dtype == torch.float32
    assert engine.params["output"].shape[1] == KW["codebook_size"] + 1  # gathered
    assert engine.params["embeddings"] is tparams["embeddings"]

    from_jax = dual_ar_params_from_numpy(jax.tree.map(np.asarray, jq.quantize_lm_params(params)))
    given = LMEngine(from_jax, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                     dtype=torch.float32, device="cpu", **BATCH1)
    prompt = _prompts(2, (9,))[0]
    a, _ = engine.generate(prompt, max_new_tokens=8, sampling=SamplingArgs(**ARGMAX))
    b, _ = given.generate(prompt, max_new_tokens=8, sampling=SamplingArgs(**ARGMAX))
    np.testing.assert_array_equal(_codes(a), _codes(b))
    with pytest.raises(ValueError, match="quantized already"):
        LMEngine(from_jax, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                 dtype=torch.float32, device="cpu", quantize_int8=True, **BATCH1)


def test_batcher_inherits_quantization(models):
    """A batcher over an int8 engine decodes with the int8 weights: an
    argmax request's codes equal the int8 engine's own generate_batch
    row for the same prompt."""
    _, tc, _, tparams = models
    engine = _engine(tc, tparams, impl="fused", **COMMON)
    prompt = _prompts(3, (10,))[0]
    rows = engine.generate_batch([prompt] * B, max_new_tokens=8, sampling=SamplingArgs(**ARGMAX))
    batcher = ContinuousBatcher(engine, SamplingArgs(**ARGMAX), horizon=4)
    out = {}

    def client():
        out["chunks"] = list(batcher.submit([prompt], 0, 8, sampling=SamplingArgs(**ARGMAX))
                             .iter_chunks(timeout=WAIT))
    try:
        assert batcher.engine.quantize_int8 and is_quantized(batcher.engine.params["slow"]["w2"])
        t = threading.Thread(target=client)
        t.start()
        t.join(timeout=WAIT)
        assert not t.is_alive()
    finally:
        batcher.shutdown()
    (chunk,) = out["chunks"]
    np.testing.assert_array_equal(np.concatenate([chunk.semantic[None], chunk.tokens]),
                                  _codes(rows[0]))
