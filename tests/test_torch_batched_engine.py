"""The port's batched dynamic LMEngine against the JAX dynamic engine
(`dynamic_sampling=True`, attention/prefill/slow/fast all "xla") at a
tiny float32 config on the CPU: `generate_batch` on ragged prompts,
`prefill_rows` bursts, `prefill_row`, chunked `decode_chunk`, mixed
per-row sampling. Sampled runs feed the port the JAX engine's own
per-row draws (`JaxRowNoise`), so codes must be exactly equal. The
port's fused decode path ("fused": the plain versions of the fused slow
step and of the batched fast frame) must give the same codes, also at 16
rows against the JAX engine's own fused slow step (in interpret mode)."""

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
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
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


@pytest.fixture(scope="module")
def models():
    """Two weight sets: `long`, with the im_end column zeroed (rows run
    their budget), and `eos`, whose im_end column is 2.5x the column of
    semantic token 5, so rows stop at frames that depend on their data."""
    jc = jcfg.DualARConfig(**KW)
    base = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    out = {}
    for name in ("long", "eos"):
        params = dict(base)
        col = 0.0 if name == "long" else 2.5 * base["output"][:, TOK["semantic_start_id"] + 5]
        params["output"] = base["output"].at[:, TOK["im_end_id"]].set(col)
        out[name] = (params, dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)))
    return jc, tcfg.DualARConfig(**KW), out


def _prompts(seed, lens=(7, 12, 5, 16)):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.integers(10, 138, (1, n)), rng.integers(0, 128, (4, n))]
                           ).astype(np.int32) for n in lens]


def _jax_engine(jc, params):
    return JaxEngine(params, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                     attention_impl="xla", prefill_impl="xla", slow_impl="xla",
                     fast_frame_impl="xla", dtype=jnp.float32, **COMMON)


def _engine(tc, tparams, impl="xla", batch=B):
    return LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                    dtype=torch.float32, device="cpu", slow_impl=impl, fast_frame_impl=impl,
                    **{**COMMON, "batch_size": batch})


def _inject(engine):
    """Make the engine's states draw the JAX engine's per-row keys."""
    make = engine.init_state

    def init_state(seed=None):
        return make(seed)._replace(rng=JaxRowNoise(engine.batch_size, seed))
    engine.init_state = init_state
    return engine


def _codes(res):
    return np.concatenate([res.semantic[None], res.tokens])


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("mode", ["argmax", "sampled"])
@pytest.mark.parametrize("weights", ["long", "eos"])
def test_generate_batch_matches_jax(models, impl, mode, weights):
    jc, tc, sets = models
    params, tparams = sets[weights]
    knobs = ARGMAX if mode == "argmax" else SAMPLED
    ref = _jax_engine(jc, params).generate_batch(
        _prompts(1), max_new_tokens=12, sampling=JaxSampling(**knobs), seed=3)
    engine = _inject(_engine(tc, tparams, impl))
    assert (engine.use_fused_slow, engine.use_fused_fast) == ((impl == "fused",) * 2)
    got = engine.generate_batch(_prompts(1), max_new_tokens=12, sampling=SamplingArgs(**knobs),
                                seed=3)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_codes(g), _codes(r))
        assert (g.frames, g.hit_max, g.prompt_tokens) == (r.frames, r.hit_max, r.prompt_tokens)
    if weights == "eos":
        assert min(r.frames for r in ref) < 12  # some row stopped early


ROWS16 = dict(COMMON, batch_size=16)


@pytest.mark.parametrize("mode", ["argmax", "sampled"])
def test_sixteen_rows_fused_slow_step_matches_jax_fused(models, mode):
    """16 rows, the serving batch, where CUDA runs the fused slow step's
    row sequence: the port's dynamic engine with slow_impl="fused" (the
    plain version on the CPU, beside the batched fast frame's) against the
    JAX 16-row engine with slow_impl="fused" (its Pallas kernel in
    interpret mode), on ragged prompts and the JAX engine's own per-row
    draws: the codes are equal."""
    jc, tc, sets = models
    params, tparams = sets["eos"]
    knobs = ARGMAX if mode == "argmax" else SAMPLED
    prompts = _prompts(9, (7, 12, 5, 16, 9, 3, 14, 8, 11, 6, 16, 4, 10, 13, 2, 15))
    jengine = JaxEngine(params, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                        attention_impl="xla", prefill_impl="xla", slow_impl="fused",
                        fast_frame_impl="xla", dtype=jnp.float32, **ROWS16)
    assert jengine.use_fused_slow
    ref = jengine.generate_batch(prompts, max_new_tokens=6, sampling=JaxSampling(**knobs), seed=4)
    engine = _inject(LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                              dtype=torch.float32, device="cpu", slow_impl="fused",
                              fast_frame_impl="fused", **ROWS16))
    assert engine.use_fused_slow and engine.use_fused_fast
    got = engine.generate_batch(prompts, max_new_tokens=6, sampling=SamplingArgs(**knobs), seed=4)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(_codes(g), _codes(r))
        assert (g.frames, g.hit_max) == (r.frames, r.hit_max)


def test_generate_batch_rows_equal_batch1_generation(models):
    """Argmax: each row of a ragged batch gives the codes of its prompt
    generated alone on a batch-1 engine."""
    _, tc, sets = models
    _, tparams = sets["eos"]
    rows = _engine(tc, tparams).generate_batch(_prompts(2), max_new_tokens=12,
                                               sampling=SamplingArgs(**ARGMAX), seed=0)
    single = _engine(tc, tparams, batch=1)
    for prompt, row in zip(_prompts(2), rows):
        alone, _ = single.generate(prompt, max_new_tokens=12, sampling=SamplingArgs(**ARGMAX),
                                   seed=0)
        np.testing.assert_array_equal(_codes(alone), _codes(row))


def _admit_jax(jc, params, per_row, row0, prompts):
    engine = _jax_engine(jc, params)
    state = engine.init_state(seed=11)
    state, frames, eos = engine.prefill_rows(
        state, prompts, JaxSampling(), row0,
        per_row=[(JaxSampling(**k), s) for k, s in per_row])
    return engine, state, np.asarray(frames), np.asarray(eos)


PER_ROW = [(ARGMAX, 5), (SAMPLED, 6)]
# rows that all stop within 12 frames on the eos weights
STOPPING_ROWS = [(ARGMAX, 5), (dict(SAMPLED, temp=0.3), 6), (dict(ARGMAX, top_k=4), 8)]


@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_prefill_rows_burst_matches_prefill_row_and_jax(models, impl):
    """A burst into rows [1, 3) equals the same two admissions one row at
    a time (first frames, positions, cache rows) and the JAX burst;
    rows outside the burst are untouched. Mixed per-row configs: an
    argmax row and a sampled row."""
    jc, tc, sets = models
    params, tparams = sets["long"]
    prompts = _prompts(4, (9, 14))
    per_row = PER_ROW
    _, ref_state, ref_frames, _ = _admit_jax(jc, params, per_row, 1, prompts)
    engine = _inject(_engine(tc, tparams, impl))
    burst, frames, _ = engine.prefill_rows(
        engine.init_state(11), prompts, SamplingArgs(), 1,
        per_row=[(SamplingArgs(**k), s) for k, s in per_row])
    np.testing.assert_array_equal(frames.numpy(), ref_frames)
    np.testing.assert_array_equal(burst.pos.numpy(), np.asarray(ref_state.pos))
    seq = engine.init_state(11)
    for i, (prompt, (k, s)) in enumerate(zip(prompts, per_row)):
        seq, frame, _ = engine.prefill_row(seq, prompt, SamplingArgs(**k), 1 + i, seed=s)
        np.testing.assert_array_equal(frame.numpy(), ref_frames[i])
    for a, b in ((burst.pos, seq.pos), (burst.prev, seq.prev), (burst.cache.k, seq.cache.k),
                 (burst.samp.temp, seq.samp.temp)):
        assert torch.equal(a, b)
    assert not burst.cache.k[:, [0, 3]].any()  # other rows untouched


def test_decode_chunks_match_one_chunk_and_jax(models):
    """After a mixed admission, three chunks of 4 frames equal one chunk
    of 12 and the JAX engine's three chunks, `steps` included; the eos
    weights make rows stop inside the chunks."""
    jc, tc, sets = models
    params, tparams = sets["eos"]
    prompts = _prompts(5, (8, 11, 6))
    jengine, jstate, _, _ = _admit_jax(jc, params, STOPPING_ROWS, 0, prompts)
    jstate = jstate._replace(done=jstate.done.at[3].set(True))  # row 3 stays idle
    ref = []
    for _ in range(3):
        jstate, out, valid, steps = jengine.decode_chunk(jstate, JaxSampling(), 4)
        ref.append((np.asarray(out), np.asarray(valid), int(steps)))

    engine = _inject(_engine(tc, tparams))

    def admitted():
        state, _, _ = engine.prefill_rows(engine.init_state(11), prompts, SamplingArgs(), 0,
                                          per_row=[(SamplingArgs(**k), s)
                                                   for k, s in STOPPING_ROWS])
        return state._replace(done=state.done.clone().index_fill_(0, torch.tensor([3]), True))

    state = admitted()
    chunks = []
    for out_r, valid_r, steps_r in ref:
        state, out, valid, steps = engine.decode_chunk(state, SamplingArgs(), 4)
        assert int(steps) == steps_r
        np.testing.assert_array_equal(valid.numpy(), valid_r)
        np.testing.assert_array_equal(out[:steps_r].numpy(), out_r[:steps_r])
        chunks.append((out, valid))
    assert [r[2] for r in ref] == [4, 4, 1]  # every row stopped inside the last chunk
    _, out, valid, steps = engine.decode_chunk(admitted(), SamplingArgs(), 12)
    assert torch.equal(valid, torch.cat([v for _, v in chunks]))
    for i in range(12):
        live = valid[i]
        assert torch.equal(out[i][live], chunks[i // 4][0][i % 4][live])


def test_decode_chunk_max_steps_and_all_done(models):
    """max_steps caps the frames run; a batch that is all done reports 0
    steps and only invalid frames."""
    _, tc, sets = models
    engine = _engine(tc, sets["long"][1])
    state = engine.init_state(0)
    state, out, valid, steps = engine.decode_chunk(state._replace(done=~state.done),
                                                   SamplingArgs(), 4)
    assert int(steps) == 0 and not valid.any()
    # seeded rows: with fresh seeds (the default) a row may draw <|im_end|>
    # in its first frames, and the capped chunk would hold fewer valid rows
    state, _, _ = engine.prefill_rows(engine.init_state(0), _prompts(6), SamplingArgs(), 0,
                                      per_row=[(SamplingArgs(), 100 + r) for r in range(4)])
    state, out, valid, steps = engine.decode_chunk(state, SamplingArgs(), 8, max_steps=3)
    assert int(steps) == 3 and valid[:3].all() and not valid[3:].any()


def test_seeded_row_ignores_cotenants(models):
    """A seeded request's codes depend on its seed and prompt only: the
    same admission into row 2 beside other co-tenants (other prompts,
    seeds and configs) gives the same codes."""
    _, tc, sets = models
    engine = _engine(tc, sets["long"][1])
    mine = _prompts(7, (10,))[0]
    codes = []
    for others_seed, knobs in ((1, SAMPLED), (2, ARGMAX)):
        others = _prompts(others_seed, (5, 13, 9))
        state = engine.init_state(others_seed)
        state, _, _ = engine.prefill_rows(
            state, others[:2], SamplingArgs(), 0,
            per_row=[(SamplingArgs(**knobs), others_seed)] * 2)
        state, first, _ = engine.prefill_row(state, mine, SamplingArgs(**SAMPLED), 2, seed=42)
        state, _, _ = engine.prefill_row(state, others[2], SamplingArgs(**knobs), 3)
        state, out, _, _ = engine.decode_chunk(state, SamplingArgs(), 6)
        codes.append(torch.cat([first[None], out[:, 2]]))
    assert torch.equal(codes[0], codes[1])


def test_static_engine_batches_too(models):
    """A static-sampling engine at B = 4 (one SamplingArgs, one
    generator) runs ragged batches and chunks as well; at temp 0 its
    codes equal the dynamic engine's."""
    _, tc, sets = models
    tparams = sets["eos"][1]
    static = LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                      dtype=torch.float32, device="cpu", **{**COMMON, "dynamic_sampling": False})
    a = static.generate_batch(_prompts(8), max_new_tokens=10, sampling=SamplingArgs(**ARGMAX))
    b = _engine(tc, tparams).generate_batch(_prompts(8), max_new_tokens=10,
                                            sampling=SamplingArgs(**ARGMAX))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_codes(x), _codes(y))
