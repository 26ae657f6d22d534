"""The port's overlapped batch-1 driver (generate/overlap.py) against the
JAX package's `generate_vocode_overlapped`, after tests/test_overlap.py,
at test_torch_engine.py's tiny LM and codec configurations, on the same
float32 parameters: full budget over several chunks with a
budget-truncated last one, EOS mid-chunk, budget 0, the dynamic engine
taking the caller's sampling (on JAX's per-row draws), Fish 1.4 at temp 0 on the JAX engine's
uniforms (its PAD/EOS draw) with the output shift, and
`generate(collect_hidden=True)` against JAX's.

Tolerances: tokens exactly equal; PCM within 1e-4 absolute and relative
of JAX's (float32; convolutions summed in another order) and within
1e-5 of the port's own batch decode of the same codes; hidden states
within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.engine import LMEngine as JaxEngine
from fish_speech_tpu.generate.overlap import generate_vocode_overlapped as jax_overlapped
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped, output_shift
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy, firefly_params_from_numpy
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
from test_torch_dynamic_sampling import JaxRowNoise
from test_torch_engine import HEAD, KW, QUANT, TOK, VOCAB, _JaxStaticNoise, _lm_setup, tc_of

torch.set_num_threads(1)
TOL = 1e-4
SELF_TOL = 1e-5


@pytest.fixture(scope="module")
def codecs():
    jf = jcfg.FireflyConfig(spec_transform=jcfg.SpecTransformConfig(hop_length=4),
                            head=jcfg.HiFiGANConfig(**HEAD),
                            quantizer=jcfg.DownsampleFSQConfig(**QUANT))
    tf = tcfg.FireflyConfig(spec_transform=tcfg.SpecTransformConfig(hop_length=4),
                            head=tcfg.HiFiGANConfig(**HEAD),
                            quantizer=tcfg.DownsampleFSQConfig(**QUANT))
    shapes = jax.eval_shape(
        lambda: jfire.init_firefly_params(jax.random.PRNGKey(1), jf, jnp.float32))
    leaves, tree = jax.tree.flatten(shapes)
    rng = np.random.default_rng(1)
    params = jax.tree.unflatten(
        tree, [jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * 0.2) for l in leaves])
    return (jfire.FireflyCodec(params, jf, buckets=(8, 16, 32)),
            FireflyCodec(firefly_params_from_numpy(jax.tree.map(np.asarray, params)), tf,
                         device="cpu"))


def _engines(im_end_bias, max_frames=24, dynamic_sampling=False):
    """The JAX engine (unfused throughout) and the port's, on one float32
    tree whose im_end column is scaled by im_end_bias."""
    jc = jcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    params["output"] = params["output"].at[:, TOK["im_end_id"]].multiply(im_end_bias)
    kw = dict(cache_len=64, max_frames=max_frames, prompt_buckets=(16, 32),
              dynamic_sampling=dynamic_sampling)
    jeng = JaxEngine(params, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                     attention_impl="xla", prefill_impl="xla", slow_impl="xla",
                     fast_frame_impl="xla", dtype=jnp.float32, **kw)
    teng = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)), tc_of(jc),
                    tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, dtype=torch.float32,
                    device="cpu", **kw)
    return jeng, teng


def _prompt(seq=9):
    rng = np.random.default_rng(0)
    sem = rng.integers(TOK["semantic_start_id"], VOCAB, size=(1, seq))
    return np.concatenate([sem, np.zeros((2, seq), np.int64)]).astype(np.int32)


def _match(got, ref, codec):
    """Port (pcm, result) against JAX's: tokens exact, PCM within TOL, and
    the port's PCM within SELF_TOL of its own batch decode."""
    (pcm, res), (jpcm, jres) = got, ref
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    np.testing.assert_array_equal(res.semantic, jres.semantic)
    assert (res.frames, res.hit_max) == (jres.frames, jres.hit_max)
    assert pcm.dtype == np.float32 and pcm.shape == (res.frames * codec.samples_per_frame,)
    np.testing.assert_allclose(pcm, jpcm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pcm, codec.decode(res.tokens)[0], rtol=0, atol=SELF_TOL)


@pytest.mark.parametrize("chunk", [4, 8])
def test_full_budget_matches_jax(codecs, chunk):
    """im_end suppressed: the full budget over several chunks, the last
    one truncated by the budget."""
    jcodec, codec = codecs
    jeng, teng = _engines(im_end_bias=0.0)
    jpcm, jres, _ = jax_overlapped(jeng, jcodec, _prompt(), sampling=JaxSampling(temp=0.0),
                                   max_new_tokens=22, seed=7, chunk=chunk)
    pcm, res, state = generate_vocode_overlapped(teng, codec, _prompt(),
                                                 sampling=SamplingArgs(temp=0.0),
                                                 max_new_tokens=22, seed=7, chunk=chunk)
    assert res.frames == 22 and res.hit_max
    _match((pcm, res), (jpcm, jres), codec)
    serial, _ = teng.generate(_prompt(), max_new_tokens=22, sampling=SamplingArgs(temp=0.0),
                              seed=7)
    np.testing.assert_array_equal(res.tokens, serial.tokens)


def test_eos_mid_chunk_matches_jax(codecs):
    """im_end amplified: EOS lands mid-chunk and the speculative chunk is
    discarded."""
    jcodec, codec = codecs
    jeng, teng = _engines(im_end_bias=50.0)
    jpcm, jres, _ = jax_overlapped(jeng, jcodec, _prompt(), sampling=JaxSampling(temp=0.0),
                                   max_new_tokens=20, seed=3, chunk=4)
    pcm, res, _ = generate_vocode_overlapped(teng, codec, _prompt(),
                                             sampling=SamplingArgs(temp=0.0),
                                             max_new_tokens=20, seed=3, chunk=4)
    assert 1 < res.frames < 20 and not res.hit_max
    _match((pcm, res), (jpcm, jres), codec)


def test_budget_zero(codecs):
    """max_new_tokens=1: only the prefill's frame, still vocoded."""
    jcodec, codec = codecs
    jeng, teng = _engines(im_end_bias=0.0)
    jpcm, jres, _ = jax_overlapped(jeng, jcodec, _prompt(), sampling=JaxSampling(temp=0.0),
                                   max_new_tokens=1, seed=5, chunk=4)
    pcm, res, _ = generate_vocode_overlapped(teng, codec, _prompt(),
                                             sampling=SamplingArgs(temp=0.0),
                                             max_new_tokens=1, seed=5, chunk=4)
    assert res.frames == 1 and pcm.shape == (codec.samples_per_frame,)
    _match((pcm, res), (jpcm, jres), codec)


def test_dynamic_engine_takes_the_callers_sampling(codecs):
    """A dynamic engine reads its knobs from state.samp: the driver installs
    the caller's. Sampled on the JAX dynamic engine's per-row draws
    (JaxRowNoise), the codes are JAX's and those of generate with the same
    knobs, and not those of other knobs."""
    jcodec, codec = codecs
    jeng, teng = _engines(im_end_bias=0.0, dynamic_sampling=True)
    knobs = dict(temp=0.8, top_p=0.9, top_k=16, repetition_penalty=1.3)

    def state():
        return teng.init_state(11)._replace(rng=JaxRowNoise(1, 11))

    other, _ = teng.generate(_prompt(), max_new_tokens=16, state=state(),
                             sampling=SamplingArgs(temp=0.5, top_k=4))
    same, _ = teng.generate(_prompt(), max_new_tokens=16, state=state(),
                            sampling=SamplingArgs(**knobs))
    assert not np.array_equal(other.tokens, same.tokens), "the knobs must alter this stream"
    pcm, res, _ = generate_vocode_overlapped(teng, codec, _prompt(), state=state(),
                                             sampling=SamplingArgs(**knobs), max_new_tokens=16,
                                             chunk=4)
    np.testing.assert_array_equal(res.tokens, same.tokens)
    jpcm, jres, _ = jax_overlapped(jeng, jcodec, _prompt(), sampling=JaxSampling(**knobs),
                                   max_new_tokens=16, seed=11, chunk=4)
    _match((pcm, res), (jpcm, jres), codec)


def test_fish_1_4_on_jax_uniforms_with_the_output_shift(codecs):
    """Fish 1.4 draws PAD or <|im_end|> at random even at temp 0: on the
    JAX engine's uniforms the port's overlapped codes are JAX's, EOS
    included, and the codec reads them shifted back by one."""
    jcodec, codec = codecs
    jc, tok, params, prompt = _lm_setup("FISH_1_4")
    kw = dict(cache_len=64, max_frames=24, prompt_buckets=(16, 32))
    jeng = JaxEngine(params, jc, jcfg.TokenConfig(**tok), jcfg.WhichLM.FISH_1_4,
                     attention_impl="xla", prefill_impl="xla", slow_impl="xla",
                     fast_frame_impl="xla", dtype=jnp.float32, **kw)
    teng = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)), tc_of(jc),
                    tcfg.TokenConfig(**tok), tcfg.WhichLM.FISH_1_4, dtype=torch.float32,
                    device="cpu", **kw)
    teng._noise = _JaxStaticNoise(7)
    shift = output_shift(tcfg.WhichLM.FISH_1_4)
    jshift = lambda c: np.maximum(c.astype(np.int64) - 1, 0).astype(np.int32)  # noqa: E731
    jpcm, jres, _ = jax_overlapped(jeng, jcodec, prompt,
                                   sampling=JaxSampling(temp=0.0, repetition_penalty=1.2),
                                   max_new_tokens=22, seed=7, chunk=4, shift_fn=jshift)
    pcm, res, _ = generate_vocode_overlapped(
        teng, codec, prompt, sampling=SamplingArgs(temp=0.0, repetition_penalty=1.2),
        max_new_tokens=22, seed=7, chunk=4, shift_fn=shift)
    assert jres.frames > 3
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    np.testing.assert_array_equal(res.semantic, jres.semantic)
    assert (res.frames, res.hit_max) == (jres.frames, jres.hit_max)
    np.testing.assert_allclose(pcm, jpcm, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pcm, codec.decode(shift(res.tokens))[0], rtol=0, atol=SELF_TOL)
    np.testing.assert_array_equal(shift(np.array([[0, 1, 7]])), [[0, 0, 6]])
    assert output_shift(tcfg.WhichLM.FISH_1_5)(res.tokens) is res.tokens


def test_generate_collect_hidden_matches_jax():
    """generate(collect_hidden=True): the slow hidden state of every kept
    frame, the prefill's first, as JAX's."""
    jeng, teng = _engines(im_end_bias=50.0)
    jres, _ = jeng.generate(_prompt(), max_new_tokens=12, sampling=JaxSampling(temp=0.0),
                            seed=2, collect_hidden=True)
    res, _ = teng.generate(_prompt(), max_new_tokens=12, sampling=SamplingArgs(temp=0.0),
                           seed=2, collect_hidden=True)
    np.testing.assert_array_equal(res.tokens, jres.tokens)
    assert res.hidden.dtype == np.float32
    assert res.hidden.shape == jres.hidden.shape == (res.frames, KW["dim"])
    np.testing.assert_allclose(res.hidden, jres.hidden, rtol=TOL, atol=TOL)
    assert teng.generate(_prompt(), max_new_tokens=4, seed=2)[0].hidden is None


def test_warmup_runs_the_buckets_offsets_and_horizons_it_is_given(monkeypatch):
    """warmup() prefills the smallest prompt bucket once by default; given
    buckets, conditioning offsets and chunk horizons, it prefills each
    distinct (bucket, offset) that fits the cache once and decodes one
    chunk of each horizon after the one-frame chunk."""
    _, teng = _engines(im_end_bias=1.0)
    prefills, chunks = [], []
    prefill_row, decode_chunk = teng.prefill_row, teng.decode_chunk

    def count_prefill(state, prompt, sampling, row, offset=0):
        prefills.append((prompt.shape[-1], offset))
        return prefill_row(state, prompt, sampling, row, offset=offset)

    def count_chunk(state, sampling, horizon, max_steps=None):
        chunks.append(horizon)
        return decode_chunk(state, sampling, horizon, max_steps)

    monkeypatch.setattr(teng, "prefill_row", count_prefill)
    monkeypatch.setattr(teng, "decode_chunk", count_chunk)
    teng.warmup(SamplingArgs(temp=0.0))
    assert (prefills, chunks) == ([(16, 0)], [1])
    prefills.clear()
    chunks.clear()
    teng.warmup(SamplingArgs(temp=0.0), buckets=(16, 32), conditioning_lens=(0, 8, 12, 40),
                chunk_horizons=(4, 8))
    # cache 64: 32 at 40 overruns it; 16 and 32 at 12 attend over the
    # same extent as at 8
    assert sorted(prefills) == [(16, 0), (16, 8), (16, 40), (32, 0), (32, 8)]
    assert chunks == [1, 4, 8]
