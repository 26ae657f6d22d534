"""The whole slice on the CPU: prompt tokens -> codes -> PCM -> WAV.

The port's LMEngine in argmax mode against the JAX LMEngine on the
same engine configuration (attention_impl="pallas" in interpret mode,
prefill_impl "flash" or "xla", slow_impl="xla", fast_frame_impl="xla")
at a tiny DualAR config: the codes must be exactly equal over 12
frames. The port's firefly_decode of those codes must match the JAX
package's PCM within 1e-4 absolute (float32, convolutions summed in
another order)."""

import dataclasses
import io
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.engine import LMEngine as JaxEngine
from fish_speech_tpu.models.codec import firefly as jfire
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.generate.frame import FrameNoise
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy, firefly_params_from_numpy
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params as init_dual_ar_params_t
from fish_speech_tpu_torch.ops.sampling import SamplingArgs

torch.set_num_threads(1)

KW = dict(vocab_size=128, n_layer=2, n_fast_layer=1, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=128,
          codebook_size=1000, num_codebooks=2)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=1009)
VOCAB = 1010
N_FRAMES = 12
HEAD = dict(upsample_rates=(2, 2), upsample_kernel_sizes=(4, 4),
            resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
            num_mels=16, upsample_initial_channel=16, pre_conv_kernel_size=5,
            post_conv_kernel_size=5)
QUANT = dict(input_dim=16, n_codebooks=1, n_groups=2, levels=(8, 5, 5, 5),
             downsample_factor=(2, 2))


@pytest.fixture(scope="module")
def slice_setup():
    jc = jcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})
    tc = tcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    # as bench.py does: a zero im_end column, so generation runs its length
    params["output"] = params["output"].at[:, TOK["im_end_id"]].set(0.0)
    rng = np.random.default_rng(0)
    prompt = np.concatenate([rng.integers(10, 1010, size=(1, 11)),
                             rng.integers(0, 1000, size=(2, 11))]).astype(np.int32)
    return jc, tc, params, prompt


def _jax_codes(jc, params, prompt, prefill_impl):
    engine = JaxEngine(params, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                       attention_impl="pallas", prefill_impl=prefill_impl, slow_impl="xla",
                       fast_frame_impl="xla", cache_len=64, max_frames=N_FRAMES,
                       prompt_buckets=(16, 32), dtype=jnp.float32)
    res, _ = engine.generate(prompt, max_new_tokens=N_FRAMES,
                             sampling=JaxSampling(temp=0.0, repetition_penalty=1.4), seed=0)
    return res


@pytest.mark.parametrize("prefill_impl", ["flash", "xla"])
def test_slice_codes_and_pcm_match_jax(slice_setup, prefill_impl):
    jc, tc, params, prompt = slice_setup
    ref = _jax_codes(jc, params, prompt, prefill_impl)

    engine = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)), tc,
                      tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, cache_len=64,
                      max_frames=N_FRAMES, prompt_buckets=(16, 32), dtype=torch.float32,
                      device="cpu")
    res, state = engine.generate(prompt, max_new_tokens=N_FRAMES,
                                 sampling=SamplingArgs(temp=0.0, repetition_penalty=1.4), seed=0)
    assert res.frames == ref.frames == N_FRAMES
    np.testing.assert_array_equal(res.semantic, ref.semantic)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert int(state.pos[0]) == prompt.shape[1] + N_FRAMES - 1

    # codes -> PCM -> WAV, against the JAX codec on the same parameters
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
    fparams = jax.tree.unflatten(
        tree, [jnp.asarray(rng.normal(size=l.shape).astype(np.float32) * 0.2) for l in leaves])
    ref_pcm = np.asarray(jax.jit(jfire.firefly_decode, static_argnums=1)(
        fparams, jf, jnp.asarray(ref.tokens)[None]))[:, 0]
    codec = FireflyCodec(firefly_params_from_numpy(jax.tree.map(np.asarray, fparams)), tf,
                         device="cpu")
    pcm = codec.decode(res.tokens)
    assert pcm.shape == (1, N_FRAMES * codec.samples_per_frame)
    np.testing.assert_allclose(pcm, ref_pcm, rtol=1e-4, atol=1e-4)
    with wave.open(io.BytesIO(pcm_to_wav_bytes(pcm[0], codec.sample_rate))) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate(), w.getnframes()) == (
            1, 2, 44100, pcm.shape[1])


@pytest.mark.parametrize("slow_impl,fast_frame_impl", [
    ("fused", "fused"), ("fused", "xla"), ("xla", "fused")])
def test_fused_decode_paths_match_jax(slice_setup, slow_impl, fast_frame_impl):
    """The fused decode steps (plain versions on the CPU) give codes
    exactly equal to the JAX engine's unfused configuration; the JAX
    package's own tests hold its fused kernels equal to that
    configuration (tests/test_slow_step.py, tests/test_fast_frame.py)."""
    jc, tc, params, prompt = slice_setup
    ref = _jax_codes(jc, params, prompt, "flash")
    engine = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)), tc,
                      tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, cache_len=64,
                      max_frames=N_FRAMES, prompt_buckets=(16, 32), dtype=torch.float32,
                      device="cpu", slow_impl=slow_impl, fast_frame_impl=fast_frame_impl)
    assert (engine.use_fused_slow, engine.use_fused_fast) == (
        slow_impl == "fused", fast_frame_impl == "fused")
    res, state = engine.generate(prompt, max_new_tokens=N_FRAMES,
                                 sampling=SamplingArgs(temp=0.0, repetition_penalty=1.4), seed=0)
    assert res.frames == ref.frames == N_FRAMES
    np.testing.assert_array_equal(res.semantic, ref.semantic)
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    assert int(state.pos[0]) == prompt.shape[1] + N_FRAMES - 1


def test_fused_and_unfused_engines_sample_alike(slice_setup):
    """Sampling (temp 0.7, top-k, top-p, rep-pen) from the same seed:
    the fused engine consumes the same draws as the unfused one, so the
    float32 codes are equal."""
    _, tc, params, prompt = slice_setup
    tparams = dual_ar_params_from_numpy(jax.tree.map(np.asarray, params))
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.4)
    codes = []
    for impl in ("fused", "xla"):
        engine = LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                          cache_len=64, max_frames=N_FRAMES, prompt_buckets=(16, 32),
                          dtype=torch.float32, device="cpu", slow_impl=impl,
                          fast_frame_impl=impl)
        res, _ = engine.generate(prompt, max_new_tokens=N_FRAMES, sampling=sampling, seed=4)
        codes.append(np.concatenate([res.semantic[None], res.tokens]))
    np.testing.assert_array_equal(codes[0], codes[1])


def test_decode_impl_choice(slice_setup):
    """'auto' is unfused on the CPU; unknown names are refused."""
    _, tc, params, _ = slice_setup
    tparams = dual_ar_params_from_numpy(jax.tree.map(np.asarray, params))
    kw = dict(cache_len=64, prompt_buckets=(16, 32), dtype=torch.float32, device="cpu")
    engine = LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, **kw)
    assert not engine.use_fused_slow and not engine.use_fused_fast
    with pytest.raises(ValueError, match="slow_impl"):
        LMEngine(tparams, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                 slow_impl="pallas", **kw)


def test_rewind_and_continue(slice_setup):
    """A conditioning prefix kept by rewind: the continuation starts at
    the prefix length, as the JAX engine's rewind does."""
    jc, tc, params, prompt = slice_setup
    engine = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)), tc,
                      tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, cache_len=64,
                      max_frames=4, prompt_buckets=(16, 32), dtype=torch.float32, device="cpu")
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.4)
    res, state = engine.generate(prompt, max_new_tokens=4, sampling=sampling, seed=3)
    state = engine.rewind(state, prompt.shape[1])
    assert int(state.pos[0]) == prompt.shape[1] and state.rep_pen.ptr == 0
    res2, state2 = engine.generate(prompt[:, :5], max_new_tokens=4, sampling=sampling,
                                   state=state, conditioning_offset=prompt.shape[1])
    assert res2.frames == 4
    assert int(state2.pos[0]) == prompt.shape[1] + 5 + 3
    assert ((res2.tokens >= 0) & (res2.tokens < 1000)).all()


def test_bf16_slice_runs_on_cpu(slice_setup):
    """The main path's dtypes: bf16 LM and bf16 codec, sampling from a
    torch.Generator (the chip run's configuration at a tiny size). The
    bf16 PCM stays within 5e-2 of the float32 decode of the same codes
    (bf16 keeps ~3 significant digits through the conv stack)."""
    jc, tc, params, prompt = slice_setup
    engine = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params),
                                                dtype=torch.bfloat16),
                      tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, cache_len=64,
                      max_frames=N_FRAMES, prompt_buckets=(16, 32), device="cpu")
    res, _ = engine.generate(prompt, max_new_tokens=6,
                             sampling=SamplingArgs(temp=0.7, top_p=0.8, top_k=16,
                                                   repetition_penalty=1.4), seed=0)
    assert res.tokens.shape == (2, 6)
    assert ((res.semantic >= 10) & (res.semantic <= 1009)).all()
    tf = tcfg.FireflyConfig(spec_transform=tcfg.SpecTransformConfig(hop_length=4),
                            head=tcfg.HiFiGANConfig(**HEAD),
                            quantizer=tcfg.DownsampleFSQConfig(**QUANT))
    fparams = init_firefly_params(tf, seed=2, dtype=torch.float32, device="cpu")
    to_bf16 = lambda tree: jax.tree.map(lambda t: t.to(torch.bfloat16), tree)  # noqa: E731
    pcm32 = FireflyCodec(fparams, tf, device="cpu").decode(res.tokens)
    pcm16 = FireflyCodec(to_bf16(fparams), tf, device="cpu").decode(res.tokens)
    assert np.isfinite(pcm16).all()
    np.testing.assert_allclose(pcm16, pcm32, atol=5e-2, rtol=0)


# -- Fish <= 1.4 and DualAR at temp 0 -------------------------------------------

LEGACY_TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=5, semantic_end_id=None)


class _JaxStaticNoise:
    """The draws of the JAX static engine's one key chain at temp 0: each
    frame splits (key, frame key), the frame key splits (rest, semantic
    key), and Fish <= 1.4 draws its PAD/EOS uniforms from the latter."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, state, sampling, rows):
        self.key, frame_key = jax.random.split(self.key)
        _, sem_key = jax.random.split(frame_key)
        u = jax.random.uniform(sem_key, (len(rows),))
        return FrameNoise(semantic=torch.from_numpy(np.array(u)), codebooks=None)


def _lm_setup(lm):
    """Fish <= 1.4: a large constant in embedding dim 0 makes the final
    hidden's dim 0 large and positive, and the PAD column reads it, so
    p(PAD) is ~0.9 a frame and a stream runs several frames; each stop
    still rests on the uniform draw. DualAR: the Fish-1.5 layout with
    the im_end column zeroed."""
    legacy = lm in ("FISH_1_2", "FISH_1_4")
    tok = LEGACY_TOK if legacy else TOK
    jc = jcfg.DualARConfig(**{**KW, "vocab_size": VOCAB})
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(2), jc, jnp.float32)
    if legacy:
        params["embeddings"] = params["embeddings"].at[:, 0].set(10.0)
        params["output"] = (params["output"].at[:, tok["pad_id"]].set(0.0)
                            .at[:, tok["im_end_id"]].set(0.0).at[0, tok["pad_id"]].set(0.3))
    else:
        params["output"] = params["output"].at[:, tok["im_end_id"]].set(0.0)
    rng = np.random.default_rng(3)
    sem = np.full((1, 9), tok["semantic_start_id"]) if legacy else rng.integers(10, 1010, (1, 9))
    prompt = np.concatenate([sem, rng.integers(0, 1000, size=(2, 9))]).astype(np.int32)
    return jc, tok, params, prompt


@pytest.mark.parametrize("lm", ["FISH_1_2", "FISH_1_4", "DUAL_AR"])
def test_temp0_codes_follow_the_seed_and_jax(lm):
    """At temp 0 Fish <= 1.4 still draws PAD or <|im_end|> at random:
    the draw comes from the engine's generator, so one seed gives one
    stream (three calls), and on the JAX engine's uniforms the codes are
    the JAX engine's. DualAR (argmax throughout) likewise."""
    jc, tok, params, prompt = _lm_setup(lm)
    sampling = SamplingArgs(temp=0.0, repetition_penalty=1.2)
    ref_engine = JaxEngine(params, jc, jcfg.TokenConfig(**tok), jcfg.WhichLM[lm],
                           attention_impl="xla", prefill_impl="xla", slow_impl="xla",
                           fast_frame_impl="xla", cache_len=64, max_frames=16,
                           prompt_buckets=(16, 32), dtype=jnp.float32)
    ref, _ = ref_engine.generate(prompt, max_new_tokens=16,
                                 sampling=JaxSampling(temp=0.0, repetition_penalty=1.2), seed=7)
    engine = LMEngine(dual_ar_params_from_numpy(jax.tree.map(np.asarray, params)), tc_of(jc),
                      tcfg.TokenConfig(**tok), tcfg.WhichLM[lm], cache_len=64, max_frames=16,
                      prompt_buckets=(16, 32), dtype=torch.float32, device="cpu")
    runs = [engine.generate(prompt, max_new_tokens=16, sampling=sampling, seed=7)[0]
            for _ in range(3)]
    for r in runs[1:]:
        np.testing.assert_array_equal(r.semantic, runs[0].semantic)
        np.testing.assert_array_equal(r.tokens, runs[0].tokens)
    engine._noise = _JaxStaticNoise(7)
    got, _ = engine.generate(prompt, max_new_tokens=16, sampling=sampling, seed=7)
    assert ref.frames > 3
    np.testing.assert_array_equal(got.semantic, ref.semantic)
    np.testing.assert_array_equal(got.tokens, ref.tokens)


def tc_of(jc):
    return tcfg.DualARConfig(**{f.name: getattr(jc, f.name)
                                for f in dataclasses.fields(tcfg.DualARConfig)})


@pytest.mark.cuda
def test_cuda_engine_refuses_non_bf16():
    """On CUDA the kernels take bf16 only; an engine built from float32
    weights, or with a float32 cache, says so at construction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = tcfg.DualARConfig(**{**KW, "vocab_size": VOCAB, "n_head": 4, "dim": 256,
                               "head_dim": 64})
    for dtype, params_dtype in ((torch.bfloat16, torch.float32),
                                (torch.float32, torch.bfloat16)):
        params = init_dual_ar_params_t(cfg, 0, params_dtype, "cpu")
        with pytest.raises(ValueError, match="bfloat16"):
            LMEngine(params, cfg, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                     dtype=dtype, device="cuda")
    LMEngine(init_dual_ar_params_t(cfg, 0, torch.bfloat16, "cpu"), cfg,
             tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, device="cuda")
