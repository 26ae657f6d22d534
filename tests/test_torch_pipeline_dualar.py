"""The generic DualAR (smoltts) path of the port: a tiny depthwise DualAR
LM with tests/test_mimi.py's tiny Mimi through `TTSPipeline`, against the
JAX package's pipeline; the port's counterpart of
tests/test_pipeline_dualar.py.

Both pipelines are loaded by `TTSPipeline.load(..., WhichModel.DUAL_AR)`
from one directory this file writes: config.json (depthwise_wte and
depthwise_output), a word-level tokenizer.json with 32 `<|semantic:N|>`
ids, the LM in the upstream names (its <|im_end|> column zeroed, so each
generation runs its budget) and the Mimi weights in transformers' names
as mimi.safetensors (the decoder's last conv scaled by 2^-6, exact in
float32, so the PCM peaks below 1, as audio does, and int16 does not
clip it). Each package's Mimi config is patched to
the tiny one, as test_torch_pipeline.py patches Firefly's.

The routes draw argmax at temp 0, so codes are held exactly equal; the
serial route also samples (temp 0.7, top-k, top-p) on the JAX static
engine's own Gumbel draws (`_jax_static_draws`), its codes held exactly
equal too. PCM (float32, convolutions summed in other
orders) within 1e-4 of JAX's; where a batcher's central vocoder rounds it
to int16 on both sides, within 1e-4 plus two int16 steps.

One route departs from JAX: its central vocoder cannot reset one lane
of a Mimi stream (its KV ring keeps one position for every row, and the
masked select over lanes does not broadcast over it), so the port's
central-vocoder PCM is held to JAX's client-vocoded route instead."""

import pytest

pytest.importorskip("transformers")
pytest.importorskip("tokenizers")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from fish_speech_tpu import config as jcfg  # noqa: E402
from fish_speech_tpu.generate.continuous import ContinuousBatcher as JaxBatcher  # noqa: E402
from fish_speech_tpu.models.codec import mimi as jmimi  # noqa: E402
from fish_speech_tpu.models.dual_ar import init_dual_ar_params  # noqa: E402
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling  # noqa: E402
from fish_speech_tpu.pipeline import TTSPipeline as JaxPipeline  # noqa: E402
from fish_speech_tpu_torch import config as tcfg  # noqa: E402
from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher  # noqa: E402
from fish_speech_tpu_torch.generate.frame import FrameNoise  # noqa: E402
from fish_speech_tpu_torch.io.checkpoint import save_lm_params, save_safetensors  # noqa: E402
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy  # noqa: E402
from fish_speech_tpu_torch.models.codec import mimi as tmimi  # noqa: E402
from fish_speech_tpu_torch.ops.sampling import SamplingArgs  # noqa: E402
from fish_speech_tpu_torch.pipeline import TTSPipeline  # noqa: E402
from test_mimi import models as mimi_models  # noqa: E402,F401
from test_torch_mimi import port_cfg  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-4
I16 = 1.0 / 32767
MAX_NEW = 8
TEXT = "hello world . the provided text out . speak the text hello world ."
ARGMAX = dict(temp=0.0, top_p=0.8, top_k=256, repetition_penalty=1.2)
SAMPLED = dict(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.2)
LM_KW = dict(vocab_size=256, n_layer=2, n_fast_layer=2, n_head=4, dim=64,
             intermediate_size=128, n_local_heads=2, head_dim=16, rope_base=10000.0,
             norm_eps=1e-6, max_seq_len=256, codebook_size=32, num_codebooks=4,
             depthwise_wte=True, depthwise_output=True)
PCM_SCALE = 2.0**-6  # the Mimi decoder's last conv, weight and bias
WORDS = ["hello", "world", "speak", "out", "the", "provided", "text", "."]


def _write_tokenizer(path, codebook_size):
    """ChatML specials, `<|semantic:N|>` at 10..10+N-1, words from 50."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    vocab = {"<unk>": 0, "<|im_start|>": 1, "<|im_end|>": 4, "<|semantic|>": 5,
             "<|voice|>": 6}
    vocab.update({f"<|semantic:{i}|>": 10 + i for i in range(codebook_size)})
    vocab.update({w: 50 + i for i, w in enumerate(WORDS)})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(path))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, mimi_models):  # noqa: F811
    hf, _, _ = mimi_models
    d = tmp_path_factory.mktemp("dual_ar")
    jc = jcfg.DualARConfig(**LM_KW)
    params = dual_ar_params_from_numpy(jax.tree.map(np.asarray, init_dual_ar_params(
        jax.random.PRNGKey(0), jc, dtype=jnp.float32)))
    params["output"][:, 4] = 0.0  # <|im_end|> never wins: every generation runs its budget
    save_lm_params(d / "model.safetensors", params, tcfg.DualARConfig(**LM_KW))
    (d / "config.json").write_text(json.dumps(dataclasses.asdict(jc)))
    _write_tokenizer(d / "tokenizer.json", jc.codebook_size)
    sd = {k: v.detach().clone().contiguous() for k, v in hf.state_dict().items()}
    last = max((k for k in sd if k.startswith("decoder.layers.")),
               key=lambda k: int(k.split(".")[2]))
    for k in (last, last.replace("weight", "bias")):
        sd[k] = sd[k] * PCM_SCALE
    save_safetensors(d / "mimi.safetensors", sd)
    return d


@pytest.fixture(scope="module")
def pipes(ckpt, mimi_models):  # noqa: F811
    """(JAX pipeline, port pipeline), float32, temp 0, reroll off."""
    _, jmc, _ = mimi_models
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmimi, "MimiConfig", lambda: jmc)
        mp.setattr(tmimi.MimiConfig, "kyutai", staticmethod(lambda: port_cfg(jmc)))
        jp = JaxPipeline.load(ckpt, jcfg.WhichModel.DUAL_AR, lm_dtype=jnp.float32,
                              max_new_tokens=MAX_NEW)
        tp = TTSPipeline.load(ckpt, tcfg.WhichModel.DUAL_AR, lm_dtype=torch.float32,
                              max_new_tokens=MAX_NEW, device="cpu")
    jp.default_sampling, tp.default_sampling = JaxSampling(**ARGMAX), SamplingArgs(**ARGMAX)
    jp.reroll_on_runaway = tp.reroll_on_runaway = False
    return jp, tp


def _close(got, ref, atol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_load_builds_a_mimi_codec(pipes, ckpt):
    """The depthwise LM and a Mimi codec on the CPU, encoding the LM's 4
    codebooks; a missing mimi.safetensors is named."""
    jp, tp = pipes
    assert isinstance(tp.codec, tmimi.MimiCodec) and tp.codec.num_quantizers == 4
    assert tp.codec.device.type == tp.engine.device.type == "cpu"
    assert tp.codec.samples_per_frame == jp.codec.samples_per_frame == 160
    assert tp.engine.cfg.depthwise_wte and tp.engine.cfg.depthwise_output
    assert tp.engine.token_cfg == tcfg.TokenConfig(**dataclasses.asdict(jp.engine.token_cfg))
    assert tp._shift_output_tokens(np.arange(8).reshape(4, 2)).tolist() == \
        np.arange(8).reshape(4, 2).tolist()  # no Fish <= 1.4 shift
    with pytest.raises(FileNotFoundError, match="elsewhere.safetensors"):
        TTSPipeline.load(ckpt, tcfg.WhichModel.DUAL_AR, codec_file=ckpt / "elsewhere.safetensors",
                         device="cpu")


def test_serial_route(pipes):
    """Two text chunks, the second behind the cached prefix; Mimi streams,
    so each chunk runs through the overlapped driver in both packages."""
    jp, tp = pipes
    ref = list(jp.synthesize_streaming(TEXT, seed=3))
    got = list(tp.synthesize_streaming(TEXT, seed=3))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.codes, r.codes)
        assert g.codes.shape == (4, MAX_NEW)
        _close(g.pcm, r.pcm)
        _close(g.pcm, tp.codec.decode(g.codes)[0], 1e-5)
    assert 100 * I16 < np.abs(got[0].pcm).max() < 1.0


def _jax_static_draws(engine):
    """Make the port's batch-1 engine draw the JAX static engine's noise:
    init_state(seed) starts one key chain at PRNGKey(seed); each frame
    splits (chain, frame key) and the frame key (codebook key, semantic
    key); the semantic head draws min(top_k, head) Gumbel values from the
    semantic key, codebook step c min(top_k, V) from split(codebook key,
    C)[c]."""
    make, chain = engine.init_state, {}
    cfg, head = engine.cfg, engine.params["output"].shape[1]

    def init_state(seed=None):
        chain["key"] = jax.random.PRNGKey(seed)
        return make(seed)

    def noise(state, sampling, rows):
        chain["key"], frame_key = jax.random.split(chain["key"])
        cb_key, sem_key = jax.random.split(frame_key)
        draw = lambda k, n: torch.from_numpy(  # noqa: E731
            np.array(jax.random.gumbel(k, (len(rows), min(sampling.top_k, n)), jnp.float32)))
        return FrameNoise(semantic=draw(sem_key, head), codebooks=[
            draw(k, cfg.codebook_size) for k in jax.random.split(cb_key, cfg.num_codebooks)])

    engine.init_state, engine._noise = init_state, noise


def test_sampled_serial_route_on_jax_draws(pipes):
    """The serial route sampling (temp 0.7, top_k 16, top_p 0.8; the
    codebook rep-pen off under depthwise_wte) on the JAX engine's Gumbel
    draws: codes exactly JAX's, PCM within TOL."""
    jp, tp = pipes
    _jax_static_draws(tp.engine)
    try:
        ref = list(jp.synthesize_streaming(TEXT, sampling=JaxSampling(**SAMPLED), seed=11))
        got = list(tp.synthesize_streaming(TEXT, sampling=SamplingArgs(**SAMPLED), seed=11))
    finally:
        del tp.engine.init_state, tp.engine._noise
    assert len(got) == len(ref) == 2
    argmax = [c.codes for c in tp.synthesize_streaming(TEXT, seed=11)]
    for g, r, a in zip(got, ref, argmax):
        np.testing.assert_array_equal(g.codes, r.codes)
        _close(g.pcm, r.pcm)
        assert not np.array_equal(g.codes, a)  # the draws moved the codes


@pytest.mark.parametrize("frame_chunk", [2, 16])
def test_lowlatency_route(pipes, frame_chunk):
    """PCM every frame_chunk frames through a Mimi stream session: JAX's
    pieces, concatenating to the serial route's PCM."""
    jp, tp = pipes
    ref = list(jp.synthesize_streaming_lowlatency(TEXT, frame_chunk=frame_chunk, seed=1))
    got = list(tp.synthesize_streaming_lowlatency(TEXT, frame_chunk=frame_chunk, seed=1))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)
    serial = np.concatenate([c.pcm for c in tp.synthesize_streaming(TEXT, seed=1)])
    _close(np.concatenate(got), serial, 1e-5)


def test_batcher_routes(pipes):
    """A 2-row batcher without central vocoding: the client vocodes its
    frames through a Mimi session (a PCM chunk a text chunk) or every
    tick (low latency); JAX's PCM, and both routes equal to the serial
    route's codes' decode."""
    jp, tp = pipes
    jb = JaxBatcher(jp.create_batcher(rows=2, horizon=4).engine, jp.default_sampling, horizon=4)
    tb = ContinuousBatcher(tp.create_batcher(rows=2, horizon=4).engine, tp.default_sampling,
                           horizon=4)
    try:
        got = list(tp.synthesize_streaming_continuous(tb, TEXT, seed=5))
        ref = list(jp.synthesize_streaming_continuous(jb, TEXT, seed=5))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            _close(g, r)
        low = list(tp.synthesize_streaming_continuous_lowlatency(tb, TEXT, seed=5))
        _close(np.concatenate(low), np.concatenate(got), 1e-5)
    finally:
        jb.shutdown()
        tb.shutdown()
    serial = [c.codes for c in tp.synthesize_streaming(TEXT, seed=5)]
    _close(np.concatenate(got), np.concatenate([tp.codec.decode(c)[0] for c in serial]), 1e-5)
    assert all(s is None for s in tb.rows)


def test_central_vocoder_route(pipes):
    """create_batcher(2, 4) builds the central vocoder on the Mimi codec:
    two requests at once (each row its own lane of one 2-row stream, reset
    at each text chunk, sitting ticks out while it has no frames), PCM
    delivered as int16; each request's PCM is JAX's client-vocoded PCM of
    the same request within the int16 tolerance, and its low-latency
    pieces concatenate to it."""
    jp, tp = pipes
    tb = tp.create_batcher(rows=2, horizon=4)
    jb = JaxBatcher(jp.create_batcher(rows=2, horizon=4).engine, jp.default_sampling, horizon=4)
    assert tb._central is not None
    texts = (TEXT, "speak the text out .")
    try:
        outs = {}

        def run(i):
            outs[i] = list(tp.synthesize_streaming_continuous(tb, texts[i], seed=6 + i))

        import threading

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        low = list(tp.synthesize_streaming_continuous_lowlatency(tb, TEXT, seed=6))
        refs = [list(jp.synthesize_streaming_continuous(jb, texts[i], seed=6 + i))
                for i in range(2)]
    finally:
        tb.shutdown()
        jb.shutdown()
    for i in range(2):
        assert len(outs[i]) == len(refs[i])
        for g, r in zip(outs[i], refs[i]):
            _close(g, r, TOL + 2 * I16)
    _close(np.concatenate(low), np.concatenate(outs[0]), 2 * I16)
    assert all(s is None for s in tb.rows)


def test_jax_central_vocoder_cannot_reset_a_mimi_lane(pipes):
    """The divergence named above: JAX's lane reset over a 2-row Mimi
    stream state fails on the ring's shared positions; the port's
    per-row state takes it."""
    jp, tp = pipes
    jb = jp.create_batcher(rows=2, horizon=4)
    try:
        with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
            list(jp.synthesize_streaming_continuous(jb, TEXT, seed=6))
    finally:
        jb.shutdown()
