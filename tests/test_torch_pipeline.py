"""The port's TTSPipeline (fish_speech_tpu_torch/pipeline.py) against the
JAX package's, both loaded by `TTSPipeline.load` from one synthetic
checkpoint directory (tests/test_torch_cli.py's: a tiny LM in the
upstream key names with config.json and tokenizer.json, its <|im_end|>
head row zeroed, and the tiny Firefly-1.5 codec), in float32 on the CPU.

Every route runs at argmax (temp 0), so the codes are deterministic:
codes are held token-exact; PCM within 1e-4 absolute of JAX's (float32,
convolutions summed in another order; test_torch_stream_codec.py's
tolerance), and where a batcher's central vocoder delivers it as int16
on both sides, within 1e-4 plus one int16 step. The runaway reroll is
off (`reroll_on_runaway = False`, as the benchmark CLI sets it), so
every generation runs its budget deterministically; the reroll itself is
tested with a runaway forced on purpose. Encoded voices follow
test_torch_encode.py's tie rule."""

import pytest

pytest.importorskip("safetensors")
pytest.importorskip("tokenizers")

import dataclasses
import threading
import time

import jax.numpy as jnp
import numpy as np
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate import continuous as jcont
from fish_speech_tpu.generate.continuous import ContinuousBatcher as JaxBatcher
from fish_speech_tpu.ops.sampling import SamplingArgs as JaxSampling
from fish_speech_tpu.pipeline import TTSPipeline as JaxPipeline
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate import continuous as tcont
from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
from fish_speech_tpu_torch.pipeline import TTSPipeline
from test_torch_checkpoint import codec_cfgs
from test_torch_cli import ckpt  # noqa: F401 - the shared checkpoint fixture
from test_torch_encode import MAX_FLIP_SHARE

torch.set_num_threads(1)
TOL = 1e-4
I16 = 1.0 / 32767
MAX_NEW = 8
TEXT = "hello world . the provided text out . speak the text hello world ."
ARGMAX = dict(temp=0.0, top_p=0.8, top_k=256, repetition_penalty=1.4)


@pytest.fixture(scope="module")
def pipes(ckpt):  # noqa: F811
    """(JAX pipeline, port pipeline) from the same directory, float32,
    temp 0, reroll off, each with a voice of five code frames."""
    jc, tc = codec_cfgs("1.5")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcfg.FireflyConfig, "for_version", staticmethod(lambda v: jc))
        mp.setattr(tcfg.FireflyConfig, "for_version", staticmethod(lambda v: tc))
        jp = JaxPipeline.load(ckpt, jcfg.WhichModel.FISH_1_5, lm_dtype=jnp.float32,
                              max_new_tokens=MAX_NEW)
        tp = TTSPipeline.load(ckpt, tcfg.WhichModel.FISH_1_5, lm_dtype=torch.float32,
                              max_new_tokens=MAX_NEW, device="cpu")
    jp.default_sampling, tp.default_sampling = JaxSampling(**ARGMAX), SamplingArgs(**ARGMAX)
    jp.reroll_on_runaway = tp.reroll_on_runaway = False
    codes = np.load(ckpt / "voice.npy").astype(np.int32)
    voices = (jp.prompt_encoder.encode_conditioning_prompt("hello", codes),
              tp.prompt_encoder.encode_conditioning_prompt("hello", codes))
    np.testing.assert_array_equal(voices[0], voices[1])
    return jp, tp, voices[1]


class _CopyingJnp:
    """jax.numpy, with asarray copying its host input first."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def asarray(a, *args, **kwargs):
        return jnp.asarray(np.array(a, copy=True), *args, **kwargs)


@pytest.fixture
def jax_lane_resets(monkeypatch):
    """The JAX central vocoder's lane resets, made to happen. Its tick
    hands `jnp.asarray(self.reset_mask)` to the asynchronously dispatched
    reset and then clears the numpy array in place
    (fish_speech_tpu/generate/continuous.py:381-387); on the CPU the
    reset can read the array after the clear, the lane is not reset, and
    its request's next text chunk decodes on the previous chunk's carried
    state (hundreds of int16 steps off, when the delivery thread lags the
    scheduler). Where it runs a JAX central vocoder as the reference, a
    test takes the mask as it was when the tick used it; the port reads
    its mask before clearing it (test_central_lane_reset_in_a_lagging_
    interleaving)."""
    monkeypatch.setattr(jcont, "jnp", _CopyingJnp())


def _close(got, ref, atol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.float32 and got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_load_from_a_checkpoint_directory(pipes):
    jp, tp, _ = pipes
    assert tp.engine.cfg.num_codebooks == jp.engine.cfg.num_codebooks == 2
    assert tp.engine.device.type == tp.codec.device.type == "cpu"
    assert tp.engine.token_cfg.im_end_id == jp.engine.token_cfg.im_end_id
    assert tp.codec.cfg.samples_per_frame == jp.codec.cfg.samples_per_frame


@pytest.mark.parametrize("voiced", [False, True])
def test_synthesize_streaming_codes_and_pcm(pipes, voiced):
    """Two text chunks, the second prefilled behind the cached
    conditioning; the codec streams, so each chunk runs through the
    overlapped driver in both packages."""
    jp, tp, voice = pipes
    kw = dict(voice_conditioning=voice if voiced else None, seed=3)
    ref = list(jp.synthesize_streaming(TEXT, **kw))
    got = list(tp.synthesize_streaming(TEXT, **kw))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.codes, r.codes)
        np.testing.assert_array_equal(g.prompt, r.prompt)
        assert (g.result.frames, g.result.hit_max) == (r.result.frames, r.result.hit_max)
        _close(g.pcm, r.pcm)
    _close(tp.synthesize(TEXT, **kw), np.concatenate([r.pcm for r in ref]))


@pytest.mark.parametrize("frame_chunk", [3, 16])
def test_synthesize_streaming_lowlatency(pipes, frame_chunk):
    """PCM every frame_chunk frames: the same pieces as JAX's, and their
    concatenation the PCM of the serial route's codes."""
    jp, tp, voice = pipes
    kw = dict(voice_conditioning=voice, frame_chunk=frame_chunk, seed=1)
    ref = list(jp.synthesize_streaming_lowlatency(TEXT, **kw))
    got = list(tp.synthesize_streaming_lowlatency(TEXT, **kw))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g, r)
    serial = [c.codes for c in tp.synthesize_streaming(TEXT, voice_conditioning=voice, seed=1)]
    whole = np.concatenate([tp.codec.decode(c)[0] for c in serial])
    _close(np.concatenate(got), whole, atol=1e-5)


def test_synthesize_batched(pipes):
    """The two chunks in one group of three rows (padded with a copy of
    the last row, whose output is dropped): the same PCM as JAX's, chunk
    by chunk in order."""
    jp, tp, voice = pipes
    kw = dict(voice_conditioning=voice, seed=0)
    got = tp.synthesize_batched(TEXT, 3, **kw)
    _close(got, jp.synthesize_batched(TEXT, 3, **kw))
    assert tp._get_batch_engine(3) is tp._get_batch_engine(3)
    assert tp._get_batch_engine(3).params["output"] is tp.engine.params["output"]  # shared
    _close(tp.synthesize_batched(TEXT, 1, **kw), tp.synthesize(TEXT, **kw))


def test_synthesize_with_hidden(pipes):
    jp, tp, voice = pipes
    kw = dict(voice_conditioning=voice, seed=2)
    hidden, pcm = tp.synthesize_with_hidden(TEXT, **kw)
    jhidden, jpcm = jp.synthesize_with_hidden(TEXT, **kw)
    assert hidden.shape == jhidden.shape and hidden.shape[1] == tp.engine.cfg.dim
    np.testing.assert_allclose(hidden, jhidden, rtol=TOL, atol=TOL)
    _close(pcm, jpcm)
    assert tp.synthesize_with_hidden(TEXT, return_audio=False, seed=2)[1] is None


def test_encode_reference_audio(pipes):
    """A 24 kHz voice resampled to the codec rate and encoded: the same
    codes as JAX's but where a value lies near a rounding tie (at most
    MAX_FLIP_SHARE of them)."""
    jp, tp, _ = pipes
    audio = (np.random.default_rng(4).normal(size=6000) * 0.2).astype(np.float32)
    got = tp.encode_reference_audio(audio, 24000)
    ref = np.asarray(jp.encode_reference_audio(audio, 24000))
    assert got.shape == ref.shape and got.shape[0] == 2
    assert np.count_nonzero(got != ref) <= MAX_FLIP_SHARE * got.size


def _batchers(jp, tp, central):
    """Two-row, horizon-4 batchers of both packages, through
    create_batcher; without central vocoding, a batcher on the same
    engine without the codec."""
    jb, tb = jp.create_batcher(rows=2, horizon=4), tp.create_batcher(rows=2, horizon=4)
    assert (jb._central is not None) and (tb._central is not None)
    assert tb.engine.params["output"] is tp.engine.params["output"] and tb.engine.dynamic_sampling
    if not central:
        jb.shutdown()
        tb.shutdown()
        jb = JaxBatcher(jb.engine, jp.default_sampling, horizon=4)
        tb = ContinuousBatcher(tb.engine, tp.default_sampling, horizon=4)
    return jb, tb


@pytest.mark.parametrize("central", [True, False])
def test_continuous_routes(pipes, central, jax_lane_resets):
    """synthesize_streaming_continuous (a PCM chunk a text chunk) and its
    low-latency form (PCM every tick) through a 2-row batcher, with the
    central vocoder and with the client vocoding: the PCM of JAX's, and
    the low-latency pieces concatenate to the per-chunk PCM."""
    jp, tp, voice = pipes
    jb, tb = _batchers(jp, tp, central)
    atol = TOL + 2 * I16 if central else TOL
    kw = dict(voice_conditioning=voice, seed=5)
    try:
        got = list(tp.synthesize_streaming_continuous(tb, TEXT, **kw))
        ref = list(jp.synthesize_streaming_continuous(jb, TEXT, **kw))
        assert len(got) == len(ref) == 2
        for g, r in zip(got, ref):
            assert g.shape[0] % tp.codec.samples_per_frame == 0
            _close(g, r, atol)
        low = list(tp.synthesize_streaming_continuous_lowlatency(tb, TEXT, **kw))
        jlow = list(jp.synthesize_streaming_continuous_lowlatency(jb, TEXT, **kw))
        _close(np.concatenate(low), np.concatenate(jlow), atol)
        _close(np.concatenate(low), np.concatenate(got), 1e-5 if not central else 2 * I16)
    finally:
        jb.shutdown()
        tb.shutdown()
    assert all(s is None for s in tb.rows)


def test_central_lane_reset_in_a_lagging_interleaving(pipes, monkeypatch):
    """The interleaving in which the JAX central vocoder skips a lane's
    reset (jax_lane_resets): the delivery thread's copies slowed by 50 ms
    and a second request arriving a second after the first, so that the
    first request's second text chunk is admitted, and its lane reset,
    while the other lane streams. Each request's PCM through the port's
    create_batcher(2, 4) is its codes' decode, within one int16 step."""
    _, tp, voice = pipes
    get = tcont._Fetch.get
    monkeypatch.setattr(tcont._Fetch, "get", lambda self: (time.sleep(0.05), get(self))[1])
    texts = ((TEXT, 2), ("hello world .", 3))
    batcher = tp.create_batcher(rows=2, horizon=4)
    outs = {}

    def run(i):
        text, seed = texts[i]
        outs[i] = np.concatenate(list(tp.synthesize_streaming_continuous(
            batcher, text, voice_conditioning=voice, seed=seed)))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    try:
        threads[0].start()
        time.sleep(1.0)
        threads[1].start()
        for t in threads:
            t.join(timeout=300)
    finally:
        batcher.shutdown()
    for i, (text, seed) in enumerate(texts):
        codes = [c.codes for c in tp.synthesize_streaming(text, voice_conditioning=voice,
                                                          seed=seed)]
        _close(outs[i], np.concatenate([tp.codec.decode(c)[0] for c in codes]), I16)


def test_shift_output_tokens():
    """Fish <= 1.4 codebook tokens come out +1 and are shifted back,
    clamped at 0; Fish 1.5 and DualAR pass through."""
    codes = np.random.default_rng(0).integers(0, 9, size=(2, 12)).astype(np.int32)

    class Stub:  # what the constructor reads of an engine and a codec
        cfg = dataclasses.replace(tcfg.DualARConfig.fish_speech_1_5(), num_codebooks=2)
        device = torch.device("cpu")

    for lm in ("FISH_1_2", "FISH_1_4", "FISH_1_5", "DUAL_AR"):
        tp = TTSPipeline(Stub(), Stub(), None, tcfg.WhichLM[lm])
        jp = JaxPipeline.__new__(JaxPipeline)
        jp.lm = jcfg.WhichLM[lm]
        got = tp._shift_output_tokens(codes)
        np.testing.assert_array_equal(got, jp._shift_output_tokens(codes))
        assert got.dtype == np.int32


@pytest.mark.parametrize("attempts", [1, 2])
def test_reroll_on_a_forced_runaway(pipes, attempts, monkeypatch):
    """The <|im_end|> row is zeroed, so every chunk runs away (hits its
    budget). With the reroll on, a chunk whose first attempt alone is
    marked a runaway is rewound and generated again (the second result
    kept, equal to JAX's); one that runs away twice raises, in both
    packages."""
    jp, tp, voice = pipes
    for p in (jp, tp):
        monkeypatch.setattr(p, "reroll_on_runaway", True)
    calls = {"jax": 0, "port": 0}

    def forced(module, name, key):
        orig = getattr(module, name)

        def run(*a, **k):
            calls[key] += 1
            pcm, result, state = orig(*a, **k)
            return pcm, result._replace(hit_max=calls[key] <= attempts), state
        monkeypatch.setattr(module, name, run)

    import fish_speech_tpu.generate.overlap as jov
    import fish_speech_tpu_torch.pipeline as tpipe

    forced(jov, "generate_vocode_overlapped", "jax")
    forced(tpipe, "generate_vocode_overlapped", "port")
    kw = dict(voice_conditioning=voice, seed=0)
    if attempts == 2:
        for p in (jp, tp):
            with pytest.raises(RuntimeError, match="ran away twice"):
                p.synthesize(TEXT, **kw)
        assert calls == {"jax": 2, "port": 2}
        return
    got, ref = tp.synthesize(TEXT, **kw), jp.synthesize(TEXT, **kw)
    assert calls == {"jax": 3, "port": 3}  # two attempts of chunk 1, one of chunk 2
    monkeypatch.setattr(tp, "reroll_on_runaway", False)
    _close(got, ref)
    _close(got, tp.synthesize(TEXT, **kw), atol=0)


def test_warmup_codec_keeps_the_codec_exact(pipes):
    """warmup_codec runs the one-frame and budget decodes and the stream
    steps without touching the codec's state: decodes after it are
    bit-equal to decodes before."""
    _, tp, _ = pipes
    codes = np.random.default_rng(1).integers(0, 1000, size=(2, 5)).astype(np.int32)
    before = tp.codec.decode(codes)
    tp.warmup_codec(frame_chunk=4)
    np.testing.assert_array_equal(tp.codec.decode(codes), before)


def test_benchmark_cli_modes(monkeypatch, capsys):
    """cli/benchmark.py with random weights (the Fish-1.5 architecture
    patched down to one narrow layer each and the tiny codec) runs its
    warm-up and three scenarios on the port's pipeline, each a fixed
    length (reroll off, <|im_end|> column zeroed)."""
    from fish_speech_tpu_torch.cli import benchmark

    tiny = dataclasses.replace(tcfg.DualARConfig.fish_speech_1_5(), n_layer=1, n_fast_layer=1,
                               n_head=2, n_local_heads=1, dim=32, head_dim=16,
                               intermediate_size=64, codebook_size=8, num_codebooks=2)
    _, tc = codec_cfgs("1.5")
    monkeypatch.setattr(tcfg.DualARConfig, "fish_speech_1_5", staticmethod(lambda: tiny))
    monkeypatch.setattr(tcfg.FireflyConfig, "for_version", staticmethod(lambda v: tc))
    pipe = benchmark._load_random_pipeline("cpu")
    assert not pipe.reroll_on_runaway and pipe.engine.cache_len == 2048
    monkeypatch.setattr(benchmark, "_load_random_pipeline", lambda device: pipe)
    benchmark.main(["--device", "cpu", "--max-new-tokens", "3"])
    err = capsys.readouterr().err
    for label in ("unbatched", "batch_size=1", "batch_size=4"):
        line = next(ln for ln in err.splitlines() if ln.startswith(f"{label}:"))
        assert "RTF" in line and "FAILED" not in line
    assert f"audio {3 * 128 / 44100:.2f}s" in err  # one text chunk of three frames


def test_burst_first_frames_are_drawn_at_the_whole_batch(monkeypatch):
    """A dynamic engine draws an admission burst's first frames at its
    whole batch (rows past the burst are copies, thrown away): the shape
    of every product, and so cuBLAS's summation order, is the same for a
    request admitted alone or among others. On the H100 a 16-row engine's
    burst of 8 drew other codebook tokens for a row than the same row
    alone (chip_smoke.py's server phase found it). Each row's frame
    equals its frame alone."""
    import fish_speech_tpu_torch.generate.engine as engmod
    from test_torch_central_vocode import _engine, make_prompt

    engine = _engine(4)
    seen = []
    orig = engmod.generate_frame

    def recording(*a, **k):
        seen.append(a[5].shape[0])  # logits
        return orig(*a, **k)

    monkeypatch.setattr(engmod, "generate_frame", recording)
    s = SamplingArgs(temp=0.8, top_k=8)
    prompts = [make_prompt(5 + i) for i in range(3)]
    _, burst, _ = engine.prefill_rows(engine.init_state(0), prompts, s, 1,
                                      per_row=[(s, 10 + i) for i in range(3)])
    assert seen == [4]
    for i in range(3):
        _, alone, _ = engine.prefill_rows(engine.init_state(0), [prompts[i]], s, 0,
                                          per_row=[(s, 10 + i)])
        np.testing.assert_array_equal(burst[i].numpy(), alone[0].numpy())
