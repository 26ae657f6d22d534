"""The two serving faults repaired in the port, on the CPU at
test_torch_engine.py's tiny LM and test_torch_central_vocode.py's tiny
codec.

Request cancel. The JAX batcher has no cancel (its BatchedRequest,
fish_speech_tpu/generate/continuous.py:88): a request whose client went
away keeps its row decoding to the end of its budget, and the executor
thread that waits on it stays blocked. The port's
`BatchedRequest.cancel()` ends the request's iterators at once and, at
the next tick, frees its row (or drops it from the admission queue) and
its central-vocoder lane. Held here: in a 2-row batcher with 3 long
requests, one cancelled after its first event, the waiting request is
admitted at the first tick after the cancel; the others' codes equal
their codes in a run without the cancelled request; every row is free
at the end. The pipeline's generators cancel their request when closed,
and the server cancels it when its client disconnects (an Opus client
after its first audio bytes, a WAV client mid-request): the row returns
to admission and no thread is left waiting on the request.

TF32 during an encode. An encode on the card turns the process-wide TF32
switches off for its block (`FireflyCodec.encode`). Every codec call
now queues its work under one lock that the encode's block also holds,
so no feed or decode of another thread (the central vocoder's ticks)
runs inside an encode: each codec call's start and end is recorded while
encodes run beside a serving central-vocoder batcher, and no encode
overlaps a feed or a decode; an encode's codes during serving equal
those of an encode alone.

Every wait has a timeout."""

import asyncio
import sys
import threading
import time
import types
import zlib

import numpy as np
import pytest
import torch

from fish_speech_tpu.generate.continuous import BatchedRequest as JaxBatchedRequest
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.continuous import ContinuousBatcher, _ChunkResult
from fish_speech_tpu_torch.models.codec import firefly as tfire
from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec, init_firefly_params
from fish_speech_tpu_torch.ops.sampling import SamplingArgs
from fish_speech_tpu_torch.pipeline import TTSPipeline
from test_torch_central_vocode import _engine, codecs, make_prompt  # noqa: F401
from test_torch_checkpoint import codec_cfgs
from test_torch_engine import TOK

torch.set_num_threads(1)
WAIT = 60.0
MAX_NEW = 40  # a long request: ten ticks of horizon 4
TWO_CHUNKS = "hello world . the provided text out . speak the text hello world ."


def _until(cond, what, timeout=WAIT):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, f"timed out waiting for {what}"
        time.sleep(0.002)


def _batcher(codecs, central):  # noqa: F811
    return ContinuousBatcher(_engine(2), SamplingArgs(temp=0.8, top_k=8), horizon=4,
                             codec=codecs[1] if central else None, shift_fn=lambda c: c)


def _submit(batcher, i, central):
    return batcher.submit([make_prompt(6 + i)], cond_len=0, max_new=MAX_NEW, seed=100 + i,
                          stream=not central, deliver_pcm=central)


def _codes(req):
    results = [ev for ev in req.iter_events(timeout=WAIT) if isinstance(ev, _ChunkResult)]
    assert len(results) == 1
    return np.concatenate([results[0].semantic[None], results[0].tokens])


def _rows_free(batcher):
    return all(s is None for s in batcher.rows) and batcher.queue.empty()


def test_jax_request_has_no_cancel():
    """The divergence: the JAX BatchedRequest (continuous.py:88) has no
    cancel, so a request whose client went away keeps its row decoding;
    the port's has one."""
    assert not hasattr(JaxBatchedRequest, "cancel")
    from fish_speech_tpu_torch.generate.continuous import BatchedRequest

    assert callable(BatchedRequest.cancel)


@pytest.mark.parametrize("central", [False, True])
def test_cancel_frees_the_row_for_the_waiting_request(codecs, central):  # noqa: F811
    """Two rows, three long requests: the third waits for a row. The
    second is cancelled after its first event: its iterator ends, its row
    is freed and the third admitted at the first tick after the cancel,
    and the other two give the codes they give without it."""
    batcher = _batcher(codecs, central)
    try:
        reqs = [_submit(batcher, i, central) for i in range(3)]
        events = reqs[1].iter_events(timeout=WAIT)
        next(events)
        assert reqs[2].admitted_tick is None  # still waiting for a row
        reqs[1].cancel()
        assert list(events) == [] and list(reqs[1].iter_events(timeout=WAIT)) == []
        got = {i: _codes(reqs[i]) for i in (0, 2)}
        _until(lambda: _rows_free(batcher), "every row free")
        assert reqs[1].freed_tick is not None
        assert reqs[1].freed_tick <= reqs[1].cancel_tick + 1
        assert reqs[2].admitted_tick <= reqs[1].cancel_tick + 1
        assert reqs[1].freed_time >= reqs[1].cancel_time
        alone = {i: _codes(_submit(batcher, i, central)) for i in (0, 2)}
    finally:
        batcher.shutdown()
    for i in (0, 2):
        assert got[i].shape[1] == MAX_NEW
        np.testing.assert_array_equal(got[i], alone[i])


def test_cancel_while_queued_drops_the_request(codecs):  # noqa: F811
    """A request cancelled before a row was free is dropped from the
    admission queue at the next tick: it is never admitted, its
    iterator ends at once, and the others run as they would."""
    batcher = _batcher(codecs, central=False)
    try:
        reqs = [_submit(batcher, i, False) for i in range(3)]
        reqs[2].cancel()
        assert list(reqs[2].iter_chunks(timeout=WAIT)) == []
        _until(lambda: batcher.queue.empty(), "the queue purged")
        got = {i: _codes(reqs[i]) for i in (0, 1)}
        _until(lambda: _rows_free(batcher), "every row free")
        assert reqs[2].admitted_tick is None and reqs[2].freed_tick is None
        reqs[0].cancel()  # after the last result: a no-op
        assert not reqs[0].cancelled
        alone = _codes(_submit(batcher, 1, False))
    finally:
        batcher.shutdown()
    assert got[0].shape[1] == got[1].shape[1] == MAX_NEW
    np.testing.assert_array_equal(got[1], alone)


class StandInTokenizer:
    """ChatML specials at test_torch_engine.py's ids, words by crc32."""

    vocab = {"<|im_start|>": 1, "<|im_end|>": TOK["im_end_id"], "<|semantic|>": 5,
             "<|voice|>": 2, "<|semantic:0|>": TOK["semantic_start_id"]}

    def token_to_id(self, token):
        return self.vocab.get(token)

    def encode(self, text, add_special_tokens=False):
        import re

        return types.SimpleNamespace(ids=[
            self.vocab.get(w, 100 + zlib.crc32(w.encode()) % 800)
            for w in re.findall(r"<\|[^|]*\|>|\w+|[^\w\s]", text)])


@pytest.fixture(scope="module")
def pipeline():
    """A batch-1 pipeline on the tiny LM, with tests/test_server.py's tiny
    codec (128 samples a frame at 44.1 kHz, so a tick of 4 frames is
    enough audio for an Opus page within two ticks)."""
    engine = _engine(1)
    _, tc = codec_cfgs("1.5")
    codec = FireflyCodec(init_firefly_params(tc, seed=1, dtype=torch.float32, device="cpu"), tc,
                         device="cpu")
    return TTSPipeline(engine.__class__(engine.params, engine.cfg, engine.token_cfg, engine.lm,
                                        cache_len=64, max_frames=MAX_NEW, prompt_buckets=(16, 32),
                                        dtype=torch.float32, device="cpu",
                                        _params_preprocessed=True),
                       codec, StandInTokenizer(), tcfg.WhichLM.FISH_1_5, max_new_tokens=MAX_NEW)


@pytest.mark.parametrize("route", ["continuous", "continuous_lowlatency"])
def test_closing_the_generator_cancels(pipeline, route):
    """gen.close() after the first PCM (of two text chunks) cancels the
    request: its row is free at the next tick, and the batcher serves
    the next request."""
    batcher = pipeline.create_batcher(rows=2, horizon=4)
    handles = []
    try:
        gen = getattr(pipeline, f"synthesize_streaming_{route}")(
            batcher, TWO_CHUNKS, seed=1, on_submit=handles.append)
        assert next(gen).shape[0] > 0
        gen.close()
        (req,) = handles
        assert req.cancelled
        _until(lambda: req.freed_tick is not None and _rows_free(batcher), "the row freed")
        assert req.freed_tick <= req.cancel_tick + 1
        pcm = list(pipeline.synthesize_streaming_continuous(batcher, "hello world .", seed=1))
        assert len(pcm) == 1 and pcm[0].shape[0] > 0
    finally:
        batcher.shutdown()


def _threads_waiting_on_a_request():
    """Threads whose stack is inside a batcher request's wait."""
    out = []
    for tid, frame in sys._current_frames().items():
        f = frame
        while f is not None:
            if f.f_code.co_name == "_next" and "continuous" in f.f_code.co_filename:
                out.append(tid)
                break
            f = f.f_back
    return out


@pytest.mark.parametrize("fmt", ["opus", "wav"])
def test_server_client_disconnect_frees_row_and_thread(pipeline, fmt):
    """A streaming Opus client that reads its first audio bytes and
    closes, or a WAV client that goes away mid-request: the server
    cancels the batcher request, its row returns to admission, and no
    thread is left waiting on it."""
    pytest.importorskip("aiohttp")
    from aiohttp.test_utils import TestClient, TestServer

    from fish_speech_tpu_torch.audio.opus import OggOpusEncoder
    from fish_speech_tpu_torch.server.app import AppState, create_app

    if fmt == "opus" and not OggOpusEncoder.available():
        from fish_speech_tpu_torch.audio import _natlib

        pytest.skip(f"libfishaudio.so could not be built: {_natlib.build_error()}")
    batcher = pipeline.create_batcher(rows=2, horizon=4)
    decode_chunk = batcher.engine.decode_chunk

    def slow_tick(*a, **k):  # ten ticks of 30 ms: the client leaves mid-request
        time.sleep(0.03)
        return decode_chunk(*a, **k)

    batcher.engine.decode_chunk = slow_tick
    submitted = []
    submit = batcher.submit
    batcher.submit = lambda *a, **k: submitted.append(submit(*a, **k)) or submitted[-1]
    state = AppState(pipeline, batcher=batcher)
    body = {"input": "hello world .", "seed": 1, "response_format": fmt,
            "stream_chunk_frames": 4}

    async def run():
        client = TestClient(TestServer(create_app(state)))
        await client.start_server()
        try:
            if fmt == "opus":
                resp = await client.post("/v1/audio/speech", json=body)
                assert resp.status == 200 and resp.content_type == "audio/ogg"
                got = b""
                while got.count(b"OggS") < 3:  # OpusHead, OpusTags, then audio
                    got += await asyncio.wait_for(resp.content.readany(), WAIT)
                resp.close()
            else:
                post = asyncio.ensure_future(client.post("/v1/audio/speech", json=body))
                t0 = time.perf_counter()
                while not (submitted and submitted[0].admitted_tick is not None):
                    assert time.perf_counter() - t0 < WAIT
                    await asyncio.sleep(0.002)
                post.cancel()
            t0 = time.perf_counter()
            while not (submitted[0].freed_tick is not None and _rows_free(batcher)):
                assert time.perf_counter() - t0 < WAIT, "the row was not freed"
                await asyncio.sleep(0.002)
        finally:
            await client.close()

    try:
        asyncio.run(run())
        (req,) = submitted
        assert req.cancelled and req.freed_tick <= req.cancel_tick + 2
        assert req.ended is False and req.freed_time - req.cancel_time < WAIT
        _until(lambda: not _threads_waiting_on_a_request(), "no thread waiting on the request")
    finally:
        batcher.shutdown()


def test_no_encode_overlaps_a_feed_or_decode(pipeline, monkeypatch):
    """Encodes on one thread beside a central-vocoder batcher serving
    four requests: every codec call's interval is recorded (each encode
    held 20 ms inside its TF32 block, so that an unguarded feed would
    land in it), and no encode overlaps a feed or a decode; the codes
    equal those of an encode alone."""
    spans = []
    lock = threading.Lock()

    def recorded(name, fn, hold=0.0):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            time.sleep(hold)
            with lock:
                spans.append((name, t0, time.perf_counter()))
            return out
        return call

    audio = (np.random.default_rng(0).normal(size=4000) * 0.2).astype(np.float32)
    alone = pipeline.encode_reference_audio(audio, 24000)
    monkeypatch.setattr(tfire, "firefly_encode_mel",
                        recorded("encode", tfire.firefly_encode_mel, hold=0.02))
    monkeypatch.setattr(tfire, "firefly_decode_step",
                        recorded("feed", tfire.firefly_decode_step))
    monkeypatch.setattr(tfire, "firefly_decode", recorded("decode", tfire.firefly_decode))
    batcher = pipeline.create_batcher(rows=2, horizon=4)
    encoded = []
    try:
        serving = [threading.Thread(target=lambda i=i: list(
            pipeline.synthesize_streaming_continuous_lowlatency(batcher, "hello world .",
                                                                seed=i))) for i in range(4)]
        for t in serving:
            t.start()
        while any(t.is_alive() for t in serving) and len(encoded) < 20:
            encoded.append(pipeline.encode_reference_audio(audio, 24000))
        pipeline.codec.decode(alone)
        for t in serving:
            t.join(WAIT)
        assert not any(t.is_alive() for t in serving)
    finally:
        batcher.shutdown()
    enc = [(a, b) for n, a, b in spans if n == "encode"]
    other = [(a, b) for n, a, b in spans if n != "encode"]
    assert len(enc) >= 2 and sum(n == "feed" for n, _, _ in spans) >= 4
    overlaps = [(e, o) for e in enc for o in other if o[0] < e[1] and e[0] < o[1]]
    assert overlaps == []
    for codes in encoded:
        np.testing.assert_array_equal(codes, alone)


@pytest.mark.cuda
def test_cuda_server_core_small_depth():
    """On the card, the server's aiohttp-free core at the Fish-1.5 widths
    and two slow layers (bf16, random weights), a float32 Firefly-1.5
    codec (TF32 at PyTorch's defaults) and an 8-row batcher with the
    central vocoder: three WAV requests at once, an Opus stream where the
    native library builds, a request whose generator is closed after its
    first PCM (its row free within two ticks), and encodes beside the
    serving batcher equal to an encode alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    from fish_speech_tpu_torch.audio.decode import decode_audio_bytes
    from fish_speech_tpu_torch.audio.opus import OggOpusEncoder
    from fish_speech_tpu_torch.audio.wav import read_wav
    from fish_speech_tpu_torch.generate.engine import LMEngine
    from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
    from fish_speech_tpu_torch.server import core

    cfg = dataclasses.replace(tcfg.DualARConfig.fish_speech_1_5(), n_layer=2, n_fast_layer=1)
    tok = tcfg.TokenConfig(im_end_id=100011, pad_id=5, semantic_start_id=100012,
                           semantic_end_id=100012 + cfg.codebook_size - 1)
    params = init_dual_ar_params(cfg, 0, torch.bfloat16, "cuda")
    params["output"][:, tok.im_end_id] = 0
    fc = tcfg.FireflyConfig.for_version(tcfg.FishVersion.V1_5)
    codec = FireflyCodec(init_firefly_params(fc, seed=1, dtype=torch.float32, device="cuda"), fc)

    class Words(StandInTokenizer):
        vocab = {"<|im_start|>": 100010, "<|im_end|>": 100011, "<|semantic|>": 5,
                 "<|voice|>": 100008, "<|semantic:0|>": 100012}

    engine = LMEngine(params, cfg, tok, tcfg.WhichLM.FISH_1_5, cache_len=512, max_frames=32,
                      prompt_buckets=(64, 128))
    pipe = TTSPipeline(engine, codec, Words(), tcfg.WhichLM.FISH_1_5, max_new_tokens=32)
    pipe.reroll_on_runaway = False
    batcher = pipe.create_batcher(rows=8, horizon=8)
    assert batcher.engine.use_fused_slow and batcher.engine.use_fused_fast
    state = core.AppState(pipe, batcher=batcher)
    audio = (np.random.default_rng(0).normal(size=48000) * 0.2).astype(np.float32)
    alone = pipe.encode_reference_audio(audio, 24000)
    try:
        outs = [None] * 3

        def wav(i):
            req = core.SpeechRequest.parse({"input": f"hello world number {i} ."},
                                           pipe.default_sampling)
            outs[i] = read_wav(core.wav_bytes(state, core.wav_pcm(state, req)))[0]

        threads = [threading.Thread(target=wav, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        during = [pipe.encode_reference_audio(audio, 24000) for _ in range(3)]
        for t in threads:
            t.join(WAIT)
        for pcm in outs:
            assert pcm is not None and 0 < pcm.shape[0] <= 32 * codec.samples_per_frame
            assert np.isfinite(pcm).all()
        for codes in during:
            np.testing.assert_array_equal(codes, alone)
        handles = []
        gen = core.pcm_chunks(state, core.SpeechRequest.parse(
            {"input": "hello again .", "stream_chunk_frames": 8}, pipe.default_sampling),
            on_submit=handles.append)
        next(gen)
        gen.close()
        (req,) = handles
        _until(lambda: req.freed_tick is not None and _rows_free(batcher), "the row freed")
        assert req.freed_tick - req.cancel_tick <= 2
        if OggOpusEncoder.available():
            req = core.SpeechRequest.parse({"input": "hello opus .", "response_format": "opus",
                                            "stream_chunk_frames": 8}, pipe.default_sampling)
            pcm, rate = decode_audio_bytes(b"".join(core.opus_body(state, req)))
            assert rate == 48000 and pcm.shape[0] > 0 and np.isfinite(pcm).all()
    finally:
        batcher.shutdown()


def test_cancel_stress(codecs):  # noqa: F811
    """Eight client threads (more than the cores here) submit three long
    requests each to a 2-row central-vocoder batcher and cancel some of
    them at random points, the interpreter switching threads every 10 us:
    every iterator ends, every request not cancelled gets its result, and
    at the end every row is free and the queue empty."""
    import random
    import sys

    batcher = _batcher(codecs, central=True)
    results, errors = {}, []

    def client(c):
        rnd = random.Random(c)
        try:
            for j in range(3):
                req = batcher.submit([make_prompt(6 + (c + j) % 8, shift=c)], cond_len=0,
                                     max_new=MAX_NEW, seed=c * 3 + j, deliver_pcm=True)
                cut = rnd.choice([None, 0, 1, 3])
                frames = 0
                for n, ev in enumerate(req.iter_events(timeout=WAIT)):
                    if cut is not None and n == cut:
                        req.cancel()
                    if isinstance(ev, _ChunkResult):
                        frames = ev.tokens.shape[1]
                results[(c, j)] = (req.cancelled, frames)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(4 * WAIT)
        assert not any(t.is_alive() for t in threads) and errors == []
        _until(lambda: _rows_free(batcher), "every row free")
    finally:
        sys.setswitchinterval(old)
        batcher.shutdown()
    assert len(results) == 24
    for cancelled, frames in results.values():
        assert cancelled or 1 <= frames <= MAX_NEW
    assert any(c for c, _ in results.values()) and not all(c for c, _ in results.values())
