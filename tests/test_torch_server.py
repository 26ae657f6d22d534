"""The port's HTTP server (fish_speech_tpu_torch/server/{app,core,voices}.py)
against the JAX package's app, on test_torch_pipeline.py's two pipelines
(one synthetic checkpoint directory, float32, temp 0, reroll off), each
route driven through aiohttp's test client on both apps:

* status, content type and CORS headers equal on every route, errors
  (400, 500, 501 and the error middleware's JSON) included;
* WAV: the serial, static-batch (batch_size 2) and continuous-batcher
  routes' PCM within 1e-4 of JAX's (3.3 int16 steps, plus one of
  rounding), and the port's WAV bytes equal JAX's writer's bytes of the
  port's PCM;
* Opus: for the same PCM, the serial and low-latency streams are equal
  byte for byte (the pipelines' generators patched to yield the same
  chunks); from real generation both streams decode to the same length;
* /v1/audio/encoding: the .npy codes by test_torch_encode.py's tie rule,
  the registered voice, and the persisted npy and index.json equal;
* the hidden-states ZIP, /v1/voices, /healthz and the /metrics counters;
* the connection closed on a failure mid-stream;
* the aiohttp-free core on its own: its Opus body equals the route's."""

import asyncio
import io
import json
import zipfile

import numpy as np
import pytest

aiohttp = pytest.importorskip("aiohttp")
from aiohttp.test_utils import TestClient, TestServer  # noqa: E402

from fish_speech_tpu.audio import opus as jopus  # noqa: E402
from fish_speech_tpu.audio.wav import pcm_to_wav_bytes as jax_wav_bytes  # noqa: E402
from fish_speech_tpu.audio.wav import read_wav  # noqa: E402
from fish_speech_tpu.server import app as japp  # noqa: E402
from fish_speech_tpu.server.voices import load_speaker_prompts as jax_load_voices  # noqa: E402
from fish_speech_tpu_torch.audio import opus as topus  # noqa: E402
from fish_speech_tpu_torch.audio.decode import decode_audio_bytes  # noqa: E402
from fish_speech_tpu_torch.server import app as tapp  # noqa: E402
from fish_speech_tpu_torch.server import core  # noqa: E402
from fish_speech_tpu_torch.server.voices import load_speaker_prompts  # noqa: E402
from test_torch_cli import ckpt  # noqa: E402,F401
from test_torch_encode import MAX_FLIP_SHARE  # noqa: E402
from test_torch_pipeline import MAX_NEW, TEXT, TOL, jax_lane_resets, pipes  # noqa: E402,F401

I16 = 1.0 / 32767
WAV_TOL = TOL + I16  # PCM within TOL, each side rounded to int16
ORIGIN = {"Origin": "http://example.com"}
CORS_KEYS = ("Access-Control-Allow-Origin", "Access-Control-Allow-Methods",
             "Access-Control-Allow-Headers", "Access-Control-Expose-Headers")


def _need_opus():
    if not topus.OggOpusEncoder.available():
        from fish_speech_tpu_torch.audio import _natlib

        pytest.skip(f"libfishaudio.so could not be built: {_natlib.build_error()}")
    if not jopus.OggOpusEncoder.available():
        pytest.skip("the JAX package's native encoder could not be built")


@pytest.fixture
def states(pipes):  # noqa: F811
    """(JAX AppState, port AppState), each with its pipeline's "default"
    voice and no batcher."""
    jp, tp, voice = pipes
    return (japp.AppState(jp, {"default": voice}, voice),
            tapp.AppState(tp, {"default": voice}, voice))


def _both(states, fn):
    """Run `fn(client)` against the JAX app and the port's app; returns
    (JAX's result, the port's)."""
    async def run():
        out = []
        for module, state in zip((japp, tapp), states):
            client = TestClient(TestServer(module.create_app(state)),
                                timeout=aiohttp.ClientTimeout(total=300))
            await client.start_server()
            try:
                out.append(await fn(client))
            finally:
                await client.close()
        return out

    return asyncio.run(run())


async def _reply(resp):
    """What is compared of a response: status, content type, the CORS
    headers, and the body."""
    body = await resp.read()
    return (resp.status, resp.content_type,
            {k: resp.headers.get(k) for k in CORS_KEYS}), body


def _same_head(ref, got):
    assert got[0] == ref[0], (got[0], ref[0])
    return ref[1], got[1]


def _wav_close(ref_body, got_body):
    ref, rate = read_wav(ref_body)
    got, got_rate = read_wav(got_body)
    assert got_rate == rate and got.shape == ref.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=WAV_TOL + 1e-6)
    assert got_body[:44] == ref_body[:44]  # the same header, lengths included


def test_voices_healthz_cors_and_errors(states):
    async def fn(client):
        out = [await _reply(await client.get("/v1/voices", headers=ORIGIN)),
               await _reply(await client.get("/healthz")),
               await _reply(await client.options("/v1/audio/speech", headers={
                   **ORIGIN, "Access-Control-Request-Method": "POST",
                   "Access-Control-Request-Headers": "content-type"})),
               await _reply(await client.post("/v1/audio/speech", data=b"{not json",
                                              headers=ORIGIN)),
               await _reply(await client.post("/v1/audio/encoding", data=b"--b--\r\n", headers={
                   **ORIGIN, "Content-Type": "multipart/form-data; boundary=b"}))]
        return out

    ref, got = _both(states, fn)
    for r, g in zip(ref, got):
        assert g[0] == r[0], (g[0], r[0])
    assert json.loads(got[0][1]) == {"voices": ["default"]}
    assert json.loads(got[1][1]) == json.loads(ref[1][1])
    assert got[2][0][0] == 204
    assert got[3][0][:2] == (500, "application/json") and "error" in json.loads(got[3][1])
    assert got[4][0][0] == 400 and got[4][1] == ref[4][1] == b"No file provided"


@pytest.mark.parametrize("body", [
    {"voice": "default", "input": TEXT, "seed": 1},
    {"voice": "unconditioned", "input": TEXT, "seed": 1, "temperature": 0.0},
    {"voice": "default", "input": TEXT, "batch_size": 2},
], ids=["serial", "unconditioned", "static_batch"])
def test_speech_wav(states, body):
    async def fn(client):
        return await _reply(await client.post("/v1/audio/speech", json=body, headers=ORIGIN))

    ref, got = _both(states, fn)
    assert got[0] == (200, "audio/wav", got[0][2]) and got[0] == ref[0]
    _wav_close(*_same_head(ref, got))
    # the port's bytes are JAX's WAV writer's bytes of the port's PCM
    pcm = core.wav_pcm(states[1], core.SpeechRequest.parse(
        body, states[1].pipeline.default_sampling))
    assert got[1] == jax_wav_bytes(pcm, states[1].pipeline.codec.sample_rate)


def test_speech_through_the_batcher(pipes, jax_lane_resets):  # noqa: F811
    """Two concurrent WAV requests and one low-latency Opus request
    through each package's create_batcher(2, 4) (central vocoder): the
    same statuses and headers, the WAV PCM within tolerance. The JAX
    central vocoder's lane resets are made to happen (jax_lane_resets):
    it skipped one when its delivery thread lagged, and its first
    request's second text chunk came out hundreds of int16 steps off."""
    jp, tp, voice = pipes
    batchers = (jp.create_batcher(rows=2, horizon=4), tp.create_batcher(rows=2, horizon=4))
    states = tuple(m.AppState(p, {"default": voice}, voice, batcher=b)
                   for m, p, b in zip((japp, tapp), (jp, tp), batchers))

    async def fn(client):
        bodies = [{"voice": "default", "input": TEXT, "seed": 2},
                  {"voice": "default", "input": "hello world .", "seed": 3}]
        resps = await asyncio.gather(*[client.post("/v1/audio/speech", json=b) for b in bodies])
        out = [await _reply(r) for r in resps]
        if topus.OggOpusEncoder.available():
            out.append(await _reply(await client.post("/v1/audio/speech", json={
                "voice": "default", "input": TEXT, "response_format": "opus",
                "stream_chunk_frames": 4, "seed": 2})))
        out.append((await _reply(await client.get("/healthz")))[1])
        return out

    try:
        ref, got = _both(states, fn)
    finally:
        for b in batchers:
            b.shutdown()
    for r, g in zip(ref[:2], got[:2]):
        _wav_close(*_same_head(r, g))
    if len(got) == 4:
        assert got[2][0] == ref[2][0] and got[2][0][:2] == (200, "audio/ogg")
        pcm, rate = decode_audio_bytes(got[2][1])
        assert pcm.shape == decode_audio_bytes(ref[2][1])[0].shape and rate == 48000
    assert json.loads(got[-1])["continuous_batching"] is True
    assert all(s is None for s in batchers[1].rows)


def _fixed_chunks(monkeypatch, pipelines, n=3):
    """Both pipelines' serial streaming generators yield the same PCM
    chunks (noise at the codec rate), so the servers' Opus framing is
    compared on equal input."""
    rng = np.random.default_rng(9)
    chunks = [(rng.normal(size=2000 + 700 * i) * 0.1).astype(np.float32) for i in range(n)]

    class Chunk:
        def __init__(self, pcm):
            self.pcm = pcm

    for p in pipelines:
        monkeypatch.setattr(p, "synthesize_streaming",
                            lambda text, **kw: (Chunk(c) for c in chunks))
        monkeypatch.setattr(p, "synthesize_streaming_lowlatency",
                            lambda text, **kw: iter(chunks))
    return chunks


@pytest.mark.parametrize("lowlatency", [False, True])
def test_opus_stream_bytes_equal(states, monkeypatch, lowlatency):
    """For the same PCM the two servers stream the same Ogg/Opus bytes
    (24 kHz through a carried-phase resampler, 1024-byte writes), and the
    aiohttp-free core's body is the same bytes."""
    _need_opus()
    _fixed_chunks(monkeypatch, [s.pipeline for s in states])
    body = {"voice": "default", "input": TEXT, "response_format": "opus", "seed": 1}
    if lowlatency:
        body["stream_chunk_frames"] = 4

    async def fn(client):
        return await _reply(await client.post("/v1/audio/speech", json=body, headers=ORIGIN))

    ref, got = _both(states, fn)
    assert got[0] == ref[0] and got[0][:2] == (200, "audio/ogg")
    assert got[1] == ref[1] and got[1][:4] == b"OggS"
    req = core.SpeechRequest.parse(body, states[1].pipeline.default_sampling)
    assert b"".join(core.opus_body(states[1], req)) == got[1]


def test_opus_from_generation(states):
    """Real generation on both: the streams decode to the same length."""
    _need_opus()
    body = {"voice": "default", "input": TEXT, "response_format": "opus", "seed": 1}

    async def fn(client):
        return await _reply(await client.post("/v1/audio/speech", json=body))

    ref, got = _both(states, fn)
    assert got[0] == ref[0]
    pcm, rate = decode_audio_bytes(got[1])
    ref_pcm, _ = decode_audio_bytes(ref[1])
    assert rate == 48000 and pcm.shape == ref_pcm.shape and np.isfinite(pcm).all()


def test_opus_is_501_without_the_native_encoder(states, monkeypatch):
    for cls in (topus.OggOpusEncoder, jopus.OggOpusEncoder):
        monkeypatch.setattr(cls, "available", staticmethod(lambda: False))

    async def fn(client):
        return await _reply(await client.post("/v1/audio/speech", headers=ORIGIN, json={
            "input": "hi .", "response_format": "opus"}))

    ref, got = _both(states, fn)
    assert got == ref and got[0][0] == 501
    assert got[0][2]["Access-Control-Allow-Origin"] == "*"


def test_encoding_registers_and_persists_the_voice(states, tmp_path):
    audio = (np.random.default_rng(0).normal(size=6400) * 0.1).astype(np.float32)
    wav = jax_wav_bytes(audio, 44100)
    for i, s in enumerate(states):
        s.persist_voice_dir = tmp_path / str(i)

    async def fn(client):
        form = aiohttp.FormData()
        form.add_field("file", wav, filename="ref.wav", content_type="audio/wav")
        first = await _reply(await client.post("/v1/audio/encoding?id=cloned&prompt=hello",
                                               data=form, headers=ORIGIN))
        form = aiohttp.FormData()
        form.add_field("file", wav, filename="ref.wav", content_type="audio/wav")
        again = await _reply(await client.post("/v1/audio/encoding?id=cloned&prompt=hello",
                                               data=form))
        voices = await client.get("/v1/voices")
        return first, again, await voices.json()

    ref, got = _both(states, fn)
    (r_head, r_body), (g_head, g_body) = ref[0], got[0]
    assert g_head == r_head and g_head[:2] == (200, "application/x-npy")
    codes, ref_codes = np.load(io.BytesIO(g_body)), np.load(io.BytesIO(r_body))
    assert codes.dtype == ref_codes.dtype == np.uint32 and codes.shape == ref_codes.shape
    assert np.count_nonzero(codes != ref_codes) <= MAX_FLIP_SHARE * codes.size
    assert got[1] == ref[1] and got[1][0][0] == 500  # the id exists
    assert got[2] == ref[2] == {"voices": ["cloned", "default"]}
    np.testing.assert_array_equal(np.load(tmp_path / "1" / "cloned.npy"), codes)
    assert (tmp_path / "1" / "index.json").read_text() == \
        (tmp_path / "0" / "index.json").read_text()
    jp, tp = (s.pipeline for s in states)
    np.testing.assert_array_equal(states[1].voices["cloned"],
                                  tp.prompt_encoder.encode_conditioning_prompt("hello", codes))
    for i in "01":  # the persisted directory loads back through both loaders
        (tmp_path / i / "default.npy").write_bytes((tmp_path / i / "cloned.npy").read_bytes())
        idx = json.loads((tmp_path / i / "index.json").read_text())
        (tmp_path / i / "index.json").write_text(json.dumps(
            {"speakers": {**idx["speakers"], "default": "hello"}}))
    voices, default = load_speaker_prompts(tmp_path / "1", tp.prompt_encoder, 2)
    jvoices, _ = jax_load_voices(tmp_path / "1", jp.prompt_encoder, 2)
    assert voices.keys() == jvoices.keys()
    for k in voices:
        np.testing.assert_array_equal(voices[k], jvoices[k])
    np.testing.assert_array_equal(default, voices["default"])


def test_hidden_states_zip(states):
    body = {"voice": "default", "input": TEXT, "return_audio": True, "seed": 1}

    async def fn(client):
        return await _reply(await client.post("/v1/audio/hidden_states", json=body))

    ref, got = _both(states, fn)
    assert got[0] == ref[0] and got[0][:2] == (200, "application/zip")
    zr, zg = zipfile.ZipFile(io.BytesIO(ref[1])), zipfile.ZipFile(io.BytesIO(got[1]))
    assert zg.namelist() == zr.namelist() == ["hidden_states.npy", "audio.wav", "metadata.json"]
    hidden = np.load(io.BytesIO(zg.read("hidden_states.npy")))
    np.testing.assert_allclose(hidden, np.load(io.BytesIO(zr.read("hidden_states.npy"))),
                               rtol=TOL, atol=TOL)
    assert json.loads(zg.read("metadata.json")) == json.loads(zr.read("metadata.json"))
    _wav_close(zr.read("audio.wav"), zg.read("audio.wav"))


def test_metrics_counters(states):
    async def fn(client):
        await client.get("/healthz")
        await (await client.post("/v1/audio/speech", json={
            "voice": "default", "input": "hello world .", "seed": 1})).read()
        await client.get("/v1/voices")
        return await (await client.get("/metrics")).text()

    ref, got = _both(states, fn)

    def counters(text):
        return sorted(line for line in text.splitlines()
                      if line.startswith(("fish_requests_total", "fish_requests_in_flight",
                                          "fish_audio_seconds_total", "#")))

    assert counters(got) == counters(ref)
    assert 'fish_requests_total{route="/v1/audio/speech",status="200"} 1' in got
    assert "fish_requests_in_flight 1" in got


def test_midstream_failure_closes_the_connection(states, monkeypatch):
    """A generation failure after the headers went out (no 500 possible)
    closes the connection, so the client sees a cut stream at once."""
    _need_opus()
    import time

    class Chunk:
        pcm = np.zeros(3000, np.float32)

    def boom(text, **kw):
        yield Chunk()
        raise RuntimeError("generation ran away (synthetic)")

    for s in states:
        monkeypatch.setattr(s.pipeline, "synthesize_streaming", boom)

    async def fn(client):
        resp = await client.post("/v1/audio/speech", json={
            "voice": "default", "input": "hello .", "response_format": "opus"})
        assert resp.status == 200
        t0 = time.perf_counter()
        with pytest.raises(aiohttp.ClientError):
            await resp.read()
        return time.perf_counter() - t0

    ref, got = _both(states, fn)
    assert got < 60 and ref < 60


def test_core_routes_without_aiohttp(pipes):  # noqa: F811
    """The core's route choice and its WAV route, called directly."""
    _, tp, voice = pipes
    state = core.AppState(tp, {"default": voice}, voice)
    parse = lambda body: core.SpeechRequest.parse(body, tp.default_sampling)  # noqa: E731
    req = parse({"input": TEXT, "seed": 4, "top_k": 5, "max_new_tokens": 6})
    assert (req.seed, req.max_new, req.sampling.top_k, req.sampling.temp) == (4, 6, 5, 0.0)
    assert not core.use_batcher(state, req)
    pcm = core.wav_pcm(state, req)
    np.testing.assert_array_equal(
        pcm, tp.synthesize(TEXT, voice_conditioning=voice, seed=4, max_new_tokens=6,
                           sampling=req.sampling))
    batcher = tp.create_batcher(rows=2, horizon=4)
    try:
        state.batcher = batcher
        assert core.use_batcher(state, parse({"input": "x", "stream_chunk_frames": 4}))
        assert not core.use_batcher(state, parse({"input": "x", "stream_chunk_frames": 2}))
        assert not core.use_batcher(state, parse({"input": "x", "batch_size": 2}))
        assert core.resolve_voice(state, "unconditioned") is None
        assert core.resolve_voice(state, "nobody") is voice
        got = core.wav_pcm(state, parse({"input": "hello world .", "seed": 2}))
        ref = np.concatenate(list(tp.synthesize_streaming_continuous(
            batcher, "hello world .", voice_conditioning=voice, seed=2)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * I16)
    finally:
        batcher.shutdown()
