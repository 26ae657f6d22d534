"""The server's request logic, without aiohttp.

Counterpart of the request handling in `fish_speech_tpu/server/app.py`:
body parsing, voice resolution, the choice of route, the PCM generators,
Opus framing, the hidden-states ZIP, voice registration and the metrics.
`server/app.py` is a thin aiohttp layer over these functions; a caller
without aiohttp (a machine where it is missing) drives them directly.

Routes of POST /v1/audio/speech, as in JAX:

* with a batcher (and no `batch_size`, and a `stream_chunk_frames` of at
  least the batcher's horizon): the continuous batcher, per text chunk or
  (with `stream_chunk_frames`) per scheduler tick;
* otherwise the serial engine under the state's lock: per text chunk, or
  every `stream_chunk_frames` frames (`synthesize_streaming_lowlatency`),
  or, for WAV with `batch_size` > 1, static batching.

`response_format: "opus"` streams Ogg/Opus at 24 kHz: each PCM chunk is
resampled by a carried-phase `StreamingResampler` and encoded, on the
caller's thread (the event loop's, in `app`), as in JAX.
"""

from __future__ import annotations

import asyncio
import dataclasses
import io
import json
import logging
import time
import zipfile
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from fish_speech_tpu_torch.audio.resample import StreamingResampler
from fish_speech_tpu_torch.audio.wav import pcm_to_wav_bytes
from fish_speech_tpu_torch.ops.sampling import SamplingArgs

logger = logging.getLogger(__name__)

MAX_BODY_SIZE = 32 * 1024 * 1024
OPUS_RATE = 24000
WRITE_BYTES = 1024  # a streamed response is written in pieces of this size


class HTTPError(Exception):
    """A response with an error status and a plain-text body."""

    def __init__(self, status: int, text: str) -> None:
        super().__init__(text)
        self.status = status
        self.text = text


class Metrics:
    """Serving counters, rendered in Prometheus text format at GET
    /metrics (the same lines as JAX's). Updated from the event loop and
    from worker threads; the increments are single dict or float
    operations under the GIL. The Opus host time (resample and encode
    seconds, chunks) is kept beside them and not rendered."""

    def __init__(self) -> None:
        self.requests_total: Dict[tuple, int] = {}
        self.request_seconds: Dict[str, float] = {}
        self.in_flight = 0
        self.audio_seconds_total = 0.0
        self.started_at = time.time()
        self.opus_chunks = 0
        self.opus_resample_s = 0.0
        self.opus_encode_s = 0.0

    def observe(self, route: str, status: int, seconds: float) -> None:
        key = (route, status)
        self.requests_total[key] = self.requests_total.get(key, 0) + 1
        self.request_seconds[route] = self.request_seconds.get(route, 0.0) + seconds

    def add_audio_seconds(self, seconds: float) -> None:
        self.audio_seconds_total += seconds

    def render(self) -> str:
        lines = ["# HELP fish_requests_total Requests by route and status.",
                 "# TYPE fish_requests_total counter"]
        for (route, status), n in sorted(self.requests_total.items()):
            lines.append(f'fish_requests_total{{route="{route}",status="{status}"}} {n}')
        lines += ["# HELP fish_request_seconds_total Wall time by route.",
                  "# TYPE fish_request_seconds_total counter"]
        for route, s in sorted(self.request_seconds.items()):
            lines.append(f'fish_request_seconds_total{{route="{route}"}} {s:.3f}')
        lines += [
            "# HELP fish_audio_seconds_total Seconds of audio synthesized.",
            "# TYPE fish_audio_seconds_total counter",
            f"fish_audio_seconds_total {self.audio_seconds_total:.3f}",
            "# HELP fish_requests_in_flight Requests currently in flight.",
            "# TYPE fish_requests_in_flight gauge",
            f"fish_requests_in_flight {self.in_flight}",
            "# HELP fish_uptime_seconds Seconds since server start.",
            "# TYPE fish_uptime_seconds gauge",
            f"fish_uptime_seconds {time.time() - self.started_at:.0f}",
        ]
        return "\n".join(lines) + "\n"


class AppState:
    """The pipeline, the voices, an optional continuous batcher and the
    lock that serialises the serial engine (requests through the batcher
    skip it)."""

    def __init__(self, pipeline, voices: Optional[Dict[str, np.ndarray]] = None,
                 default_voice: Optional[np.ndarray] = None, batcher=None) -> None:
        self.pipeline = pipeline
        self.voices: Dict[str, np.ndarray] = voices or {}
        self.default_voice = default_voice
        self.batcher = batcher
        self.lock = asyncio.Lock()
        self.metrics = Metrics()
        # set: /v1/audio/encoding?id=&prompt= also writes the voice here
        self.persist_voice_dir = None


def resolve_voice(state: AppState, name: str) -> Optional[np.ndarray]:
    """'unconditioned' -> None; unknown names fall back to the default."""
    if name == "unconditioned":
        return None
    return state.voices.get(name, state.default_voice)


@dataclasses.dataclass
class SpeechRequest:
    """The body of POST /v1/audio/speech."""

    text: str
    voice: str = "default"
    response_format: Optional[str] = None
    sysprompt: Optional[str] = None  # `speaker_prompt` overrides the system prompt
    seed: Optional[int] = None
    max_new: Optional[int] = None
    batch_size: Optional[int] = None
    stream_chunk_frames: Optional[int] = None  # PCM every N frames instead of a text chunk
    sampling: Optional[SamplingArgs] = None  # None: the pipeline's default

    @staticmethod
    def parse(body: dict, default_sampling: SamplingArgs) -> "SpeechRequest":
        sampling = None
        if any(k in body for k in ("temperature", "top_p", "top_k", "repetition_penalty")):
            d = default_sampling
            sampling = SamplingArgs(
                temp=float(body.get("temperature", d.temp)),
                top_p=float(body.get("top_p", d.top_p)),
                top_k=int(body.get("top_k", d.top_k)),
                repetition_penalty=float(body.get("repetition_penalty", d.repetition_penalty)))
        return SpeechRequest(
            text=body.get("input", ""), voice=body.get("voice", "default"),
            response_format=body.get("response_format"), sysprompt=body.get("speaker_prompt"),
            seed=body.get("seed"), max_new=body.get("max_new_tokens"),
            batch_size=body.get("batch_size"), stream_chunk_frames=body.get("stream_chunk_frames"),
            sampling=sampling)

    def kwargs(self, state: AppState) -> dict:
        return dict(voice_conditioning=resolve_voice(state, self.voice), sysprompt=self.sysprompt,
                    seed=self.seed, max_new_tokens=self.max_new, sampling=self.sampling)


def use_batcher(state: AppState, req: SpeechRequest) -> bool:
    """The continuous batcher serves the request: there is one, the
    request asks for no static batch, and (on a static-sampling batcher
    engine) carries no seed or sampling of its own; a stream_chunk_frames
    finer than the batcher's horizon goes to the serial engine, which
    honours it exactly."""
    b = state.batcher
    if b is None or req.batch_size:
        return False
    if not (getattr(b.engine, "dynamic_sampling", False)
            or (req.seed is None and req.sampling is None)):
        return False
    return not (req.stream_chunk_frames and int(req.stream_chunk_frames) < b.horizon)


def check_opus() -> None:
    """501 where the native encoder cannot be had, as in JAX."""
    from fish_speech_tpu_torch.audio.opus import OggOpusEncoder

    if not OggOpusEncoder.available():
        raise HTTPError(501, "opus streaming requires the native encoder "
                             "(native/libfishaudio.so)")


OnSubmit = Optional[Callable[[object], None]]  # receives a batcher request


def pcm_chunks(state: AppState, req: SpeechRequest, on_submit: OnSubmit = None
               ) -> Iterator[np.ndarray]:
    """The streamed PCM of a speech request, chunk by chunk, at the codec
    rate. On the batcher routes `on_submit` receives the batcher request
    (cancel it to end this generator from another thread); closing the
    generator cancels it too."""
    pipeline = state.pipeline
    if use_batcher(state, req):
        make = (pipeline.synthesize_streaming_continuous_lowlatency if req.stream_chunk_frames
                else pipeline.synthesize_streaming_continuous)
        yield from make(state.batcher, req.text, on_submit=on_submit, **req.kwargs(state))
    elif req.stream_chunk_frames:
        yield from pipeline.synthesize_streaming_lowlatency(
            req.text, frame_chunk=int(req.stream_chunk_frames), **req.kwargs(state))
    else:
        for chunk in pipeline.synthesize_streaming(req.text, **req.kwargs(state)):
            yield chunk.pcm


def wav_pcm(state: AppState, req: SpeechRequest, on_submit: OnSubmit = None) -> np.ndarray:
    """The whole PCM of a WAV speech request (blocking): through the
    batcher, by static batching, or serially."""
    pipeline = state.pipeline
    if use_batcher(state, req):
        parts = list(pipeline.synthesize_streaming_continuous(
            state.batcher, req.text, on_submit=on_submit, **req.kwargs(state)))
        return np.concatenate(parts) if parts else np.zeros((0,), np.float32)
    if req.batch_size and int(req.batch_size) > 1:
        return pipeline.synthesize_batched(req.text, int(req.batch_size), **req.kwargs(state))
    return pipeline.synthesize(req.text, **req.kwargs(state))


def wav_bytes(state: AppState, pcm: np.ndarray) -> bytes:
    rate = state.pipeline.codec.sample_rate
    state.metrics.add_audio_seconds(len(pcm) / rate)
    return pcm_to_wav_bytes(pcm, rate)


def pieces(data: bytes) -> List[bytes]:
    """A streamed body's pieces of WRITE_BYTES."""
    return [data[i:i + WRITE_BYTES] for i in range(0, len(data), WRITE_BYTES)]


class OpusFramer:
    """Codec-rate PCM chunks -> Ogg/Opus bytes at 24 kHz: a carried-phase
    resampler (its concatenated output is the resampling of the whole
    signal, so chunk boundaries do not click) and the streaming encoder.
    Counts the audio seconds and the host time of each chunk in the
    state's metrics."""

    def __init__(self, state: AppState) -> None:
        from fish_speech_tpu_torch.audio.opus import OggOpusEncoder

        self.metrics = state.metrics
        self.rate = state.pipeline.codec.sample_rate
        self.resampler = StreamingResampler(self.rate, OPUS_RATE)
        self.encoder = OggOpusEncoder(OPUS_RATE)

    def header(self) -> bytes:
        return self.encoder.header()

    def encode(self, pcm: np.ndarray) -> bytes:
        m = self.metrics
        m.add_audio_seconds(pcm.shape[-1] / self.rate)
        t0 = time.perf_counter()
        pcm24 = self.resampler.process(pcm)
        t1 = time.perf_counter()
        data = self.encoder.encode(pcm24)
        m.opus_resample_s += t1 - t0
        m.opus_encode_s += time.perf_counter() - t1
        m.opus_chunks += 1
        return data

    def finish(self) -> bytes:
        """The resampler's tail and the encoder's last (padded) page."""
        tail = self.resampler.process(np.zeros(0, np.float32), final=True)
        return self.encoder.encode(tail, final=True)

    def close(self) -> None:
        self.encoder.close()


def opus_body(state: AppState, req: SpeechRequest, on_submit: OnSubmit = None
              ) -> Iterator[bytes]:
    """The whole Opus response body as pieces, generated and encoded on
    this thread: the route for callers without an event loop."""
    check_opus()
    framer = OpusFramer(state)
    gen = pcm_chunks(state, req, on_submit)
    try:
        yield framer.header()
        for pcm in gen:
            yield from pieces(framer.encode(pcm))
        tail = framer.finish()
        if tail:
            yield tail
    finally:
        gen.close()
        framer.close()


def hidden_states_zip(state: AppState, body: dict) -> bytes:
    """POST /v1/audio/hidden_states: a ZIP of hidden_states.npy, audio.wav
    (unless return_audio is false) and metadata.json."""
    pipeline = state.pipeline
    hidden, pcm = pipeline.synthesize_with_hidden(
        body.get("input", ""), voice_conditioning=resolve_voice(state, body.get("voice", "default")),
        sysprompt=body.get("speaker_prompt"), seed=body.get("seed"),
        max_new_tokens=body.get("max_new_tokens"),
        return_audio=bool(body.get("return_audio", True)))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        npy = io.BytesIO()
        np.save(npy, hidden.astype(np.float32))
        zf.writestr("hidden_states.npy", npy.getvalue())
        if pcm is not None:
            zf.writestr("audio.wav", pcm_to_wav_bytes(pcm, pipeline.codec.sample_rate))
        zf.writestr("metadata.json", json.dumps({
            "frame_rate": pipeline.codec.cfg.frame_rate,
            "num_frames": int(hidden.shape[0]),
            "dim": int(hidden.shape[1]),
        }))
    return buf.getvalue()


def register_voice(state: AppState, voice_id: Optional[str], prompt_text: Optional[str],
                   codes: np.ndarray) -> None:
    """With both ?id= and ?prompt=, register the encoded voice (500 if the
    id exists), and write it to the persist directory where there is
    one."""
    if not (voice_id and prompt_text):
        return
    if voice_id in state.voices:
        raise HTTPError(500, f"ID already exists on server: {voice_id}")
    state.voices[voice_id] = state.pipeline.prompt_encoder.encode_conditioning_prompt(
        prompt_text, codes)
    if state.persist_voice_dir is not None:
        from fish_speech_tpu_torch.server.voices import save_voice

        save_voice(state.persist_voice_dir, voice_id, prompt_text, codes)


def npy_bytes(codes: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, codes.astype(np.uint32))
    return buf.getvalue()


def health(state: AppState) -> dict:
    return {"status": "ok", "voices": len(state.voices),
            "continuous_batching": state.batcher is not None}
