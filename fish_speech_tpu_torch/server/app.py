"""OpenAI-compatible TTS server on aiohttp: a thin layer over `server/core.py`.

Counterpart of `fish_speech_tpu/server/app.py`, with its routes, status
codes and headers:

  POST /v1/audio/speech        text -> WAV, or streamed Ogg/Opus with
                               response_format "opus" (501 without the
                               native encoder)
  POST /v1/audio/encoding      multipart audio -> .npy codec tokens;
                               ?id=&prompt= registers the voice
  POST /v1/audio/hidden_states ZIP of hidden states (+ audio) + metadata
  GET  /v1/voices, /healthz, /metrics

with permissive CORS, a 500 JSON body for unexpected errors, and the
connection closed when a stream fails after its headers went out.

Generation runs in worker threads; the serial engine is serialised by the
state's lock, and batcher requests skip it. The Opus resampling and
encoding run on the event loop's thread, as in JAX.

Request cancel, which JAX lacks: when a client goes away (a write raises
ConnectionResetError, or the handler is cancelled, which `serve` turns
on for a disconnect), the handler cancels the request's batcher request,
waits for the worker thread it had started (which the cancel releases)
and closes the generator, so the row returns to admission and no thread
is left blocked. A serial request's thread runs to its next chunk, under
the lock, and the closed generator stops there.
"""

from __future__ import annotations

import asyncio
import logging
import time

from aiohttp import web

from fish_speech_tpu_torch.audio.decode import decode_audio_bytes
from fish_speech_tpu_torch.server import core
from fish_speech_tpu_torch.server.core import AppState, Metrics

logger = logging.getLogger(__name__)

_HTTP_ERRORS = {500: web.HTTPInternalServerError, 501: web.HTTPNotImplemented}


def _http(err: core.HTTPError) -> web.HTTPException:
    return _HTTP_ERRORS[err.status](text=err.text)


async def _in_thread(fn, *args, handles=()):
    """fn(*args) in a worker thread. If the handler is cancelled meanwhile
    (its client went away), cancel the batcher requests in `handles`,
    which releases a thread waiting on them, and wait for the thread to
    end before the cancel goes on: the serial engine stays under the
    state's lock until its work ends, and no thread is left blocked."""
    task = asyncio.ensure_future(asyncio.to_thread(fn, *args))
    try:
        return await asyncio.shield(task)
    except asyncio.CancelledError:
        for req in handles:
            req.cancel()
        await asyncio.wait({task})
        raise


async def _stream_opus(request: web.Request, state: AppState, req: core.SpeechRequest
                       ) -> web.StreamResponse:
    resp = web.StreamResponse(status=200, headers={
        "Content-Type": "audio/ogg",
        # set here, not in cors_middleware: a prepared StreamResponse's
        # headers are on the wire by the time the middlewares unwind
        "Access-Control-Allow-Origin": "*",
        "Access-Control-Expose-Headers": "*",
    })
    resp.enable_chunked_encoding()
    await resp.prepare(request)
    framer = core.OpusFramer(state)
    handles = []
    gen = core.pcm_chunks(state, req, on_submit=handles.append)
    try:
        await resp.write(framer.header())
        while True:
            pcm = await _in_thread(next, gen, None, handles=handles)
            if pcm is None:
                break
            for piece in core.pieces(framer.encode(pcm)):
                await resp.write(piece)
        tail = framer.finish()
        if tail:
            await resp.write(tail)
    except (ConnectionResetError, asyncio.CancelledError):
        logger.info("client went away mid-stream; its request is cancelled")
        raise
    except Exception:
        # headers are sent, so a 500 is impossible: close the connection,
        # so the client sees a cut stream instead of waiting on a chunked
        # body that never ends (the runaway-reroll failure, for one)
        logger.exception("streaming synthesis failed mid-response")
        if request.transport is not None:
            request.transport.close()
        return resp
    finally:
        gen.close()  # cancels its batcher request, if it has one
        framer.close()
    await resp.write_eof()
    return resp


async def handle_speech(request: web.Request) -> web.StreamResponse:
    state: AppState = request.app["state"]
    req = core.SpeechRequest.parse(await request.json(), state.pipeline.default_sampling)
    serial = not core.use_batcher(state, req)
    if req.response_format == "opus":
        try:
            core.check_opus()
        except core.HTTPError as err:
            raise _http(err) from None
        if serial:
            async with state.lock:
                return await _stream_opus(request, state, req)
        return await _stream_opus(request, state, req)
    if serial:
        async with state.lock:
            pcm = await _in_thread(core.wav_pcm, state, req)
    else:
        handles = []
        pcm = await _in_thread(core.wav_pcm, state, req, handles.append, handles=handles)
    return web.Response(body=core.wav_bytes(state, pcm), content_type="audio/wav")


async def handle_hidden_states(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    body = await request.json()
    async with state.lock:
        data = await _in_thread(core.hidden_states_zip, state, body)
    return web.Response(body=data, content_type="application/zip")


async def handle_encoding(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    reader = await request.multipart()
    field = await reader.next()
    if field is None:
        raise web.HTTPBadRequest(text="No file provided")
    audio, sr = decode_audio_bytes(await field.read(decode=False))
    async with state.lock:
        codes = await _in_thread(state.pipeline.encode_reference_audio, audio, sr)
    try:
        await asyncio.to_thread(core.register_voice, state, request.query.get("id"),
                                request.query.get("prompt"), codes)
    except core.HTTPError as err:
        raise _http(err) from None
    return web.Response(body=core.npy_bytes(codes), content_type="application/x-npy")


async def handle_voices(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    return web.json_response({"voices": sorted(state.voices.keys())})


async def handle_healthz(request: web.Request) -> web.Response:
    return web.json_response(core.health(request.app["state"]))


async def handle_metrics(request: web.Request) -> web.Response:
    return web.Response(text=request.app["state"].metrics.render(), content_type="text/plain",
                        charset="utf-8")


@web.middleware
async def error_middleware(request: web.Request, handler):
    """Unexpected errors -> 500 with a JSON body, logged."""
    try:
        return await handler(request)
    except web.HTTPException:
        raise
    except Exception as exc:  # noqa: BLE001
        logger.exception("request failed")
        return web.json_response({"error": str(exc)}, status=500)


@web.middleware
async def metrics_middleware(request: web.Request, handler):
    """Counts every request by route and status with its wall time;
    outside error_middleware, so 500s are counted too."""
    m: Metrics = request.app["state"].metrics
    m.in_flight += 1
    t0 = time.perf_counter()
    status = 500
    try:
        resp = await handler(request)
        status = resp.status
        return resp
    except web.HTTPException as exc:
        status = exc.status
        raise
    finally:
        m.in_flight -= 1
        m.observe(request.path, status, time.perf_counter() - t0)


@web.middleware
async def cors_middleware(request: web.Request, handler):
    """Permissive CORS: any origin, method and headers, so browser clients
    on another origin pass preflight and can read responses, errors
    included."""

    def apply(resp) -> None:
        if resp.prepared:  # a streamed response sets its own
            return
        resp.headers["Access-Control-Allow-Origin"] = "*"
        resp.headers["Access-Control-Allow-Methods"] = "*"
        resp.headers["Access-Control-Allow-Headers"] = request.headers.get(
            "Access-Control-Request-Headers", "*")
        resp.headers["Access-Control-Expose-Headers"] = "*"

    if request.method == "OPTIONS" and "Access-Control-Request-Method" in request.headers:
        resp = web.Response(status=204)
    else:
        try:
            resp = await handler(request)
        except web.HTTPException as exc:
            apply(exc)
            raise
    apply(resp)
    return resp


def create_app(state: AppState) -> web.Application:
    # cors outermost, so error responses carry the headers; metrics
    # outside error_middleware, so 500s are counted
    app = web.Application(client_max_size=core.MAX_BODY_SIZE,
                          middlewares=[cors_middleware, metrics_middleware, error_middleware])
    app["state"] = state
    app.router.add_post("/v1/audio/speech", handle_speech)
    app.router.add_post("/v1/audio/encoding", handle_encoding)
    app.router.add_post("/v1/audio/hidden_states", handle_hidden_states)
    app.router.add_get("/v1/voices", handle_voices)
    app.router.add_get("/healthz", handle_healthz)
    app.router.add_get("/metrics", handle_metrics)

    async def shutdown_batcher(app: web.Application) -> None:
        # release clients blocked on in-flight batcher requests
        b = app["state"].batcher
        if b is not None:
            await asyncio.to_thread(b.shutdown)

    app.on_cleanup.append(shutdown_batcher)
    return app


def serve(state: AppState, port: int = 3000) -> None:
    """Serve until interrupted; a client's disconnect cancels its handler
    (and so its batcher request)."""
    web.run_app(create_app(state), port=port, handler_cancellation=True)

