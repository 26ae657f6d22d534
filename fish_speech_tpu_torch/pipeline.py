"""TTSPipeline: text -> tokens -> semantic codes -> PCM, end to end.

Counterpart of `fish_speech_tpu/pipeline.py`, the object behind the HTTP
server and the benchmark CLI: text cleaning and chunking, prompts with
speaker conditioning, chunked generation that keeps the conditioning
prefix in the cache (with one reroll of a suspected runaway), the Fish
<= 1.4 -1 token shift, and the codec.

Routes, as in JAX:

* serial (`synthesize`, `synthesize_streaming`): the batch-1 engine, one
  text chunk at a time; where the codec streams, each chunk goes through
  the overlapped driver (`generate/overlap.py`);
* low latency (`synthesize_streaming_lowlatency`): PCM every `frame_chunk`
  frames through a carried-state vocoder session;
* continuous batching (`create_batcher`,
  `synthesize_streaming_continuous(_lowlatency)`): a 16-row dynamic-
  sampling engine sharing the weights, with the batcher's central
  vocoder where the codec streams;
* static batching (`synthesize_batched`) and hidden states
  (`synthesize_with_hidden`);
* `encode_reference_audio` for voice cloning.

The batcher routes cancel their request when the generator is closed or
dropped (`BatchedRequest.cancel`, in a `finally`), which frees its row;
`on_submit` hands the request to a caller on another thread, which can
cancel it while this generator waits for the batcher.

Under a (dp, tp) mesh (`load(mesh=)`, `parallel/`) every rank loads its
shard of the LM; rank 0's pipeline drives every rank's engine through
`parallel.driver` and holds the codec whole, as JAX keeps it replicated
(pipeline.py:104-107); `close` ends the other ranks' loops.

Departures from JAX: `load` takes the version's own config where
config.json is missing (as the port's CLI does, `cli/llama_generate.py`;
1.4 and dual_ar need the file); there are no compile buckets, so
`warmup_codec` runs each shape a request reaches once.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

from fish_speech_tpu_torch.config import (
    DEFAULT_MAX_NEW_TOKENS, FireflyConfig, TokenConfig, WhichLM, WhichModel, default_rep_pen)
from fish_speech_tpu_torch.device import resolve_device
from fish_speech_tpu_torch.generate.continuous import (
    ContinuousBatcher, _Fetch, _PartialFrames, _PartialPCM)
from fish_speech_tpu_torch.generate.engine import GenerationResult, LMEngine
from fish_speech_tpu_torch.generate.overlap import generate_vocode_overlapped, output_shift
from fish_speech_tpu_torch.ops.quant import quantize_lm_params
from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs
from fish_speech_tpu_torch.parallel.distributed import coords
from fish_speech_tpu_torch.parallel.mesh import shard_lm_params
from fish_speech_tpu_torch.text.clean import preprocess_text
from fish_speech_tpu_torch.text.prompt import FISH_1_5_SYSPROMPT, PromptEncoder

logger = logging.getLogger(__name__)

OnSubmit = Optional[Callable[[object], None]]


@dataclasses.dataclass
class SynthesisChunk:
    pcm: np.ndarray  # (T,) float32 at the codec sample rate
    codes: np.ndarray  # (C, frames)
    result: GenerationResult
    prompt: Optional[np.ndarray] = None  # the encoded (C+1, S) prompt of this chunk


def _concat(parts: List[np.ndarray]) -> np.ndarray:
    return np.concatenate(parts) if parts else np.zeros((0,), np.float32)


class TTSPipeline:
    def __init__(self, engine: LMEngine, codec, tokenizer, lm: WhichLM, *,
                 max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS,
                 default_sampling: Optional[SamplingArgs] = None) -> None:
        """engine: a batch-1 LMEngine; codec: a FireflyCodec or a
        MimiCodec on the engine's device; tokenizer: anything with PromptEncoder's calls
        (`encode(text, add_special_tokens=False).ids`, `token_to_id`)."""
        if codec.device.type != engine.device.type:
            raise ValueError(f"the codec is on {codec.device}, the engine on {engine.device}")
        self.engine = engine
        self.codec = codec
        self.tokenizer = tokenizer
        self.lm = lm
        self.max_new_tokens = max_new_tokens
        # the runaway policy: benchmarks on untrained weights turn it off
        # to get fixed-length generations
        self.reroll_on_runaway = True
        self.default_sampling = default_sampling or SamplingArgs(
            repetition_penalty=default_rep_pen(lm))
        self.prompt_encoder = PromptEncoder(tokenizer, engine.cfg.num_codebooks, lm)
        self._shift = output_shift(lm)
        self._batch_engines = {}
        self.driver = None  # parallel.driver.Driver, on rank 0 of a mesh (load(mesh=))

    def close(self) -> None:
        """On rank 0 of a mesh: end the other ranks' loops. Elsewhere a
        no-op."""
        if self.driver is not None:
            self.driver.close()

    # -- loading -----------------------------------------------------------

    @staticmethod
    def load(checkpoint_dir: str | Path, model: WhichModel, *, lm_dtype=torch.bfloat16,
             codec_dtype=torch.float32, codec_file: Optional[str | Path] = None,
             max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS, cache_len: Optional[int] = None,
             quantize_int8: bool = False, device="cuda",
             mesh=None) -> Optional["TTSPipeline"]:
        """config.json (or the version's own config), tokenizer.json and the
        LM and codec weights of a local checkpoint directory, on `device`
        (CUDA unless asked otherwise; on CUDA the LM is bfloat16). The
        codec: Firefly of the version, in codec_dtype; for dual_ar, Mimi
        (kyutai/mimi's config, float32, as JAX loads it) from
        mimi.safetensors in the directory, encoding the LM's codebook
        count. codec_file: the codec's weights elsewhere.

        mesh: a (dp, tp) mesh (`parallel.distributed.make_mesh`); every
        rank calls `load`, and each takes its shard of the LM (under tp
        with quantize_int8, the shard of the tree quantized whole, as the
        JAX pipeline runs it, pipeline.py:132-140). On a mesh
        of more than one rank, rank 0 gets the pipeline, whose engine
        drives every rank's; the other ranks follow its engine calls here
        until it is closed, and then get None."""
        from fish_speech_tpu_torch.cli.llama_generate import load_config, load_tokenizer
        from fish_speech_tpu_torch.io.checkpoint import load_firefly_params, load_lm_params
        from fish_speech_tpu_torch.io.hub import MIMI_CHECKPOINT_FILE, resolve_checkpoint
        from fish_speech_tpu_torch.models.codec.firefly import FireflyCodec
        from fish_speech_tpu_torch.models.codec.mimi import (
            MimiCodec, MimiConfig, load_mimi_params)

        device = resolve_device(device)
        ckpt = resolve_checkpoint(checkpoint_dir, model)
        lm = WhichLM.from_model(model)
        cfg = load_config(ckpt, model)
        tokenizer = load_tokenizer(ckpt / "tokenizer.json")
        token_cfg = TokenConfig.from_tokenizer(lm, tokenizer, cfg)
        t0 = time.perf_counter()
        params = load_lm_params(ckpt, cfg, dtype=lm_dtype, device=device)
        if quantize_int8 and coords(mesh).tp > 1:
            # a row-split weight's scales need its whole column: quantize the
            # whole tree, then shard it (the quantization leaves the head,
            # which the engine gathers, as it is)
            params = quantize_lm_params(params)
        params = shard_lm_params(params, mesh, cfg)
        engine = LMEngine(params, cfg, token_cfg, lm, cache_len=cache_len, dtype=lm_dtype,
                          quantize_int8=quantize_int8, device=device, mesh=mesh)
        del params
        logger.info("LM loaded in %.1fs", time.perf_counter() - t0)
        driver = None
        if coords(mesh).size > 1:
            from fish_speech_tpu_torch.parallel.driver import Driver

            driver = Driver(mesh)
            if torch.distributed.get_rank() != 0:
                calls = driver.follow(engine)
                logger.info("rank %d: rank 0 closed the driver after %d calls",
                            torch.distributed.get_rank(), calls)
                return None
            engine = driver.lead(engine)
        if model.fish_version is None:
            mimi_cfg = MimiConfig.kyutai()
            mimi = load_mimi_params(codec_file if codec_file is not None
                                    else ckpt / MIMI_CHECKPOINT_FILE, mimi_cfg, device=device)
            codec = MimiCodec(mimi, mimi_cfg, num_quantizers=cfg.num_codebooks, device=device)
        else:
            codec_cfg = FireflyConfig.for_version(model.fish_version)
            codec_params = load_firefly_params(codec_file if codec_file is not None else ckpt,
                                               codec_cfg, dtype=codec_dtype, device=device)
            codec = FireflyCodec(codec_params, codec_cfg, device=device)
        pipeline = TTSPipeline(engine, codec, tokenizer, lm, max_new_tokens=max_new_tokens)
        pipeline.driver = driver
        return pipeline

    # -- warmup ------------------------------------------------------------

    def warmup_codec(self, frame_chunk: int = 16) -> None:
        """Run the vocoder once at the shapes a request reaches first: a
        one-frame decode, a decode of the generation budget, and, where
        the codec streams, a session step of each power of two up to
        frame_chunk. PyTorch builds no program per shape (the JAX version
        compiles its buckets here); these calls pay cuDNN's first-call
        set-up before serving. The batcher warms its own central vocoder
        (ContinuousBatcher.warmup)."""
        c = self.engine.cfg.num_codebooks
        budget = min(self.max_new_tokens, self.engine.max_frames)
        for frames in sorted({1, budget}):
            self.codec.decode(np.zeros((c, frames), np.int32))
        if self.codec.can_stream:
            session = self.codec.start_stream(max_step_frames=frame_chunk)
            step = session.max_step
            while step >= 1:
                session.feed(np.zeros((c, step), np.int32))
                step //= 2
        logger.info("codec warmup done")

    # -- generation --------------------------------------------------------

    def _shift_output_tokens(self, codes: np.ndarray) -> np.ndarray:
        """Fish <= 1.4 codebook tokens come out +1; shift them back."""
        return self._shift(codes)

    def _encode(self, text: str, voice_conditioning, sysprompt, assume_kv_cache=True):
        """(n_conditioning, one prompt a text chunk), or None for a text
        with no chunk; the Fish 1.5 system prompt by default."""
        chunks = preprocess_text(text)
        if not chunks:
            return None
        if sysprompt is None and self.lm == WhichLM.FISH_1_5:
            sysprompt = FISH_1_5_SYSPROMPT
        return self.prompt_encoder.encode_sequence(
            chunks, sysprompt_text=sysprompt, cached_speaker=voice_conditioning,
            assume_kv_cache=assume_kv_cache)

    def _generate_codes_chunked(self, encoded_chunks: List[np.ndarray], n_conditioning: int,
                                sampling: SamplingArgs, max_new_tokens: Optional[int] = None,
                                seed: Optional[int] = None) -> Iterator[SynthesisChunk]:
        """Generate chunk by chunk, keeping the conditioning prefix in the
        cache, with one reroll of a suspected runaway. Where the codec
        streams, each chunk runs through the overlapped driver (a rerolled
        runaway throws its PCM away)."""
        max_new = max_new_tokens or self.max_new_tokens
        state = self.engine.init_state(seed)
        overlap = self.engine.batch_size == 1 and getattr(self.codec, "can_stream", False)

        def run(chunk_tokens, state, offset):
            if overlap:
                return generate_vocode_overlapped(
                    self.engine, self.codec, chunk_tokens, sampling=sampling,
                    max_new_tokens=max_new, state=state, conditioning_offset=offset,
                    shift_fn=self._shift_output_tokens)
            result, state = self.engine.generate(
                chunk_tokens, max_new_tokens=max_new, sampling=sampling, state=state,
                conditioning_offset=offset)
            return None, result, state

        cond_len = 0
        for i, chunk_tokens in enumerate(encoded_chunks):
            offset = cond_len if i > 0 else 0
            pcm, result, state = run(chunk_tokens, state, offset)
            if result.hit_max and self.reroll_on_runaway:
                logger.warning("Suspected runaway generation; rerolling once")
                state = self.engine.rewind(state, offset)
                pcm, result, state = run(chunk_tokens, state, offset)
                if result.hit_max:
                    raise RuntimeError("Generation ran away twice; bailing")
            if i == 0:
                cond_len = n_conditioning
            state = self.engine.rewind(state, cond_len)
            codes = self._shift_output_tokens(result.tokens)
            if pcm is None:
                pcm = self.codec.decode(codes)[0]
            yield SynthesisChunk(pcm=pcm, codes=codes, result=result, prompt=chunk_tokens)

    def synthesize_streaming(self, text: str, voice_tokens: Optional[np.ndarray] = None,
                             voice_text: Optional[str] = None, *,
                             voice_conditioning: Optional[np.ndarray] = None,
                             sampling: Optional[SamplingArgs] = None,
                             sysprompt: Optional[str] = None,
                             max_new_tokens: Optional[int] = None,
                             seed: Optional[int] = None) -> Iterator[SynthesisChunk]:
        """One decoded PCM chunk a text chunk. voice_conditioning: a
        pre-encoded (C+1, N) conditioning prompt (what the server's voices
        hold); voice_tokens / voice_text: codec tokens and transcript,
        encoded here."""
        sampling = sampling or self.default_sampling
        speaker = voice_conditioning
        if speaker is None and voice_tokens is not None:
            speaker = self.prompt_encoder.encode_conditioning_prompt(voice_text or "",
                                                                     voice_tokens)
        enc = self._encode(text, speaker, sysprompt)
        if enc is None:
            return
        yield from self._generate_codes_chunked(enc[1], enc[0], sampling, max_new_tokens, seed)

    def synthesize(self, text: str, **kwargs) -> np.ndarray:
        """Blocking synthesis: the whole PCM at the codec sample rate."""
        return _concat([c.pcm for c in self.synthesize_streaming(text, **kwargs)])

    def synthesize_streaming_lowlatency(self, text: str, *, frame_chunk: int = 16,
                                        voice_conditioning: Optional[np.ndarray] = None,
                                        sampling: Optional[SamplingArgs] = None,
                                        sysprompt: Optional[str] = None,
                                        max_new_tokens: Optional[int] = None,
                                        seed: Optional[int] = None) -> Iterator[np.ndarray]:
        """PCM every `frame_chunk` frames instead of a text chunk at a time:
        the engine decodes chunks of frame_chunk frames and a carried-state
        session vocodes each (a fresh session a text chunk). Chunk k+1 is
        launched before chunk k's frames are read, which were copied to the
        host behind it (`continuous._Fetch`). No reroll: audio already out
        cannot be taken back, so a runaway ends at the budget. A codec that
        cannot stream (Fish 1.2) decodes the whole prefix again and yields
        its new samples."""
        sampling = sampling or self.default_sampling
        enc = self._encode(text, voice_conditioning, sysprompt)
        if enc is None:
            return
        n_cond, encoded = enc
        max_new = max_new_tokens or self.max_new_tokens
        engine = self.engine
        state = engine.init_state(seed)
        use_stream = getattr(self.codec, "can_stream", False)

        def launch(state, n):
            state, out, valid, steps = engine.decode_chunk(state, sampling, frame_chunk,
                                                           max_steps=n)
            return state, _Fetch([out, valid, steps, state.done])

        def emit(frames, emitted, stream):
            """The PCM of frames[emitted:] (frames[0] is the prefill's)."""
            if stream is not None:
                new = self._shift_output_tokens(np.stack(frames[emitted:], axis=1)[1:])
                return stream.feed(new)[0]
            codes = self._shift_output_tokens(np.stack(frames, axis=1)[1:])
            pcm = self.codec.decode(codes)[0]
            return pcm[emitted * (pcm.shape[-1] // codes.shape[1]):]

        cond_len = 0
        for i, chunk_tokens in enumerate(encoded):
            offset = cond_len if i > 0 else 0
            stream = self.codec.start_stream(max_step_frames=frame_chunk) if use_stream else None
            state, first_frame, first_eos, _ = engine._prefill_raw(state, chunk_tokens, sampling,
                                                                  offset=offset)
            first_frame, first_eos = _Fetch([first_frame, first_eos]).get()
            frames = [first_frame[0]]
            budget = min(max_new - 1, engine.cache_len - (offset + chunk_tokens.shape[-1]) - 1)
            done = bool(first_eos[0])
            emitted = 0
            pending = None
            produced = 0  # frames the launched chunks cover, at most the budget
            if not done and budget > 0:
                produced = min(frame_chunk, budget)
                state, pending = launch(state, produced)
            while pending is not None:
                fetch = pending
                # speculate only if the chunk in flight cannot exhaust the
                # budget; a speculative chunk past an EOS is thrown away and
                # its positions rewound below. JAX decodes whole chunks past
                # the budget too, its positions clamped at the cache end;
                # here a chunk stops at the budget (`max_steps`), which
                # keeps every position inside the cache and the same codes.
                if produced < budget:
                    n = min(frame_chunk, budget - produced)
                    produced += n
                    state, pending = launch(state, n)
                else:
                    pending = None
                out, valid, steps, done_arr = fetch.get()
                for s in range(int(steps)):
                    if valid[s, 0] and len(frames) - 1 < budget:
                        frames.append(out[s, 0])
                    else:
                        done = True
                        break
                else:
                    done = bool(done_arr[0])
                if done or len(frames) - 1 >= budget:
                    pending = None
                if len(frames) > emitted:
                    yield emit(frames, emitted, stream)
                    emitted = len(frames)
            if len(frames) > emitted:  # e.g. EOS on the first frame
                yield emit(frames, emitted, stream)
            if i == 0:
                cond_len = n_cond
            state = engine.rewind(state, cond_len)

    # -- continuous batching ----------------------------------------------

    def create_batcher(self, rows: int = 16, horizon: int = 16):
        """A ContinuousBatcher over `rows` decode rows of a new engine that
        shares this pipeline's weights, with dynamic sampling (each
        request's sampling and seed installed in its row at admission)
        and, where the codec streams, the central vocoder."""
        engine = self.engine.sibling(batch_size=rows, rep_pen_window=BATCHED_REP_PEN_WINDOW,
                                     dynamic_sampling=True)
        central = getattr(self.codec, "can_stream", False) and hasattr(self.codec,
                                                                        "decode_step_async")
        return ContinuousBatcher(engine, self.default_sampling, horizon=horizon,
                                 codec=self.codec if central else None,
                                 shift_fn=self._shift_output_tokens if central else None)

    def synthesize_streaming_continuous(self, batcher, text: str, *,
                                        voice_conditioning: Optional[np.ndarray] = None,
                                        sysprompt: Optional[str] = None,
                                        max_new_tokens: Optional[int] = None,
                                        sampling: Optional[SamplingArgs] = None,
                                        seed: Optional[int] = None,
                                        on_submit: OnSubmit = None) -> Iterator[np.ndarray]:
        """PCM a text chunk through a shared continuous batcher; this call
        waits only for its own chunks. With the batcher's central vocoder
        the batcher delivers the PCM; otherwise a streaming codec vocodes
        the frames as they come in this thread (a fresh session a chunk),
        and a codec that cannot stream decodes each finished chunk."""
        enc = self._encode(text, voice_conditioning, sysprompt)
        if enc is None:
            return
        n_cond, encoded = enc
        max_new = max_new_tokens or self.max_new_tokens
        can_stream = getattr(self.codec, "can_stream", False)
        central = can_stream and batcher._central is not None
        req = batcher.submit(encoded, n_cond, max_new, stream=can_stream and not central,
                             deliver_pcm=central, low_latency=False, sampling=sampling,
                             seed=seed)
        if on_submit is not None:
            on_submit(req)
        try:
            if not can_stream:
                for chunk in req.iter_chunks():
                    yield self.codec.decode(self._shift_output_tokens(chunk.tokens))[0]
                return
            session, parts = None, []
            for ev in req.iter_events():
                if isinstance(ev, _PartialPCM):
                    parts.append(ev.pcm)
                elif isinstance(ev, _PartialFrames):
                    if session is None:
                        session = self.codec.start_stream(max_step_frames=batcher.horizon)
                    parts.append(session.feed(self._shift_output_tokens(ev.frames[1:]))[0])
                else:  # a chunk's result: emit it, a fresh session for the next
                    yield _concat(parts)
                    session, parts = None, []
        finally:
            req.cancel()

    def synthesize_streaming_continuous_lowlatency(
            self, batcher, text: str, *, voice_conditioning: Optional[np.ndarray] = None,
            sysprompt: Optional[str] = None, max_new_tokens: Optional[int] = None,
            sampling: Optional[SamplingArgs] = None, seed: Optional[int] = None,
            on_submit: OnSubmit = None) -> Iterator[np.ndarray]:
        """PCM every scheduler tick (one horizon of frames) through the
        shared batcher, with its low-latency scheduling: a short first
        tick. With the central vocoder the batcher delivers the PCM;
        otherwise this thread vocodes (a streaming session a chunk, or the
        whole prefix again for a codec that cannot stream). The JAX
        central route submits without low_latency, which then defaults to
        its stream=False (continuous.py:108), so its first tick is a full
        horizon; here it is short on both routes. Scheduling does not
        change the codes."""
        enc = self._encode(text, voice_conditioning, sysprompt)
        if enc is None:
            return
        n_cond, encoded = enc
        max_new = max_new_tokens or self.max_new_tokens
        central = batcher._central is not None
        req = batcher.submit(encoded, n_cond, max_new, stream=not central, deliver_pcm=central,
                             low_latency=True, sampling=sampling, seed=seed)
        if on_submit is not None:
            on_submit(req)
        can_stream = getattr(self.codec, "can_stream", False)
        try:
            session, chunk_codes, emitted = None, [], 0
            for ev in req.iter_events():
                if isinstance(ev, _PartialPCM):
                    yield ev.pcm
                elif isinstance(ev, _PartialFrames):
                    codes = self._shift_output_tokens(ev.frames[1:])
                    if can_stream:
                        if session is None:
                            session = self.codec.start_stream(max_step_frames=batcher.horizon)
                        yield session.feed(codes)[0]
                    else:
                        chunk_codes.append(codes)
                        allc = np.concatenate(chunk_codes, axis=1)
                        pcm = self.codec.decode(allc)[0]
                        yield pcm[emitted * (pcm.shape[-1] // allc.shape[1]):]
                        emitted = allc.shape[1]
                else:  # a chunk's result: fresh vocoder state for the next
                    session, chunk_codes, emitted = None, [], 0
        finally:
            req.cancel()

    # -- static batching ---------------------------------------------------

    def _get_batch_engine(self, batch_size: int) -> LMEngine:
        """One engine a batch size, made at first use, sharing the weights,
        with the batched rep-pen window."""
        if batch_size not in self._batch_engines:
            self._batch_engines[batch_size] = self.engine.sibling(
                batch_size=batch_size, rep_pen_window=BATCHED_REP_PEN_WINDOW)
        return self._batch_engines[batch_size]

    def synthesize_batched(self, text: str, batch_size: int, *,
                           voice_conditioning: Optional[np.ndarray] = None,
                           sampling: Optional[SamplingArgs] = None,
                           sysprompt: Optional[str] = None,
                           max_new_tokens: Optional[int] = None,
                           seed: Optional[int] = None) -> np.ndarray:
        """Blocking synthesis with the text chunks run `batch_size` at a
        time through a static-batch engine. Each chunk's prompt carries
        the whole conditioning (no cache prefix is shared across rows); a
        short last group is padded with a copy of its last row, whose
        output is dropped. One batched decode a group; chunk PCM in input
        order."""
        if batch_size <= 1:
            return self.synthesize(text, voice_conditioning=voice_conditioning,
                                   sampling=sampling, sysprompt=sysprompt,
                                   max_new_tokens=max_new_tokens, seed=seed)
        sampling = sampling or self.default_sampling
        enc = self._encode(text, voice_conditioning, sysprompt, assume_kv_cache=False)
        if enc is None:
            return np.zeros((0,), np.float32)
        encoded = enc[1]
        engine = self._get_batch_engine(batch_size)
        max_new = max_new_tokens or self.max_new_tokens
        spf = self.codec.samples_per_frame
        pcm_parts: List[np.ndarray] = []
        for g in range(0, len(encoded), batch_size):
            group = encoded[g:g + batch_size]
            real = len(group)
            group = group + [group[-1]] * (batch_size - real)
            results = engine.generate_batch(group, max_new_tokens=max_new, sampling=sampling,
                                            seed=seed)
            rows = [self._shift_output_tokens(results[r].tokens) for r in range(real)]
            batch = np.zeros((real, rows[0].shape[0], max(r.shape[1] for r in rows)), np.int32)
            for r, codes in enumerate(rows):
                batch[r, :, :codes.shape[1]] = codes
            pcm = self.codec.decode(batch)
            for r, codes in enumerate(rows):
                pcm_parts.append(pcm[r, :codes.shape[1] * spf])
        return np.concatenate(pcm_parts)

    def synthesize_with_hidden(self, text: str, *,
                               voice_conditioning: Optional[np.ndarray] = None,
                               sampling: Optional[SamplingArgs] = None,
                               sysprompt: Optional[str] = None,
                               max_new_tokens: Optional[int] = None,
                               seed: Optional[int] = None, return_audio: bool = True):
        """Generate while collecting the slow transformer's hidden state of
        every kept frame. Returns (hidden (T, dim) float32, PCM or None)."""
        sampling = sampling or self.default_sampling
        enc = self._encode(text, voice_conditioning, sysprompt)
        if enc is None:
            return np.zeros((0, self.engine.cfg.dim), np.float32), None
        n_cond, encoded = enc
        max_new = max_new_tokens or self.max_new_tokens
        state = self.engine.init_state(seed)
        hiddens: List[np.ndarray] = []
        pcm_parts: List[np.ndarray] = []
        cond_len = 0
        for i, chunk_tokens in enumerate(encoded):
            offset = cond_len if i > 0 else 0
            result, state = self.engine.generate(
                chunk_tokens, max_new_tokens=max_new, sampling=sampling, state=state,
                conditioning_offset=offset, collect_hidden=True)
            if i == 0:
                cond_len = n_cond
            state = self.engine.rewind(state, cond_len)
            hiddens.append(result.hidden)
            if return_audio:
                pcm_parts.append(self.codec.decode(self._shift_output_tokens(result.tokens))[0])
        return np.concatenate(hiddens, axis=0), (np.concatenate(pcm_parts) if pcm_parts
                                                 else None)

    def encode_reference_audio(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """A voice's audio -> its codec tokens (C, T), for cloning."""
        from fish_speech_tpu_torch.audio.resample import resample

        return self.codec.encode(resample(audio, sample_rate, self.codec.sample_rate))[0]
