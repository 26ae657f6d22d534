"""Overlapped blocking generation: LM decode chunks and carried-state
vocoder feeds pipelined on one card.

Counterpart of `fish_speech_tpu/generate/overlap.py`. The serial path
(engine.generate, then codec.decode) waits for the host twice in a row.
Here decode chunk k+1 is launched before chunk k's frames are read, each
chunk read is fed to a streaming vocoder session without waiting
(`StreamSessionBase.feed_async`), and one copy at the end reads all the
PCM, so the card runs [prefill, D1, D2, V1, D3, V2, ...] back to back
and the host's unpacking overlaps it.

Reading chunk k must not wait for chunk k+1: in PyTorch `.cpu()` or
`int()` on chunk k's outputs after chunk k+1 is queued waits for both.
So chunk k's (out, valid, steps, done) are copied to pinned host memory
behind chunk k on the same stream, an event is recorded, chunk k+1 is
launched, and only then is the event waited on
(`continuous._Fetch`, shared with the batcher). No kernel writes `done`
in place (every step returns a new tensor), so it needs no copy on the
card first.

The LM and the vocoder share one stream. Every vocode feed is padded to
`chunk` frames; the decode path is causal, so padding cannot change the
real samples, and the last feed's tail is trimmed.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from fish_speech_tpu_torch.config import WhichLM
from fish_speech_tpu_torch.generate.continuous import _Fetch
from fish_speech_tpu_torch.generate.engine import GenerationResult, GenState
from fish_speech_tpu_torch.ops.sampling import SamplingArgs


def output_shift(lm: WhichLM) -> Callable[[np.ndarray], np.ndarray]:
    """Codebook tokens -> codec indices: Fish <= 1.4 emits them +1 and
    they are shifted back (clamped at 0); 1.5 and DualAR need no shift."""
    if lm.uses_explicit_semantic_ids:
        return lambda codes: codes
    return lambda codes: np.maximum(codes.astype(np.int64) - 1, 0).astype(np.int32)


def generate_vocode_overlapped(
    engine,
    codec,
    prompt: np.ndarray,
    *,
    sampling: Optional[SamplingArgs] = None,
    max_new_tokens: int = 1024,
    state: Optional[GenState] = None,
    conditioning_offset: int = 0,
    seed: Optional[int] = None,
    chunk: int = 32,
    shift_fn=None,
) -> Tuple[np.ndarray, GenerationResult, GenState]:
    """Generate codes for one (C+1, S) prompt on a batch-1 engine and
    vocode them, overlapped.

    Returns (pcm (T * spf,) float32, GenerationResult, carried state).
    The PCM is codec.decode of the generated codes (the streaming decode
    is carried-state exact). GenerationResult.decode_s is the wall time
    until the last LM frame was on the host; total - prefill_s - decode_s
    is the vocode tail that did not overlap. shift_fn maps each (C, t)
    code slice to codec indices (`output_shift`); None is the identity.
    """
    if engine.batch_size != 1:
        raise ValueError("the overlapped driver drives batch-1 engines")
    if not codec.can_stream:
        raise ValueError("the overlapped driver needs a causal (streaming) codec")
    sampling = sampling or SamplingArgs()
    shift = shift_fn or (lambda c: c)
    if state is None:
        state = engine.init_state(seed)
    if engine.dynamic_sampling:
        # dynamic engines read every knob from state.samp (as generate does)
        state = engine.with_sampling(state, sampling)
    chunk = max(engine.decode_unroll, (chunk // engine.decode_unroll) * engine.decode_unroll)

    prompt = np.asarray(prompt)
    prompt_len = prompt.shape[-1]
    t0 = time.perf_counter()
    state, first_frame, first_eos, _ = engine._prefill_raw(state, prompt, sampling,
                                                           offset=conditioning_offset)
    first = _Fetch([first_frame, first_eos])
    prefill_s = time.perf_counter() - t0

    budget = max(min(max_new_tokens - 1, engine.max_frames,
                     engine.cache_len - (conditioning_offset + prompt_len) - 1), 0)
    session = codec.start_stream(max_step_frames=chunk)
    spf = codec.samples_per_frame

    def launch(state, n):
        state, out, valid, steps = engine.decode_chunk(state, sampling, chunk, max_steps=n)
        return state, _Fetch([out, valid, steps, state.done])

    t1 = time.perf_counter()
    produced = min(chunk, budget)  # frames the launched chunks cover
    pending = None
    if produced > 0:
        state, pending = launch(state, produced)

    frame, eos = first.get()
    frames: List[np.ndarray] = [frame[0]]  # host (C+1,) frames, the prefill's first
    done = bool(eos[0])
    emitted = 0  # frames fed to the vocoder
    pcm_parts = []  # (device audio (1, chunk * spf), real frames)

    def feed_ready(flush: bool = False) -> None:
        nonlocal emitted
        while len(frames) - emitted >= chunk or (flush and len(frames) > emitted):
            piece = frames[emitted:emitted + chunk]
            codes = shift(np.stack(piece, axis=1)[1:])
            pcm_parts.append(session.feed_async(codes, pad_to=chunk))
            emitted += len(piece)

    while pending is not None and not done:
        fetch = pending
        # speculate the next chunk before reading this one, unless the
        # launched chunks can already exhaust the budget
        if produced < budget:
            n = min(chunk, budget - produced)
            state, pending = launch(state, n)
            produced += n
        else:
            pending = None
        out, valid, steps, done_arr = fetch.get()
        for s in range(int(steps)):
            if not valid[s, 0]:
                done = True
                break
            frames.append(out[s, 0])
        else:
            done = bool(done_arr[0])
        feed_ready()
    lm_done_t = time.perf_counter()
    feed_ready(flush=True)

    pcm = np.zeros((0,), np.float32)
    if pcm_parts:  # one copy reads every feed's output; each is `chunk` frames long
        audio = _Fetch([torch.cat([a for a, _ in pcm_parts], dim=-1).float()]).get()[0][0]
        pcm = np.concatenate([audio[i * chunk * spf:][:t * spf]
                              for i, (_, t) in enumerate(pcm_parts)])

    stacked = np.stack(frames, axis=1)  # (C+1, T)
    n_frames = stacked.shape[1]
    result = GenerationResult(
        tokens=stacked[1:],
        semantic=stacked[0],
        frames=n_frames,
        hit_max=(n_frames - 1) >= budget > 0 and not done,
        prefill_s=prefill_s,
        decode_s=lm_done_t - t1,
        prompt_tokens=prompt_len,
    )
    return pcm, result, state
