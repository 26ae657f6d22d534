"""Continuous cross-request decode batching.

Counterpart of `fish_speech_tpu/generate/continuous.py` without its
central batched vocoder. B decode rows share one GenState of a batched
engine; a scheduler thread interleaves:

    admit queued requests into free rows (a prefill at the row's own
    offset; fresh requests on contiguous free rows in power-of-two
    bursts through one `prefill_rows`) -> decode a short horizon of
    frames for ALL rows (`decode_chunk`) -> hand finished frames to their
    requests -> repeat.

Rows are independent, so requests join and leave the batch at chunk
granularity. The scheduler is pipelined: PyTorch launches asynchronously,
so each tick launches chunk N+1 (and its admissions) before it waits for
chunk N's outputs, which were copied to the host behind chunk N on the
same stream and are fetched once, by an event. The card computes chunk
N+1 while the host unpacks chunk N. Rows that finish in chunk N keep
decoding speculatively in chunk N+1; a per-row epoch counter (bumped on
every admission and finish) tags each dispatch, so stale speculative
frames are discarded on the host.

On a dynamic_sampling engine (the serving configuration) each request's
temp/top_p/top_k/rep-pen and seed are installed into its row at
admission, and a seeded request's codes depend only on its own seed; on
a static engine the batcher's one SamplingArgs serves every request.

Not ported yet: the central batched vocoder (`codec=` / `shift_fn=`, and
`deliver_pcm` requests), which needs the streaming codec. Clients vocode
their own codes.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from fish_speech_tpu_torch.generate.engine import GenState, LMEngine
from fish_speech_tpu_torch.ops.sampling import SamplingArgs

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _ChunkResult:
    tokens: np.ndarray  # (C, T) codebook rows
    semantic: np.ndarray  # (T,)
    hit_max: bool


@dataclasses.dataclass
class _PartialFrames:
    """Streaming event: frames decoded for the current text chunk since
    the last event (the final _ChunkResult still carries them all)."""

    frames: np.ndarray  # (C+1, t): semantic row + codebook rows


class BatchedRequest:
    """Handle returned by ContinuousBatcher.submit: iterate to receive one
    _ChunkResult per text chunk, in order."""

    def __init__(self, prompts: List[np.ndarray], cond_len: int, max_new: int,
                 stream: bool = False, sampling: Optional[SamplingArgs] = None,
                 seed: Optional[int] = None, low_latency: Optional[bool] = None):
        self.prompts = prompts
        self.cond_len = cond_len
        self.max_new = max_new
        # stream controls delivery (per-tick _PartialFrames events);
        # low_latency controls scheduling (a short admission tick and
        # cooldown ticks so first frames beat a full horizon)
        self.stream = stream
        self.low_latency = stream if low_latency is None else low_latency
        self.sampling = sampling  # None -> the batcher's default
        self.seed = seed
        self.results: "queue.Queue[Optional[object]]" = queue.Queue()
        self.error: Optional[Exception] = None

    def _next(self, timeout: Optional[float]):
        try:
            r = self.results.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"no batcher event within {timeout} s") from None
        if r is None:
            raise self.error or RuntimeError("batcher shut down")
        return r

    def __iter__(self):
        return self.iter_chunks()

    def iter_chunks(self, timeout: Optional[float] = None):
        """Yield one _ChunkResult per text chunk (partial-frame events of
        a stream=True request are skipped). timeout: seconds to wait for
        each event before TimeoutError."""
        for _ in range(len(self.prompts)):
            while True:
                r = self._next(timeout)
                if isinstance(r, _ChunkResult):
                    break
            yield r

    def iter_events(self, timeout: Optional[float] = None):
        """Yield _PartialFrames and _ChunkResult events in decode order;
        requires stream=True at submit."""
        ended = 0
        while ended < len(self.prompts):
            r = self._next(timeout)
            if isinstance(r, _ChunkResult):
                ended += 1
            yield r


class _RowState:
    """Scheduler-side tracking for one decode row. Frames are kept as
    (C+1, t) segments (views into a tick's fetched buffer), one per tick
    or admission."""

    def __init__(self, req: BatchedRequest, row: int):
        self.req = req
        self.row = row
        self.chunk_idx = -1  # admitted chunk index
        self.segs: List[np.ndarray] = []  # (C+1, t) segments, in order
        self.sent_segs = 0  # segments already sent as _PartialFrames
        self.budget = 0
        self.active = False  # row currently decoding a chunk


@dataclasses.dataclass
class _AdmitGroup:
    """One admission prefill of this tick (a pow2 burst or one row); its
    first frames and EOS flags are fetched with the tick."""

    slots: List[_RowState]
    epochs: List[int]
    frames: torch.Tensor  # (k, C+1)
    eoses: torch.Tensor  # (k,) bool


class _Fetch:
    """Device tensors copied to the host behind the work that makes them,
    on the current stream; `get` waits for those copies only, not for
    work launched after them."""

    def __init__(self, tensors: Sequence[torch.Tensor]):
        cuda = tensors[0].device.type == "cuda"
        self.host = [t.to("cpu", non_blocking=cuda) if cuda else t.clone() for t in tensors]
        self.event = None
        if cuda:
            self.event = torch.cuda.Event()
            self.event.record()

    def get(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [t.numpy() for t in self.host]


@dataclasses.dataclass
class _Inflight:
    """One dispatched tick: admissions plus a decode chunk whose outputs
    the host has not read yet."""

    admits: List[_AdmitGroup]
    snapshot: List[tuple]  # (slot, epoch) per row live at dispatch
    fetch: _Fetch  # admissions' frames/eoses, then out, valid, done, steps


class ContinuousBatcher:
    def __init__(self, engine: LMEngine, sampling: SamplingArgs, *, horizon: int = 16,
                 admit_horizon: int = 3, admit_cooldown: int = 2, codec=None,
                 shift_fn=None) -> None:
        """engine: built with batch_size == the number of decode rows (16
        in the serving configuration). The admission tick of a fresh
        low-latency request decodes admit_horizon frames and the
        admit_cooldown ticks after it stay that short too, so its first
        frames do not wait a full horizon; other ticks decode `horizon`."""
        if codec is not None or shift_fn is not None:
            raise NotImplementedError(
                "central batched vocoding (codec=, shift_fn=) needs the streaming codec, "
                "which is not ported yet (ROADMAP queue 1, module 3); vocode on the client")
        self.engine = engine
        self.sampling = sampling
        self.horizon = horizon
        u = engine.decode_unroll
        self.admit_horizon = min(-(-min(admit_horizon, horizon) // u) * u, horizon)
        self.admit_cooldown = admit_cooldown
        self._short_left = 0  # short ticks remaining after a fresh admission
        self._first_flush = False  # a first partial event was just sent
        state = engine.init_state()
        # idle rows must be done on the device, or they decode junk and
        # advance their cache positions between admissions
        self.state: GenState = state._replace(done=torch.ones_like(state.done))
        self.rows: List[Optional[_RowState]] = [None] * engine.batch_size
        # bumped on every admission/finish of the row; tags dispatches so
        # speculative frames of a superseded chunk are discarded
        self.epoch = [0] * engine.batch_size
        self.queue: "queue.Queue[BatchedRequest]" = queue.Queue()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, prompts: List[np.ndarray], cond_len: int, max_new: int,
               stream: bool = False, sampling: Optional[SamplingArgs] = None,
               seed: Optional[int] = None, low_latency: Optional[bool] = None,
               deliver_pcm: bool = False) -> BatchedRequest:
        """sampling/seed are honoured per request on dynamic_sampling
        engines; a static engine serves every request with the batcher's
        config. deliver_pcm needs the central vocoder, not ported yet."""
        if deliver_pcm:
            raise ValueError(
                "deliver_pcm requires a streaming codec on the batcher "
                "(ContinuousBatcher(..., codec=..., shift_fn=...))")
        req = BatchedRequest(prompts, cond_len, max_new, stream=stream, sampling=sampling,
                             seed=seed, low_latency=low_latency)
        self.queue.put(req)
        self._wake.set()
        if self._stop:
            # submit raced shutdown: the scheduler may be past its final
            # queue drain, so release this client directly
            req.results.put(None)
        return req

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # scheduler wedged: its own exit drain will never run, so
            # release clients blocked on in-flight rows here
            logger.error("continuous batcher scheduler did not exit within 10s; "
                         "force-releasing %d in-flight rows",
                         sum(s is not None for s in self.rows))
            err = RuntimeError("batcher shutdown timed out (scheduler hung)")
            for slot in self.rows:
                if slot is not None:
                    slot.req.error = err
                    slot.req.results.put(None)
        # requests enqueued after the scheduler's final drain
        while not self.queue.empty():
            self.queue.get_nowait().results.put(None)

    def warmup(self) -> None:
        """Build the kernels and run the engine's paths once, then one
        small request through the scheduler."""
        eng = self.engine
        eng.warmup(self.sampling)
        n = min(eng.prompt_buckets[0], eng.cache_len - self.horizon - 2)
        prompt = np.zeros((eng.cfg.num_codebooks + 1, n), np.int32)
        for _ in self.submit([prompt], 0, self.admit_horizon + 2, stream=True):
            pass

    # -- scheduler ---------------------------------------------------------

    def _admit(self) -> List[_AdmitGroup]:
        """Fill free rows: next chunks of rows whose previous chunk just
        finished first (those keep their row), then new requests, in
        power-of-two bursts over contiguous free rows."""
        admits: List[_AdmitGroup] = []
        for slot in self.rows:
            if slot is not None and not slot.active:
                admits.append(self._start_chunk(slot))
        placements: List[_RowState] = []
        for r in range(len(self.rows)):
            if self.rows[r] is None:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    break
                slot = _RowState(req, r)
                self.rows[r] = slot
                placements.append(slot)
        i = 0
        while i < len(placements):
            j = i
            while j + 1 < len(placements) and placements[j + 1].row == placements[j].row + 1:
                j += 1
            run = placements[i:j + 1]
            s, k = 0, len(run)
            while s < k:
                g = 1 << ((k - s).bit_length() - 1)  # power-of-two groups
                group = run[s:s + g]
                admits.append(self._start_chunk(group[0]) if g == 1
                              else self._start_chunk_burst(group))
                s += g
            i = j + 1
        return admits

    def _req_sampling(self, req: BatchedRequest) -> SamplingArgs:
        """A request's own sampling on dynamic engines, the batcher's
        otherwise."""
        if self.engine.dynamic_sampling and req.sampling is not None:
            return req.sampling
        return self.sampling

    @staticmethod
    def _req_seed(req: BatchedRequest, chunk_idx: int) -> Optional[int]:
        """Per-text-chunk seed of a seeded request: the stream depends on
        (seed, chunk_idx, own frame count) only."""
        if req.seed is None:
            return None
        return (int(req.seed) + chunk_idx * 0x9E3779B1) & 0x7FFFFFFF

    def _begin(self, slot: _RowState, prompt_len: int, offset: int) -> None:
        slot.segs = []
        slot.sent_segs = 0
        slot.budget = max(min(slot.req.max_new - 1,
                              self.engine.cache_len - (offset + prompt_len) - 1), 0)
        slot.active = True
        self.epoch[slot.row] += 1

    def _start_chunk_burst(self, slots: List[_RowState]) -> _AdmitGroup:
        """Admit a contiguous run of fresh requests (first chunk, offset 0)
        in one prefill."""
        prompts = []
        for slot in slots:
            slot.chunk_idx += 1  # -1 -> 0
            prompt = np.asarray(slot.req.prompts[0])
            prompt = prompt[0] if prompt.ndim == 3 else prompt
            prompts.append(prompt)
            self._begin(slot, prompt.shape[-1], 0)
        self.state, frames, eoses = self.engine.prefill_rows(
            self.state, prompts, self.sampling, slots[0].row,
            per_row=[(self._req_sampling(s.req), self._req_seed(s.req, 0)) for s in slots])
        return _AdmitGroup(slots, [self.epoch[s.row] for s in slots], frames, eoses)

    def _start_chunk(self, slot: _RowState) -> _AdmitGroup:
        req = slot.req
        slot.chunk_idx += 1
        prompt = np.asarray(req.prompts[slot.chunk_idx])
        offset = req.cond_len if slot.chunk_idx > 0 else 0
        # prefill_row rewinds the row to `offset` and marks it live again
        self.state, frame, is_eos = self.engine.prefill_row(
            self.state, prompt, self._req_sampling(req), slot.row, offset=offset,
            seed=self._req_seed(req, slot.chunk_idx))
        self._begin(slot, prompt.shape[-1], offset)
        return _AdmitGroup([slot], [self.epoch[slot.row]], frame[None], is_eos[None])

    def _flush_partial(self, slot: _RowState) -> None:
        """Send frames decoded since the last event to a stream=True
        request (one event per scheduler tick)."""
        if not slot.req.stream or slot.sent_segs >= len(slot.segs):
            return
        if slot.sent_segs == 0 and slot.req.low_latency:
            self._first_flush = True  # see _run
        new_segs = slot.segs[slot.sent_segs:]
        new = new_segs[0] if len(new_segs) == 1 else np.concatenate(new_segs, axis=1)
        slot.req.results.put(_PartialFrames(frames=new))
        slot.sent_segs = len(slot.segs)

    def _finish_chunk(self, slot: _RowState, hit_max: bool) -> None:
        self._flush_partial(slot)
        c = self.engine.cfg.num_codebooks
        # an empty chunk is (C+1, 0), so its tokens are (C, 0); the JAX
        # batcher stacks np.zeros((0, 0)) there (continuous.py:870-876)
        stacked = (slot.segs[0] if len(slot.segs) == 1
                   else np.concatenate(slot.segs, axis=1) if slot.segs
                   else np.zeros((c + 1, 0), np.int32))
        slot.req.results.put(_ChunkResult(tokens=stacked[1:], semantic=stacked[0],
                                          hit_max=hit_max))
        slot.active = False
        slot.segs = []
        self.epoch[slot.row] += 1
        # silence the row on the device until its next admission (after
        # the chunks already launched, which may still decode it
        # speculatively: those frames are epoch-stale)
        done = self.state.done.clone()
        done[slot.row] = True
        self.state = self.state._replace(done=done)
        if slot.chunk_idx + 1 >= len(slot.req.prompts):
            self.rows[slot.row] = None  # request complete; free the row
        # else: the row stays reserved; the next chunk is admitted next tick

    def _any_active(self) -> bool:
        return any(s is not None and s.active for s in self.rows)

    def _dispatch(self) -> Optional[_Inflight]:
        """One tick's device work, launched without waiting: admissions
        and one decode chunk. None when there is nothing to run."""
        admits = self._admit()
        if not self._any_active():
            return None
        snapshot = [(slot, self.epoch[slot.row]) for slot in self.rows
                    if slot is not None and slot.active]
        # fresh low-latency admissions get a short first chunk, and the
        # next admit_cooldown ticks stay short; other ticks decode the
        # full horizon
        if any(s.chunk_idx == 0 and s.req.low_latency for a in admits for s in a.slots):
            self._short_left = 1 + self.admit_cooldown
        if self._short_left > 0:
            self._short_left -= 1
            horizon = self.admit_horizon
        else:
            horizon = self.horizon
        self.state, out, valid, steps = self.engine.decode_chunk(
            self.state, self.sampling, horizon)
        tensors = [t for g in admits for t in (g.frames, g.eoses)]
        fetch = _Fetch(tensors + [out, valid, self.state.done, steps])
        return _Inflight(admits, snapshot, fetch)

    def _process(self, flight: _Inflight) -> None:
        """Wait for one in-flight tick's outputs and hand frames to their
        requests; runs while the next tick computes on the device."""
        fetched = flight.fetch.get()
        # admission first frames precede the chunk's frames in time
        for gi, group in enumerate(flight.admits):
            gframes, geoses = fetched[2 * gi], fetched[2 * gi + 1]
            for i, (slot, epoch) in enumerate(zip(group.slots, group.epochs)):
                if self.epoch[slot.row] != epoch or not slot.active:
                    continue
                slot.segs.append(gframes[i:i + 1].T)  # (C+1, 1) view
                if bool(geoses[i]) or slot.budget == 0:
                    self._finish_chunk(slot, hit_max=False)
        out, valid, done, steps = fetched[2 * len(flight.admits):]
        steps = int(steps)
        if steps and flight.snapshot:
            # leading-valid count per row: a live row's first invalid
            # frame is its EOS; later frames are EOS padding
            v = valid[:steps]
            counts = np.where(v.all(axis=0), steps, np.argmin(v, axis=0))
        for slot, epoch in flight.snapshot:
            if not slot.active or self.epoch[slot.row] != epoch:
                continue  # the row finished before this chunk was read
            r = slot.row
            k = int(counts[r]) if steps else 0
            take = min(k, slot.budget)
            if take:
                slot.segs.append(out[:take, r].T)  # (C+1, take) view
                slot.budget -= take
            if slot.budget <= 0:
                self._finish_chunk(slot, hit_max=not done[r])
            elif k < steps or done[r]:
                self._finish_chunk(slot, hit_max=False)
        for slot, epoch in flight.snapshot:
            if slot.active and self.epoch[slot.row] == epoch:
                self._flush_partial(slot)

    def _run(self) -> None:
        pending: Optional[_Inflight] = None
        try:
            with torch.inference_mode():
                while not self._stop:
                    idle = all(s is None for s in self.rows) and self.queue.empty()
                    if idle and pending is None:
                        self._wake.wait(timeout=0.1)
                        self._wake.clear()
                        continue
                    # launch tick N+1 before waiting for tick N
                    flight = self._dispatch()
                    if pending is not None:
                        self._process(pending)
                        if self._first_flush:
                            # first events were just delivered: give the
                            # clients a beat before the next launch
                            self._first_flush = False
                            time.sleep(0.002)
                    pending = flight
                if pending is not None:
                    self._process(pending)
            # clean shutdown: release clients still waiting for chunks
            for slot in self.rows:
                if slot is not None:
                    slot.req.results.put(None)
            while not self.queue.empty():
                self.queue.get_nowait().results.put(None)
        except Exception as e:  # noqa: BLE001 - reaches every waiting client
            logger.exception("continuous batcher died")
            for slot in self.rows:
                if slot is not None:
                    slot.req.error = e
                    slot.req.results.put(None)
            while not self.queue.empty():
                req = self.queue.get_nowait()
                req.error = e
                req.results.put(None)
