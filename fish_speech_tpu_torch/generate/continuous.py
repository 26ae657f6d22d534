"""Continuous cross-request decode batching.

Counterpart of `fish_speech_tpu/generate/continuous.py`. B decode rows
share one GenState of a batched engine; a scheduler thread interleaves:

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

With a streaming codec (`codec=`, `shift_fn=`), requests submitted with
`deliver_pcm=True` receive PCM from the batcher's central vocoder: one
batched carried-state feed a tick for every such row (`_CentralVocoder`).
Other clients vocode their own codes.

A request can be cancelled from any thread (`BatchedRequest.cancel`): its
iterators end at once, and at the next tick the scheduler frees its row
(or drops it from the admission queue) and its vocoder lane. The JAX
batcher has no cancel (its `BatchedRequest`, continuous.py:88): there a
client that goes away leaves its row decoding to the end of its budget.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fish_speech_tpu_torch.device import Fetch as _Fetch
from fish_speech_tpu_torch.device import host_to_device
from fish_speech_tpu_torch.generate.engine import GenState, LMEngine
from fish_speech_tpu_torch.models.codec.stream_conv import tree_where
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


@dataclasses.dataclass
class _PartialPCM:
    """Streaming event of a deliver_pcm request: the PCM of `frames` code
    frames from the central vocoder. A chunk's events concatenate to the
    codec's whole-sequence decode of that chunk."""

    pcm: np.ndarray  # (frames * samples_per_frame,) float32
    frames: int


class _Cancelled(Exception):
    """Raised inside a cancelled request's iterators, which end on it."""


_CANCELLED = object()  # the results sentinel of a cancelled request


class BatchedRequest:
    """Handle returned by ContinuousBatcher.submit: iterate to receive one
    _ChunkResult per text chunk, in order; `cancel()` gives its row up."""

    def __init__(self, prompts: List[np.ndarray], cond_len: int, max_new: int,
                 stream: bool = False, sampling: Optional[SamplingArgs] = None,
                 seed: Optional[int] = None, low_latency: Optional[bool] = None,
                 deliver_pcm: bool = False):
        self.prompts = prompts
        self.cond_len = cond_len
        self.max_new = max_new
        # stream controls delivery (per-tick _PartialFrames events, or
        # _PartialPCM ones with deliver_pcm); low_latency controls
        # scheduling (a short admission tick and cooldown ticks so first
        # frames beat a full horizon)
        self.stream = stream or deliver_pcm
        self.deliver_pcm = deliver_pcm
        self.low_latency = stream if low_latency is None else low_latency
        self.sampling = sampling  # None -> the batcher's default
        self.seed = seed
        self.results: "queue.Queue[Optional[object]]" = queue.Queue()
        self.error: Optional[Exception] = None
        self.batcher: Optional["ContinuousBatcher"] = None  # set by submit
        self.cancelled = False
        self.ended = False  # every chunk result was read
        # scheduler ticks (ContinuousBatcher.ticks) and perf_counter times
        # of the first admission, the cancel and the row's release
        self.admitted_tick: Optional[int] = None
        self.cancel_tick: Optional[int] = None
        self.freed_tick: Optional[int] = None
        self.cancel_time: Optional[float] = None
        self.freed_time: Optional[float] = None

    def cancel(self) -> None:
        """Give the request up, from any thread: its iterators end now
        (a caller blocked in one returns), and at the next tick the
        scheduler frees its row, or drops it from the admission queue,
        and throws away its pending frames and its vocoder lane. A no-op
        once every result was read."""
        if self.cancelled or self.ended:
            return
        self.cancelled = True
        self.cancel_time = time.perf_counter()
        self.results.put(_CANCELLED)
        b = self.batcher
        if b is not None:
            self.cancel_tick = b.ticks
            b._cancels.put(self)
            b._wake.set()

    def _next(self, timeout: Optional[float]):
        if self.cancelled:
            raise _Cancelled
        try:
            r = self.results.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError(f"no batcher event within {timeout} s") from None
        if r is _CANCELLED:
            raise _Cancelled
        if r is None:
            raise self.error or RuntimeError("batcher shut down")
        return r

    def __iter__(self):
        return self.iter_chunks()

    def iter_chunks(self, timeout: Optional[float] = None):
        """Yield one _ChunkResult per text chunk (partial-frame events of
        a stream=True request are skipped). timeout: seconds to wait for
        each event before TimeoutError. Ends early once cancelled."""
        for i in range(len(self.prompts)):
            while True:
                try:
                    r = self._next(timeout)
                except _Cancelled:
                    return
                if isinstance(r, _ChunkResult):
                    break
            self.ended = i + 1 == len(self.prompts)
            yield r

    def iter_events(self, timeout: Optional[float] = None):
        """Yield _PartialFrames (or, with deliver_pcm, _PartialPCM) and
        _ChunkResult events in decode order; requires stream=True or
        deliver_pcm=True at submit. Ends early once cancelled."""
        ended = 0
        while ended < len(self.prompts):
            try:
                r = self._next(timeout)
            except _Cancelled:
                return
            if isinstance(r, _ChunkResult):
                ended += 1
                self.ended = ended == len(self.prompts)
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
        # central vocoder (deliver_pcm) bookkeeping
        self.pcm = False  # PCM delivery through the central vocoder
        self.ending = False  # chunk decoded; its PCM not all delivered yet
        self.held_final: Optional[_ChunkResult] = None
        self.release_row = False  # free the row once the PCM is delivered


@dataclasses.dataclass
class _AdmitGroup:
    """One admission prefill of this tick (a pow2 burst or one row); its
    first frames and EOS flags are fetched with the tick."""

    slots: List[_RowState]
    epochs: List[int]
    frames: torch.Tensor  # (k, C+1)
    eoses: torch.Tensor  # (k,) bool


@dataclasses.dataclass
class _Inflight:
    """One dispatched tick: admissions plus a decode chunk whose outputs
    the host has not read yet."""

    admits: List[_AdmitGroup]
    snapshot: List[tuple]  # (slot, epoch) per row live at dispatch
    fetch: _Fetch  # admissions' frames/eoses, then out, valid, done, steps


class _CentralVocoder:
    """The batcher's batched carried-state vocoder, driven by the
    scheduler thread.

    Every row of a deliver_pcm request is a lane of one B-row streaming
    session; each tick feeds every lane that has frames in one batched
    `decode_step_async`, converts the PCM to int16 on the card, and
    queues one event-fenced copy of it (`_Fetch`) to a delivery thread,
    which emits each lane's `_PartialPCM` (int16 / 32767 as float32) in
    tick order, then a finished chunk's held `_ChunkResult`.

    A feed advances every lane by t frames, so lanes are reconciled by
    host-side pending queues: t is the fewest frames any mid-stream lane
    with frames holds (at most max_step). A mid-stream lane takes exactly
    t real frames (zero padding would corrupt its carried state) or, when
    it holds fewer, sits the tick out, and a masked select keeps its
    state. An ending lane (chunk decoded) takes what it has up to t,
    right-padded: the decode is causal, and its lane is reset before its
    next chunk. Resets (a fresh stream a text chunk) are one masked
    select of the state with the zero template.

    Departures from the JAX batcher (continuous.py), both faults there:
    JAX takes t = min(pending) over all mid-stream lanes (l.336), so one
    lane with nothing pending stops every lane's PCM for that tick; and
    when delivery raises it unblocks the clients but never releases the
    finished rows (l.461-465), so they are lost to admission. Here lanes
    with frames are fed, and finished rows are released whatever
    delivery did.

    Threads: the scheduler thread owns lanes, queues and state and makes
    every launch; the delivery thread only waits for copies and puts
    events. Rows it finishes go back through `released`, which the
    scheduler drains (`ContinuousBatcher._drain_releases`), so the
    scheduler alone writes the rows."""

    def __init__(self, batcher: "ContinuousBatcher", codec, shift_fn):
        self.codec = codec
        self.shift = shift_fn if shift_fn is not None else (lambda c: c)
        self.b = batcher.engine.batch_size
        self.n_codebooks = batcher.engine.cfg.num_codebooks
        # a lane that fell behind catches up at twice the decode rate
        self.session = codec.start_stream(batch=self.b, max_step_frames=2 * batcher.horizon)
        self.max_step = self.session.max_step
        self.spf = codec.samples_per_frame
        self.pend = [collections.deque() for _ in range(self.b)]  # (C, t) segments
        self.pend_n = [0] * self.b
        self.reset_mask = np.zeros(self.b, bool)
        self.lanes: Dict[int, _RowState] = {}  # row -> slot streaming PCM
        self._dq: "queue.Queue[Optional[tuple]]" = queue.Queue()  # (_Fetch | None, meta)
        self._queued = 0  # deliveries put on _dq and not yet emitted
        self._emitted = threading.Condition()
        self.released: "queue.Queue[_RowState]" = queue.Queue()
        self._thread = threading.Thread(target=self._deliver_loop, daemon=True)
        self._thread.start()

    def _mask(self, rows: np.ndarray) -> torch.Tensor:
        return host_to_device(rows, self.codec.device)

    @staticmethod
    def _to_i16(audio: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(audio.float() * 32767.0), -32768, 32767).to(torch.int16)

    def enable_row(self, slot: _RowState) -> None:
        """A deliver_pcm chunk admitted: claim the lane and schedule its
        reset (a fresh stream a text chunk)."""
        r = slot.row
        self.lanes[r] = slot
        self.reset_mask[r] = True
        self.pend[r].clear()
        self.pend_n[r] = 0
        slot.pcm = True
        slot.ending = False

    def drop(self, slot: _RowState) -> None:
        """A cancelled request's lane: no further feeds, its pending frames
        and held result thrown away. Deliveries already queued for it
        still run; their release of the row is ignored (the row is no
        longer the slot's, `ContinuousBatcher._drain_releases`)."""
        r = slot.row
        if self.lanes.get(r) is slot:
            del self.lanes[r]
            self.pend[r].clear()
            self.pend_n[r] = 0
        slot.held_final = None
        slot.ending = slot.pcm = slot.release_row = False

    def push(self, slot: _RowState, seg: np.ndarray) -> None:
        """Queue one (C+1, t) token segment for the slot's lane (semantic
        row dropped, codec shift applied)."""
        codes = np.ascontiguousarray(self.shift(np.asarray(seg)[1:]))
        if codes.shape[-1]:
            self.pend[slot.row].append(codes)
            self.pend_n[slot.row] += codes.shape[-1]

    def has_work(self) -> bool:
        return bool(self.lanes) or self._queued > 0

    def _put(self, fetch: Optional[_Fetch], meta: list) -> None:
        with self._emitted:
            self._queued += 1
        self._dq.put((fetch, meta))

    def _take(self, r: int, n: int) -> np.ndarray:
        """Pop the first n pending frames of lane r, (C, n)."""
        q, parts = self.pend[r], []
        while n:
            seg = q[0]
            if seg.shape[-1] <= n:
                parts.append(q.popleft())
                n -= seg.shape[-1]
            else:
                parts.append(seg[:, :n])
                q[0] = seg[:, n:]
                n = 0
        return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=-1)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run a feed of max_step frames, the int16 conversion and the
        masked select once, on a scratch state."""
        st = self.session.state
        audio, _ = self.codec.decode_step_async(
            np.zeros((self.b, self.n_codebooks, self.max_step), np.int32), st)
        self._to_i16(audio)
        tree_where(self._mask(np.zeros(self.b, bool)), self.session._template(), st)
        if self.codec.device.type == "cuda":
            torch.cuda.synchronize(self.codec.device)

    @torch.inference_mode()
    def tick(self) -> None:
        """Launch at most one batched feed and queue its PCM for delivery."""
        mids = [self.pend_n[r] for r, s in self.lanes.items() if not s.ending and self.pend_n[r]]
        ends = [self.pend_n[r] for r, s in self.lanes.items() if s.ending and self.pend_n[r]]
        t = min(min(mids) if mids else max(ends, default=0), self.max_step)
        buf = np.zeros((self.b, self.n_codebooks, t), np.int32)
        fed = np.zeros(self.b, bool)
        meta = []  # (slot, frames taken, final)
        for r in list(self.lanes):
            slot = self.lanes[r]
            n = self.pend_n[r]
            take = min(n, t) if slot.ending else (t if n >= t else 0)
            if take:
                buf[r, :, :take] = self._take(r, take)
                self.pend_n[r] -= take
                fed[r] = True
            final = slot.ending and self.pend_n[r] == 0
            if final:
                del self.lanes[r]  # no further feeds for this chunk
            if take or final:
                meta.append((slot, take, final))
        if not t:
            if meta:  # lanes already fed in full: their held results, in order
                self._put(None, meta)
            return
        state = self.session.state
        if self.reset_mask.any():
            state = tree_where(self._mask(self.reset_mask), self.session._template(), state)
            self.reset_mask[:] = False
        audio, new_state = self.codec.decode_step_async(buf, state)
        sat_out = np.zeros(self.b, bool)
        sat_out[[r for r in self.lanes if not fed[r]]] = True
        if sat_out.any():  # lanes that did not take frames keep their state
            new_state = tree_where(self._mask(sat_out), state, new_state)
        self.session.state = new_state
        self._put(_Fetch([self._to_i16(audio)]), meta)

    def _deliver_loop(self) -> None:
        while True:
            item = self._dq.get()
            if item is None:
                return
            fetch, meta = item
            try:
                pcm = fetch.get()[0] if fetch is not None else None  # (B, t * spf) int16
                for slot, take, final in meta:
                    if take:
                        f32 = pcm[slot.row, :take * self.spf].astype(np.float32) / 32767.0
                        slot.req.results.put(_PartialPCM(pcm=f32, frames=take))
                    if final and slot.held_final is not None:
                        slot.req.results.put(slot.held_final)
            except Exception as e:  # noqa: BLE001 - reaches the tick's clients
                logger.exception("central vocoder delivery failed")
                for slot, _, _ in meta:
                    slot.req.error = e
                    slot.req.results.put(None)
            finally:
                for slot, _, final in meta:
                    if final:
                        slot.held_final = None
                        self.released.put(slot)  # also after a failure
                with self._emitted:
                    self._queued -= 1
                    self._emitted.notify_all()

    def finish(self, timeout: float = 30.0) -> None:
        """Feed every ending lane to its end, then wait until every queued
        delivery has been emitted. Each tick takes at least one frame of
        every ending lane or retires it, and no frames arrive meanwhile,
        so the feeding ends."""
        while any(s.ending for s in self.lanes.values()):
            self.tick()
        self.drain(timeout)

    def drain(self, timeout: float = 30.0) -> None:
        """Wait until every queued delivery has been emitted."""
        with self._emitted:
            if not self._emitted.wait_for(lambda: self._queued == 0, timeout):
                logger.error("central vocoder deliveries not emitted within %.0fs", timeout)

    def shutdown(self) -> None:
        self._dq.put(None)
        self._thread.join(timeout=10)


class ContinuousBatcher:
    def __init__(self, engine: LMEngine, sampling: SamplingArgs, *, horizon: int = 16,
                 admit_horizon: int = 3, admit_cooldown: int = 2, codec=None,
                 shift_fn=None) -> None:
        """engine: built with batch_size == the number of decode rows (16
        in the serving configuration). The admission tick of a fresh
        low-latency request decodes admit_horizon frames and the
        admit_cooldown ticks after it stay that short too, so its first
        frames do not wait a full horizon; other ticks decode `horizon`.

        codec + shift_fn: a streaming codec (`can_stream`) on the engine's
        device turns on central vocoding for deliver_pcm requests;
        shift_fn maps codebook tokens to codec indices
        (`overlap.output_shift`), None is the identity. A codec that
        cannot stream leaves it off."""
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
        self._central: Optional[_CentralVocoder] = None
        if codec is not None and getattr(codec, "can_stream", False):
            self._central = _CentralVocoder(self, codec, shift_fn)
        self.rows: List[Optional[_RowState]] = [None] * engine.batch_size
        # bumped on every admission/finish of the row; tags dispatches so
        # speculative frames of a superseded chunk are discarded
        self.epoch = [0] * engine.batch_size
        self.queue: "queue.Queue[BatchedRequest]" = queue.Queue()
        self._cancels: "queue.Queue[BatchedRequest]" = queue.Queue()  # BatchedRequest.cancel
        self.ticks = 0  # ticks dispatched
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
        config. deliver_pcm=True (needs the batcher's streaming codec)
        streams _PartialPCM events from the central vocoder."""
        if deliver_pcm and self._central is None:
            raise ValueError(
                "deliver_pcm requires a streaming codec on the batcher "
                "(ContinuousBatcher(..., codec=..., shift_fn=...))")
        req = BatchedRequest(prompts, cond_len, max_new, stream=stream, sampling=sampling,
                             seed=seed, low_latency=low_latency, deliver_pcm=deliver_pcm)
        req.batcher = self
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
        if self._central is not None:
            self._central.shutdown()
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
        """Build the kernels and run the engine's paths once (a decode
        chunk of each of the two horizons, which captures their loops on
        an engine with CUDA graphs), the central vocoder's feed on a
        scratch state, then one small request through the scheduler
        (through the central vocoder where there is one)."""
        eng = self.engine
        eng.warmup(self.sampling, chunk_horizons=sorted({self.admit_horizon, self.horizon}))
        if self._central is not None:
            self._central.warmup()
        n = min(eng.prompt_buckets[0], eng.cache_len - self.horizon - 2)
        prompt = np.zeros((eng.cfg.num_codebooks + 1, n), np.int32)
        for _ in self.submit([prompt], 0, self.admit_horizon + 2, stream=True,
                             deliver_pcm=self._central is not None):
            pass

    # -- scheduler ---------------------------------------------------------

    def _admit(self) -> List[_AdmitGroup]:
        """Fill free rows: next chunks of rows whose previous chunk just
        finished first (those keep their row), then new requests, in
        power-of-two bursts over contiguous free rows."""
        admits: List[_AdmitGroup] = []
        self._drain_releases()
        self._reap_cancelled()
        for slot in self.rows:
            # an ending slot keeps its row until its PCM is delivered
            if slot is not None and not slot.active and not slot.ending:
                admits.append(self._start_chunk(slot))
        placements: List[_RowState] = []
        for r in range(len(self.rows)):
            if self.rows[r] is None:
                req = self._next_queued()
                if req is None:
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

    def _next_queued(self) -> Optional[BatchedRequest]:
        """The next request of the admission queue that is not cancelled."""
        while True:
            try:
                req = self.queue.get_nowait()
            except queue.Empty:
                return None
            if not req.cancelled:
                return req

    def _reap_cancelled(self) -> None:
        """Apply the cancels made since the last tick: free each cancelled
        request's row (its in-flight frames turn epoch-stale, and the row
        is silenced on the device), drop its vocoder lane, and drop it
        from the admission queue if it was never admitted."""
        reqs = []
        while True:
            try:
                reqs.append(self._cancels.get_nowait())
            except queue.Empty:
                break
        if not reqs:
            return
        queued = False
        for req in reqs:
            slot = next((s for s in self.rows if s is not None and s.req is req), None)
            if slot is None:
                queued = True
                continue
            if self._central is not None:
                self._central.drop(slot)
            if slot.active:
                done = self.state.done.clone()
                done[slot.row] = True
                self.state = self.state._replace(done=done)
            slot.active = False
            slot.segs = []
            self.epoch[slot.row] += 1
            self.rows[slot.row] = None
            req.freed_tick, req.freed_time = self.ticks, time.perf_counter()
        if queued:
            with self.queue.mutex:  # submit's put takes the same lock
                self.queue.queue = collections.deque(
                    r for r in self.queue.queue if not r.cancelled)

    def _drain_releases(self) -> None:
        """Apply the rows the central vocoder's delivery thread finished
        (only this scheduler thread writes self.rows). A request whose
        delivery failed gives its row up; a slot whose row was taken from
        it by a cancel is past."""
        if self._central is None:
            return
        while True:
            try:
                slot = self._central.released.get_nowait()
            except queue.Empty:
                return
            slot.ending = False
            slot.pcm = False
            if ((slot.release_row or slot.req.error is not None)
                    and self.rows[slot.row] is slot):
                self.rows[slot.row] = None

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
        if slot.req.admitted_tick is None:
            slot.req.admitted_tick = self.ticks
        if slot.req.deliver_pcm:
            self._central.enable_row(slot)

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
        if slot.pcm:
            # central vocoding: queue the segments for the batched feed
            for seg in slot.segs[slot.sent_segs:]:
                self._central.push(slot, seg)
            slot.sent_segs = len(slot.segs)
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
        result = _ChunkResult(tokens=stacked[1:], semantic=stacked[0], hit_max=hit_max)
        slot.active = False
        slot.segs = []
        self.epoch[slot.row] += 1
        # silence the row on the device until its next admission (after
        # the chunks already launched, which may still decode it
        # speculatively: those frames are epoch-stale)
        done = self.state.done.clone()
        done[slot.row] = True
        self.state = self.state._replace(done=done)
        last = slot.chunk_idx + 1 >= len(slot.req.prompts)
        if slot.pcm:
            # hold the result and the row until the lane's PCM is
            # delivered: PCM events precede the chunk's result, and no
            # admission may reset the lane before it is drained
            slot.ending = True
            slot.held_final = result
            slot.release_row = last
            return
        slot.req.results.put(result)
        if last:
            self.rows[slot.row] = None  # request complete; free the row
        # else: the row stays reserved; the next chunk is admitted next tick

    def _any_active(self) -> bool:
        return any(s is not None and s.active for s in self.rows)

    def _dispatch(self) -> Optional[_Inflight]:
        """One tick's device work, launched without waiting: admissions
        and one decode chunk. None when there is nothing to run."""
        self.ticks += 1
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
        # one batched vocoder feed for the deliver_pcm rows, launched
        # behind the next decode chunk
        if self._central is not None and self._central.has_work():
            self._central.tick()

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
                    if pending is None and self._central is not None:
                        # no decode work: go on feeding and retiring the
                        # PCM lanes (the last requests of a wave)
                        self._drain_releases()
                        if self._central.has_work():
                            self._central.tick()
                            time.sleep(0.001)
                if pending is not None:
                    self._process(pending)
                if self._central is not None:
                    # deliver held chunk results before releasing clients
                    # (mid-stream lanes cut off by shutdown are released
                    # below)
                    self._central.finish()
                    self._drain_releases()
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
