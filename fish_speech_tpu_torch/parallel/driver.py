"""Rank 0 drives the engines of every rank; the other ranks follow.

JAX runs one controller over the whole mesh. Here each rank is a process
holding its shard, so rank 0 (which serves) drives the others:

* every rank builds its engine on its shard, `LMEngine(..., mesh=mesh)`,
  and then a `Driver(mesh)` (a collective: it makes the control group);
* rank 0 calls `driver.lead(engine)` and gets a `ShardedEngine`, with
  LMEngine's interface over the whole batch, which the pipeline and the
  batcher use as they use an engine, their code unchanged (the
  counterpart of the JAX batcher's `shard_state` hook);
* the other ranks call `driver.follow(engine)`, which runs every call it
  receives until rank 0 closes the driver.

Each call that touches the decode state (`init_state`, `rewind`,
`with_sampling`, `with_rng`, `prefill_rows`, `_prefill_raw`, `_step`,
`decode_chunk`, and `logits`) goes from rank 0 to every rank by one
broadcast on the control group (gloo, on the CPU: its name and its small
arguments, with fresh seeds already drawn), before rank 0 runs it. Every
rank then runs it on its engine and its state, and the rows that dp
splits are gathered (`distributed.fetch_replicated`), so rank 0 returns
whole results. The other methods (`generate`, `generate_batch`,
`prefill`, `prefill_row`, `decode_step`, `warmup`) are LMEngine's own,
run on rank 0 over those calls. `sibling` makes a new engine on every
rank (the pipeline's batcher and static-batch engines).

The decode state stays on the ranks. Rank 0's caller holds a view of it:
a GenState whose `pos` and `done` are the whole batch's, whose `cache`
names the state on every rank, and whose other fields are None. A caller
that sets `done` (the batcher silencing a finished or cancelled row)
has it sent with the next call. A state rank 0 no longer references is
dropped on every rank with the next call. Calls are serialised by a
lock, so every rank runs them in one order. Without calls, rank 0 sends
a heartbeat, so a follower's wait is bounded by the group's timeout and
a lost rank 0 ends it.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import logging
import threading
import time
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from fish_speech_tpu_torch.generate.engine import GenState, LMEngine, _fresh_seed
from fish_speech_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S, fetch_replicated

logger = logging.getLogger(__name__)

_STOP, _NOOP = "stop", "noop"
_RETURNS_STATE = {"init_state", "rewind", "with_sampling", "with_rng", "prefill_rows",
                  "_prefill_raw", "_step", "decode_chunk"}


class _Ref:
    """Names one decode state held on every rank (a GenState view's
    `cache`); the state is dropped on the ranks once this is collected."""

    __slots__ = ("id", "__weakref__")

    def __init__(self, sid: int) -> None:
        self.id = sid


@dataclasses.dataclass
class _Call:
    engine: int
    method: str
    state: Optional[int]  # the input state's id
    out: Optional[int]  # the id of the state the call returns
    args: tuple
    kwargs: dict
    done: Optional[np.ndarray]  # the whole batch's done flags, where the caller set them
    free: List[int]  # states rank 0 no longer references


@dataclasses.dataclass
class _Sibling:
    base: int
    new: int
    kwargs: dict


def _host(x):
    """Tensors of a call's arguments to the CPU (the message is pickled)."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


class _Executor:
    """What every rank runs for each call: the call on its engine and its
    state, then the gathers that make rank 0's results whole."""

    def __init__(self, engine: LMEngine) -> None:
        self.engines: Dict[int, LMEngine] = {0: engine}
        self.states: Dict[int, GenState] = {}

    def run(self, msg):
        if isinstance(msg, _Sibling):
            self.engines[msg.new] = self.engines[msg.base].sibling(**msg.kwargs)
            return None
        eng = self.engines[msg.engine]
        for sid in msg.free:
            self.states.pop(sid, None)
        state = None
        if msg.state is not None:
            state = self.states[msg.state]
            if msg.done is not None:
                lo, hi = eng.rows
                state = state._replace(done=torch.from_numpy(msg.done[lo:hi]).to(eng.device))
        with torch.inference_mode():
            out = getattr(self, msg.method)(eng, state, *msg.args, **msg.kwargs)
        if msg.method not in _RETURNS_STATE:
            return out
        new_state, *rest = out
        self.states[msg.out] = new_state
        lo = eng.rows[0]
        both = self._rows(eng, torch.stack([new_state.pos, new_state.done.to(torch.int32)], 1),
                          lo, eng.batch_size)
        return (both[:, 0].contiguous(), both[:, 1].to(torch.bool), *rest)

    @staticmethod
    def _rows(eng, x, offset: int, total: int, axis: int = 0):
        """The whole batch's rows of a result of this rank's rows."""
        if not eng.rows_split:
            return x
        if axis:
            return fetch_replicated(x.transpose(0, axis), eng.mesh, offset,
                                    total).transpose(0, axis).contiguous()
        return fetch_replicated(x, eng.mesh, offset, total)

    # one method a call: (engine, state, *the call's arguments)

    def init_state(self, eng, _, seed):
        return (eng.init_state(seed),)

    def rewind(self, eng, state, length):
        return (eng.rewind(state, length),)

    def with_sampling(self, eng, state, sampling):
        return (eng.with_sampling(state, sampling),)

    def with_rng(self, eng, state, rng):
        return (eng.with_rng(state, rng),)

    def prefill_rows(self, eng, state, prompts, sampling, row0, per_row=None, offset=0):
        state, frames, eos = eng.prefill_rows(state, prompts, sampling, row0, per_row,
                                              offset=offset)
        a, k = eng.mine(row0, len(prompts)).start, len(prompts)
        return state, self._rows(eng, frames, a, k), self._rows(eng, eos, a, k)

    def _prefill_raw(self, eng, state, prompt, sampling, offset=0, seq_lens=None):
        state, *rows = eng._prefill_raw(state, prompt, sampling, offset, seq_lens)
        return (state, *(self._rows(eng, t, eng.rows[0], eng.batch_size) for t in rows))

    def _step(self, eng, state, sampling):
        state, *rows = eng._step(state, sampling)
        return (state, *(self._rows(eng, t, eng.rows[0], eng.batch_size) for t in rows))

    def decode_chunk(self, eng, state, sampling, horizon, max_steps=None):
        state, out, valid, steps = eng.decode_chunk(state, sampling, horizon, max_steps)
        lo, b = eng.rows[0], eng.batch_size
        return (state, self._rows(eng, out, lo, b, axis=1), self._rows(eng, valid, lo, b, axis=1),
                steps)

    def logits(self, eng, _, hidden):
        return eng.logits(hidden.to(eng.device))


class Driver:
    """The control channel of a mesh's ranks. Every rank makes one, at the
    same point (it makes a process group)."""

    def __init__(self, mesh, timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
        self.mesh = mesh
        self.rank = dist.get_rank()
        self.timeout_s = timeout_s
        self.control = dist.new_group(backend="gloo",
                                      timeout=datetime.timedelta(seconds=timeout_s))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._refs: Dict[int, weakref.ref] = {}
        self._done: Dict[int, torch.Tensor] = {}  # the done view last handed out, by state
        self._executor: Optional[_Executor] = None
        self._closed = threading.Event()
        self._last_send = time.monotonic()
        self._heartbeat: Optional[threading.Thread] = None

    # -- the other ranks -------------------------------------------------

    def follow(self, engine: LMEngine) -> int:
        """Run every call rank 0 sends on this rank's engine, until rank 0
        closes the driver. A call that raises here raised on rank 0 too
        (the same code on the same arguments), which reports it: the
        loop goes on. Returns the number of calls run."""
        ex, n = _Executor(engine), 0
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self.control)
            msg = box[0]
            if msg == _STOP:
                return n
            if msg == _NOOP:
                continue
            n += 1
            try:
                ex.run(msg)
            except Exception:  # noqa: BLE001 - the loop serves every later call
                logger.exception("rank %d: call %s failed", self.rank,
                                 getattr(msg, "method", msg))

    # -- rank 0 ----------------------------------------------------------

    def lead(self, engine: LMEngine) -> "ShardedEngine":
        """Rank 0's engine over the whole batch of every rank."""
        self._executor = _Executor(engine)
        self._heartbeat = threading.Thread(target=self._beat, daemon=True)
        self._heartbeat.start()
        return ShardedEngine(self, 0, engine)

    def close(self) -> None:
        """End every follower's loop."""
        if self._closed.is_set():
            return
        with self._lock:
            self._closed.set()
            self._send(_STOP)
        if self._heartbeat is not None:
            self._heartbeat.join(timeout=self.timeout_s)

    def _send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.control)
        self._last_send = time.monotonic()

    def _beat(self) -> None:
        period = self.timeout_s / 4
        while not self._closed.wait(period / 4):
            with self._lock:
                if not self._closed.is_set() and time.monotonic() - self._last_send > period:
                    self._send(_NOOP)

    def sibling(self, base: int, kwargs: dict) -> "ShardedEngine":
        with self._lock:
            new = next(self._ids)
            msg = _Sibling(base, new, kwargs)
            self._send(msg)
            self._executor.run(msg)
        return ShardedEngine(self, new, self._executor.engines[new])

    def call(self, engine: int, method: str, state: Optional[GenState], *args, **kwargs):
        """Send one call to every rank, run it here, and return its whole
        result, with a state view where the call returns a state."""
        if self._closed.is_set():
            raise RuntimeError("the driver is closed: the other ranks have left")
        with self._lock:
            sid = done = None
            if state is not None:
                sid = state.cache.id
                if state.done is not self._done.get(sid):
                    done = state.done.cpu().numpy()
            out = next(self._ids) if method in _RETURNS_STATE else None
            free = [i for i, r in self._refs.items() if r() is None]
            for i in free:
                del self._refs[i]
                self._done.pop(i, None)
            msg = _Call(engine, method, sid, out, _host(args),
                        {k: _host(v) for k, v in kwargs.items()}, done, free)
            self._send(msg)
            result = self._executor.run(msg)
            if out is None:
                return result
            pos, done_all, *rest = result
            ref = _Ref(out)
            self._refs[out] = weakref.ref(ref)
            self._done[out] = done_all
            view = GenState(cache=ref, pos=pos, prev=None, rep_pen=None, rng=None,
                            done=done_all, samp=None)
        return view if not rest else (view, *rest)


class ShardedEngine:
    """LMEngine's interface over the whole batch of a mesh, on rank 0
    (`Driver.lead`). Attributes are the local engine's (`batch_size` is
    the whole batch's); states are views (see the module docstring)."""

    rows_split = False  # results are the whole batch's
    generate = LMEngine.generate
    generate_batch = LMEngine.generate_batch
    prefill = LMEngine.prefill
    prefill_row = LMEngine.prefill_row
    decode_step = LMEngine.decode_step
    warmup = LMEngine.warmup
    _kv_extent_for = LMEngine._kv_extent_for
    _sync = LMEngine._sync

    def __init__(self, driver: Driver, engine_id: int, local: LMEngine) -> None:
        self._driver, self._id, self._local = driver, engine_id, local

    def __getattr__(self, name: str) -> Any:
        return getattr(self._local, name)

    def _call(self, method: str, state, *args, **kwargs):
        return self._driver.call(self._id, method, state, *args, **kwargs)

    def sibling(self, **kwargs) -> "ShardedEngine":
        return self._driver.sibling(self._id, kwargs)

    def init_state(self, seed: Optional[int] = None):
        return self._call("init_state", None, _fresh_seed() if seed is None else int(seed))

    def rewind(self, state, length: int):
        return self._call("rewind", state, length)

    def with_sampling(self, state, sampling):
        return self._call("with_sampling", state, sampling)

    def with_rng(self, state, rng):
        return self._call("with_rng", state, rng)

    def prefill_rows(self, state, prompts, sampling, row0: int, per_row=None, offset: int = 0):
        k = len(prompts)
        if self.dynamic_sampling:  # every rank takes the same fresh seeds
            per_row = [(s, _fresh_seed() if seed is None else int(seed))
                       for s, seed in (per_row or [(sampling, None)] * k)]
        return self._call("prefill_rows", state, [np.asarray(p) for p in prompts], sampling,
                          row0, per_row, offset=offset)

    def _prefill_raw(self, state, prompt, sampling, offset: int = 0, seq_lens=None):
        return self._call("_prefill_raw", state, np.asarray(prompt), sampling, offset=offset,
                          seq_lens=seq_lens)

    def _step(self, state, sampling):
        return self._call("_step", state, sampling)

    def decode_chunk(self, state, sampling, horizon: int, max_steps: Optional[int] = None):
        return self._call("decode_chunk", state, sampling, horizon, max_steps=max_steps)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self._call("logits", None, hidden)
