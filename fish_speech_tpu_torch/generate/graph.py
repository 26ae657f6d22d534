"""The decode loop on the card: one engine's decode loop as CUDA graphs.

Counterpart of the JAX engine's compiled decode loop (`_get_decode_loop`,
`fish_speech_tpu/generate/engine.py:585-711`): there the whole loop is
one device program; here `LMEngine._decode_body` (the same function the
eager loop runs) is captured into a `torch.cuda.CUDAGraph`, one graph per
(sampling key, horizon, collect_hidden, masked) as JAX keys its jit cache, and a
chunk is one replay instead of ~100-120 launches a frame from Python. The
count of frames that count is an operand, as JAX's max_steps is: a
budget-cut chunk replays its horizon's masked graph, so a caller's
horizons bound its captures, whatever its budgets.

A graph reads and writes static buffers: the decode state's tensors
(cache, pos, prev, the rep-pen tokens, done, the per-row knobs) and the
count of frames that count (a () int64, the JAX loop's max_steps operand),
shared by every graph of the engine; a graph whose frames can lie past
that count (a budget-cut chunk) is one of its own. A replay copies the caller's state
in, replays, and copies it out, so the call consumes the state it gets
(as JAX donates it) and returns one that no later call changes: the cache
goes back into the caller's own tensors (12,288 bytes a position at
Fish-1.5 widths, ~100 MB of traffic a batch-1 call at cache 4096, tens of
microseconds against a chunk of frames), the small tensors come out as new
tensors. A new request's `init_state` therefore causes no capture. The
rep-pen window is rotated so that its write slot is 0 at entry, where the
capture put it: the captured pushes land where the eager loop's would.

Noise: each graph draws from generators of its own, registered with it
(PyTorch's graph-safe generator state): one for a static engine, one a
row for a dynamic one. A replay sets them to the state's generators and
hands the advanced ones back, so a seeded request draws the same numbers
under the graph and eagerly. The eager loop runs a budget-cut chunk's
frames up to max_steps rounded up to the unroll, as JAX's loop does, where
the graph replays its whole horizon: after such a replay the streams are
set back and advanced by the eager loop's frames' draws, so both leave
them alike. A state whose streams replay recorded draws
(`frame.ReplayRowNoise`) is refused here.

Before a capture the body runs once eagerly on the capturing stream, so
that what the kernels keep between calls (the engine's sync state, the
batched frame's scratch, cuBLAS's workspace) exists outside the graph's
pool. A capture or replay that fails raises: there is no fallback to the
eager loop.

Launch counts: a capture records launches without running them, so the
wrappers count none of them and note them instead (`ops/launch_count.py`);
each replay adds what its capture noted. The kernels' own device counters
(`ops/decode_stack.py`) count the replays as they run.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import torch

from fish_speech_tpu_torch.generate.frame import RowNoise
from fish_speech_tpu_torch.ops import launch_count
from fish_speech_tpu_torch.ops.sampling import RepPenWindow, RowSampling


class _Captured(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    outputs: tuple  # (state, out, valid, steps, hidden) in the graph's pool
    launches: launch_count.Notes  # the wrappers' launches a replay stands for


class DecodeGraphs:
    """The captured decode loops of one engine (`LMEngine.graphs`)."""

    def __init__(self, engine) -> None:
        self.engine = engine
        self.graphs: Dict[tuple, _Captured] = {}
        self.captures = 0  # graphs captured
        self.capture_s = 0.0  # seconds spent capturing, warm-up runs included
        self.replays = 0
        self.frames = 0  # frames the replays ran
        self._static = None  # the static state, made at the first call
        self._limit: Optional[torch.Tensor] = None

    def run(self, state, sampling, horizon: int, n: int, run: int, collect_hidden: bool):
        """`LMEngine._decode_body` of `horizon` frames of which the first n
        (0 < n <= horizon, an operand of the replay) count, as a replay of
        the captured loop; captures it first where this key has none. The
        noise streams advance by `run` frames' draws (the eager loop's
        frames). Returns (state, out, valid, steps, hidden)."""
        eng = self.engine
        theirs = self._streams(state.rng)
        if self._static is None:
            self._make_static(state)
        st = self._static
        if state.cache.k.shape != st.cache.k.shape or state.pos.shape != st.pos.shape:
            raise ValueError(f"decode graph: a state of cache {tuple(state.cache.k.shape)} on an "
                             f"engine whose states have {tuple(st.cache.k.shape)}")
        key = (eng._skey(sampling), horizon, collect_hidden, n < horizon)
        captured = self.graphs.get(key)
        if captured is None:
            captured = self._capture(key, sampling, horizon, collect_hidden)

        ptr = state.rep_pen.ptr
        st.pos.copy_(state.pos)
        st.prev.copy_(state.prev)
        st.done.copy_(state.done)
        st.rep_pen.tokens.copy_(state.rep_pen.tokens.roll(-ptr, -1) if ptr
                                else state.rep_pen.tokens)
        if eng.dynamic_sampling:
            for mine, given in zip(st.samp, state.samp):
                mine.copy_(given)
        st.cache.k.copy_(state.cache.k)
        st.cache.v.copy_(state.cache.v)
        self._limit.fill_(n)
        before = [g.get_state() for g in theirs] if run < horizon else None
        pairs = list(zip(self._generators(), theirs))
        for mine, given in pairs:
            mine.set_state(given.get_state())
        captured.graph.replay()
        for mine, given in pairs:
            given.set_state(mine.get_state())
        state.cache.k.copy_(st.cache.k)
        state.cache.v.copy_(st.cache.v)
        self.replays += 1
        self.frames += horizon
        launch_count.replayed(captured.launches)

        o, out, valid, steps, hid = captured.outputs
        tokens = o.rep_pen.tokens.roll(ptr, -1) if ptr else o.rep_pen.tokens.clone()
        new = state._replace(pos=o.pos.clone(), prev=o.prev.clone(),
                             rep_pen=RepPenWindow(tokens=tokens, ptr=ptr),
                             done=o.done.clone())
        if before is not None:  # the streams where the eager loop's frames leave them
            for g, s in zip(theirs, before):
                g.set_state(s)
            for _ in range(run):
                eng._noise(new, sampling, range(eng.batch_size))
        return (new, out.clone(), valid.clone(), steps.clone(),
                None if hid is None else hid.clone())

    def _streams(self, rng) -> List[torch.Generator]:
        """The state's noise generators, one a stream, in the order of the
        graphs' own (`_generators`)."""
        eng = self.engine
        if isinstance(rng, torch.Generator) and not eng.dynamic_sampling:
            return [rng]
        if isinstance(rng, RowNoise) and eng.dynamic_sampling:
            if len(rng.generators) != eng.local_batch:
                raise ValueError(f"decode graph: {len(rng.generators)} noise streams for "
                                 f"{eng.local_batch} rows")
            return rng.generators
        raise ValueError(f"decode graph: the state's noise ({type(rng).__name__}) is not the "
                         "engine's own generator(s); recorded draws replay on an engine built "
                         "with decode_impl='eager'")

    def _make_static(self, state) -> None:
        """The static state every graph of the engine reads and writes, and
        the graphs' own noise streams."""
        eng = self.engine
        dev = eng.device
        if eng.dynamic_sampling:
            rng = RowNoise(eng.local_batch, 0, dev)
        else:
            rng = torch.Generator(device=dev)
        self._static = state._replace(
            cache=type(state.cache)(k=torch.zeros_like(state.cache.k),
                                    v=torch.zeros_like(state.cache.v)),
            pos=torch.zeros_like(state.pos), prev=torch.zeros_like(state.prev),
            rep_pen=RepPenWindow(tokens=torch.full_like(state.rep_pen.tokens, -1), ptr=0),
            rng=rng, done=torch.zeros_like(state.done),
            samp=RowSampling(*(torch.zeros_like(t) for t in state.samp)))
        self._limit = torch.zeros((), dtype=torch.int64, device=dev)

    def _generators(self) -> List[torch.Generator]:
        rng = self._static.rng
        return rng.generators if isinstance(rng, RowNoise) else [rng]

    def _capture(self, key, sampling, horizon: int, collect_hidden: bool) -> _Captured:
        eng = self.engine
        t0 = time.perf_counter()
        st, limit = self._static, self._limit
        graph, outputs, recorded = self._record(
            lambda: eng._decode_body(st, sampling, horizon, limit, collect_hidden, key[3]))
        captured = _Captured(graph, outputs, recorded)
        self.graphs[key] = captured
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return captured

    def _record(self, body):
        """Run `body` once on a side stream, then capture it there: (the
        graph, its outputs, the wrappers' launches a replay stands for)."""
        dev = self.engine.device
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        with torch.cuda.stream(side):  # the warm-up, on the capturing stream
            body()
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators():
            graph.register_generator_state(gen)
        # thread_local: the batcher's delivery thread may wait on an event
        # while its scheduler thread captures
        with launch_count.recording() as notes, \
                torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            outputs = body()
        return graph, outputs, notes
