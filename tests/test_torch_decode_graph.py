"""The captured decode loop's host side (fish_speech_tpu_torch/generate/
graph.py and LMEngine's decode loop), on the CPU, port only:

* `decode_impl` choices: "graph" raises on the CPU and on a sharded
  engine, "auto" takes graphs on CUDA for an unsharded engine only;
* generate(profile=False) reads the device once a chunk plus once for the
  first frame, none between the prefill and the first chunk, through
  `device.Fetch` only (Tensor reads counted);
* the frames a call runs are one function of (horizon, max_steps,
  decode_unroll) under the graph and eagerly, and a graph is keyed by the
  horizon, not by the budget: budgets with different remainders share
  one capture;
* `DecodeGraphs` with its capture emulated on the CPU (the body run
  again into the captured outputs at each replay): the static buffers,
  the rep-pen rotation and the noise hand-off give the eager loop's codes
  bit for bit, static and dynamic, across admissions and rewinds, with
  one capture per key.

The `cuda` case captures and replays on the card and skips here."""

import math

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch.config import DualARConfig, TokenConfig, WhichLM
from fish_speech_tpu_torch.device import Fetch
from fish_speech_tpu_torch.generate import graph as tgraph
from fish_speech_tpu_torch.generate.engine import LMEngine
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params
from fish_speech_tpu_torch.ops.sampling import BATCHED_REP_PEN_WINDOW, SamplingArgs

torch.set_num_threads(1)

CFG = DualARConfig(vocab_size=256, n_layer=2, n_fast_layer=2, n_head=4, dim=64,
                   intermediate_size=128, n_local_heads=2, head_dim=16, rope_base=10000.0,
                   norm_eps=1e-6, max_seq_len=256, codebook_size=32, num_codebooks=4)
TOK = TokenConfig(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=41)
SAMPLED = SamplingArgs(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.3)
ARGMAX = SamplingArgs(temp=0.0, repetition_penalty=1.3)


@pytest.fixture(scope="module")
def params():
    """Weights whose im_end column is zeroed (argmax generations run
    their budget) and a copy with it amplified (sampled rows stop
    early)."""
    p = init_dual_ar_params(CFG, seed=0, dtype=torch.float32, device="cpu")
    run = dict(p, output=p["output"].clone())
    run["output"][:, TOK.im_end_id] = 0
    stop = dict(p, output=p["output"].clone())
    stop["output"][:, TOK.im_end_id] *= 40
    return {"run": run, "stop": stop}


def _engine(params, **kw):
    kw = {**dict(cache_len=256, max_frames=200, prompt_buckets=(16,), dtype=torch.float32,
                 device="cpu"), **kw}
    return LMEngine(params, CFG, TOK, WhichLM.FISH_1_5, **kw)


def _prompt(seed, n=8):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(TOK.semantic_start_id, TOK.semantic_end_id,
                                        size=(1, n)),
                           np.zeros((CFG.num_codebooks, n), np.int64)]).astype(np.int32)


class _Coords:
    """A (dp, tp) mesh's coordinates without processes."""

    def __init__(self, dp, tp):
        self.shape = (dp, tp)

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return 0

    def get_group(self, name):
        return None


@pytest.mark.parametrize("case", ["graph_cpu", "graph_sharded", "unknown_cpu", "auto_cpu",
                                  "eager_cpu", "auto_sharded"])
def test_decode_impl_choice(params, case):
    """"graph" raises on the CPU and under a mesh of more than one rank
    (gloo's collectives are not captured); "auto" and "eager" run the
    eager loop there; an unknown name raises."""
    impl, where = case.split("_")
    mesh = _Coords(2, 1) if where == "sharded" else None
    if impl in ("graph", "unknown"):
        with pytest.raises(ValueError, match="decode_impl"):
            _engine(params["run"], decode_impl="pallas" if impl == "unknown" else impl,
                    mesh=mesh)
        return
    eng = _engine(params["run"], decode_impl=impl, mesh=mesh)
    assert eng.graphs is None and eng.decode_impl == impl
    assert eng.sibling(batch_size=2).decode_impl == impl


class _Reads:
    """Every device read during a call: `Fetch.get` calls, and Tensor
    reads (item, bool, int, float, tolist, cpu, numpy) made outside one;
    in order with the engine's prefills and decode chunks."""

    def __init__(self, monkeypatch, engine):
        self.log = []
        self.inside = False
        get = Fetch.get

        def fetch_get(fetch):
            self.log.append("read")
            self.inside = True
            try:
                return get(fetch)
            finally:
                self.inside = False
        monkeypatch.setattr(Fetch, "get", fetch_get)
        for name in ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy"):
            monkeypatch.setattr(torch.Tensor, name, self._direct(getattr(torch.Tensor, name)))
        for name, tag in (("_prefill_raw", "prefill"), ("_decode", "chunk")):
            monkeypatch.setattr(engine, name, self._logged(getattr(engine, name), tag))

    def _direct(self, fn):
        def read(t, *a, **k):
            if not self.inside:
                self.log.append("direct")
            return fn(t, *a, **k)
        return read

    def _logged(self, fn, tag):
        def call(*a, **k):
            out = fn(*a, **k)
            self.log.append(tag)
            return out
        return call


@pytest.mark.parametrize("weights,max_new", [("run", 1), ("run", 40), ("run", 150),
                                             ("stop", 150)])
def test_generate_reads_once_a_chunk(params, monkeypatch, weights, max_new):
    """generate(profile=False): no read between the prefill and the first
    chunk, at most one read a chunk plus one for the first frame, all
    through Fetch; a row that stops ends the issuing one chunk later."""
    eng = _engine(params[weights])
    sampling = SAMPLED if weights == "stop" else ARGMAX
    ref, _ = eng.generate(_prompt(1), max_new_tokens=max_new, sampling=sampling, seed=3)
    reads = _Reads(monkeypatch, eng)
    res, _ = eng.generate(_prompt(1), max_new_tokens=max_new, sampling=sampling, seed=3)
    monkeypatch.undo()
    np.testing.assert_array_equal(res.tokens, ref.tokens)
    log = reads.log
    plan = eng.chunk_plan(max_new - 1)
    assert "direct" not in log
    assert log[0] == "prefill" and log.count("prefill") == 1
    chunks = log.count("chunk")
    if plan:
        assert log[1] == "chunk"  # issued before any read
    assert log.count("read") <= chunks + 1 <= len(plan) + 1
    if weights == "stop":
        assert not res.hit_max and res.frames < max_new
        # issuing ends one chunk after the chunk that showed the row done
        assert chunks <= math.ceil(res.frames / eng.generate_chunk) + 1 < len(plan)
    else:
        assert res.frames == max_new and chunks == len(plan)


def test_generate_profile_reads_after_the_prefill(params, monkeypatch):
    """profile=True: the first frame is read before the first chunk is
    issued (the true phase split)."""
    eng = _engine(params["run"])
    reads = _Reads(monkeypatch, eng)
    eng.generate(_prompt(1), max_new_tokens=10, sampling=SAMPLED, seed=3, profile=True)
    monkeypatch.undo()
    assert reads.log[:3] == ["prefill", "read", "chunk"]


@pytest.mark.parametrize("unroll,horizon,max_steps", [
    (1, 8, None), (1, 8, 5), (2, 8, 5), (4, 8, 5), (4, 8, 0), (4, 12, 9), (2, 4, 7)])
def test_frames_a_call_runs(params, monkeypatch, unroll, horizon, max_steps):
    """min(max_steps, horizon) rounded up to the unroll, as the JAX loop
    runs: eagerly (counted frames); under the graph a replay of the whole
    horizon, after which the noise stream stands where the eager loop's
    frames leave it; the outputs alike."""
    _emulated(monkeypatch)
    want = -(-(horizon if max_steps is None else min(max_steps, horizon)) // unroll) * unroll
    runs = []
    for mode in ("eager", "graph"):
        eng = _engine(params["run"], decode_unroll=unroll)
        frames = []
        step = eng._step
        eng._step = lambda *a: frames.append(1) or step(*a)
        if mode == "graph":
            _with_graphs(eng)
        state, _, _ = eng.prefill(eng.init_state(1), _prompt(2), SAMPLED)
        state, out, valid, steps = eng.decode_chunk(state, SAMPLED, horizon, max_steps=max_steps)
        assert out.shape[0] == valid.shape[0] == horizon
        if mode == "eager":
            assert len(frames) == want
        else:
            assert eng.graphs.frames == (horizon if want else 0)
        runs.append((out, valid, steps, state.rng.get_state()))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


class _EagerGraph:
    """A CUDA graph's contract, emulated on the CPU: the outputs of the
    capture stay the graph's, and a replay runs the body again on the
    static buffers and writes its results into them."""

    def __init__(self, body):
        self.body = body

    @staticmethod
    def tensors(outputs):
        state, out, valid, steps, hid = outputs
        return [state.pos, state.prev, state.rep_pen.tokens, state.done, out, valid, steps] + (
            [] if hid is None else [hid])

    def replay(self):
        for dst, src in zip(self.tensors(self.outputs), self.tensors(self.body())):
            dst.copy_(src)


def _emulated(monkeypatch):
    def record(self, body):
        graph = _EagerGraph(body)
        body()  # the warm-up
        graph.outputs = body()
        return graph, graph.outputs, {}
    monkeypatch.setattr(tgraph.DecodeGraphs, "_record", record)


def _with_graphs(engine):
    engine.graphs = tgraph.DecodeGraphs(engine)
    return engine


@pytest.mark.parametrize("unroll", [1, 2])
def test_emulated_replay_is_the_eager_loop_static(params, monkeypatch, unroll):
    """A static engine (sampled, rep-pen on: the window's ptr moves) under
    the emulated graph: generate over several chunks, a rewind to a
    conditioning prefix and a continuation on the same stream, and
    generate_batch at 3 rows, as the eager engine on the same seeds; one
    capture per key across requests."""
    _emulated(monkeypatch)
    codes = []
    for graphs in (False, True):
        eng = _engine(params["run"], decode_unroll=unroll)
        eng.generate_chunk = 8 * unroll  # several chunks
        if graphs:
            _with_graphs(eng)
        runs = []
        for seed in (3, 4):
            res, state = eng.generate(_prompt(seed), max_new_tokens=30, sampling=SAMPLED,
                                      seed=seed)
            state = eng.rewind(state, 8)
            res2, _ = eng.generate(_prompt(seed + 1, 5), max_new_tokens=21, sampling=SAMPLED,
                                   state=state, conditioning_offset=8)
            runs += [res.tokens, res.semantic, res2.tokens, res2.semantic]
        batch = eng.sibling(batch_size=3)
        if graphs:
            _with_graphs(batch)
        runs += [r.tokens for r in batch.generate_batch([_prompt(s, 6 + s) for s in range(3)],
                                                        max_new_tokens=12, sampling=SAMPLED,
                                                        seed=5)]
        codes.append(runs)
        if graphs:
            # budgets of 29 and 20 frames: full chunks and a budget-cut last
            # chunk of another remainder each, all of one horizon: two graphs
            assert sorted(k[1:] for k in eng.graphs.graphs) == [
                (8 * unroll, False, False), (8 * unroll, False, True)]
            assert eng.graphs.captures == 2 and eng.graphs.replays > eng.graphs.captures
    for a, b in zip(*codes):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("unroll", [1, 2])
def test_budgets_share_one_capture(params, monkeypatch, unroll):
    """decode_chunk at one horizon and max_steps of several remainders (the
    overlap driver's and the streaming route's last chunks), on one
    carried noise stream: one masked graph and one full one, each chunk
    and the stream after them as the eager loop's."""
    _emulated(monkeypatch)
    runs = []
    for graphs in (False, True):
        eng = _engine(params["run"], decode_unroll=unroll)
        if graphs:
            _with_graphs(eng)
        got = []
        state = eng.init_state(0)
        for seed, max_steps in enumerate((3, 8, 5, None, 7, 1)):
            state, _, _ = eng.prefill(eng.rewind(state, 0), _prompt(seed), SAMPLED)
            state, *outs = eng.decode_chunk(state, SAMPLED, 8, max_steps=max_steps)
            got += outs
        got.append(state.rng.get_state())  # the stream after the last chunk
        runs.append(got)
        if graphs:
            assert eng.graphs.captures == 2 and eng.graphs.replays == 6
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_emulated_replay_is_the_eager_loop_dynamic(params, monkeypatch):
    """A 4-row dynamic engine (per-row streams, the batched rep-pen window)
    under the emulated graph: seeded admissions between chunks of 3 and
    16 frames (the batcher's horizons, the window's ptr off 0 at entry),
    each row's codes as the eager engine's; captures one per horizon."""
    _emulated(monkeypatch)
    outs = []
    for graphs in (False, True):
        eng = _engine(params["stop"], batch_size=4, rep_pen_window=BATCHED_REP_PEN_WINDOW,
                      dynamic_sampling=True)
        if graphs:
            _with_graphs(eng)
        state = eng.init_state(0)
        state = state._replace(done=torch.ones_like(state.done))
        got = []
        for tick, (row, seed) in enumerate([(0, 10), (2, 11), (1, 12), (3, 13), (0, 14)]):
            state, first, _ = eng.prefill_row(state, _prompt(seed), SAMPLED, row, seed=seed)
            for horizon in (3, 16):
                state, out, valid, steps = eng.decode_chunk(state, SAMPLED, horizon)
                got += [first, out, valid, steps]
        got += [state.pos, state.prev, state.rep_pen.tokens, torch.tensor(state.rep_pen.ptr)]
        outs.append(got)
        if graphs:
            assert eng.graphs.captures == 2 and eng.graphs.replays == 10
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_graph_refuses_replayed_draws(params, monkeypatch):
    """Recorded draws (ReplayRowNoise) replay on the eager loop only."""
    from fish_speech_tpu_torch.generate.frame import ReplayRowNoise

    _emulated(monkeypatch)
    eng = _with_graphs(_engine(params["run"], batch_size=2, dynamic_sampling=True,
                               rep_pen_window=BATCHED_REP_PEN_WINDOW))
    state = eng.init_state(0)._replace(rng=ReplayRowNoise([[], []], "cpu"))
    with pytest.raises(ValueError, match="decode_impl='eager'"):
        eng.decode_chunk(state, SAMPLED, 4)


@pytest.mark.cuda
def test_cuda_graph_replay_matches_eager():
    """On the card: a bf16 engine at head_dim 64 with decode_impl="graph"
    and one with "eager" give the same codes on one seed (batch 1 over
    several chunks and a rewind; 16 dynamic rows over horizons 3 and 16),
    one capture per key, and a new request's init_state captures
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = DualARConfig(vocab_size=1010, n_layer=2, n_fast_layer=1, n_head=8, dim=512,
                       intermediate_size=1024, n_local_heads=2, head_dim=64,
                       rope_base=10000.0, norm_eps=1e-6, max_seq_len=512,
                       codebook_size=1000, num_codebooks=2)
    tok = TokenConfig(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=1009)
    p = init_dual_ar_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    p["output"][:, tok.im_end_id] = 0

    def prompt(seed, n=8):
        rng = np.random.default_rng(seed)
        return np.concatenate([rng.integers(10, 1010, (1, n)),
                               rng.integers(0, 1000, (2, n))]).astype(np.int32)

    codes = []
    for impl in ("eager", "graph"):
        eng = LMEngine(p, cfg, tok, WhichLM.FISH_1_5, cache_len=512, max_frames=100,
                       prompt_buckets=(16,), decode_impl=impl)
        got = []
        for seed in (1, 2):
            res, state = eng.generate(prompt(seed), max_new_tokens=90, sampling=SAMPLED,
                                      seed=seed)
            state = eng.rewind(state, 8)
            res2, _ = eng.generate(prompt(seed + 5), max_new_tokens=20, sampling=SAMPLED,
                                   state=state, conditioning_offset=8)
            got += [res.tokens, res2.tokens]
        rows = eng.sibling(batch_size=16, rep_pen_window=BATCHED_REP_PEN_WINDOW,
                           dynamic_sampling=True)
        state = rows.init_state(0)
        for r in range(16):
            state, _, _ = rows.prefill_row(state, prompt(r), SAMPLED, r, seed=100 + r)
        for horizon in (3, 16, 3, 16):
            state, out, valid, steps = rows.decode_chunk(state, SAMPLED, horizon)
            got.append(out.cpu().numpy())
        codes.append(got)
        if impl == "graph":
            assert eng.graphs.captures == len(eng.graphs.graphs)
            assert rows.graphs.captures == 2 and rows.graphs.replays == 4
            n = eng.graphs.captures
            eng.generate(prompt(9), max_new_tokens=90, sampling=SAMPLED,
                         state=eng.init_state(9))
            assert eng.graphs.captures == n
    for a, b in zip(*codes):
        np.testing.assert_array_equal(a, b)
