"""The batched fast frame's persistent kernel (csrc/fast_frame_batched.cu,
one cooperative launch a frame): its plan mirror
(`ops/decode_stack.py::frame_plan`), the engine's sync state and the
scratch kept with it, here on the CPU; on a card only (the `cuda`
marker), the kernel against its plain version and its contract (one
launch a call, grid syncs and exchanges as the kernel counts them, the
plan as built, a row alone among 16, repeat, graph replay, two streams).

The CPU tests need no JAX: the plain version is held to the JAX kernel in
tests/test_torch_fast_frame_batched.py."""

import gc
import inspect

import numpy as np
import pytest
import torch

from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params as torch_init
from fish_speech_tpu_torch.models.dual_ar import rope_tables
from fish_speech_tpu_torch.ops import decode_stack as ds
from fish_speech_tpu_torch.ops import fast_frame_batched as fb
from fish_speech_tpu_torch.ops import sampling as ts
from fish_speech_tpu_torch.ops.quant import quantize_lm_params

torch.set_num_threads(1)

KW = dict(vocab_size=256, n_layer=2, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=128, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=137)
# the fast stack of Fish-1.5 (4 layers, 1024 wide, 8 codebooks of 1024)
# and the card tests' config, with the serving top-k cap
FISH15 = dict(n_layer=4, d=1024, n_head=16, kv=2, f=4096, n_cb=8, vocab=1024, k_dyn=256)
CARD = dict(n_layer=2, d=512, n_head=8, kv=2, f=1024, n_cb=8, vocab=512, k_dyn=256)
SHAPES = {"fish15": FISH15, "card": CARD}


def _plan(shape, int8, grid=132, **kw):
    s = {**SHAPES[shape], **kw}
    return ds.frame_plan(s["n_layer"], s["d"], s["n_head"], s["kv"], s["f"], s["n_cb"],
                         s["vocab"], s["k_dyn"], int8, grid)


def _fish15_cfg():
    return tcfg.DualARConfig(**{**KW, "n_fast_layer": 4, "dim": 1024, "n_head": 16,
                                "head_dim": 64, "intermediate_size": 4096,
                                "codebook_size": 1024, "num_codebooks": 8})


@pytest.mark.parametrize("int8", [False, True])
def test_frame_plan_is_one_object_for_every_batch(int8):
    """The plan is a function of the shapes alone: the wrapper asks for it
    without the batch, and it is one object for 1 to 32 rows, so a row's
    bits cannot depend on its co-tenants."""
    assert list(inspect.signature(fb.frame_plan).parameters) == ["cfg", "k_dyn", "int8", "grid"]
    assert "batch" not in inspect.signature(ds.frame_plan).parameters
    cfg = _fish15_cfg()
    plans = [fb.frame_plan(cfg, 256, int8, 132) for _ in range(1, 33)]
    assert plans[0] is not None and all(p is plans[0] for p in plans)
    assert plans[0] == _plan("fish15", int8)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", ["fish15", "card"])
def test_frame_plan_fits_one_block_an_sm(shape, int8):
    """On the H100's 132 SMs: one block's shared memory within 232,448
    bytes; the draw's shared memory over the rows and the attention's
    scratch costs the ring no stage (the row kernel's plan at the same
    shapes has as many), 120 KB of weights in flight at Fish-1.5 width;
    every unit of every phase runs at once; a row's 8 keys on 2 ranks;
    the grid syncs C (3 L + 2) - 1 and the head exchanges C L of a call."""
    s = SHAPES[shape]
    plan = _plan(shape, int8)
    rows = plan.rows
    assert rows.smem <= 232448
    bare = ds.rows_plan(s["d"], s["n_head"], s["kv"], s["f"], s["vocab"], s["n_cb"], int8, 132)
    assert rows.stages == bare.stages and rows.smem == bare.smem
    if shape == "fish15":
        assert rows.stages * rows.stage_bytes >= 120 * 1024
    assert max(rows.qkv_units, rows.attn_units, rows.sw_units, rows.head_units) <= rows.grid
    assert rows.attn_ranks == 2 and rows.syncs_per_layer == 3
    assert plan.sort_keys == 256 and plan.draw_bytes == ds.draw_smem_bytes(s["vocab"], 256)
    assert plan.hist_bytes == 2 * s["n_layer"] * 32 * s["kv"] * s["n_cb"] * 64 * 2
    assert rows.scratch_bytes >= bare.scratch_bytes + plan.hist_bytes
    assert ds.FramePlan.syncs_per_call(s["n_layer"], s["n_cb"]) == \
        s["n_cb"] * (3 * s["n_layer"] + 2) - 1
    assert ds.FramePlan.head_exchanges(s["n_layer"], s["n_cb"]) == s["n_layer"] * s["n_cb"]
    if shape == "fish15":
        assert ds.FramePlan.syncs_per_call(4, 8) == 111


@pytest.mark.parametrize("k,width", [(1, 32), (16, 32), (33, 64), (256, 256), (257, 512),
                                     (4096, 4096)])
def test_draw_sorts_only_the_top_k(k, width):
    """The draw sorts the k_eff <= k_dyn selected keys, a power of two of
    at least 32, never all V logits: 256 keys at the serving cap."""
    assert ds.draw_sort_width(k) == width
    plan = _plan("fish15", False, vocab=4096, k_dyn=k)
    assert plan is not None and plan.sort_keys == width


def test_frame_plan_domain():
    """The kernel's limits: V <= 4096 and a multiple of 8, 1 <= k_dyn <=
    V, widths the layer pass takes."""
    assert _plan("fish15", False, vocab=4096, k_dyn=4096) is not None
    assert _plan("fish15", False, vocab=4104, k_dyn=256) is None
    assert _plan("fish15", False, vocab=1020, k_dyn=256) is None
    assert _plan("fish15", False, k_dyn=1025) is None
    assert _plan("fish15", False, k_dyn=0) is None
    assert _plan("fish15", False, d=768) is None


def _tiles_once(segments, shapes, stage_rows=32):
    """Counts of every (32-row, 128-column) tile of each matrix over the
    segments (w13 covers w1 and w3)."""
    counts = {m: np.zeros((-(-k // stage_rows), -(-n // 128)), int) for m, (k, n) in shapes.items()}
    for mat, row0, col0, krows, ntiles in segments:
        assert row0 % stage_rows == 0 and krows % stage_rows == 0 and col0 % 128 == 0
        for m in (("w1", "w3") if mat == "w13" else (mat,)):
            counts[m][row0 // stage_rows:(row0 + krows) // stage_rows,
                      col0 // 128:col0 // 128 + ntiles] += 1
    return counts


@pytest.mark.parametrize("depthwise", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", ["fish15", "card"])
def test_frame_units_cover_every_tile_once_a_step(shape, int8, depthwise):
    """Each step, every weight tile of every phase (QKV, wo, w1 + w3, w2)
    and of the step's column block of the head (block cb of C when
    depthwise_output, else the one block) is streamed by exactly one unit
    of one block: over a frame, each stack tile C times and each head
    column block once a step."""
    s = SHAPES[shape]
    rows = _plan(shape, int8).rows
    d, f, v, n_cb = s["d"], s["f"], s["vocab"], s["n_cb"]
    qkv = (s["n_head"] + 2 * s["kv"]) * 64
    head_cols = n_cb * v if depthwise else v
    shapes = {"wqkv": (d, qkv), "wo": (d, d), "w1": (d, f), "w3": (d, f), "w2": (f, d),
              "head": (d, head_cols)}
    segs = []
    for cb in range(n_cb):  # the producer's head_step: V columns a step when depthwise
        for blk in range(rows.grid):
            segs += rows.segments(blk, "layer")
            segs += [(m, r0, c0 + (cb * v if depthwise else 0), kr, nt)
                     for m, r0, c0, kr, nt in rows.segments(blk, "head")]
    for mat, counts in _tiles_once(segs, shapes).items():
        want = 1 if mat == "head" and depthwise else n_cb
        assert (counts == want).all(), (mat, counts)


def _tiny(dtype=torch.float32, **kw):
    tc = tcfg.DualARConfig(**{**KW, **kw})
    return tc, torch_init(tc, seed=0, dtype=dtype, device="cpu")


def _cpu_inputs(tc, b, seed=0):
    g = torch.Generator().manual_seed(seed)
    hidden = torch.randn((b, tc.dim), generator=g)
    window = torch.randint(-1, tc.codebook_size, (b, tc.num_codebooks, 12), generator=g,
                           dtype=torch.int32)
    gumbel = ts.gumbel_noise((b, tc.num_codebooks, tc.codebook_size), g, "cpu")
    samp = ts.RowSampling.broadcast(ts.SamplingArgs(), b)
    return samp, hidden, window, gumbel, torch.zeros((b,), dtype=torch.bool)


def test_cpu_calls_count_no_launch():
    """CPU tensors run the plain version: no launch is counted, and the
    result is the plain version's."""
    tc, params = _tiny()
    args = (tc, *_cpu_inputs(tc, 3), rope_tables(tc, "cpu"))
    before = fb.launches, fb.int8_launches
    got = fb.fused_fast_frame_batched(params, *args, rep_enabled=True)
    assert (fb.launches, fb.int8_launches) == before
    assert torch.equal(got, fb.fused_fast_frame_batched_plain(params, *args, rep_enabled=True))


def test_engine_hands_its_sync_state_to_the_batched_frame(monkeypatch):
    """generate/frame.py hands each engine's own sync state to the batched
    frame, as to the batch-1 frame and the slow step, so two engines on
    two streams never count into the same words (nor share a scratch)."""
    from fish_speech_tpu_torch.generate import engine as engine_mod
    from fish_speech_tpu_torch.generate import frame as frame_mod

    tc, params = _tiny()
    tok = tcfg.TokenConfig(**TOK)
    engines = [engine_mod.LMEngine(params, tc, tok, tcfg.WhichLM.FISH_1_5, dtype=torch.float32,
                                   device="cpu", fast_frame_impl="fused", batch_size=2,
                                   dynamic_sampling=True, cache_len=32, prompt_buckets=(16,))
               for _ in range(2)]
    assert all(e.use_fused_fast for e in engines)
    states = [e.sync_state for e in engines]
    assert states[0] is not states[1]
    seen = []
    real = frame_mod.fused_fast_frame_batched

    def spy(*args, sync=None, **kwargs):
        seen.append(sync)
        return real(*args, sync=sync, **kwargs)

    monkeypatch.setattr(frame_mod, "fused_fast_frame_batched", spy)
    rng = np.random.default_rng(0)
    prompts = [np.concatenate([rng.integers(10, 42, (1, 4)), rng.integers(0, 32, (4, 4))]
                              ).astype(np.int32) for _ in range(2)]
    for e in engines:
        n = len(seen)
        e.generate_batch(prompts, max_new_tokens=2, sampling=ts.SamplingArgs(), seed=0)
        assert len(seen) > n and all(s is e.sync_state for s in seen[n:])


def test_frame_scratch_is_kept_with_its_sync_state(monkeypatch):
    """The kernel's scratch is made once for a sync state and kept with it
    (the same tensor every frame, grown only for larger shapes), is freed
    with the state, and is never first made inside a CUDA graph capture."""
    state = ds.new_sync_state("cpu")
    first = ds.frame_scratch(state, 1000)
    assert ds.frame_scratch(state, 1000) is first and ds.frame_scratch(state, 10) is first
    bigger = ds.frame_scratch(state, 5000)
    assert bigger.numel() == 5000 and ds.frame_scratch(state, 1000) is bigger
    other = ds.new_sync_state("cpu")
    assert ds.frame_scratch(other, 1000) is not bigger
    key = id(state)
    del state, first, bigger
    gc.collect()
    assert key not in ds._frame_scratch
    # a CUDA state met first during a capture: raises before allocating
    class _CudaLooking(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        ds.frame_scratch(ds.new_sync_state("cpu").as_subclass(_CudaLooking), 1000)


def test_supported_needs_a_plan_on_cuda():
    """On CUDA the batched frame is supported only where its plan exists:
    a width the layer pass takes (not 768), an ffn width of whole 128-column
    slices; the CPU's plain version takes any."""
    class _CudaLooking(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda", 0)

    def looking(tree):
        if isinstance(tree, dict):
            return {k: looking(v) for k, v in tree.items()}
        return tree.as_subclass(_CudaLooking)

    ok = dict(n_head=4, dim=256, head_dim=64)
    tc, params = _tiny(torch.bfloat16, **ok)
    assert fb.fused_fast_frame_batched_supported(tc, looking(params), 16)
    assert fb.fused_fast_frame_batched_supported(tc, looking(quantize_lm_params(params)), 16)
    for bad in (dict(n_head=12, dim=768, head_dim=64), dict(ok, intermediate_size=192)):
        tc_b, p_b = _tiny(torch.bfloat16, **bad)
        assert fb.fused_fast_frame_batched_supported(tc_b, p_b, 16)  # the plain version
        assert not fb.fused_fast_frame_batched_supported(tc_b, looking(p_b), 16)


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(device, int8=False, depthwise=False):
    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "codebook_size": 512, "num_codebooks": 8},
                           depthwise_wte=depthwise, depthwise_output=depthwise)
    params = torch_init(tc, seed=0, dtype=torch.bfloat16, device=device)
    return tc, quantize_lm_params(params) if int8 else params


def _card_inputs(tc, b, dev, seed, mixed=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    hidden = torch.randn((b, tc.dim), generator=g, device=dev).to(torch.bfloat16)
    window = torch.randint(-1, tc.codebook_size, (b, tc.num_codebooks, 12), generator=g,
                           device=dev, dtype=torch.int32)
    gumbel = ts.gumbel_noise((b, tc.num_codebooks, 256), g, dev)
    knobs = [[0.7, 0.0, 1.2, 0.5], [0.8, 1.0, 0.6, 0.95], [256, 0, 16, 64], [1.4, 1.0, 1.5, 1.1]]
    vecs = torch.tensor([[k[i % 4 if mixed else 0] for k in knobs] for i in range(b)],
                        dtype=torch.float32, device=dev)
    is_eos = torch.zeros((b,), dtype=torch.bool, device=dev)
    if mixed and b > 2:
        is_eos[2] = True
    return ts.RowSampling.from_vectors(vecs), hidden, window, gumbel, is_eos


def _call(params, tc, inputs, rope, sync=None):
    return fb.fused_fast_frame_batched(params, tc, *inputs, rope, rep_enabled=True,
                                       return_logits=True, sync=sync)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_plan_on_card_equals_mirror(cuda_device, int8):
    """The plan the built kernel computes (fs_fast_frame_batched_plan)
    equals ops/decode_stack.py's mirror, at the card config and at
    Fish-1.5 width, top-k caps 64 to 512."""
    grid = ds.grid_of(cuda_device)
    for shape in ("card", "fish15"):
        for k_dyn in (64, 256, 512):
            s = {**SHAPES[shape], "k_dyn": k_dyn}
            mirror = _plan(shape, int8, grid, k_dyn=k_dyn)
            assert mirror is not None
            assert ds.frame_plan_on_card(s["n_layer"], s["d"], s["n_head"], s["kv"], s["f"],
                                         s["n_cb"], s["vocab"], k_dyn, int8) == mirror


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_one_launch_and_the_plans_syncs(cuda_device, int8):
    """One launch a call, counted by the wrapper and by the kernel in the
    sync state, and the grid syncs and head 0's exchanges the kernel
    counts equal to the plan's."""
    tc, params = _card_model(cuda_device, int8)
    rope = rope_tables(tc, cuda_device)
    state = ds.new_sync_state(cuda_device)
    inputs = _card_inputs(tc, 16, cuda_device, 1)
    before, on_card = fb.launches, ds.frame_launch_count(cuda_device, state)
    for _ in range(3):
        _call(params, tc, inputs, rope, state)
    torch.cuda.synchronize()
    assert fb.launches - before == 3
    assert ds.frame_launch_count(cuda_device, state) - on_card == 3
    syncs, exchanges = ds.last_call_counts(cuda_device, state)
    assert syncs == ds.FramePlan.syncs_per_call(tc.n_fast_layer, tc.num_codebooks)
    assert exchanges == ds.FramePlan.head_exchanges(tc.n_fast_layer, tc.num_codebooks)
    assert not state[:-6].any()  # the counters are left zero


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_row_alone_equals_row_among_sixteen(cuda_device, int8):
    """Each of 16 rows' tokens and step logits are bit-equal through the
    kernel alone and among 15 co-tenants (the plan and every sum's order
    are the shapes')."""
    tc, params = _card_model(cuda_device, int8)
    rope = rope_tables(tc, cuda_device)
    inputs = _card_inputs(tc, 16, cuda_device, 2)
    toks, logits = _call(params, tc, inputs, rope)
    for r in range(16):
        one = tuple(t[r:r + 1].contiguous() for t in inputs[1:])
        samp = ts.RowSampling(*(t[r:r + 1].contiguous() for t in inputs[0]))
        t1, l1 = _call(params, tc, (samp, *one), rope)
        assert torch.equal(t1[0], toks[r]) and torch.equal(l1[:, 0], logits[:, r])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_repeat_and_graph_replay_bit_identical(cuda_device, int8):
    """Five calls give the same bits, and a CUDA graph of the call
    (captured on the stream that made its sync state and scratch) replays
    them."""
    tc, params = _card_model(cuda_device, int8)
    rope = rope_tables(tc, cuda_device)
    inputs = _card_inputs(tc, 16, cuda_device, 3)
    outs = [_call(params, tc, inputs, rope) for _ in range(5)]
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1], outs[0][1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _call(params, tc, inputs, rope)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        toks, logits = _call(params, tc, inputs, rope)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(toks, outs[0][0]) and torch.equal(logits, outs[0][1])


@pytest.mark.cuda
def test_two_streams_each_equal_to_its_run_alone(cuda_device):
    """Two callers, each with its own sync state (and so its own scratch),
    run 16-row frames from two threads on two streams at once: each one's
    tokens and logits are bit-equal to its run alone."""
    import threading

    tc, params = _card_model(cuda_device)
    rope = rope_tables(tc, cuda_device)
    states = [ds.new_sync_state(cuda_device) for _ in range(2)]
    inputs = [_card_inputs(tc, 16, cuda_device, 10 + i) for i in range(2)]

    def run(i):
        out = [_call(params, tc, inputs[i], rope, states[i]) for _ in range(20)]
        torch.cuda.current_stream().synchronize()
        return out

    alone = [run(i) for i in range(2)]
    streams = [torch.cuda.Stream() for _ in range(2)]
    got = [None, None]

    def thread(i):
        with torch.cuda.stream(streams[i]):
            got[i] = run(i)

    threads = [threading.Thread(target=thread, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for g_i, a_i in zip(got, alone):
        for (t1, l1), (t2, l2) in zip(g_i, a_i):
            assert torch.equal(t1, t2) and torch.equal(l1, l2)


@pytest.mark.cuda
def test_depthwise_and_k_dyn_past_256(cuda_device):
    """depthwise_output / depthwise_wte (step cb's head block and
    embedding rows) and a top-k cap of 512 (a 512-key sort): tokens and
    step logits equal to the plain version on inputs that make every sum
    exact (zero fast weights, one-hot hidden and embedding rows)."""
    for depthwise, k_dyn in ((True, 256), (False, 512)):
        tc, params = _card_model(cuda_device, depthwise=depthwise)
        params["fast"] = {k: (v if k.endswith("norm") else torch.zeros_like(v))
                          for k, v in params["fast"].items()}
        emb = torch.zeros_like(params["fast_embeddings"])
        rows = torch.arange(emb.shape[0], device=cuda_device)
        emb[rows, rows % tc.dim] = 1
        params["fast_embeddings"] = emb
        rope = rope_tables(tc, cuda_device)
        g = torch.Generator(device=cuda_device).manual_seed(k_dyn)
        samp, _, window, _, is_eos = _card_inputs(tc, 8, cuda_device, 4)
        hidden = torch.zeros((8, tc.dim), dtype=torch.bfloat16, device=cuda_device)
        hidden[torch.arange(8), torch.randint(0, tc.dim, (8,), generator=g, device=cuda_device)] = 1
        gumbel = ts.gumbel_noise((8, tc.num_codebooks, k_dyn), g, cuda_device)
        args = (tc, samp, hidden, window, gumbel, is_eos, rope)
        got = fb.fused_fast_frame_batched(params, *args, rep_enabled=not depthwise,
                                          return_logits=True)
        ref = fb.fused_fast_frame_batched_plain(params, *args, rep_enabled=not depthwise,
                                                return_logits=True)
        assert torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0])
