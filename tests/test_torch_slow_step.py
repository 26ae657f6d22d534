"""The port's fused slow step (ops/slow_step.py) against the JAX
package's TPU kernel `fish_speech_tpu/ops/slow_step_pallas.py::
fused_slow_step`, run in interpret mode as tests/test_slow_step.py runs
it, at that file's tiny config in float32, with bf16 and with int8
stacks (the kernel's quantized body, as tests/test_slow_step.py:251 runs
it); the bf16 int8 plain version against the JAX unfused int8 step; its
dispatch rules; and, on a card only, the CUDA kernel sequence against
its plain version.

Tolerances (float32 on the CPU): logits and hidden 1e-4 absolute (the
same arithmetic over three layers, summed in another order), the caches
1e-5; cache rows other than pos must be exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.frame import semantic_head_columns
from fish_speech_tpu.models.dual_ar import KVCache as JaxKVCache
from fish_speech_tpu.models.dual_ar import embed_tokens as jax_embed_tokens
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.models.dual_ar import slow_decode_step as jax_slow_decode_step
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops.slow_step_pallas import fused_slow_step as jax_fused_slow_step
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params as torch_init
from fish_speech_tpu_torch.models.dual_ar import rope_tables
from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops import quant as tq
from fish_speech_tpu_torch.ops import slow_step as ss
from fish_speech_tpu_torch.ops.sampling import SamplingArgs

torch.set_num_threads(1)

KW = dict(vocab_size=256, n_layer=3, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=32, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=41)
CACHE = 32
LOGITS_TOL = 1e-4
CACHE_TOL = 1e-5
ROWS5 = (0, 3, 17, 29, 31)
ROWS16 = tuple((7 * i + 4) % CACHE for i in range(16))  # 16 distinct positions


def _t(a):
    return torch.from_numpy(np.array(a))


def _gathered(params, jc, lm):
    jp = dict(params)
    cols = semantic_head_columns(lm, jcfg.TokenConfig(**TOK), jc)
    jp["output"] = jnp.take(params["output"], jnp.asarray(cols), axis=1)
    return jp


@pytest.fixture(scope="module")
def models():
    """JAX parameters with the head gathered per LM, dense ("FISH_1_5",
    "FISH_1_2") and int8-quantized by the JAX package ("FISH_1_5_int8",
    "FISH_1_2_int8"), and the port's copy of each."""
    jc = jcfg.DualARConfig(**KW)
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    out = {}
    for lm in (jcfg.WhichLM.FISH_1_5, jcfg.WhichLM.FISH_1_2):
        jp = _gathered(params, jc, lm)
        out[lm.name] = (jp, dual_ar_params_from_numpy(jax.tree.map(np.asarray, jp)))
        jq_p = jq.quantize_lm_params(jp)
        out[f"{lm.name}_int8"] = (jq_p, dual_ar_params_from_numpy(jax.tree.map(np.asarray, jq_p)))
    return jc, tcfg.DualARConfig(**KW), out


@pytest.mark.parametrize("positions,lm", [
    ((0,), "FISH_1_5"),
    ((5,), "FISH_1_5"),
    ((31,), "FISH_1_5"),
    ((3, 29), "FISH_1_5"),   # two rows, each at its own position
    ((0,), "FISH_1_2"),      # Fish <= 1.4: the two-way [pad, im_end] head
    ((0,), "FISH_1_5_int8"),
    ((5,), "FISH_1_5_int8"),
    ((31,), "FISH_1_5_int8"),
    ((3, 29), "FISH_1_5_int8"),
    ((7,), "FISH_1_2_int8"),
    # the batched domain, where CUDA runs the row sequence: 5 and 16 rows,
    # each at its own position
    (ROWS5, "FISH_1_5"),
    (ROWS16, "FISH_1_5"),
    (ROWS5, "FISH_1_5_int8"),
    (ROWS16, "FISH_1_5_int8"),
])
def test_plain_matches_pallas_interpret(models, positions, lm):
    jc, tc, by_lm = models
    jp, tp = by_lm[lm]
    assert tq.is_quantized(tp["slow"]["wqkv"]) == lm.endswith("int8")
    b = len(positions)
    rng = np.random.default_rng(sum(positions) + b)
    x0 = rng.normal(size=(b, jc.dim)).astype(np.float32)
    shape = (jc.n_layer, b, jc.n_local_heads, CACHE, jc.head_dim)
    ck, cv = ((rng.normal(size=shape) * 0.1).astype(np.float32) for _ in range(2))
    pos = np.asarray(positions, np.int32)

    j_logits, j_hidden, j_ck, j_cv = jax_fused_slow_step(
        jp, jc, jnp.asarray(x0), jnp.asarray(pos), jnp.asarray(ck), jnp.asarray(cv),
        interpret=True)
    tck, tcv = _t(ck), _t(cv)
    logits, hidden = ss.fused_slow_step(tp, tc, _t(x0), _t(pos), tck, tcv,
                                        rope_tables(tc, "cpu"))

    assert logits.dtype == torch.float32 and logits.shape == (b, tp["output"].shape[1])
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(j_hidden), atol=LOGITS_TOL, rtol=0)
    np.testing.assert_allclose(tck.numpy(), np.asarray(j_ck), atol=CACHE_TOL, rtol=0)
    np.testing.assert_allclose(tcv.numpy(), np.asarray(j_cv), atol=CACHE_TOL, rtol=0)
    for row, p in enumerate(positions):  # only row pos of each batch row is written
        keep = np.arange(CACHE) != p
        np.testing.assert_array_equal(tck.numpy()[:, row, :, keep], ck[:, row, :, keep])
        np.testing.assert_array_equal(tcv.numpy()[:, row, :, keep], cv[:, row, :, keep])


def _tiny_params(dtype=torch.float32):
    tc = tcfg.DualARConfig(**KW)
    return tc, torch_init(tc, seed=0, dtype=dtype, device="cpu")


def _bf16_t(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_int8_plain_matches_jax_unfused(seed):
    """bf16 weights quantized by the JAX package: the plain int8 step
    against the JAX unfused int8 step (`slow_decode_step`, x @ q rounded
    to bf16, rescaled and rounded again, silu of that). Hidden and the
    caches are bit-equal; the logits differ only by the unfused path's
    bf16 rounding of the head product, so by at most half a bf16 ulp."""
    jc, tc = jcfg.DualARConfig(**KW), tcfg.DualARConfig(**KW)
    jp = jq.quantize_lm_params(_gathered(jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.bfloat16), jc, jcfg.WhichLM.FISH_1_5))
    tp = dual_ar_params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(seed)
    tokens = np.concatenate([rng.integers(10, 42, (2, 1)), rng.integers(0, 32, (2, 4))],
                            axis=1).astype(np.int32)
    shape = (jc.n_layer, 2, jc.n_local_heads, CACHE, jc.head_dim)
    cache = JaxKVCache(*(jnp.asarray(rng.normal(size=shape) * 0.5, jnp.bfloat16)
                         for _ in range(2)))
    pos = np.array([3, 17], np.int32)
    j_logits, j_hidden, j_cache = jax_slow_decode_step(jp, jc, jcfg.TokenConfig(**TOK),
                                                       jnp.asarray(tokens), cache, jnp.asarray(pos))
    x0 = jax_embed_tokens(jp, jc, jcfg.TokenConfig(**TOK), jnp.asarray(tokens)[:, :, None])
    tck, tcv = _bf16_t(cache.k), _bf16_t(cache.v)
    logits, hidden = ss.fused_slow_step(tp, tc, _bf16_t(x0[:, 0, :]), _t(pos), tck, tcv,
                                        rope_tables(tc, "cpu"))
    assert torch.equal(hidden, _bf16_t(j_hidden))
    assert torch.equal(tck, _bf16_t(j_cache.k)) and torch.equal(tcv, _bf16_t(j_cache.v))
    ref = np.asarray(j_logits)
    half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 8)
    assert (np.abs(logits.numpy() - ref) <= half_ulp + 1e-7).all()


@pytest.mark.parametrize("batch", [1, 4, 16])
def test_supported_on_cpu_takes_any_batch(batch):
    tc, params = _tiny_params()
    assert ss.fused_slow_step_supported(tc, params, batch, cache_len=64)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the CUDA branch
    of the wrapper without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(stack):
    return {k: v.as_subclass(_CudaLooking) for k, v in stack.items()}


@pytest.mark.parametrize("limit", ["int8", "batch5", "ffn_not_64", "dim_not_in_plan"])
def test_supported_on_cuda_takes_int8_with_bf16_scales(limit):
    """On CUDA the kernels take int8 q with bf16 s and whole 16-byte
    rows; a float q, float32 scales or a width that is not a multiple of
    16 are refused, by `supported` and by the wrapper. The persistent
    kernel's limits: an ffn width that is a multiple of 64 and a model
    width its plan takes (`decode_stack.DIMS`). Five rows go to the row
    sequence, within the JAX kernel's bounds: 5 x 32 is taken, 5 x 4096
    (B * S > 16384) refused, on the card and by the plain version."""
    card = {**KW, "n_head": 4, "dim": 256, "head_dim": 64}
    if limit == "batch5":
        tc = tcfg.DualARConfig(**card)
        params = tq.quantize_lm_params(torch_init(tc, seed=0, dtype=torch.bfloat16, device="cpu"))
        on_card = {"slow": _cuda_looking_tree(params["slow"])}
        assert ss.fused_slow_step_supported(tc, on_card, 5, CACHE)
        assert not ss.fused_slow_step_supported(tc, on_card, 5, 4096)
        assert not ss.fused_slow_step_supported(tc, params, 5, 4096)
        return
    if limit != "int8":
        case = {"ffn_not_64": {"intermediate_size": 96},
                "dim_not_in_plan": {"n_head": 6, "dim": 384}}[limit]
        tc = tcfg.DualARConfig(**{**card, **case})
        params = tq.quantize_lm_params(torch_init(tc, seed=0, dtype=torch.bfloat16, device="cpu"))
        assert ss.fused_slow_step_supported(tc, {"slow": _cuda_looking_tree(params["slow"])},
                                            1, CACHE) is False
        assert ss.fused_slow_step_supported(tc, params, 1, CACHE)  # the plain version
        return
    tc = tcfg.DualARConfig(**card)
    params = tq.quantize_lm_params(torch_init(tc, seed=0, dtype=torch.bfloat16, device="cpu"))
    stack = params["slow"]
    assert ss.fused_slow_step_supported(tc, {"slow": _cuda_looking_tree(stack)}, 1, CACHE)
    float_q = dict(stack, w2={"q": stack["w2"]["q"].float(), "s": stack["w2"]["s"]})
    f32_s = dict(stack, wo={"q": stack["wo"]["q"], "s": stack["wo"]["s"].float()})
    for bad in (float_q, f32_s):
        assert not ss.fused_slow_step_supported(tc, {"slow": _cuda_looking_tree(bad)}, 1, CACHE)
        with pytest.raises(TypeError, match="int8 q with bfloat16 s"):
            ss.check_stack(bad, "fused_slow_step", "slow", torch.device("cpu"))
    narrow_cfg = tcfg.DualARConfig(**{**card, "intermediate_size": 200})
    narrow = tq.quantize_lm_params(torch_init(narrow_cfg, seed=0, dtype=torch.bfloat16,
                                              device="cpu"))["slow"]
    assert not ss.fused_slow_step_supported(narrow_cfg, {"slow": _cuda_looking_tree(narrow)}, 1,
                                            CACHE)
    with pytest.raises(ValueError, match="multiple of 16"):
        ss.check_stack(narrow, "fused_slow_step", "slow", torch.device("cpu"))


# (batch, cache, KV heads): the JAX bounds at the Fish-1.5 head layout
# (KV 2: B * S <= 16384 binds) and with 8 KV heads (the 48 MiB window
# binds first); 16 x 1024 is exactly 16384 and taken, as in JAX
DOMAIN = [(1, 4096, 2), (4, 4096, 2), (4, 4097, 2), (5, 3276, 2), (5, 3277, 2),
          (16, 512, 2), (16, 1024, 2), (16, 1025, 2), (16, 2048, 2), (32, 512, 2),
          (64, 256, 2), (64, 257, 2), (16, 1024, 8), (12, 1024, 8)]


@pytest.mark.parametrize("batch,cache,kv", DOMAIN)
def test_supported_on_cuda_is_the_jax_domain(batch, cache, kv):
    """On CUDA `supported` takes exactly what the JAX kernel's
    `fused_slow_step_supported` takes at these shapes (head dim 64, a width
    the kernels take): the persistent kernel below 5 rows, the row
    sequence from 5 rows up to 64 x 256."""
    from fish_speech_tpu.ops.slow_step_pallas import (
        fused_slow_step_supported as jax_supported)

    shape = {**KW, "n_head": 8, "dim": 512, "head_dim": 64, "n_local_heads": kv,
             "max_seq_len": 8192}
    tc = tcfg.DualARConfig(**shape)
    params = torch_init(tc, seed=0, dtype=torch.bfloat16, device="cpu")
    on_card = {"slow": _cuda_looking_tree(params["slow"])}
    want = jax_supported(jcfg.DualARConfig(**shape), None, batch, cache)
    assert ss.fused_slow_step_supported(tc, on_card, batch, cache) == want
    assert ss.fused_slow_step_supported(tc, params, batch, cache) == want  # the plain version


@pytest.mark.parametrize("n_layer,batch,launches", [(24, 5, 1), (24, 16, 1), (24, 32, 1),
                                                    (24, 33, 2), (24, 64, 2), (3, 16, 1)])
def test_rows_launches_per_step(n_layer, batch, launches):
    """The row kernel's launches a step: one for each group of at most 32
    rows, whatever the depth (the card tests hold the C entry's own count
    and the kernel's to this)."""
    assert ss.rows_launches_per_step(n_layer, batch) == launches


FISH15 = dict(dim=1024, n_head=16, n_local_heads=2, intermediate_size=4096)  # its slow stack


def _fish15_rows_plan(int8, cache, head=1025, grid=132):
    from fish_speech_tpu_torch.ops import decode_stack as ds

    return ds.rows_plan(FISH15["dim"], FISH15["n_head"], FISH15["n_local_heads"],
                        FISH15["intermediate_size"], head, cache, int8, grid)


@pytest.mark.parametrize("int8", [False, True])
def test_rows_plan_is_one_object_for_every_batch(int8):
    """The row kernel's plan is a function of the shapes alone: the same
    object for 5 to 32 rows (so a row's bits cannot depend on its
    co-tenants), one launch a group of 32 rows."""
    import inspect

    tc = tcfg.DualARConfig(**{**KW, **FISH15, "head_dim": 64})
    # the plan takes no batch: the wrapper asks for it with the shapes alone
    assert list(inspect.signature(ss.rows_plan).parameters) == [
        "cfg", "head_cols", "cache_len", "int8", "grid"]
    plans = [ss.rows_plan(tc, 1025, 512, int8, 132) for _ in range(5, 65)]
    assert all(p is plans[0] for p in plans) and plans[0] is not None
    assert [ss.rows_launches_per_step(tc.n_layer, b) for b in range(5, 65)] == [1] * 28 + [2] * 32


@pytest.mark.parametrize("cache", [512, 2048])
@pytest.mark.parametrize("int8", [False, True])
def test_rows_plan_fits_one_block_an_sm(int8, cache):
    """At Fish-1.5 width on the H100's 132 SMs: the shared memory fits
    one block (232,448 bytes), the ring keeps 120 KB of weights in flight
    (15 stages bf16, 31 int8), every unit runs at once (no phase needs a
    second pass of the grid), and a row's keys go to 2 ranks up to 1024
    keys, to all 8 warps past that."""
    from fish_speech_tpu_torch.ops import decode_stack as ds

    plan = _fish15_rows_plan(int8, cache)
    assert plan.smem <= 232448 and plan.stages * plan.stage_bytes >= 120 * 1024
    assert max(plan.qkv_units, plan.attn_units, plan.sw_units, plan.head_units) <= plan.grid
    assert plan.attn_ranks == (2 if cache <= 1024 else 8)
    assert plan.syncs_per_launch(24) == 73 and plan.head_exchanges(24) == 24
    assert ds.rows_plan(1024, 16, 2, 4096, 1025, 4097, int8, 132) is None  # past 4096 keys


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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", ["fish15", "card"])
def test_rows_units_cover_every_tile_once(shape, int8):
    """Every weight tile of every phase (QKV, wo, w1 + w3, w2 and the
    head) is streamed by exactly one unit of one block, from the plan's
    segments; each unit's w2 K-rows are its w1 + w3 slice's 128 g
    columns."""
    from fish_speech_tpu_torch.ops import decode_stack as ds

    d, h, kv, f, w = ((1024, 16, 2, 4096, 1025) if shape == "fish15"
                      else (512, 8, 2, 1024, 33))
    plan = ds.rows_plan(d, h, kv, f, w, 512, int8, 132)
    qkv = (h + 2 * kv) * 64
    shapes = {"wqkv": (d, qkv), "wo": (d, d), "w1": (d, f), "w3": (d, f), "w2": (f, d),
              "head": (d, -(-w // 128) * 128)}
    segs = [sg for blk in range(plan.grid) for kind in ("layer", "head")
            for sg in plan.segments(blk, kind)]
    for mat, counts in _tiles_once(segs, shapes).items():
        assert (counts == 1).all(), (mat, counts)
    w13 = [sg for sg in segs if sg[0] == "w13"]
    w2 = [sg for sg in segs if sg[0] == "w2"]
    assert [sg[1] for sg in w2] == [sg[2] for sg in w13]  # the slice's rows of w2
    assert all(sg[3] == 128 for sg in w2)


@pytest.mark.parametrize("width,stride", [(1025, 1032), (2, 8), (33, 40), (1024, 1024)])
def test_padded_head_stride(width, stride):
    """The row sequence's head copy: the gathered columns, then zeros up
    to whole 16-byte pieces (1025 at Fish-1.5, 2 at Fish <= 1.4); a head
    whose width is whole pieces is used as it is."""
    head = torch.randn(16, width).to(torch.bfloat16)
    padded = ss.padded_head(head)
    assert ss.head_stride(width) == stride and tuple(padded.shape) == (16, stride)
    assert torch.equal(padded[:, :width], head) and not padded[:, width:].any()
    assert (padded is head) == (width == stride)


def test_engines_hold_their_own_sync_state(monkeypatch):
    """Each engine makes its own grid sync state and hands it to the
    fused slow step (and the batch-1 fast frame), so two engines on two
    streams never count into the same words."""
    from fish_speech_tpu_torch.generate import engine as engine_mod

    tc, params = _tiny_params()
    tok = tcfg.TokenConfig(**TOK)
    engines = [engine_mod.LMEngine(params, tc, tok, tcfg.WhichLM.FISH_1_5, dtype=torch.float32,
                                   device="cpu", slow_impl="fused", fast_frame_impl="fused",
                                   cache_len=CACHE, prompt_buckets=(16,)) for _ in range(2)]
    states = [e.sync_state for e in engines]
    assert states[0] is not states[1] and states[0].data_ptr() != states[1].data_ptr()
    seen = []
    real = engine_mod.fused_slow_step

    def spy(*args, sync=None, **kwargs):
        seen.append(sync)
        return real(*args, sync=sync, **kwargs)

    monkeypatch.setattr(engine_mod, "fused_slow_step", spy)
    prompt = np.zeros((tc.num_codebooks + 1, 4), np.int32)
    argmax = SamplingArgs(temp=0.0)
    for e in engines:
        state, _, _ = e.prefill(e.init_state(0), prompt, argmax)
        e.decode_step(state, argmax)
    assert len(seen) == 2 and all(a is b for a, b in zip(seen, states))


def _cuda_looking_tree(tree):
    if isinstance(tree, dict):
        return {k: _cuda_looking_tree(v) for k, v in tree.items()}
    return tree.as_subclass(_CudaLooking)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_supported_on_cuda_is_bf16_only(dtype):
    """On CUDA the kernel takes bf16 stacks only, so `auto` must not pick
    it for others (before, float32 stacks were "supported" and failed at
    the first frame)."""
    tc = tcfg.DualARConfig(**{**KW, "n_head": 4, "dim": 256, "head_dim": 64})
    params = torch_init(tc, seed=0, dtype=dtype, device="cpu")
    assert ss.fused_slow_step_supported(tc, {"slow": _cuda_looking(params["slow"])}, 1,
                                        CACHE) == (dtype == torch.bfloat16)


def test_cuda_tensor_never_runs_plain(monkeypatch):
    """A CUDA input launches the kernel or raises: here the parameters
    lie on the CPU, so the wrapper raises before any launch."""
    def fail(*args, **kwargs):
        raise AssertionError("a CUDA tensor must not fall back to the plain version")

    monkeypatch.setattr(ss, "fused_slow_step_plain", fail)
    monkeypatch.setattr(_cuda_build, "load_library", fail)
    tc, params = _tiny_params(torch.bfloat16)
    x0 = torch.zeros(1, tc.dim, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    ck = torch.zeros(tc.n_layer, 1, tc.n_local_heads, CACHE, tc.head_dim, dtype=torch.bfloat16)
    before = ss.launches
    with pytest.raises((ValueError, TypeError)):
        ss.fused_slow_step(params, tc, x0, torch.zeros(1, dtype=torch.int32), ck, ck.clone(),
                           rope_tables(tc, "cpu"))
    assert ss.launches == before


def test_cpu_tensors_count_no_launch(models):
    _, tc, by_lm = models
    _, tp = by_lm["FISH_1_5"]
    ck = torch.zeros(tc.n_layer, 1, tc.n_local_heads, CACHE, tc.head_dim)
    before = ss.launches
    ss.fused_slow_step(tp, tc, torch.zeros(1, tc.dim), torch.zeros(1, dtype=torch.int32), ck,
                       ck.clone(), rope_tables(tc, "cpu"))
    assert ss.launches == before


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def float32_reference(tree):
    """The parameters in float32, int8 stacks dequantized: the float32
    evaluation the kernels are held to."""
    if tq.is_quantized(tree):
        return tq.dequantize_weight(tree)
    if isinstance(tree, dict):
        return {k: float32_reference(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("positions", [(0,), (1,), (104,), (255,), (7, 200)])
def test_kernel_matches_plain_on_card(cuda_device, positions, int8):
    """bf16 at head dim 64, and int8 stacks. The kernel sums in another
    order than cuBLAS and bf16 rounding flips cascade through the
    layers, so logits, hidden and the new cache rows must be as close to
    the float32 evaluation of the same function (the plain version on
    float32 weights, dequantized under int8) as the plain version is,
    within a factor of 2; every other cache row is bit-equal."""
    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "max_seq_len": 256})
    params = torch_init(tc, seed=0, dtype=torch.bfloat16, device=cuda_device)
    params["output"] = params["output"][:, :33].contiguous()
    if int8:
        params = tq.quantize_lm_params(params)
    params32 = float32_reference(params)
    g = torch.Generator(device=cuda_device).manual_seed(len(positions))
    b = len(positions)
    x0 = torch.randn((b, tc.dim), generator=g, device=cuda_device).to(torch.bfloat16)
    shape = (tc.n_layer, b, tc.n_local_heads, 256, 64)
    ck, cv = (torch.randn(shape, generator=g, device=cuda_device).to(torch.bfloat16)
              for _ in range(2))
    ckp, cvp, ck32, cv32 = ck.clone(), cv.clone(), ck.float(), cv.float()
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    rope = rope_tables(tc, cuda_device)
    got = ss.fused_slow_step(params, tc, x0, pos, ck, cv, rope)
    plain = ss.fused_slow_step_plain(params, tc, x0, pos, ckp, cvp, rope)
    ref = ss.fused_slow_step_plain(params32, tc, x0.float(), pos, ck32, cv32, rope)
    rows, p = torch.arange(b, device=cuda_device), pos.long()
    pairs = list(zip(got, plain, ref)) + [
        (c[:, rows, :, p], cp[:, rows, :, p], c32[:, rows, :, p])
        for c, cp, c32 in ((ck, ckp, ck32), (cv, cvp, cv32))]
    for k, pl, r in pairs:
        err_k = float((k.float() - r.float()).abs().max())
        err_p = float((pl.float() - r.float()).abs().max())
        assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)
    for c, cp in ((ck, ckp), (cv, cvp)):
        c[:, rows, :, p] = cp[:, rows, :, p]
        assert torch.equal(c, cp)


def _card_inputs(dev, positions, int8=False, seed=0, cache=256):
    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "max_seq_len": cache})
    params = torch_init(tc, seed=0, dtype=torch.bfloat16, device=dev)
    params["output"] = params["output"][:, :33].contiguous()
    if int8:
        params = tq.quantize_lm_params(params)
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(positions)
    x0 = torch.randn((b, tc.dim), generator=g, device=dev).to(torch.bfloat16)
    shape = (tc.n_layer, b, tc.n_local_heads, cache, 64)
    ck, cv = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return tc, params, x0, pos, ck, cv, rope_tables(tc, dev)


def _step(params, tc, x0, pos, ck, cv, rope):
    """One kernel call on copies of the caches: (logits, hidden, ck, cv)."""
    k, v = ck.clone(), cv.clone()
    logits, hidden = ss.fused_slow_step(params, tc, x0, pos, k, v, rope)
    return logits, hidden, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_plan_on_card_equals_mirror(cuda_device, int8):
    from fish_speech_tpu_torch.ops import decode_stack as ds

    tc, params, *_ = _card_inputs(cuda_device, (0,), int8)
    grid = ds.grid_of(cuda_device)
    for cache in (256, 4096):
        mirror = ss.slow_plan(tc, 33, cache, int8, grid)
        card = ds.plan_on_card(ds.SLOW, tc.dim, tc.n_head, tc.n_local_heads,
                               tc.intermediate_size, 33, cache, int8)
        assert card == mirror


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_repeated_calls_bit_identical_and_one_launch(cuda_device, int8):
    """Five calls on the same inputs give the same bits (a racy sync or
    an arrival-ordered sum would not); each call is one launch."""
    tc, params, x0, pos, ck, cv, rope = _card_inputs(cuda_device, (104, 7), int8)
    before = ss.launches
    outs = [_step(params, tc, x0, pos, ck, cv, rope) for _ in range(5)]
    torch.cuda.synchronize()
    assert ss.launches - before == 5
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda_device):
    tc, params, x0, pos, ck, cv, rope = _card_inputs(cuda_device, (104,))
    eager = _step(params, tc, x0, pos, ck, cv, rope)
    k, v = ck.clone(), cv.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.fused_slow_step(params, tc, x0, pos, k.clone(), v.clone(), rope)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the warm-up's stream and state
        logits, hidden = ss.fused_slow_step(params, tc, x0, pos, k, v, rope)
    for _ in range(3):
        k.copy_(ck)
        v.copy_(cv)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((logits, hidden, k, v), eager))


@pytest.mark.cuda
def test_completes_beside_a_kernel_on_another_stream(cuda_device):
    """The cooperative launch waits for room beside a long kernel on a
    second stream instead of deadlocking its grid syncs."""
    tc, params, x0, pos, ck, cv, rope = _card_inputs(cuda_device, (104,))
    eager = _step(params, tc, x0, pos, ck, cv, rope)
    torch.cuda.synchronize()
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of one spinning block
    got = _step(params, tc, x0, pos, ck, cv, rope)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_row_alone_equals_row_among_four(cuda_device, int8):
    """The plan does not depend on the batch, so a row's logits, hidden
    and cache rows are bit-equal alone and among three co-tenants."""
    positions = (104, 3, 255, 40)
    tc, params, x0, pos, ck, cv, rope = _card_inputs(cuda_device, positions, int8)
    logits, hidden, k, v = _step(params, tc, x0, pos, ck, cv, rope)
    for r in range(len(positions)):
        one = _step(params, tc, x0[r:r + 1].clone(), pos[r:r + 1].clone(),
                    ck[:, r:r + 1].contiguous(), cv[:, r:r + 1].contiguous(), rope)
        assert torch.equal(one[0][0], logits[r]) and torch.equal(one[1][0], hidden[r])
        assert torch.equal(one[2][:, 0], k[:, r]) and torch.equal(one[3][:, 0], v[:, r])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("positions", [(255,), (256,), (1000,), (2047,), (5, 2047)])
def test_key_split_matches_plain_on_card(cuda_device, positions, int8):
    """Past decode_stack.SPLIT_TILES key tiles a head's attention is split
    over its blocks, which exchange (max, sum) pairs and PV partials: the
    same accuracy rule as below the threshold, every other cache row
    bit-equal, and a row alone bit-equal to itself beside a short row."""
    tc, params, x0, pos, ck, cv, rope = _card_inputs(cuda_device, positions, int8, cache=2048)
    params32 = float32_reference(params)
    got = _step(params, tc, x0, pos, ck, cv, rope)
    ckp, cvp = ck.clone(), cv.clone()
    plain = ss.fused_slow_step_plain(params, tc, x0, pos, ckp, cvp, rope)
    ck32, cv32 = ck.float(), cv.float()
    ref = ss.fused_slow_step_plain(params32, tc, x0.float(), pos, ck32, cv32, rope)
    rows, p = torch.arange(len(positions), device=cuda_device), pos.long()
    pairs = list(zip(got[:2], plain, ref)) + [
        (c[:, rows, :, p], cp[:, rows, :, p], c32[:, rows, :, p])
        for c, cp, c32 in ((got[2], ckp, ck32), (got[3], cvp, cv32))]
    for k, pl, r in pairs:
        err_k = float((k.float() - r.float()).abs().max())
        err_p = float((pl.float() - r.float()).abs().max())
        assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)
    for c, cp in ((got[2], ckp), (got[3], cvp)):
        c = c.clone()
        c[:, rows, :, p] = cp[:, rows, :, p]
        assert torch.equal(c, cp)
    r = len(positions) - 1
    one = _step(params, tc, x0[r:r + 1].clone(), pos[r:r + 1].clone(),
                ck[:, r:r + 1].contiguous(), cv[:, r:r + 1].contiguous(), rope)
    assert torch.equal(one[0][0], got[0][r]) and torch.equal(one[1][0], got[1][r])


@pytest.mark.cuda
@pytest.mark.parametrize("positions", [(104,), (1024,), (104, 2047, 3)])
def test_kernel_counts_its_syncs_and_exchanges(cuda_device, positions):
    """The kernel's own count of its grid syncs and of head 0's key-split
    exchanges (the sync state's last two words) equals the plan's, and
    five calls stay bit-identical when attention is split."""
    from fish_speech_tpu_torch.ops import decode_stack as ds

    tc, params, x0, pos, ck, cv, rope = _card_inputs(cuda_device, positions, cache=2048)
    outs = [_step(params, tc, x0, pos, ck, cv, rope) for _ in range(5)]
    plan = ss.slow_plan(tc, 33, 2048, False, ds.grid_of(cuda_device))
    assert ds.last_call_counts(cuda_device) == (
        plan.syncs_per_call(ds.SLOW, tc.n_layer), plan.kv_exchanges(tc.n_layer, positions))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))


# -- the row kernel (5 rows and more), on the card --------------------------------


def _rows_inputs(dev, batch, cache, int8=False, seed=0, head_cols=33, positions=None):
    """The card config above with `batch` rows at distinct positions
    spread over the cache (the last at its end), or at `positions`, and a
    head of head_cols columns."""
    if positions is None:
        positions = [(37 * i + 5) % cache for i in range(batch - 1)] + [cache - 1]
    tc, params, x0, pos, ck, cv, rope = _card_inputs(dev, positions, int8, seed, cache)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    params["output"] = (torch.randn((tc.dim, head_cols), generator=g, device=dev) * 0.05
                        ).to(torch.bfloat16)
    return tc, params, x0, pos, ck, cv, rope


def _held_to_plain(params, tc, x0, pos, ck, cv, rope, got):
    """`got` (logits, hidden, ck, cv) as close to the float32 evaluation
    as the plain version, within 2x; other cache rows bit-equal."""
    ckp, cvp = ck.clone(), cv.clone()
    plain = ss.fused_slow_step_plain(params, tc, x0, pos, ckp, cvp, rope)
    ck32, cv32 = ck.float(), cv.float()
    ref = ss.fused_slow_step_plain(float32_reference(params), tc, x0.float(), pos, ck32, cv32,
                                   rope)
    rows, p = torch.arange(x0.shape[0], device=x0.device), pos.long()
    pairs = list(zip(got[:2], plain, ref)) + [
        (c[:, rows, :, p], cp[:, rows, :, p], c32[:, rows, :, p])
        for c, cp, c32 in ((got[2], ckp, ck32), (got[3], cvp, cv32))]
    for k, pl, r in pairs:
        err_k = float((k.float() - r.float()).abs().max())
        err_p = float((pl.float() - r.float()).abs().max())
        assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)
    for c, cp in ((got[2], ckp), (got[3], cvp)):
        c = c.clone()
        c[:, rows, :, p] = cp[:, rows, :, p]
        assert torch.equal(c, cp)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("batch,cache,positions", [
    (5, 256, None), (16, 512, None), (32, 256, None), (64, 256, None), (5, 3276, None),
    # keys past 1024, where a row's keys go to all 8 warps; the case that
    # caught the first packed attention's swapped key and value
    (8, 2048, (1024, 1025, 1500, 1777, 2000, 2046, 2047, 1031))])
def test_rows_match_plain_on_card(cuda_device, batch, cache, positions, int8):
    """The row kernel at 5, 16 and 32 rows, at 64 rows (two launches of
    32) of cache 256, at 5 rows of the longest cache the JAX bounds give
    them and at 8 rows of cache 2048 past 1024 keys: the plain version's
    accuracy rule, every other cache row bit-equal; one launch a group of
    32 rows, as the C entry and the kernel count them; the kernel's own
    count of its grid syncs and head 0's exchanges equals the plan's."""
    from fish_speech_tpu_torch.ops import decode_stack as ds

    tc, params, x0, pos, ck, cv, rope = _rows_inputs(cuda_device, batch, cache, int8,
                                                     positions=positions)
    before, before8 = ss.rows_launches, ss.rows_int8_launches
    on_card = ds.rows_launch_count(cuda_device)
    got = _step(params, tc, x0, pos, ck, cv, rope)
    torch.cuda.synchronize()
    want = ss.rows_launches_per_step(tc.n_layer, batch)
    assert ss.rows_launches - before == want
    assert ss.rows_int8_launches - before8 == (want if int8 else 0)
    assert ds.rows_launch_count(cuda_device) - on_card == want
    plan = ss.rows_plan(tc, 33, cache, int8, ds.grid_of(cuda_device))
    assert ds.last_call_counts(cuda_device) == (plan.syncs_per_launch(tc.n_layer),
                                                plan.head_exchanges(tc.n_layer))
    assert got[0].shape == (batch, 33) and bool(torch.isfinite(got[0]).all())
    _held_to_plain(params, tc, x0, pos, ck, cv, rope, got)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_rows_plan_on_card_equals_mirror(cuda_device, int8):
    """The plan the built kernel computes (fs_slow_step_rows_plan) equals
    ops/decode_stack.py's mirror, at the card config and at Fish-1.5
    width, caches 256 to 3276."""
    from fish_speech_tpu_torch.ops import decode_stack as ds

    grid = ds.grid_of(cuda_device)
    for d, h, kv, f, w in ((512, 8, 2, 1024, 33), (1024, 16, 2, 4096, 1025)):
        for cache in (256, 512, 2048, 3276):
            mirror = ds.rows_plan(d, h, kv, f, w, cache, int8, grid)
            assert mirror is not None
            assert ds.rows_plan_on_card(d, h, kv, f, w, cache, int8) == mirror


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_rows_row_alone_equals_row_among_sixteen(cuda_device, int8):
    """The plan is a function of the shapes alone, so each row's logits,
    hidden and cache rows are bit-equal through the row kernel alone
    (`rows_step`, one row) and among 15 co-tenants."""
    tc, params, x0, pos, ck, cv, rope = _rows_inputs(cuda_device, 16, 512, int8)
    logits, hidden, k, v = _step(params, tc, x0, pos, ck, cv, rope)
    for r in range(16):
        k1, v1 = ck[:, r:r + 1].contiguous(), cv[:, r:r + 1].contiguous()
        l1, h1 = ss.rows_step(params, tc, x0[r:r + 1].clone(), pos[r:r + 1].clone(), k1, v1, rope)
        assert torch.equal(l1[0], logits[r]) and torch.equal(h1[0], hidden[r])
        assert torch.equal(k1[:, 0], k[:, r]) and torch.equal(v1[:, 0], v[:, r])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_rows_repeat_and_graph_replay_bit_identical(cuda_device, int8):
    """Five calls give the same bits, and a CUDA graph of the launch
    replays them (the padded head made before the capture, as the engine
    makes it once; the sync state left zeroed by every launch)."""
    tc, params, x0, pos, ck, cv, rope = _rows_inputs(cuda_device, 16, 512, int8)
    head_rows = ss.padded_head(params["output"])

    def call(k, v):
        return ss.fused_slow_step(params, tc, x0, pos, k, v, rope, head_rows=head_rows)

    outs = []
    for _ in range(5):
        k, v = ck.clone(), cv.clone()
        outs.append((*call(k, v), k, v))
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o, outs[0]))
    k, v = ck.clone(), cv.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(k.clone(), v.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        logits, hidden = call(k, v)
    for _ in range(3):
        k.copy_(ck)
        v.copy_(cv)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip((logits, hidden, k, v), outs[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1025, 2])
def test_rows_head_widths(cuda_device, width):
    """The gathered heads of Fish-1.5 (1025 columns) and Fish <= 1.4 (2):
    logits of exactly (B, W), held to the plain version's accuracy."""
    tc, params, x0, pos, ck, cv, rope = _rows_inputs(cuda_device, 16, 512, head_cols=width)
    assert ss.head_stride(width) > width  # a ragged last tile
    got = _step(params, tc, x0, pos, ck, cv, rope)
    assert tuple(got[0].shape) == (16, width) and got[0].dtype == torch.float32
    _held_to_plain(params, tc, x0, pos, ck, cv, rope, got)


@pytest.mark.cuda
def test_two_engines_on_two_streams(cuda_device):
    """Two batch-1 engines (the persistent slow step and fast frame),
    each with its own grid sync state, decode from two threads on two
    streams at once: each engine's codes, and the logits of its slow
    steps, are bit-equal to its run alone on one stream."""
    import threading

    from fish_speech_tpu_torch.generate.engine import LMEngine

    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "max_seq_len": 256})
    params = torch_init(tc, seed=0, dtype=torch.bfloat16, device=cuda_device)
    tok = tcfg.TokenConfig(**TOK)
    engines = [LMEngine(params, tc, tok, tcfg.WhichLM.FISH_1_5, cache_len=256,
                        prompt_buckets=(16,), max_frames=48) for _ in range(2)]
    assert all(e.use_fused_slow and e.use_fused_fast for e in engines)
    assert engines[0].sync_state.data_ptr() != engines[1].sync_state.data_ptr()
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.3)
    rng = np.random.default_rng(0)
    prompts = [np.concatenate([rng.integers(10, 42, (1, 12)), rng.integers(0, 32, (4, 12))]
                              ).astype(np.int32) for _ in range(2)]
    e0 = engines[0]
    x0 = e0.params["embeddings"][torch.arange(3, 4, device=cuda_device)].contiguous()
    posb = torch.tensor([77], dtype=torch.int32, device=cuda_device)
    shape = (tc.n_layer, 1, tc.n_local_heads, 256, 64)

    def run(i):
        e = engines[i]
        res, _ = e.generate(prompts[i], max_new_tokens=40, sampling=sampling, seed=i)
        logits = []
        for _ in range(20):
            k = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
            logits.append(ss.fused_slow_step(e.params, tc, x0, posb, k, k.clone(), e.rope,
                                             sync=e.sync_state)[0])
        torch.cuda.current_stream().synchronize()
        return np.concatenate([res.semantic[None], res.tokens]), torch.stack(logits)

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
    for (codes, logits), (codes_a, logits_a) in zip(got, alone):
        np.testing.assert_array_equal(codes, codes_a)
        assert torch.equal(logits, logits_a)



@pytest.mark.cuda
def test_two_sixteen_row_engines_on_two_streams(cuda_device):
    """Two 16-row engines (the row kernel and the batched fast frame),
    each with its own grid sync state, decode from two threads on two
    streams at once: each engine's codes, and the logits of its 16-row
    slow steps, are bit-equal to its run alone on one stream."""
    import threading

    from fish_speech_tpu_torch.generate.engine import LMEngine

    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "max_seq_len": 256})
    params = torch_init(tc, seed=0, dtype=torch.bfloat16, device=cuda_device)
    tok = tcfg.TokenConfig(**TOK)
    engines = [LMEngine(params, tc, tok, tcfg.WhichLM.FISH_1_5, cache_len=256,
                        prompt_buckets=(16,), max_frames=24, batch_size=16,
                        dynamic_sampling=True) for _ in range(2)]
    assert all(e.use_fused_slow and e.use_fused_fast for e in engines)
    assert engines[0].sync_state.data_ptr() != engines[1].sync_state.data_ptr()
    sampling = SamplingArgs(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.3)
    rng = np.random.default_rng(0)
    prompts = [[np.concatenate([rng.integers(10, 42, (1, n)), rng.integers(0, 32, (4, n))]
                               ).astype(np.int32) for n in rng.integers(3, 13, 16)]
               for _ in range(2)]
    x0 = engines[0].params["embeddings"][torch.arange(3, 19, device=cuda_device)].contiguous()
    posb = torch.arange(40, 200, 10, dtype=torch.int32, device=cuda_device)
    shape = (tc.n_layer, 16, tc.n_local_heads, 256, 64)

    def run(i):
        e = engines[i]
        res = e.generate_batch(prompts[i], max_new_tokens=20, sampling=sampling, seed=i)
        logits = []
        for _ in range(10):
            k = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
            logits.append(ss.fused_slow_step(e.params, tc, x0, posb, k, k.clone(), e.rope,
                                             head_rows=e.rows_head, sync=e.sync_state)[0])
        torch.cuda.current_stream().synchronize()
        return [np.concatenate([r.semantic[None], r.tokens]) for r in res], torch.stack(logits)

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
    for (codes, logits), (codes_a, logits_a) in zip(got, alone):
        for c, ca in zip(codes, codes_a):
            np.testing.assert_array_equal(c, ca)
        assert torch.equal(logits, logits_a)
