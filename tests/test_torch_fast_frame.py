"""The port's fused fast frame (ops/fast_frame.py) against the JAX
package's TPU kernel `fish_speech_tpu/ops/fast_frame_pallas.py::
fused_fast_frame`, run in interpret mode as tests/test_fast_frame.py
runs it, at that file's tiny config in float32 and fed the JAX
package's own Gumbel draws, with bf16 and with int8 stacks (the kernel's
quantized body, as tests/test_fast_frame.py:262 runs it); the bf16 int8
plain version's step logits against the JAX unfused int8 steps; the
fused branch of `generate_frame` against the JAX frame; its dispatch
rules; and, on a card only, the CUDA kernel sequence against its plain
version.

Every comparison on the CPU asserts sampled tokens exactly equal. On
the card the kernel sums in another order than cuBLAS, which reorders
near-equal probabilities and so pairs tokens with other Gumbel draws;
tokens are held equal on inputs that make every sum exact, and the step
logits at real weights to the plain version's accuracy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.frame import generate_frame as j_generate_frame
from fish_speech_tpu.generate.frame import semantic_head_columns
from fish_speech_tpu.models.dual_ar import fast_embed as jax_fast_embed
from fish_speech_tpu.models.dual_ar import fast_hist_init as jax_fast_hist_init
from fish_speech_tpu.models.dual_ar import fast_step as jax_fast_step
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops import sampling as js
from fish_speech_tpu.ops.fast_frame_pallas import fused_fast_frame as jax_fused_fast_frame
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.frame import FrameNoise
from fish_speech_tpu_torch.generate.frame import generate_frame as t_generate_frame
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params as torch_init
from fish_speech_tpu_torch.models.dual_ar import rope_tables
from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops import fast_frame as ff
from fish_speech_tpu_torch.ops import quant as tq
from fish_speech_tpu_torch.ops import sampling as ts

torch.set_num_threads(1)

KW = dict(vocab_size=256, n_layer=2, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=32, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=41)
SAMPLED = dict(temp=0.7, top_p=0.8, top_k=16, repetition_penalty=1.3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(depthwise: bool, int8: bool = False, dtype=jnp.float32):
    jc = jcfg.DualARConfig(**KW, depthwise_wte=depthwise, depthwise_output=depthwise)
    params = dict(jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, dtype))
    cols = semantic_head_columns(jcfg.WhichLM.FISH_1_5, jcfg.TokenConfig(**TOK), jc)
    params["output"] = jnp.take(params["output"], jnp.asarray(cols), axis=1)
    if int8:
        params = jq.quantize_lm_params(params)
    tc = tcfg.DualARConfig(**KW, depthwise_wte=depthwise, depthwise_output=depthwise)
    return jc, tc, params, dual_ar_params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def models():
    """Keyed by depthwise, and by (depthwise, "int8") for the stacks
    quantized by the JAX package."""
    out = {dw: _models(dw) for dw in (False, True)}
    out.update({(dw, "int8"): _models(dw, int8=True) for dw in (False, True)})
    return out


CASES = {
    "seed0": (0, SAMPLED, False, False),
    "seed1": (1, SAMPLED, False, False),
    "seed2": (2, SAMPLED, False, False),
    "argmax": (3, dict(temp=0.0, top_p=1.0, top_k=32, repetition_penalty=1.3), False, False),
    "no_rep_pen": (4, dict(temp=0.9, top_p=1.0, top_k=8, repetition_penalty=1.0), False, False),
    "is_eos": (5, SAMPLED, True, False),
    "depthwise": (7, SAMPLED, False, True),
    "int8_seed8": (8, SAMPLED, False, False),
    "int8_seed9": (9, SAMPLED, False, False),
    "int8_argmax": (3, dict(temp=0.0, top_p=1.0, top_k=32, repetition_penalty=1.3), False, False),
    "int8_is_eos": (5, SAMPLED, True, False),
    "int8_depthwise": (7, SAMPLED, False, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(models, case):
    seed, samp, eos, depthwise = CASES[case]
    jc, tc, jp, tp = models[(depthwise, "int8") if case.startswith("int8") else depthwise]
    assert tq.is_quantized(tp["fast"]["w1"]) == case.startswith("int8")
    j_sampling, t_sampling = js.SamplingArgs(**samp), ts.SamplingArgs(**samp)
    rep_enabled = not depthwise and samp["repetition_penalty"] != 1.0
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(1, jc.dim)).astype(np.float32)
    window = rng.integers(-1, jc.codebook_size, size=(jc.num_codebooks, 16)).astype(np.int32)
    k_eff = min(samp["top_k"], jc.codebook_size)
    gumbel = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (jc.num_codebooks, k_eff),
                                          dtype=jnp.float32))
    is_eos = np.array([eos])

    ref = jax_fused_fast_frame(jp, jc, j_sampling, jnp.asarray(hidden), jnp.asarray(window),
                               jnp.asarray(gumbel), jnp.asarray(is_eos),
                               rep_enabled=rep_enabled, interpret=True)
    got = ff.fused_fast_frame(tp, tc, t_sampling, _t(hidden), _t(window),
                              None if t_sampling.is_argmax else _t(gumbel), _t(is_eos),
                              rope_tables(tc, "cpu"), rep_enabled=rep_enabled)
    assert got.dtype == torch.int32 and got.shape == (jc.num_codebooks,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if eos:
        assert not got.any()


@pytest.mark.parametrize("depthwise", [False, True])
def test_fused_generate_frame_matches_jax_frame(models, depthwise):
    """generate_frame with use_fused_fast=True (the port) against the
    JAX package's unfused frame, on the JAX frame's own draws (same rng
    splits and shapes as fish_speech_tpu/generate/frame.py)."""
    jc, tc, jp, tp = models[depthwise]
    rng = np.random.default_rng(8)
    w = 1 + jc.codebook_size
    logits = (rng.normal(size=(1, w)) * 2).astype(np.float32)
    hidden = rng.normal(size=(1, jc.dim)).astype(np.float32)
    prev = np.concatenate([rng.integers(10, 42, (1, 1)), rng.integers(0, 32, (1, 4))],
                          axis=1).astype(np.int32)
    window = rng.integers(0, 32, size=(1, 4, 16)).astype(np.int32)
    j_sampling, t_sampling = js.SamplingArgs(**SAMPLED), ts.SamplingArgs(**SAMPLED)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(j_generate_frame, static_argnums=(1, 2, 3, 4))(
        jp, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5, j_sampling,
        jnp.asarray(logits), jnp.asarray(hidden),
        js.RepPenWindow(jnp.asarray(window), jnp.int32(5)), jnp.asarray(prev), key)

    rest, sem_key = jax.random.split(key)
    cb_keys = jax.random.split(rest, jc.num_codebooks)
    k = SAMPLED["top_k"]
    noise = FrameNoise(
        semantic=_t(jax.random.gumbel(sem_key, (1, k), dtype=jnp.float32)),
        codebooks=[_t(jax.random.gumbel(cb_keys[i], (1, k), dtype=jnp.float32))
                   for i in range(jc.num_codebooks)])
    args = (tp, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5, t_sampling, _t(logits),
            _t(hidden), ts.RepPenWindow(_t(window), 5), _t(prev), noise,
            rope_tables(tc, "cpu"))
    for fused in (True, False):
        got = t_generate_frame(*args, use_fused_fast=fused)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.rep_pen.tokens.numpy(), np.asarray(ref.rep_pen.tokens))


def _tiny(dtype=torch.float32):
    tc = tcfg.DualARConfig(**KW)
    return tc, torch_init(tc, seed=0, dtype=dtype, device="cpu")


def _bf16_t(a):
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)


def jax_unfused_step_logits(jp, jc, hidden, tokens):
    """The JAX unfused codebook steps (`fast_step`, `fast_embed`) driven
    by the given frame tokens (B, C): each step's logits (C, B, V)."""
    x = jnp.asarray(hidden)[:, None, :]
    hist = jax_fast_hist_init(jc, hidden.shape[0], x.dtype)
    out = []
    for cb in range(jc.num_codebooks):
        logits, hist = jax_fast_step(jp, jc, x, hist, cb)
        out.append(np.asarray(logits))
        x = jax_fast_embed(jp, jc, jnp.asarray(tokens[:, cb]), cb)
    return np.stack(out)


def assert_within_half_bf16_ulp(got, ref):
    """The unfused steps round each head product to bf16, the fused
    plain version keeps it in float32: the two differ by at most half a
    bf16 ulp of the reference."""
    half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 8)
    assert (np.abs(got - ref) <= half_ulp + 1e-7).all(), np.abs(got - ref).max()


def test_bf16_int8_plain_step_logits_match_jax_unfused():
    """bf16 weights quantized by the JAX package: the plain int8 frame's
    step logits against the JAX unfused int8 steps on the same tokens
    (x @ q rounded to bf16, rescaled and rounded again, silu of that)."""
    jc, tc, jp, tp = _models(False, int8=True, dtype=jnp.bfloat16)
    rng = np.random.default_rng(12)
    hidden = jnp.asarray(rng.normal(size=(1, jc.dim)), jnp.bfloat16)
    argmax = ts.SamplingArgs(temp=0.0, top_p=1.0, top_k=32, repetition_penalty=1.0)
    tokens, logits = ff.fused_fast_frame(
        tp, tc, argmax, _bf16_t(hidden), torch.full((4, 16), -1, dtype=torch.int32), None,
        torch.tensor([False]), rope_tables(tc, "cpu"), rep_enabled=False, return_logits=True)
    ref = jax_unfused_step_logits(jp, jc, hidden, tokens.numpy()[None])
    assert_within_half_bf16_ulp(logits.numpy(), ref[:, 0])


@pytest.mark.parametrize("batch,head_dim,ok", [(1, None, True), (2, None, False), (1, 15, False)])
def test_supported_is_batch_one(batch, head_dim, ok):
    tc, params = _tiny()
    if head_dim is not None:
        tc = dataclasses.replace(tc, head_dim=head_dim)
    assert ff.fused_fast_frame_supported(tc, params, batch) == ok


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the CUDA branch
    of the wrapper without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("limit", ["int8", "ffn_not_64", "dim_not_in_plan", "vocab_8192"])
def test_supported_on_cuda_takes_int8_with_bf16_scales(limit):
    """int8 q with bf16 s is taken, a bf16 q among int8 ones is not; the
    persistent kernel's limits: an ffn width that is a multiple of 64, a
    model width its plan takes and a codebook of at most 4096 entries."""
    card = {**KW, "n_head": 4, "dim": 256, "head_dim": 64}
    case = {"int8": {}, "ffn_not_64": {"intermediate_size": 96},
            "dim_not_in_plan": {"n_head": 6, "dim": 384}, "vocab_8192": {"codebook_size": 8192}}
    tc = tcfg.DualARConfig(**{**card, **case[limit]})
    params = tq.quantize_lm_params(torch_init(tc, seed=0, dtype=torch.bfloat16, device="cpu"))

    def looks_cuda(tree):
        if isinstance(tree, dict):
            return {k: looks_cuda(v) for k, v in tree.items()}
        return tree.as_subclass(_CudaLooking)

    if limit != "int8":
        assert not ff.fused_fast_frame_supported(tc, {"fast": looks_cuda(params["fast"])}, 1)
        return

    assert ff.fused_fast_frame_supported(tc, {"fast": looks_cuda(params["fast"])}, 1)
    fast = dict(params["fast"], w3={"q": params["fast"]["w3"]["q"].to(torch.bfloat16),
                                    "s": params["fast"]["w3"]["s"]})
    assert not ff.fused_fast_frame_supported(tc, {"fast": looks_cuda(fast)}, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_supported_on_cuda_is_bf16_only(dtype):
    """On CUDA the kernel takes bf16 stacks only, so `auto` must not pick
    it for others (before, float32 stacks were "supported" and failed at
    the first frame)."""
    tc = tcfg.DualARConfig(**{**KW, "n_head": 4, "dim": 256, "head_dim": 64})
    params = torch_init(tc, seed=0, dtype=dtype, device="cpu")
    fast = {k: v.as_subclass(_CudaLooking) for k, v in params["fast"].items()}
    assert ff.fused_fast_frame_supported(tc, {"fast": fast}, 1) == (dtype == torch.bfloat16)


def test_cuda_tensor_never_runs_plain(monkeypatch):
    """A CUDA input launches the kernel or raises: here the parameters
    lie on the CPU, so the wrapper raises before any launch."""
    def fail(*args, **kwargs):
        raise AssertionError("a CUDA tensor must not fall back to the plain version")

    monkeypatch.setattr(ff, "fused_fast_frame_plain", fail)
    monkeypatch.setattr(_cuda_build, "load_library", fail)
    tc, params = _tiny(torch.bfloat16)
    hidden = torch.zeros(1, tc.dim, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    before = ff.launches
    with pytest.raises((ValueError, TypeError)):
        ff.fused_fast_frame(params, tc, ts.SamplingArgs(**SAMPLED), hidden,
                            torch.full((4, 16), -1, dtype=torch.int32), torch.zeros(4, 16),
                            torch.tensor([False]), rope_tables(tc, "cpu"), rep_enabled=True)
    assert ff.launches == before


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_model(device, depthwise=False):
    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "codebook_size": 512, "num_codebooks": 8},
                           depthwise_wte=depthwise, depthwise_output=depthwise)
    return tc, torch_init(tc, seed=0, dtype=torch.bfloat16, device=device)


def float32_reference(tree):
    """The parameters in float32, int8 stacks dequantized: the float32
    evaluation the kernels are held to."""
    if tq.is_quantized(tree):
        return tq.dequantize_weight(tree)
    if isinstance(tree, dict):
        return {k: float32_reference(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sampled", "argmax", "no_rep_pen", "is_eos", "depthwise",
                                  "int8_sampled", "int8_argmax"])
def test_kernel_tokens_equal_plain_on_exact_inputs(cuda_device, case):
    """Zero fast-layer weights, one-hot hidden and one-hot embedding rows
    make every sum exact (each step's logits are one head row times the
    normalised one-hot value), so logits and tokens must be equal; the
    bf16-valued logits have many ties, which both rank by index. int8:
    the zero weights quantize to q = 0, s = bf16(1e-8)."""
    int8 = case.startswith("int8")
    case = case[5:] if int8 else case
    depthwise = case == "depthwise"
    tc, params = _card_model(cuda_device, depthwise)
    params["fast"] = {k: (v if k.endswith("norm") else torch.zeros_like(v))
                      for k, v in params["fast"].items()}
    if int8:
        params = tq.quantize_lm_params(params)
    emb = torch.zeros_like(params["fast_embeddings"])
    rows = torch.arange(emb.shape[0], device=cuda_device)
    emb[rows, rows % tc.dim] = 1
    params["fast_embeddings"] = emb
    samp = {"argmax": dict(temp=0.0, top_p=1.0, top_k=512, repetition_penalty=1.4),
            "no_rep_pen": dict(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.0)}.get(
        case, dict(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4))
    sampling = ts.SamplingArgs(**samp)
    rep = not depthwise and sampling.repetition_penalty != 1.0
    g = torch.Generator(device=cuda_device).manual_seed(3)
    rope = rope_tables(tc, cuda_device)
    for j in range(4):
        hidden = torch.zeros((1, tc.dim), dtype=torch.bfloat16, device=cuda_device)
        hidden[0, 17 * j] = 1
        window = torch.randint(-1, 512, (8, 16), generator=g, device=cuda_device,
                               dtype=torch.int32)
        gumbel = None if sampling.is_argmax else ts.gumbel_noise((8, 256), g, cuda_device)
        is_eos = torch.tensor([case == "is_eos"], device=cuda_device)
        args = (tc, sampling, hidden, window, gumbel, is_eos, rope)
        got, got_l = ff.fused_fast_frame(params, *args, rep_enabled=rep, return_logits=True)
        ref, ref_l = ff.fused_fast_frame_plain(params, *args, rep_enabled=rep, return_logits=True)
        assert torch.equal(got_l, ref_l)
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_kernel_step_logits_as_accurate_as_plain_on_card(cuda_device, int8):
    """Real weights, argmax: each step's logits (up to the first step
    whose input token differs) are as close to the float32 evaluation as
    the plain version's, within a factor of 2 (int8: the float32
    evaluation of the dequantized weights)."""
    tc, params = _card_model(cuda_device)
    if int8:
        params = tq.quantize_lm_params(params)
    params32 = float32_reference(params)
    sampling = ts.SamplingArgs(temp=0.0, top_p=1.0, top_k=512, repetition_penalty=1.4)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    rope = rope_tables(tc, cuda_device)
    err_k = err_p = 0.0
    for _ in range(8):
        hidden = torch.randn((1, tc.dim), generator=g, device=cuda_device).to(torch.bfloat16)
        window = torch.randint(-1, 512, (8, 16), generator=g, device=cuda_device,
                               dtype=torch.int32)
        is_eos = torch.tensor([False], device=cuda_device)
        tk, lk = ff.fused_fast_frame(params, tc, sampling, hidden, window, None, is_eos, rope,
                                     rep_enabled=True, return_logits=True)
        tp, lp = ff.fused_fast_frame_plain(params, tc, sampling, hidden, window, None, is_eos,
                                           rope, rep_enabled=True, return_logits=True)
        tr, lr = ff.fused_fast_frame_plain(params32, tc, sampling, hidden.float(), window, None,
                                           is_eos, rope, rep_enabled=True, return_logits=True)
        differ = ((tk != tp) | (tk != tr)).nonzero()
        n = 8 if len(differ) == 0 else int(differ[0]) + 1
        err_k = max(err_k, float((lk[:n] - lr[:n]).abs().max()))
        err_p = max(err_p, float((lp[:n] - lr[:n]).abs().max()))
    assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)


def _frame_inputs(dev, int8=False, seed=5):
    tc, params = _card_model(dev)
    if int8:
        params = tq.quantize_lm_params(params)
    sampling = ts.SamplingArgs(temp=0.7, top_p=0.8, top_k=256, repetition_penalty=1.4)
    g = torch.Generator(device=dev).manual_seed(seed)
    hidden = torch.randn((1, tc.dim), generator=g, device=dev).to(torch.bfloat16)
    window = torch.randint(-1, 512, (8, 16), generator=g, device=dev, dtype=torch.int32)
    gumbel = ts.gumbel_noise((8, 256), g, dev)
    is_eos = torch.tensor([False], device=dev)
    return params, (tc, sampling, hidden, window, gumbel, is_eos, rope_tables(tc, dev))


def _frame(params, args):
    return ff.fused_fast_frame(params, *args, rep_enabled=True, return_logits=True)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_plan_on_card_equals_mirror(cuda_device, int8):
    from fish_speech_tpu_torch.ops import decode_stack as ds

    tc, _ = _card_model(cuda_device)
    for cfg in (tc, tcfg.DualARConfig.fish_speech_1_5()):
        mirror = ff.fast_plan(cfg, int8, ds.grid_of(cuda_device))
        card = ds.plan_on_card(ds.FAST, cfg.dim, cfg.n_head, cfg.n_local_heads,
                               cfg.intermediate_size, cfg.codebook_size, cfg.num_codebooks, int8)
        assert card == mirror


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_repeated_calls_bit_identical_and_one_launch(cuda_device, int8):
    """Five frames on the same inputs give the same tokens and logits; a
    frame is one call of the kernel (`launches` counts calls)."""
    params, args = _frame_inputs(cuda_device, int8)
    before = ff.launches
    outs = [_frame(params, args) for _ in range(5)]
    torch.cuda.synchronize()
    assert ff.launches - before == 5
    for t, lg in outs[1:]:
        assert torch.equal(t, outs[0][0]) and torch.equal(lg, outs[0][1])


@pytest.mark.cuda
def test_graph_replay_equals_eager(cuda_device):
    params, args = _frame_inputs(cuda_device)
    eager = _frame(params, args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _frame(params, args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):  # the warm-up's stream and state
        tokens, logits = _frame(params, args)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(tokens, eager[0]) and torch.equal(logits, eager[1])


@pytest.mark.cuda
def test_completes_beside_a_kernel_on_another_stream(cuda_device):
    params, args = _frame_inputs(cuda_device)
    eager = _frame(params, args)
    torch.cuda.synchronize()
    other = torch.cuda.Stream()
    with torch.cuda.stream(other):
        torch.cuda._sleep(200_000_000)
    got = _frame(params, args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1])


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_frame_launches_and_syncs_counted_on_card(cuda_device, int8):
    """One persistent launch and one sampler launch a codebook step, and
    the grid syncs of a launch, as the kernels count them in the sync
    state's last words, equal to the plan's; a fast frame's attention
    never splits over keys."""
    from fish_speech_tpu_torch.ops import decode_stack as ds

    params, args = _frame_inputs(cuda_device, int8)
    tc = args[0]
    _frame(params, args)
    before = ds.launch_counts(cuda_device)
    _frame(params, args)
    after = ds.launch_counts(cuda_device)
    assert (after[0] - before[0], after[1] - before[1]) == (tc.num_codebooks, tc.num_codebooks)
    plan = ff.fast_plan(tc, int8, ds.grid_of(cuda_device))
    assert ds.last_call_counts(cuda_device) == (plan.syncs_per_launch(ds.FAST, tc.n_fast_layer), 0)
