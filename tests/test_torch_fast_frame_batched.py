"""The port's batched dynamic fast frame (ops/fast_frame_batched.py and the
`samp=` branch of generate/frame.py) against the JAX package's dynamic
frame (`generate_frame(samp=...)`, the XLA path) and its TPU kernel
`fused_fast_frame_batched` in interpret mode, at the tiny config of
tests/test_fast_frame.py in float32, on the JAX package's own per-row
draws, with bf16 and with int8 stacks (the kernel's quantized body);
tokens must be exactly equal. The bf16 int8 plain version's step logits
against the JAX unfused int8 steps. On a card only: the persistent CUDA
kernel (one launch a frame) against its plain version; its contract is
tests/test_torch_frame_plan.py's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.generate.frame import generate_frame as j_generate_frame
from fish_speech_tpu.generate.frame import semantic_head_columns
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops import sampling as js
from fish_speech_tpu.ops.fast_frame_pallas import (
    fused_fast_frame_batched as jax_fused_fast_frame_batched)
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.generate.frame import NoiseLayout
from fish_speech_tpu_torch.generate.frame import generate_frame as t_generate_frame
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy
from fish_speech_tpu_torch.models.dual_ar import init_dual_ar_params as torch_init
from fish_speech_tpu_torch.models.dual_ar import rope_tables
from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops import fast_frame_batched as fb
from fish_speech_tpu_torch.ops import sampling as ts
from fish_speech_tpu_torch.ops.quant import dequantize_weight, is_quantized, quantize_lm_params
from test_torch_dynamic_sampling import jax_frame_noise
from test_torch_fast_frame import assert_within_half_bf16_ulp, jax_unfused_step_logits

torch.set_num_threads(1)

KW = dict(vocab_size=256, n_layer=2, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=128, num_codebooks=4)
TOK = dict(im_end_id=9, pad_id=5, semantic_start_id=10, semantic_end_id=137)
CAP = 256  # the engines' dyn_top_k_cap: covers the 128-entry codebook


def _t(a):
    return torch.from_numpy(np.array(a))


def _model(int8=False, dtype=jnp.float32):
    jc = jcfg.DualARConfig(**KW)
    params = dict(jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, dtype))
    cols = semantic_head_columns(jcfg.WhichLM.FISH_1_5, jcfg.TokenConfig(**TOK), jc)
    params["output"] = jnp.take(params["output"], jnp.asarray(cols), axis=1)
    if int8:
        params = jq.quantize_lm_params(params)
    return jc, tcfg.DualARConfig(**KW), params, dual_ar_params_from_numpy(
        jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def model_int8():
    """The same weights, int8-quantized by the JAX package."""
    return _model(int8=True)


def _mixed_rows(batch, width, seed):
    """The mixed rows of tests/test_fast_frame.py's batched case: row 0
    is an EOS row, row 1 argmax, the rest differ in temp/top_p/top_k/
    penalty."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(batch, width)).astype(np.float32) * 2
    logits[0, :] = -30.0
    logits[0, 0] = 30.0
    if batch > 2:
        logits[2, 0] = -100.0
    knobs = dict(temp=([0.7, 0.0, 1.2, 0.5] * 2)[:batch], top_p=([0.8, 1.0, 0.6, 0.95] * 2)[:batch],
                 top_k=([16, 0, 4, 32] * 2)[:batch], rep_pen=([1.3, 1.0, 1.5, 1.1] * 2)[:batch])
    hidden = rng.normal(size=(batch, KW["dim"])).astype(np.float32)
    window = rng.integers(-1, KW["codebook_size"],
                          (batch, KW["num_codebooks"], ts.BATCHED_REP_PEN_WINDOW)).astype(np.int32)
    prev = rng.integers(0, KW["codebook_size"], (batch, KW["num_codebooks"] + 1)).astype(np.int32)
    return logits, knobs, hidden, window, prev


def _samplings(knobs):
    j = js.RowSampling(temp=jnp.asarray(knobs["temp"], jnp.float32),
                       top_p=jnp.asarray(knobs["top_p"], jnp.float32),
                       top_k=jnp.asarray(knobs["top_k"], jnp.int32),
                       rep_pen=jnp.asarray(knobs["rep_pen"], jnp.float32))
    t = ts.RowSampling(*(_t(np.asarray(a)) for a in j))
    return j, t


@pytest.mark.parametrize("batch", [2, 4, 8, "int8_4"])
def test_dynamic_frame_matches_jax(model, model_int8, batch):
    """generate_frame(samp=...) of the port, on the unfused loop and on
    the batched fused frame's plain version, against the JAX dynamic
    frame's XLA path, on the JAX frame's own per-row draws; "int8_4": 4
    rows on the int8 stacks."""
    jc, tc, jp, tp = model_int8 if batch == "int8_4" else model
    batch = 4 if batch == "int8_4" else batch
    w = jp["output"].shape[1]
    logits, knobs, hidden, window, prev = _mixed_rows(batch, w, batch)
    j_samp, t_samp = _samplings(knobs)
    keys = jnp.stack([jax.random.PRNGKey(100 + i) for i in range(batch)])
    ref = j_generate_frame(jp, jc, jcfg.TokenConfig(**TOK), jcfg.WhichLM.FISH_1_5,
                           js.SamplingArgs(), jnp.asarray(logits), jnp.asarray(hidden),
                           js.RepPenWindow(jnp.asarray(window), jnp.int32(3)),
                           jnp.asarray(prev), keys, samp=j_samp, dyn_top_k_cap=CAP)
    assert bool(np.asarray(ref.is_eos)[0])  # the spiked row is EOS
    noise = jax_frame_noise(keys, NoiseLayout.of(tcfg.WhichLM.FISH_1_5, tc, w, CAP))
    for fused in (False, True):
        got = t_generate_frame(tp, tc, tcfg.TokenConfig(**TOK), tcfg.WhichLM.FISH_1_5,
                               ts.SamplingArgs(), _t(logits), _t(hidden),
                               ts.RepPenWindow(_t(window), 3), _t(prev), noise,
                               rope_tables(tc, "cpu"), use_fused_fast=fused, samp=t_samp,
                               dyn_top_k_cap=CAP)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
        np.testing.assert_array_equal(got.is_eos.numpy(), np.asarray(ref.is_eos))
        np.testing.assert_array_equal(got.rep_pen.tokens.numpy(),
                                      np.asarray(ref.rep_pen.tokens))


def test_plain_matches_pallas_interpret(model):
    """The batched fused frame's plain version against the TPU kernel in
    interpret mode, B = 2, mixed rows (an EOS row and an argmax row)."""
    _plain_matches_pallas_interpret(*model)


def test_plain_int8_matches_pallas_interpret(model_int8):
    """The same on the int8 stacks (the kernel's quantized body)."""
    assert is_quantized(model_int8[3]["fast"]["wo"])
    _plain_matches_pallas_interpret(*model_int8)


def _plain_matches_pallas_interpret(jc, tc, jp, tp):
    _, knobs, hidden, window, _ = _mixed_rows(2, 2, 11)
    j_samp, t_samp = _samplings(knobs)
    gumbel = np.asarray(jax.random.gumbel(jax.random.PRNGKey(5), (2, jc.num_codebooks, 128),
                                          dtype=jnp.float32))
    is_eos = np.array([True, False])
    ref = jax_fused_fast_frame_batched(jp, jc, j_samp, jnp.asarray(hidden), jnp.asarray(window),
                                       jnp.asarray(gumbel), jnp.asarray(is_eos),
                                       rep_enabled=True, interpret=True)
    got = fb.fused_fast_frame_batched(tp, tc, t_samp, _t(hidden), _t(window), _t(gumbel),
                                      _t(is_eos), rope_tables(tc, "cpu"), rep_enabled=True)
    assert got.dtype == torch.int32 and got.shape == (2, jc.num_codebooks)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[0].any()


def test_bf16_int8_plain_step_logits_match_jax_unfused():
    """bf16 weights quantized by the JAX package, 3 argmax rows: the plain
    int8 frame's step logits against the JAX unfused int8 steps on the
    same tokens (x @ q rounded to bf16, rescaled and rounded again, silu
    of that), within half a bf16 ulp (the unfused head rounds)."""
    jc, tc, jp, tp = _model(int8=True, dtype=jnp.bfloat16)
    rng = np.random.default_rng(13)
    hidden = jnp.asarray(rng.normal(size=(3, jc.dim)), jnp.bfloat16)
    samp = ts.RowSampling.broadcast(ts.SamplingArgs(temp=0.0, top_k=0), 3)
    tokens, logits = fb.fused_fast_frame_batched(
        tp, tc, samp, torch.from_numpy(np.asarray(hidden).view(np.int16).copy()).view(
            torch.bfloat16), torch.full((3, 4, 12), -1, dtype=torch.int32),
        torch.zeros(3, 4, KW["codebook_size"]), torch.zeros(3, dtype=torch.bool),
        rope_tables(tc, "cpu"),
        rep_enabled=False, return_logits=True)
    ref = jax_unfused_step_logits(jp, jc, hidden, tokens.numpy())
    assert_within_half_bf16_ulp(logits.numpy(), ref)


def _tiny(dtype=torch.float32, **kw):
    tc = tcfg.DualARConfig(**{**KW, **kw})
    return tc, torch_init(tc, seed=0, dtype=dtype, device="cpu")


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the CUDA branch
    of a wrapper or of a `supported` function without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(tree):
    if isinstance(tree, dict):
        return {k: _cuda_looking(v) for k, v in tree.items()}
    return tree.as_subclass(_CudaLooking)


def test_supported_bounds():
    """The JAX kernel's bounds (fast_frame_pallas.py:1039-1056) and the
    top-k cap rule, then the kernel's own on CUDA: bf16 and head dim 64."""
    tc, params = _tiny()
    assert fb.fused_fast_frame_batched_supported(tc, params, 1)
    assert fb.fused_fast_frame_batched_supported(tc, params, 32)
    assert not fb.fused_fast_frame_batched_supported(tc, params, 33)
    assert not fb.fused_fast_frame_batched_supported(tc, params, 0)
    assert not fb.fused_fast_frame_batched_supported(dataclasses.replace(tc, head_dim=15),
                                                     params, 4)
    assert not fb.fused_fast_frame_batched_supported(tc, params, 4, dyn_top_k_cap=100)
    assert fb.fused_fast_frame_batched_supported(tc, params, 4, dyn_top_k_cap=128)
    assert not fb.fused_fast_frame_batched_supported(
        dataclasses.replace(tc, codebook_size=200), params, 4, dyn_top_k_cap=128)
    card = dict(n_head=4, dim=256, head_dim=64)
    tc64, p64 = _tiny(torch.bfloat16, **card)
    assert fb.fused_fast_frame_batched_supported(tc64, _cuda_looking(p64), 16)
    tc32, p32 = _tiny(torch.float32, **card)
    assert not fb.fused_fast_frame_batched_supported(tc32, _cuda_looking(p32), 16)
    assert not fb.fused_fast_frame_batched_supported(tc, _cuda_looking(params), 16)
    # int8 stacks: the plain version takes them; on CUDA the kernel takes
    # int8 q with bf16 s (out % 16 == 0), not a float q
    assert fb.fused_fast_frame_batched_supported(tc, quantize_lm_params(params), 4)
    q64 = quantize_lm_params(p64)
    assert fb.fused_fast_frame_batched_supported(tc64, _cuda_looking(q64), 16)
    q64["fast"] = dict(q64["fast"], w1={"q": p64["fast"]["w1"], "s": q64["fast"]["w1"]["s"]})
    assert not fb.fused_fast_frame_batched_supported(tc64, _cuda_looking(q64), 16)


def test_cuda_tensor_never_runs_plain(monkeypatch):
    """A CUDA input launches the kernel or raises: here the parameters
    lie on the CPU, so the wrapper raises before any launch."""
    def fail(*args, **kwargs):
        raise AssertionError("a CUDA tensor must not fall back to the plain version")

    monkeypatch.setattr(fb, "fused_fast_frame_batched_plain", fail)
    monkeypatch.setattr(_cuda_build, "load_library", fail)
    tc, params = _tiny(torch.bfloat16)
    hidden = torch.zeros(2, tc.dim, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    before = fb.launches
    with pytest.raises((ValueError, TypeError)):
        fb.fused_fast_frame_batched(
            params, tc, ts.RowSampling.broadcast(ts.SamplingArgs(), 2), hidden,
            torch.full((2, 4, 12), -1, dtype=torch.int32), torch.zeros(2, 4, 128),
            torch.tensor([False, False]), rope_tables(tc, "cpu"), rep_enabled=True)
    assert fb.launches == before


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(tc, b, g, dev, one_hot: bool, argmax_rows=(), eos_rows=()):
    if one_hot:
        hidden = torch.zeros((b, tc.dim), dtype=torch.bfloat16, device=dev)
        hidden[torch.arange(b), torch.randint(0, tc.dim, (b,), generator=g, device=dev)] = 1
    else:
        hidden = torch.randn((b, tc.dim), generator=g, device=dev).to(torch.bfloat16)
    window = torch.randint(-1, tc.codebook_size, (b, tc.num_codebooks, 12), generator=g,
                           device=dev, dtype=torch.int32)
    gumbel = ts.gumbel_noise((b, tc.num_codebooks, 256), g, dev)
    vec = lambda vals: torch.tensor([vals[i % len(vals)] for i in range(b)],  # noqa: E731
                                    dtype=torch.float32, device=dev)
    temp = vec([0.7, 1.2, 0.5, 0.9])
    temp[[r for r in argmax_rows if r < b]] = 0.0
    samp = ts.RowSampling(temp=temp, top_p=vec([0.8, 1.0, 0.6, 0.95]),
                          top_k=vec([256, 0, 16, 64]).to(torch.int32),
                          rep_pen=vec([1.4, 1.0, 1.5, 1.1]))
    is_eos = torch.zeros((b,), dtype=torch.bool, device=dev)
    is_eos[[r for r in eos_rows if r < b]] = True
    return samp, hidden, window, gumbel, is_eos


def _card_model(device, depthwise=False):
    tc = tcfg.DualARConfig(**{**KW, "n_head": 8, "dim": 512, "intermediate_size": 1024,
                              "head_dim": 64, "codebook_size": 512, "num_codebooks": 8},
                           depthwise_wte=depthwise, depthwise_output=depthwise)
    return tc, torch_init(tc, seed=0, dtype=torch.bfloat16, device=device)


def float32_reference(tree):
    """The parameters in float32, int8 stacks dequantized: the float32
    evaluation the kernels are held to."""
    if is_quantized(tree):
        return dequantize_weight(tree)
    if isinstance(tree, dict):
        return {k: float32_reference(v) for k, v in tree.items()}
    return tree.float()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["sampled", "argmax", "mixed", "depthwise", "int8_sampled",
                                  "int8_mixed"])
@pytest.mark.parametrize("batch", [1, 4, 16, 32])
def test_kernel_tokens_equal_plain_on_exact_inputs(cuda_device, case, batch):
    """Zero fast-layer weights, one-hot hidden and one-hot embedding rows
    make every sum exact, so step logits and tokens must equal the plain
    version's. int8: the zero weights quantize to q = 0, s = bf16(1e-8)."""
    tc, params = _card_model(cuda_device, case == "depthwise")
    params["fast"] = {k: (v if k.endswith("norm") else torch.zeros_like(v))
                      for k, v in params["fast"].items()}
    if case.startswith("int8"):
        params = quantize_lm_params(params)
        case = case[5:]
    emb = torch.zeros_like(params["fast_embeddings"])
    rows = torch.arange(emb.shape[0], device=cuda_device)
    emb[rows, rows % tc.dim] = 1
    params["fast_embeddings"] = emb
    g = torch.Generator(device=cuda_device).manual_seed(batch)
    rope = rope_tables(tc, cuda_device)
    argmax_rows = range(batch) if case == "argmax" else (1,) if case == "mixed" else ()
    for _ in range(3):
        samp, hidden, window, gumbel, is_eos = _card_inputs(
            tc, batch, g, cuda_device, True, argmax_rows, (2,) if case == "mixed" else ())
        args = (tc, samp, hidden, window, gumbel, is_eos, rope)
        rep = case != "depthwise"
        got, got_l = fb.fused_fast_frame_batched(params, *args, rep_enabled=rep,
                                                 return_logits=True)
        ref, ref_l = fb.fused_fast_frame_batched_plain(params, *args, rep_enabled=rep,
                                                       return_logits=True)
        assert torch.equal(got_l, ref_l)
        assert torch.equal(got, ref)
        if case == "mixed" and batch > 2:
            assert not got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_kernel_step_logits_as_accurate_as_plain_on_card(cuda_device, int8):
    """Real weights, argmax rows: each step's logits (up to the first step
    whose input token differs) are as close to the float32 evaluation as
    the plain version's, within a factor of 2 (int8: the float32
    evaluation of the dequantized weights)."""
    tc, params = _card_model(cuda_device)
    if int8:
        params = quantize_lm_params(params)
    params32 = float32_reference(params)
    g = torch.Generator(device=cuda_device).manual_seed(4)
    rope = rope_tables(tc, cuda_device)
    err_k = err_p = 0.0
    for _ in range(4):
        samp, hidden, window, gumbel, is_eos = _card_inputs(tc, 8, g, cuda_device, False,
                                                            range(8))
        tk, lk = fb.fused_fast_frame_batched(params, tc, samp, hidden, window, gumbel, is_eos,
                                             rope, rep_enabled=True, return_logits=True)
        tp, lp = fb.fused_fast_frame_batched_plain(params, tc, samp, hidden, window, gumbel,
                                                   is_eos, rope, rep_enabled=True,
                                                   return_logits=True)
        tr, lr = fb.fused_fast_frame_batched_plain(params32, tc, samp, hidden.float(), window,
                                                   gumbel, is_eos, rope, rep_enabled=True,
                                                   return_logits=True)
        for b in range(8):
            differ = ((tk[b] != tp[b]) | (tk[b] != tr[b])).nonzero()
            n = tc.num_codebooks if len(differ) == 0 else int(differ[0]) + 1
            err_k = max(err_k, float((lk[:n, b] - lr[:n, b]).abs().max()))
            err_p = max(err_p, float((lp[:n, b] - lr[:n, b]).abs().max()))
    assert err_k <= 2 * err_p + 1e-6, (err_k, err_p)
