"""The port's weight-only int8 quantization (ops/quant.py) against the
JAX package's `fish_speech_tpu/ops/quant.py` on the same numpy-seeded
weights: q and s bit-equal, the quantized product in float32 (1e-5, sums
in another order) and in bf16 (bit-equal, on inputs whose sums are exact
in float32, so both roundings are tested), the converter on
JAX-quantized trees, and the per-layer slices of a quantized stack."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu import config as jcfg
from fish_speech_tpu.models.dual_ar import _layer_slice
from fish_speech_tpu.models.dual_ar import init_dual_ar_params
from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu_torch import config as tcfg
from fish_speech_tpu_torch.io.convert import dual_ar_params_from_numpy, tensor_from_numpy
from fish_speech_tpu_torch.models.dual_ar import _attn_out_ffn, _layer
from fish_speech_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

KW = dict(vocab_size=256, n_layer=3, n_fast_layer=2, n_head=4, dim=64, intermediate_size=128,
          n_local_heads=2, head_dim=16, rope_base=10000.0, norm_eps=1e-6, max_seq_len=64,
          codebook_size=32, num_codebooks=4)


def _np(a):
    """A JAX array as numpy, bf16 as its int16 bit pattern."""
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _tnp(t):
    """A torch tensor as numpy, bf16 as its int16 bit pattern."""
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _weights(case):
    rng = np.random.default_rng(list(CASES).index(case))
    shape, dtype, zero_cols = CASES[case]
    w = (rng.normal(size=shape) * 0.02).astype(np.float32)
    w[..., :zero_cols] = 0.0  # all-zero columns take the 1e-8 scale
    return jnp.asarray(w, dtype)


CASES = {
    "f32_stacked": ((3, 64, 128), jnp.float32, 0),
    "bf16_stacked": ((3, 64, 128), jnp.bfloat16, 0),
    "f32_zero_columns": ((2, 32, 48), jnp.float32, 5),
    "bf16_2d": ((96, 80), jnp.bfloat16, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_bit_equal_to_jax(case):
    w = _weights(case)
    ref = jq.quantize_weight(w)
    got = tq.quantize_weight(tensor_from_numpy(np.asarray(w)))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.bfloat16
    assert tuple(got["s"].shape) == tuple(ref["s"].shape)
    np.testing.assert_array_equal(_tnp(got["q"]), _np(ref["q"]))
    np.testing.assert_array_equal(_tnp(got["s"]), _np(ref["s"]))
    np.testing.assert_array_equal(tq.dequantize_weight(got).numpy(),
                                  np.asarray(jq.dequantize_weight(ref)))


@pytest.mark.cuda
def test_quantize_on_card_bit_equal_to_cpu():
    """On the card the quantization gives the CPU's (and so the JAX
    package's) q and s, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        w = (torch.randn((4, 1024, 1280), generator=g) * 0.02).to(dtype)
        ref = tq.quantize_weight(w)
        got = tq.quantize_weight(w.cuda())
        assert torch.equal(got["q"].cpu(), ref["q"]) and torch.equal(got["s"].cpu(), ref["s"])


def test_reciprocal_division_would_differ():
    """The scale is max|w| / 127 by true division, as JAX's is:
    multiplying by the reciprocal (what PyTorch's CUDA division by a
    Python number does) rounds otherwise for some of these columns, so
    the quantization could not be bit-equal to JAX's with it."""
    w = _weights("f32_stacked")
    amax = torch.from_numpy(np.abs(np.asarray(w)).max(axis=-2, keepdims=True))
    true_div = amax / torch.full((), 127.0)
    assert (amax * torch.tensor(1.0 / 127.0) != true_div).any()
    scale = jq.quantize_weight(w)["s"]
    np.testing.assert_array_equal(_tnp(true_div.to(torch.bfloat16)), _np(scale))


def test_matmul_float32_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    wq = jq.quantize_weight(jnp.asarray(rng.normal(size=(64, 32)) * 0.05, jnp.float32))
    ref = np.asarray(jq.matmul(jnp.asarray(x), wq))
    got = tq.matmul(torch.from_numpy(x), {k: tensor_from_numpy(np.asarray(v))
                                          for k, v in wq.items()})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_matmul_bf16_rounds_twice_as_jax():
    """bf16: x @ q rounds to bf16, then the rescale rounds again. Small
    integer activations make every sum exact in float32, so the result
    is bit-equal whatever the summation order, and it differs from one
    rounding of the float32 product."""
    rng = np.random.default_rng(2)
    x = rng.integers(-4, 5, size=(8, 64)).astype(np.float32)
    wq = jq.quantize_weight(jnp.asarray(rng.normal(size=(64, 96)) * 0.05, jnp.bfloat16))
    ref = jq.matmul(jnp.asarray(x, jnp.bfloat16), wq)
    t_wq = {k: tensor_from_numpy(np.asarray(v)) for k, v in wq.items()}
    got = tq.matmul(torch.from_numpy(x).to(torch.bfloat16), t_wq)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_tnp(got), _np(ref))
    once = ((torch.from_numpy(x) @ t_wq["q"].float()) * t_wq["s"].float()).to(torch.bfloat16)
    assert (once != got).any()


@pytest.fixture(scope="module")
def quantized_tree():
    """A JAX float32 DualAR tree quantized by the JAX package, as numpy."""
    jc = jcfg.DualARConfig(**KW)
    params = jax.jit(init_dual_ar_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(0), jc, jnp.float32)
    qparams = jq.quantize_lm_params(params)
    return params, qparams, jax.tree.map(np.asarray, qparams)


@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16])
def test_converter_keeps_int8_and_bf16_scales(quantized_tree, dtype):
    """A dtype casts the float leaves only: q stays int8 and s bf16, even
    for a float32 tree, as the JAX package keeps them."""
    _, _, tree = quantized_tree
    got = dual_ar_params_from_numpy(tree, dtype=dtype)
    for stack in ("slow", "fast"):
        for k in tq.QUANT_KEYS:
            q, s = got[stack][k]["q"], got[stack][k]["s"]
            assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
            np.testing.assert_array_equal(q.numpy(), tree[stack][k]["q"])
            np.testing.assert_array_equal(_tnp(s), tree[stack][k]["s"].view(np.int16))
        assert got[stack]["attention_norm"].dtype == (dtype or torch.float32)
    assert got["output"].dtype == (dtype or torch.float32)


def test_quantize_lm_params_matches_jax(quantized_tree):
    """The port quantizing the converted float32 tree gives the JAX
    package's quantized tree, leaf for leaf; unquantized entries are
    shared, not copied."""
    params, _, tree = quantized_tree
    dense = dual_ar_params_from_numpy(jax.tree.map(np.asarray, params))
    got = tq.quantize_lm_params(dense)
    for stack in ("slow", "fast"):
        for k in tq.QUANT_KEYS:
            np.testing.assert_array_equal(got[stack][k]["q"].numpy(), tree[stack][k]["q"])
            np.testing.assert_array_equal(_tnp(got[stack][k]["s"]),
                                          tree[stack][k]["s"].view(np.int16))
        assert got[stack]["ffn_norm"] is dense[stack]["ffn_norm"]
    assert got["embeddings"] is dense["embeddings"]


@pytest.mark.parametrize("stack", ["slow", "fast"])
def test_layer_slices_quantized_stack(quantized_tree, stack):
    _, qparams, tree = quantized_tree
    tstack = dual_ar_params_from_numpy(tree)[stack]
    for l in range(tree[stack]["wqkv"]["q"].shape[0]):
        ref = _layer_slice(qparams[stack], l)
        got = _layer(tstack, l)
        assert set(got) == set(ref)
        for k, v in got.items():
            if tq.is_quantized(v):
                assert tuple(v["s"].shape) == (1, v["q"].shape[1])
                np.testing.assert_array_equal(v["q"].numpy(), np.asarray(ref[k]["q"]))
                np.testing.assert_array_equal(_tnp(v["s"]), _np(ref[k]["s"]))
            else:
                np.testing.assert_array_equal(v.numpy(), np.asarray(ref[k]))


def test_int8_silu_sees_the_rescaled_product(quantized_tree):
    """Under int8 the fused kernels' silu sees the rescaled product in
    the activation dtype, so `unrounded` does not change a quantized
    layer (in bf16, where it would)."""
    _, _, tree = quantized_tree
    tc = tcfg.DualARConfig(**KW)
    params = dual_ar_params_from_numpy(tree, dtype=torch.bfloat16)
    lp = _layer(params["slow"], 1)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 3, tc.dim)).astype(np.float32)).to(torch.bfloat16)
    attn = torch.from_numpy(rng.normal(size=(2, tc.n_head, 3, tc.head_dim)).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(_attn_out_ffn(x, attn, lp, tc, unrounded=True),
                       _attn_out_ffn(x, attn, lp, tc, unrounded=False))
