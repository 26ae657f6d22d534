"""One GEMM of the port's batched fast frame (`ops/fast_frame_batched.py::
rows_gemm`, the frame's `rows_gemm` kernel on its own): its plain version
against the JAX package's products in each mode (RMSNorm, then the f32
product for bf16 weights or `fish_speech_tpu/ops/quant.py::matmul` for
int8 ones, which the TPU kernels' `_wdot` mirrors, then the mode's
epilogue); its launch plan; the wrapper's dispatch rules; and, on a card
only, the CUDA kernel against its plain version and across row counts.

Tolerances, in bf16 ulps of the larger of the two values (in the
residual mode, of the larger of them and the added product, which may
cancel against the residual): the two sides sum the same products in
another order (and take the RMS in another order), so a bf16 rounding
may land one ulp apart; each later rounding (the int8 rescale, the
residual add, silu times the w3 product) may add one more. The float32
head is held to 1e-5 of its scale. On the card the kernel adds its
products on the tensor cores, whose f32 sums are not IEEE-rounded at
every step, so a sum that cancels may land further than an ulp of its
result from cuBLAS's: there each output is held to be as close to a
float32 evaluation (the plain version on float32 copies of the inputs,
int8 weights dequantized) as the plain version is, within a factor of 2
(chip_smoke.py's ACCURACY_FACTOR)."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops import quant as jq
from fish_speech_tpu.ops.norms import rms_norm as j_rms_norm
from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops import fast_frame_batched as fb

torch.set_num_threads(1)

EPS = 1e-6
# bf16 ulps allowed between two evaluations of one mode (see above)
ULPS = {("qkv", False): 1, ("qkv", True): 2, ("residual", False): 2, ("residual", True): 3,
        ("swiglu", False): 3, ("swiglu", True): 5}
# Fish-1.5's fast-layer GEMMs at dim 1024, ffn 4096, 16 + 2 x 2 heads
# of 64, codebook 1024: (mode, K, N) and the tiles x splits the plan
# must give them
FISH_GEMMS = {"wqkv": ("qkv", 1024, 1280, 20, 8), "wo": ("residual", 1024, 1024, 16, 8),
              "w1+w3": ("swiglu", 1024, 4096, 64, 2), "w2": ("residual", 4096, 1024, 16, 8),
              "head": ("head", 1024, 1024, 16, 8)}


# (mode, int8) cases: the head is always bf16
CASES = [(m, q) for m in ("qkv", "residual", "swiglu", "head") for q in (False, True)
         if not (m == "head" and q)]
GEMM_CASES = [(g, q) for g in FISH_GEMMS for q in (False, True)
              if not (FISH_GEMMS[g][0] == "head" and q)]


def _id(case):
    return f"{case[0]}-{'int8' if case[1] else 'bf16'}"


def n_ulps(got, ref, floor=0.0) -> float:
    """Largest distance in bf16 ulps of the larger magnitude of the two
    (and of `floor`, elementwise)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.maximum(np.abs(got), np.abs(ref)), np.abs(np.asarray(floor, np.float64)))
    ulp = np.where(mag > 0, np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7), 1.0)
    return float((np.abs(got - ref) / ulp).max())


def _inputs(mode, int8, nb, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, k)).astype(np.float32)
    norm_w = (1 + 0.1 * rng.normal(size=(k,))).astype(np.float32)
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    w_b = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    res = rng.normal(size=(nb, n)).astype(np.float32)
    return x, norm_w, w, w_b, res


def _jax_rows_gemm(mode, int8, x, norm_w, w, w_b, res):
    """The JAX package's functions: RMSNorm to bf16, then the product of
    the fused TPU kernels (f32 sum; int8: quant.matmul in bf16)."""
    bf = jnp.bfloat16
    xb = jnp.asarray(x, bf)
    h = xb if mode == "residual" else j_rms_norm(xb, jnp.asarray(norm_w, bf), EPS)

    def prod(wt):
        if int8:
            return jq.matmul(h, jq.quantize_weight(jnp.asarray(wt, bf))).astype(jnp.float32)
        return jnp.dot(h.astype(jnp.float32), jnp.asarray(wt, bf).astype(jnp.float32))

    y = prod(w)
    if mode == "qkv":
        return y.astype(bf)
    if mode == "residual":
        return jnp.asarray(res, bf) + y.astype(bf)
    if mode == "swiglu":
        return jax.nn.silu(y).astype(bf) * prod(w_b).astype(bf)
    return y


def _torch_weight(wt, int8):
    from fish_speech_tpu_torch.ops.quant import quantize_weight

    w = torch.from_numpy(wt).to(torch.bfloat16)
    return quantize_weight(w) if int8 else w


@pytest.mark.parametrize("mode,int8", CASES, ids=[_id(c) for c in CASES])
def test_plain_matches_jax(mode, int8):
    x, norm_w, w, w_b, res = _inputs(mode, int8, 5, 96, 48, seed=len(mode) + 10 * int8)
    ref = np.asarray(_jax_rows_gemm(mode, int8, x, norm_w, w, w_b, res).astype(jnp.float32))
    bf = torch.bfloat16
    out = torch.from_numpy(res).to(bf) if mode == "residual" else None
    got = fb.rows_gemm_plain(
        mode, torch.from_numpy(x).to(bf), _torch_weight(w, int8), torch.from_numpy(norm_w).to(bf),
        _torch_weight(w_b, int8) if mode == "swiglu" else None, EPS, out).float().numpy()
    assert got.shape == ref.shape == (5, 48)
    if mode == "head":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    else:
        added = ref - res if mode == "residual" else 0.0
        assert n_ulps(got, ref, added) <= ULPS[(mode, int8)]
    if mode == "residual":
        assert out.data_ptr() and torch.equal(out.float(), torch.from_numpy(got))  # in place


def test_int8_product_is_the_tpu_wdot():
    """The int8 product rounds the f32 sum to bf16, rescales by the
    column's bf16 scale in f32 and rounds again: bit-equal to JAX's
    quant.matmul on inputs whose f32 sums are exact."""
    rng = np.random.default_rng(3)
    h = rng.integers(-3, 4, size=(4, 32)).astype(np.float32)
    w = rng.normal(size=(32, 24)).astype(np.float32)
    wq = jq.quantize_weight(jnp.asarray(w, jnp.bfloat16))
    ref = np.asarray(jq.matmul(jnp.asarray(h, jnp.bfloat16), wq).astype(jnp.float32))
    tw = {"q": torch.from_numpy(np.asarray(wq["q"])),
          "s": torch.from_numpy(np.asarray(wq["s"].astype(jnp.float32))).to(torch.bfloat16)}
    got = fb._stack_product(torch.from_numpy(h).to(torch.bfloat16), tw).numpy()
    np.testing.assert_array_equal(got, ref)


# -- the launch plan ------------------------------------------------------------


def test_plan_takes_no_row_count():
    """The plan is a function of (K, N, mode, weight type) alone: no
    argument can carry the number of rows."""
    assert list(inspect.signature(fb.rows_plan).parameters) == ["k", "n", "mode", "int8"]


@pytest.mark.parametrize("gemm,int8", GEMM_CASES, ids=[_id(c) for c in GEMM_CASES])
def test_fish_gemms_fill_the_card(gemm, int8):
    """Every Fish-1.5 GEMM at B = 16 launches >= 128 blocks (132 SMs), as
    tiles x splits; a split is a cluster of <= 8 blocks; a block's shared
    memory fits in 227 KB and its K rows tile the whole of K."""
    mode, k, n, tiles, splits = FISH_GEMMS[gemm]
    plan = fb.rows_plan(k, n, mode, int8)
    assert (plan.blocks // plan.splits, plan.splits) == (tiles, splits)
    assert plan.blocks >= 128 and plan.splits <= 8
    assert plan.smem <= fb.SMEM_LIMIT
    assert plan.k_per_split % 16 == 0 and plan.k_per_split * plan.splits >= k
    assert (plan.k_per_split - 16) * plan.splits < k  # no split left empty


@pytest.mark.parametrize("k,n", [(64, 8), (512, 768), (1000, 1032), (8192, 1024), (16, 4096)])
def test_plan_bounds_at_other_widths(k, n):
    for mode in fb.ROWS_MODES:
        plan = fb.rows_plan(k, n, mode, False)
        assert 1 <= plan.splits <= 8 and plan.splits & (plan.splits - 1) == 0
        assert plan.smem <= fb.SMEM_LIMIT
        assert plan.k_per_split * plan.splits >= k
        assert plan == fb.rows_plan(k, n, mode, False)


# -- dispatch rules -------------------------------------------------------------


class _CudaLooking(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cpu_runs_plain_and_counts_no_launch(monkeypatch):
    def fail(*args, **kwargs):
        raise AssertionError("no library on the CPU")

    monkeypatch.setattr(_cuda_build, "load_library", fail)
    before = fb.rows_gemm_launches
    x = torch.ones(2, 16, dtype=torch.bfloat16)
    got = fb.rows_gemm("head", x, torch.ones(16, 8, dtype=torch.bfloat16),
                       torch.ones(16, dtype=torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (2, 8)
    assert fb.rows_gemm_launches == before


def test_cuda_tensor_without_library_raises(monkeypatch):
    def no_library():
        raise RuntimeError("nvcc not found")

    def fail(*args, **kwargs):
        raise AssertionError("a CUDA tensor must not fall back to the plain version")

    monkeypatch.setattr(_cuda_build, "load_library", no_library)
    monkeypatch.setattr(fb, "rows_gemm_plain", fail)
    x = torch.ones(2, 16, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    before = fb.rows_gemm_launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fb.rows_gemm("qkv", x, torch.ones(16, 8, dtype=torch.bfloat16),
                     torch.ones(16, dtype=torch.bfloat16))
    assert fb.rows_gemm_launches == before


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_args(mode, int8, nb, k, n, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731

    def weight():
        from fish_speech_tpu_torch.ops.quant import quantize_weight

        w = (rnd(k, n) / k**0.5).to(torch.bfloat16)
        return quantize_weight(w) if int8 else w

    x = rnd(nb, k).to(torch.bfloat16)
    norm_w = (1 + 0.1 * rnd(k)).to(torch.bfloat16)
    res = rnd(nb, n).to(torch.bfloat16)
    return x, weight(), norm_w, weight() if mode == "swiglu" else None, res


def _run(fn, mode, x, w, norm_w, w_b, res):
    out = res.clone() if mode == "residual" else None
    return fn(mode, x, w, norm_w, w_b, EPS, out)


@pytest.mark.cuda
@pytest.mark.parametrize("gemm,int8", GEMM_CASES, ids=[_id(c) for c in GEMM_CASES])
def test_kernel_matches_plain_on_card(cuda_device, gemm, int8):
    """Each Fish-1.5 GEMM at B = 16: the kernel's largest distance to the
    float32 evaluation within twice the plain version's; the plan the
    kernel launches with is rows_plan's."""
    from fish_speech_tpu_torch.ops.quant import dequantize_weight, is_quantized

    mode, k, n, _, _ = FISH_GEMMS[gemm]
    assert fb.rows_plan_on_card(k, n, mode, int8) == fb.rows_plan(k, n, mode, int8)
    args = _card_args(mode, int8, 16, k, n, cuda_device, seed=k + n)
    got = _run(fb.rows_gemm, mode, *args)
    plain = _run(fb.rows_gemm_plain, mode, *args)
    f32 = lambda t: None if t is None else (  # noqa: E731
        dequantize_weight(t) if is_quantized(t) else t.float())
    ref = _run(fb.rows_gemm_plain, mode, *(f32(a) for a in args))
    torch.cuda.synchronize()
    err_k = float((got.float() - ref).abs().max())
    err_p = float((plain.float() - ref).abs().max())
    assert err_k <= 2.0 * err_p + 1e-6, (err_k, err_p)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,int8", CASES, ids=[_id(c) for c in CASES])
def test_row_bits_do_not_depend_on_co_tenants(cuda_device, mode, int8):
    """Rows 0..nb-1 of a 32-row input give the same bits run as nb = 1,
    4, 16 and 32 rows: the plan and every sum's order ignore the row
    count."""
    x, w, norm_w, w_b, res = _card_args(mode, int8, 32, 1024, 1280, cuda_device, seed=7)
    full = _run(fb.rows_gemm, mode, x, w, norm_w, w_b, res)
    for nb in (1, 4, 16):
        part = _run(fb.rows_gemm, mode, x[:nb].contiguous(), w, norm_w, w_b,
                    res[:nb].contiguous())
        assert torch.equal(part, full[:nb]), nb
