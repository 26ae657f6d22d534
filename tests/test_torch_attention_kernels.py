"""The port's two attention kernels: plain versions against the JAX
package's TPU kernels (run in interpret mode, as tests/test_pallas.py
and tests/test_prefill_flash.py run them) and the XLA path; the CUDA
wrappers' dispatch rules; and, on a card only, each CUDA kernel against
its plain version.

Tolerances (float32 on the CPU): 1e-5 absolute for attention outputs,
the same arithmetic summed in another order; the decode caches must be
exactly equal. On the card (bf16): one bf16 ulp of slack, see each test."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops.attention import NEG_INF, gqa_attention
from fish_speech_tpu.ops.attention_pallas import fused_decode_attention
from fish_speech_tpu.ops.prefill_pallas import flash_prefill_attention
from fish_speech_tpu_torch.ops import _cuda_build
from fish_speech_tpu_torch.ops import decode_attention as da
from fish_speech_tpu_torch.ops import prefill_attention as pa

torch.set_num_threads(1)
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("b,h,kv,s,layer,pos", [
    (2, 8, 2, 64, 2, (5, 37)),
    (1, 4, 1, 16, 0, (15,)),
    (3, 4, 4, 32, 1, (0, 31, 7)),
])
def test_decode_plain_matches_pallas_interpret(b, h, kv, s, layer, pos):
    rng = np.random.default_rng(0)
    hd, n_layer = 16, 3
    q, kn, vn = (rng.normal(size=sh).astype(np.float32)
                 for sh in [(b, h, hd), (b, kv, hd), (b, kv, hd)])
    ck, cv = (rng.normal(size=(n_layer, b, kv, s, hd)).astype(np.float32) for _ in range(2))
    p = np.asarray(pos, np.int32)
    ja, jk, jv = fused_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(p),
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(layer), interpret=True)
    tck, tcv = _t(ck), _t(cv)
    ta = da.decode_attention(_t(q), _t(kn), _t(vn), _t(p), tck, tcv, layer)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tck.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(jv))


def _xla_prefill(q, k, v, offset, seq_lens, window):
    """The mask construction of fish_speech_tpu/models/dual_ar.py::slow_prefill."""
    _, _, s, hd = q.shape
    e = k.shape[2]
    q_pos = offset + jnp.arange(s)[:, None]
    k_pos = jnp.arange(e)[None, :]
    causal = (k_pos <= q_pos) & (q_pos - k_pos < window)
    allowed = causal[None] & (k_pos < (offset + seq_lens[:, None]))[:, None, :]
    mask = jnp.where(allowed, 0.0, NEG_INF).astype(jnp.float32)[:, None]
    return gqa_attention(q, k, v, mask, 1.0 / hd**0.5)


def _prefill_inputs(b, h, kv, s, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, 16)).astype(np.float32),
            rng.normal(size=(b, kv, e, 16)).astype(np.float32),
            rng.normal(size=(b, kv, e, 16)).astype(np.float32))


def test_prefill_plain_matches_flash_interpret():
    q, k, v = _prefill_inputs(2, 4, 2, 16, 32, 1)
    lens = np.asarray([16, 11], np.int32)
    ref = flash_prefill_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 5,
                                  jnp.asarray(lens), window=64, interpret=True)
    got = pa.prefill_attention(_t(q), _t(k), _t(v), 5, _t(lens), 64)
    for row, n in enumerate(lens):  # right-pad rows are discarded by the caller
        np.testing.assert_allclose(got[row, :, :n].numpy(), np.asarray(ref)[row, :, :n],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s,e,offset,lens,window", [
    (13, 29, 9, (13, 4, 1), 64),
    (20, 20, 0, (20, 17, 3), 64),
    (8, 40, 31, (8, 2, 5), 12),
])
def test_prefill_plain_matches_xla_ragged(s, e, offset, lens, window):
    q, k, v = _prefill_inputs(len(lens), 4, 2, s, e, 2)
    lens = np.asarray(lens, np.int32)
    ref = np.asarray(_xla_prefill(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), offset,
                                  jnp.asarray(lens), window))
    got = pa.prefill_attention(_t(q), _t(k), _t(v), offset, _t(lens), window).numpy()
    assert np.isfinite(got).all()
    for row, n in enumerate(lens):
        np.testing.assert_allclose(got[row, :, :n], ref[row, :, :n], rtol=TOL, atol=TOL)


# -- the decode kernel's launch plan -------------------------------------------


def test_decode_plan_takes_only_the_cache_length():
    """The plan is a function of S alone: no argument can carry the
    batch, the rows' positions or a device-side pos."""
    assert list(inspect.signature(da.decode_plan).parameters) == ["cache_len"]


@pytest.mark.parametrize("s", [1, 16, 64, 100, 129, 512, 1000, 2048, 4096])
def test_decode_plan_bounds(s):
    """P is a power of two <= 8 (the portable cluster size) and takes
    the whole cache; a block's shared memory does not grow with S."""
    plan = da.decode_plan(s)
    assert 1 <= plan.cluster <= 8 and plan.cluster & (plan.cluster - 1) == 0
    assert s <= plan.max_cache
    assert plan == da.decode_plan(s)
    assert da.decode_smem_bytes(8) <= min(48 * 1024, da.SMEM_LIMIT)  # static, any S


def test_decode_plan_at_the_main_shapes():
    """Serving (B = 16, cache 512, 2 KV heads) launches >= 128 blocks; the
    batch-1 cache of 4096 takes clusters of 8; the new cache-length rule
    accepts S = 4096 at G = 8 (the old one capped S by G x S floats of
    shared memory) and refuses what the kernel cannot hold."""
    assert da.decode_plan(512).cluster == 4
    assert da.decode_plan(512).blocks(16, 2) >= 128
    assert da.decode_plan(4096).cluster == 8
    assert da.decode_plan(4096).blocks(1, 2) == 16
    assert da.decode_supported(4096, 8)
    assert da.decode_supported(512, 8) and da.decode_supported(64, 1)
    assert not da.decode_supported(4097, 8)
    assert not da.decode_supported(4096, 16)


# -- dispatch rules of the wrappers -------------------------------------------


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, to reach the CUDA branch
    of a wrapper without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fail_plain(*args, **kwargs):
    raise AssertionError("a CUDA tensor must not fall back to the plain version")


@pytest.mark.parametrize("wrapper", ["decode", "prefill"])
def test_cuda_tensor_without_library_raises(wrapper, monkeypatch):
    def no_library():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_cuda_build, "load_library", no_library)
    monkeypatch.setattr(da, "decode_attention_plain", _fail_plain)
    monkeypatch.setattr(pa, "prefill_attention_plain", _fail_plain)
    q = torch.zeros(1, 16, 64, dtype=torch.bfloat16).as_subclass(_CudaLooking)
    before = (da.launches, pa.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if wrapper == "decode":
            da.decode_attention(q, None, None, None, None, None, 0)
        else:
            pa.prefill_attention(q, None, None, 0, None, 4096)
    assert (da.launches, pa.launches) == before


def test_cpu_tensors_run_plain_and_count_no_launch():
    before = (da.launches, pa.launches)
    q, k, v = (torch.zeros(1, 2, 3, 16), torch.zeros(1, 1, 3, 16), torch.zeros(1, 1, 3, 16))
    pa.prefill_attention(q, k, v, 0, torch.tensor([3], dtype=torch.int32), 8)
    ck = torch.zeros(1, 1, 1, 4, 16)
    da.decode_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], torch.tensor([1], dtype=torch.int32),
                        ck, ck.clone(), 0)
    assert (da.launches, pa.launches) == before


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.build()


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 1, 63, 1024, 4095])
def test_decode_kernel_matches_plain_on_card(cuda_device, pos):
    """Cache bit-equal; attn within one bf16 ulp (1e-2 abs + 1e-2 rel)."""
    g = torch.Generator(device=cuda_device).manual_seed(pos)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(torch.bfloat16)  # noqa: E731
    q, kn, vn = rnd(1, 16, 64), rnd(1, 2, 64), rnd(1, 2, 64)
    ck, cv = rnd(4, 1, 2, 4096, 64), rnd(4, 1, 2, 4096, 64)
    p = torch.tensor([pos], dtype=torch.int32, device=cuda_device)
    ck2, cv2 = ck.clone(), cv.clone()
    got = da.decode_attention(q, kn, vn, p, ck, cv, 3)
    ref = da.decode_attention_plain(q, kn, vn, p, ck2, cv2, 3)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,offset", [(64, 0), (100, 37), (512, 0)])
def test_prefill_kernel_matches_plain_on_card(cuda_device, s_pad, offset):
    """Valid rows within 2e-2 abs + 2e-2 rel (bf16 weights rounded at
    another point); every output finite."""
    g = torch.Generator(device=cuda_device).manual_seed(s_pad + offset)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda_device).to(torch.bfloat16)  # noqa: E731
    e = offset + s_pad
    q, ck, cv = rnd(2, 16, s_pad, 64), rnd(2, 2, 4096, 64), rnd(2, 2, 4096, 64)
    lens = [s_pad, (2 * s_pad) // 3]
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    got = pa.prefill_attention(q, ck[:, :, :e], cv[:, :, :e], offset, sl, 4096)
    ref = pa.prefill_attention_plain(q, ck[:, :, :e], cv[:, :, :e], offset, sl, 4096)
    assert torch.isfinite(got.float()).all()
    for b, n in enumerate(lens):
        torch.testing.assert_close(got[b, :, :n].float(), ref[b, :, :n].float(),
                                   atol=2e-2, rtol=2e-2)


def _serving_inputs(dev, seed, b=16, s=512, n_layer=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    pos = torch.randint(39, 168, (b,), generator=g, device=dev, dtype=torch.int32)
    return (rnd(b, 16, 64), rnd(b, 2, 64), rnd(b, 2, 64), pos,
            rnd(n_layer, b, 2, s, 64), rnd(n_layer, b, 2, s, 64))


@pytest.mark.cuda
def test_decode_kernel_matches_plain_at_serving_shape(cuda_device):
    """B = 16, cache 512, a ragged pos per row (39..167, as serving
    has): cache bit-equal, attn within one bf16 ulp as above."""
    q, kn, vn, p, ck, cv = _serving_inputs(cuda_device, 11)
    ck2, cv2 = ck.clone(), cv.clone()
    got = da.decode_attention(q, kn, vn, p, ck, cv, 2)
    ref = da.decode_attention_plain(q, kn, vn, p, ck2, cv2, 2)
    assert torch.equal(ck, ck2) and torch.equal(cv, cv2)
    torch.testing.assert_close(got.float(), ref.float(), atol=1e-2, rtol=1e-2)


@pytest.mark.cuda
def test_decode_row_bits_alone_and_among_16(cuda_device):
    """A row's attn is bit-equal run alone and among 16 rows with other
    positions: the plan and every sum's order depend on S and the row's
    own pos only."""
    q, kn, vn, p, ck, cv = _serving_inputs(cuda_device, 12)
    full = da.decode_attention(q, kn, vn, p, ck.clone(), cv.clone(), 1)
    for row in (0, 7, 15):
        sl = slice(row, row + 1)
        alone = da.decode_attention(q[sl].clone(), kn[sl].clone(), vn[sl].clone(),
                                    p[sl].clone(), ck[:, sl].clone(), cv[:, sl].clone(), 1)
        assert torch.equal(alone, full[sl]), row
