"""Flash prefill attention on the tensor cores: the launch plan's
coverage on the CPU (`prefill_plan` and `cta_work` mirror
`csrc/prefill_attention.cu`'s index arithmetic), the plain version
against the JAX package at the real group size, and, on a card only, the
kernel against its plain version at the long and prefix-reuse shapes
with its contract (repeat, CUDA-graph replay and row-alone bit-equality,
the launch count, the plan and every CTA's work as built equal to their
mirrors).

Tolerances: 1e-5 absolute on the CPU (float32, the same arithmetic summed
in another order). On the card, as `chip_smoke.py` holds the kernel:
2e-2 absolute + 2e-2 relative against the plain version (the kernel
rounds the unnormalised weights to bf16, as the TPU kernel does, the
plain version the normalised ones); and, since a query that sees
thousands of keys has outputs of a few hundredths, each (head, query)
row's relative distance to a float32 evaluation of the same function,
at its largest, within ACCURACY_FACTOR of the plain version's."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fish_speech_tpu.ops.attention import NEG_INF, gqa_attention
from fish_speech_tpu.ops.prefill_pallas import flash_prefill_attention, flash_prefill_supported
from fish_speech_tpu_torch.ops import prefill_attention as pa

torch.set_num_threads(1)
TOL = 1e-5
ACCURACY_FACTOR = 2.0
H, KV, HD = 16, 2, 64  # Fish-1.5's slow stack: one KV head a group of 8 q heads
SMS = 132


def _t(a):
    return torch.from_numpy(np.array(a))


# -- the launch plan --------------------------------------------------------------


def test_plan_takes_only_shapes():
    """No argument can carry the batch, the offset, the window or the
    rows' lengths."""
    assert list(inspect.signature(pa.prefill_plan).parameters) == [
        "s_pad", "kv_len", "n_head", "n_kv", "sms"]


def _visible_range(i, offset, lim, window):
    """Keys [lo, hi] query i sees (empty when lo > hi)."""
    return max(0, offset + i - window + 1), min(offset + i, lim - 1)


COVERAGE_SHAPES = [
    (1, 1, 0), (40, 40, 0), (40, 77, 37), (64, 64, 0), (100, 137, 37), (512, 512, 0),
    (512, 549, 37), (2048, 2048, 0), (4096, 4096, 0), (128, 2048, 1920),
]


def _coverage_lens(s_pad, kv_len, offset):
    """Three rows: full, ragged, empty."""
    return [min(s_pad, kv_len - offset), max(1, s_pad // 3), 0]


@pytest.mark.parametrize("window", [4096, 300, 258])
@pytest.mark.parametrize("s_pad,kv_len,offset", COVERAGE_SHAPES)
def test_plan_covers_every_row_and_visible_tile_once(s_pad, kv_len, offset, window):
    """Over the grid of 3 rows (full, ragged, empty): each (row, q head,
    query) belongs to exactly one query block; the chunks of a block's
    CTAs partition its tiles, each at most `chunk` long; every key a valid
    or padding query sees lies in one of its block's tiles."""
    lens = _coverage_lens(s_pad, kv_len, offset)
    plan = pa.prefill_plan(s_pad, kv_len, H, KV, SMS)
    g_size = H // KV
    assert plan.queries * g_size == plan.rows
    work = pa.cta_work(plan, len(lens), KV, s_pad, kv_len, offset, lens, window)
    assert len({w[:4] for w in work}) == len(work) == len(lens) * plan.ctas  # one CTA an item
    seen_rows = np.zeros((len(lens), H, s_pad), np.int64)
    chunks = {}
    for b, g, qb, sp, t0, n, ts, nt in work:
        assert 0 <= b < len(lens) and 0 <= g < KV and 0 <= qb < plan.qblocks
        assert 0 <= sp < plan.splits
        if sp == 0:
            seen_rows[b, g * g_size:(g + 1) * g_size,
                      qb * plan.queries:(qb + 1) * plan.queries] += 1
        assert 0 <= nt <= plan.chunk
        chunks.setdefault((b, g, qb), {})[sp] = (range(t0, t0 + n), range(ts, ts + nt))
    assert (seen_rows == 1).all()
    for (b, g, qb), by_split in chunks.items():
        assert sorted(by_split) == list(range(plan.splits))
        block = by_split[0][0]
        assert all(by_split[sp][0] == block for sp in by_split)
        walked = [t for sp in range(plan.splits) for t in by_split[sp][1]]
        assert walked == list(block)  # once each, in order
        lim = min(kv_len, offset + lens[b])
        for i in range(qb * plan.queries, min((qb + 1) * plan.queries, s_pad)):
            lo, hi = _visible_range(i, offset, lim, window)
            if lo <= hi:
                assert block.start <= lo // plan.block_n and hi // plan.block_n < block.stop


@pytest.mark.parametrize("s_pad,kv_len", [(64, 64), (512, 512), (2048, 2048), (4096, 4096),
                                          (128, 2048)])
def test_plan_at_the_timed_shapes(s_pad, kv_len):
    """What the card runs at the shapes `chip_smoke.py` times: the main
    path's 64 bucket in 8 CTAs; 2048-4096 keys unsplit; the prefix-reuse
    shape split 8 ways (128 CTAs for 16 query blocks); at most 8 splits
    and a ring of 4 stages of 64-key tiles."""
    plan = pa.prefill_plan(s_pad, kv_len, H, KV, SMS)
    assert plan.queries == 16 and plan.rows == 128 and plan.block_n == 64 and plan.stages == 4
    assert plan.splits * plan.chunk >= -(-kv_len // 64) and plan.splits <= 8
    want = {(64, 64): (1, 8), (2048, 2048): (1, 256), (4096, 4096): (1, 512),
            (128, 2048): (8, 128)}
    if (s_pad, kv_len) in want:
        assert (plan.splits, plan.ctas) == want[(s_pad, kv_len)]
    assert plan.smem <= 232448 // 2  # two CTAs an SM


@pytest.mark.parametrize("n_head,n_kv,ok", [(16, 2, True), (4, 2, True), (16, 16, True),
                                            (64, 1, True), (128, 1, False), (16, 3, False)])
def test_supported_head_groupings(n_head, n_kv, ok):
    assert pa.prefill_supported(n_head, n_kv) == ok


# -- the plain version against the JAX package ----------------------------------------


def _xla_prefill(q, k, v, offset, seq_lens, window):
    """The mask construction of fish_speech_tpu/models/dual_ar.py::slow_prefill,
    the JAX package's path for shapes its flash kernel does not take."""
    _, _, s, hd = q.shape
    e = k.shape[2]
    q_pos = offset + jnp.arange(s)[:, None]
    k_pos = jnp.arange(e)[None, :]
    causal = (k_pos <= q_pos) & (q_pos - k_pos < window)
    allowed = causal[None] & (k_pos < (offset + seq_lens[:, None]))[:, None, :]
    mask = jnp.where(allowed, 0.0, NEG_INF).astype(jnp.float32)[:, None]
    return gqa_attention(q, k, v, mask, 1.0 / hd**0.5)


def _inputs(b, s, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, H, s, HD)).astype(np.float32),
            rng.normal(size=(b, KV, e, HD)).astype(np.float32),
            rng.normal(size=(b, KV, e, HD)).astype(np.float32))


@pytest.mark.parametrize("s,e,offset", [(300, 337, 37), (256, 512, 37)])
def test_plain_matches_flash_interpret_at_group_size(s, e, offset):
    """H 16, KV 2, hd 64, ragged lengths (full, ragged, one token). The
    TPU kernel's grid covers S_pad // 256 * 256 queries (it takes S_pad
    300 for no engine shape: `flash_prefill_supported` is False there and
    the JAX engine runs its XLA path), so rows below that are held to the
    Pallas kernel in interpret mode and every valid row to the XLA path."""
    q, k, v = _inputs(3, s, e, 7)
    lens = np.asarray([s, (2 * s) // 3, 1], np.int32)
    jq, jk, jv, jl = (jnp.asarray(a) for a in (q, k, v, lens))
    flash = np.asarray(flash_prefill_attention(jq, jk, jv, offset, jl, window=4096,
                                               interpret=True))
    xla = np.asarray(_xla_prefill(jq, jk, jv, offset, jl, 4096))
    got = pa.prefill_attention(_t(q), _t(k), _t(v), offset, _t(lens), 4096).numpy()
    assert np.isfinite(got).all()
    covered = s // 256 * 256 if not flash_prefill_supported(s, e, H, KV, HD) else s
    for row, n in enumerate(lens):
        np.testing.assert_allclose(got[row, :, :min(n, covered)], flash[row, :, :min(n, covered)],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[row, :, :n], xla[row, :, :n], rtol=TOL, atol=TOL)


def test_plain_window_edge_matches_xla():
    """A window shorter than the extent (300 of 512 keys)."""
    q, k, v = _inputs(2, 96, 512, 8)
    lens = np.asarray([96, 50], np.int32)
    ref = np.asarray(_xla_prefill(*(jnp.asarray(a) for a in (q, k, v)), 416, jnp.asarray(lens),
                                  300))
    got = pa.prefill_attention(_t(q), _t(k), _t(v), 416, _t(lens), 300).numpy()
    for row, n in enumerate(lens):
        np.testing.assert_allclose(got[row, :, :n], ref[row, :, :n], rtol=TOL, atol=TOL)


# -- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(dev, b, s_pad, e, seed, cache=4096):
    """q and k/v as views of cache-shaped buffers, as on the main path."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    ck, cv = rnd(b, KV, cache, HD), rnd(b, KV, cache, HD)
    return rnd(b, H, s_pad, HD), ck[:, :, :e], cv[:, :, :e]


def _row_rel_err(got, ref32):
    """Largest ||got - ref|| / ||ref|| over the (head, query) rows."""
    diff = (got.float() - ref32).norm(dim=-1)
    return float((diff / ref32.norm(dim=-1)).max())


def _assert_valid_rows_close(got, ref, ref32, lens):
    assert torch.isfinite(got.float()).all()
    for b, n in enumerate(lens):
        if n == 0:
            continue
        torch.testing.assert_close(got[b, :, :n].float(), ref[b, :, :n].float(),
                                   atol=2e-2, rtol=2e-2)
        rel_k = _row_rel_err(got[b, :, :n], ref32[b, :, :n])
        rel_p = _row_rel_err(ref[b, :, :n], ref32[b, :, :n])
        assert rel_k <= ACCURACY_FACTOR * rel_p + 1e-6, (b, rel_k, rel_p)


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,e,offset,lens,window", [
    (2048, 2048, 0, (2048, 2000), 4096),
    (4096, 4096, 0, (4096,), 4096),
    (128, 2048, 1920, (100, 128), 4096),
    (512, 512, 0, (512, 341), 300),
    (128, 2048, 1920, (128, 1, 0), 4096),
    (64, 64, 0, (40, 1, 0), 4096),
])
def test_kernel_matches_plain_on_card(cuda_device, s_pad, e, offset, lens, window):
    """The long, prefix-reuse and window shapes, and rows of length 1 and
    0 beside a full one: valid rows within 2e-2 of the plain version and
    as close to the float32 evaluation as it is, every output finite; two
    launches a call where the plan splits keys, else one."""
    q, k, v = _card_inputs(cuda_device, len(lens), s_pad, e, s_pad + offset)
    sl = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    before = pa.launches
    got = pa.prefill_attention(q, k, v, offset, sl, window)
    assert pa.launches - before == (2 if pa.prefill_plan(s_pad, e, H, KV, sms).splits > 1 else 1)
    ref = pa.prefill_attention_plain(q, k, v, offset, sl, window)
    ref32 = pa.prefill_attention_plain(q.float(), k.float(), v.float(), offset, sl, window)
    _assert_valid_rows_close(got, ref, ref32, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,e,offset", [(128, 2048, 1920), (1024, 1024, 0)])
def test_kernel_repeat_graph_and_row_alone_on_card(cuda_device, s_pad, e, offset):
    """Five calls bit-identical; a CUDA graph's replay equal to the eager
    call; row 1 prefilled alone bit-equal to row 1 among two."""
    q, k, v = _card_inputs(cuda_device, 2, s_pad, e, 5)
    sl = torch.tensor([s_pad - 28, s_pad // 2], dtype=torch.int32, device=cuda_device)
    first = pa.prefill_attention(q, k, v, offset, sl, 4096)
    for _ in range(4):
        assert torch.equal(pa.prefill_attention(q, k, v, offset, sl, 4096), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pa.prefill_attention(q, k, v, offset, sl, 4096)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pa.prefill_attention(q, k, v, offset, sl, 4096)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, first)
    alone = pa.prefill_attention(q[1:].clone(), k[1:].clone(), v[1:].clone(), offset,
                                 sl[1:].clone(), 4096)
    assert torch.equal(alone, first[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad,e", [(64, 64), (512, 512), (2048, 2048), (4096, 4096),
                                     (128, 2048), (100, 137)])
def test_plan_on_card_equals_mirror(cuda_device, s_pad, e):
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert pa.plan_on_card(s_pad, e, H, KV, sms) == pa.prefill_plan(s_pad, e, H, KV, sms)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [4096, 300])
@pytest.mark.parametrize("s_pad,kv_len,offset", COVERAGE_SHAPES)
def test_cta_work_on_card_equals_mirror(cuda_device, s_pad, kv_len, offset, window):
    """Every CTA's (row, KV head, query block, split, block tiles, chunk)
    from the kernel's own index arithmetic equals `cta_work`'s, so the
    coverage test above holds for the kernel."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lens = _coverage_lens(s_pad, kv_len, offset)
    plan = pa.prefill_plan(s_pad, kv_len, H, KV, sms)
    assert pa.cta_work_on_card(s_pad, kv_len, H, KV, sms, offset, lens, window) == pa.cta_work(
        plan, len(lens), KV, s_pad, kv_len, offset, lens, window)
