"""The plan of the persistent decode kernel (`ops/decode_stack.py::
stack_plan`, the mirror of `csrc/decode_stack.cuh::ds_make_plan`) at
Fish-1.5 width and at the card tests' small configs, on the CPU: every
weight element of each phase belongs to exactly one work unit, the units
cover all of K and N, a block's shared memory fits the card, a layer has
at most three grid syncs, and the plan depends on the shapes, the weight
type and the grid alone (never on the batch or the data). The card tests
in tests/test_torch_{slow_step,fast_frame}.py hold the built kernel's plan
equal to this one."""

import inspect

import numpy as np
import pytest

from fish_speech_tpu_torch.config import DualARConfig
from fish_speech_tpu_torch.ops import decode_stack as ds
from fish_speech_tpu_torch.ops import fast_frame as ff
from fish_speech_tpu_torch.ops import slow_step as ss

FISH = DualARConfig.fish_speech_1_5()
# (kind, D, H, KV, F, head columns, cache length): the slow step and the
# fast frame at Fish-1.5 width, and the small configs of the card tests
SHAPES = {
    "fish15_slow": (ds.SLOW, FISH.dim, FISH.n_head, FISH.n_local_heads, FISH.intermediate_size,
                    FISH.codebook_size + 1, FISH.max_seq_len),
    "fish15_fast": (ds.FAST, FISH.dim, FISH.n_head, FISH.n_local_heads, FISH.intermediate_size,
                    FISH.codebook_size, FISH.num_codebooks),
    "card_slow": (ds.SLOW, 512, 8, 2, 1024, 33, 256),
    "card_fast": (ds.FAST, 512, 8, 2, 1024, 512, 8),
    "small_slow": (ds.SLOW, 256, 4, 2, 128, 33, 32),
}
GRIDS = (ds.H100_SMS, 114)  # H100 SXM, and the PCIe part's SM count


def _coverage(plan, d, n_head, kv, f):
    """How often each weight element of each matrix is streamed by some
    block's segments."""
    qkv = (n_head + 2 * kv) * ds.HEAD_DIM
    cover = {"wqkv": np.zeros((d, qkv), np.int32), "wo": np.zeros((d, d), np.int32),
             "w1": np.zeros((d, f), np.int32), "w3": np.zeros((d, f), np.int32),
             "w2": np.zeros((f, d), np.int32)}
    for block in range(plan.grid):
        for mat, row0, col0, rows, cpr, pieces in plan.segments(block):
            cols = cpr * 8
            assert rows * cpr % ds.THREADS == 0  # every thread takes whole pieces
            assert pieces * ds.THREADS == rows * cpr * (2 if mat == "w13" else 1)
            for m in (("w1", "w3") if mat == "w13" else (mat,)):
                cover[m][row0:row0 + rows, col0:col0 + cols] += 1
    return cover


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_every_weight_element_in_one_unit(shape, int8, grid):
    kind, d, n_head, kv, f, head_n, cache = SHAPES[shape]
    plan = ds.stack_plan(kind, d, n_head, kv, f, head_n, cache, int8, grid)
    assert plan is not None
    for name, c in _coverage(plan, d, n_head, kv, f).items():
        assert (c == 1).all(), (name, int(c.min()), int(c.max()))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_units_cover_k_and_n(shape, int8, grid):
    """QKV tiles x K-splits and head tiles x K-splits cover (K, N); the
    attention blocks cover every head and all of wo's columns; the F
    slices cover F; lines are whole 128 bytes where the widths allow."""
    kind, d, n_head, kv, f, head_n, cache = SHAPES[shape]
    p = ds.stack_plan(kind, d, n_head, kv, f, head_n, cache, int8, grid)
    qkv = (n_head + 2 * kv) * ds.HEAD_DIM
    for tiles, cols, splits, klen, units, n in (
            (p.qkv_tiles, p.qkv_cols, p.qkv_splits, p.qkv_klen, p.qkv_units, qkv),
            (p.head_tiles, ds.TILE, p.head_splits, p.head_klen, p.head_units, head_n)):
        assert units == tiles * splits
        assert (tiles - 1) * cols < n <= tiles * cols
        assert (splits - 1) * klen < d <= splits * klen and klen % 32 == 0
    assert p.qkv_cols * p.piece_bytes // 8 == 128  # whole lines a row
    assert p.attn_units == n_head * p.q_blocks and p.wo_cols * p.q_blocks == d
    assert p.kv_ranks == p.q_blocks
    assert p.sw_units == f // p.sw_cols * p.sw_split and p.sw_cols * p.piece_bytes // 8 == 128
    assert p.sw_units <= grid or p.sw_split == 1
    assert p.x_tiles * 8 == d and p.owners == min(p.x_tiles, grid)


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fits_an_sm_and_syncs_per_layer(shape, int8, grid):
    kind, d, n_head, kv, f, head_n, cache = SHAPES[shape]
    p = ds.stack_plan(kind, d, n_head, kv, f, head_n, cache, int8, grid)
    assert p.smem <= ds.SMEM_LIMIT == 232448
    assert p.stages >= 2 and p.stages * ds.THREADS * p.piece_bytes < p.smem
    assert p.syncs_per_layer <= 3
    if kind == ds.SLOW:
        assert p.syncs_per_call(kind, 24) == p.syncs_per_launch(kind, 24) == 24 * 3 + 1
    else:  # a launch a codebook step; its head's partials go to the sampler launch
        assert p.syncs_per_call(kind, 4, 8) == 8 * p.syncs_per_launch(kind, 4) == 8 * 4 * 3


@pytest.mark.parametrize("int8", [False, True])
def test_plan_depends_on_no_batch_or_data(int8):
    """The plan takes shapes, the weight type and the grid only; the
    wrappers ask it the same for every batch of 1..4, and the scratch it
    sizes is for the most rows the kernel takes."""
    params = set(inspect.signature(ds.stack_plan).parameters)
    assert params == {"kind", "d", "n_head", "kv", "f", "head_n", "cache_len", "int8", "grid"}
    plans = {b: ss.slow_plan(FISH, FISH.codebook_size + 1, FISH.max_seq_len, int8,
                             ds.H100_SMS) for b in range(1, ss.MAX_BATCH + 1)}
    assert len(set(plans.values())) == 1
    assert ss.MAX_BATCH == ds.MAX_ROWS
    fast = ff.fast_plan(FISH, int8, ds.H100_SMS)
    assert fast == ds.stack_plan(ds.FAST, FISH.dim, FISH.n_head, FISH.n_local_heads,
                                 FISH.intermediate_size, FISH.codebook_size,
                                 FISH.num_codebooks, int8, ds.H100_SMS)


@pytest.mark.parametrize("case,ok", [
    ({}, True),
    ({"dim": 768, "n_head": 12}, False),  # a width outside DIMS
    ({"intermediate_size": 4096 + 32}, False),  # ffn not a multiple of 64
    ({"n_head": 15}, False),  # H * 64 != D
])
def test_plan_states_the_limits(case, ok):
    cfg = DualARConfig(**{**FISH.__dict__, **case}) if case else FISH
    plan = ds.stack_plan(ds.SLOW, cfg.dim, cfg.n_head, cfg.n_local_heads, cfg.intermediate_size,
                         cfg.codebook_size + 1, cfg.max_seq_len, False, ds.H100_SMS)
    assert (plan is not None) == ok


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_attention_splits_over_keys_past_the_threshold(shape):
    """Rows whose keys span more than SPLIT_TILES tiles have their
    attention split over the head's blocks: two exchanges a layer on the
    head's counter; shorter rows (every fast-frame row) none. The sync
    state holds every counter and the two count words."""
    kind, d, n_head, kv, f, head_n, cache = SHAPES[shape]
    p = ds.stack_plan(kind, d, n_head, kv, f, head_n, cache, False, ds.H100_SMS)
    last_local = ds.SPLIT_TILES * ds.KV_TILE - 1
    assert p.kv_ranks == p.q_blocks and p.attn_units == n_head * p.kv_ranks <= p.grid
    assert p.kv_exchanges(24, [0, 104, last_local]) == 0
    per_row = 2 * 24 if p.kv_ranks > 1 else 0
    assert p.kv_exchanges(24, [last_local + 1]) == per_row
    assert p.kv_exchanges(24, [last_local + 1, 3, 4095, 40]) == 2 * per_row
    if kind == ds.FAST:
        assert p.kv_exchanges(4, range(cache)) == 0
    assert 3 + f // p.sw_cols + n_head + 4 <= ds.STATE_WORDS
