"""The plan of the persistent decode kernel (`csrc/decode_stack.cuh`) that
runs the fused slow step (`ops/slow_step.py`) and the fused batch-1 fast
frame (`ops/fast_frame.py`), mirrored from `ds_make_plan`; the plan of the
group layer pass (`csrc/rows_stack.cuh`) of the slow step's row kernel for
5 rows and more (`csrc/slow_step_rows.cu`), mirrored from `sr_make_plan`
(`rows_plan`), and of the batched fast frame's kernel
(`csrc/fast_frame_batched.cu`), mirrored from `fr_make_plan`
(`frame_plan`); and the grid sync states the kernels count in: one per
engine, and one per (card, stream) for calls made outside an engine.

One cooperative launch puts one block on every SM. The plan cuts each
layer's GEMVs into work units from the shapes, the weight type and the
grid alone, never from the batch or the data, so a row's bits do not
depend on its co-tenants:

* QKV: `qkv_cols`-column tiles (whole 128-byte lines a row: 64 bf16, 128
  int8 columns) x K-splits of `qkv_klen` rows, as many splits as keep
  tiles x splits within the grid; the attention blocks add the splits in
  order.
* attention + wo: `q_blocks` blocks a query head; block (h, q) computes
  head h's attention and the wo partial of its `wo_cols` columns. The
  keys are in 32-key tiles dealt round-robin to `kv_ranks` ranks; past
  SPLIT_TILES tiles block q is rank q and the head's blocks exchange
  their (max, sum) pairs and PV partials, below it each computes every
  rank itself (the same sums in the same order).
* w1 + w3 + w2: `sw_cols`-column slices of F (whole lines a row), each
  over `sw_split` K-splits whose blocks exchange their partial sums; the
  block of split h then owns `sw_cols / sw_split` g columns, which are its
  K-rows of w2 (all D columns).
* the residual x: `x_tiles` 8-column tiles, added by `owners` blocks.
* the head: 64-column tiles x K-splits, read directly (not through the
  weight ring).

Each thread streams 8 weight columns of one row at a time (16 bytes bf16,
8 bytes int8) through a ring of `stages` stages of 256 pieces.
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Optional

import torch

from fish_speech_tpu_torch.ops import _cuda_build

HEAD_DIM = 64
THREADS = 256  # consumer threads of a block
BLOCK_THREADS = THREADS + 32  # and the producer warp that fills the weight ring
MAX_ROWS = 4  # batch rows the slow step takes
TILE = 64  # columns of a head tile
KV_TILE = 32  # keys of an attention tile
MAX_Q = 8  # blocks (and key ranks) a head
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90
MAX_STAGES = 128
MAX_SEGS = 16  # weight segments a block streams each layer
STATE_WORDS = 1024  # sync state: arrivals, finished blocks, publishes of x, F-slice groups,
# heads' key-split exchanges; the last six words: launches of the batched frame's kernel,
# of the row kernel, of the sampler and of the persistent kernel so far, the last launch's
# grid syncs and head 0's exchanges
SPLIT_TILES = 8  # attention over more key tiles (256 keys) is split over a head's blocks
MAX_WINDOW = 64  # rep-pen window entries the sampler takes
DIMS = (256, 512, 1024, 2048)  # model widths the kernel takes
H100_SMS = 132  # the grid on an H100 SXM, for plans made without a card
RED_BYTES = THREADS * MAX_ROWS * 8 * 4  # the GEMV reduction scratch (its largest need)

SLOW, FAST = 0, 1

PLAN_FIELDS = (
    "grid", "stages", "piece_bytes", "smem", "scratch_bytes",
    "qkv_cols", "qkv_tiles", "qkv_splits", "qkv_klen", "qkv_units",
    "q_blocks", "wo_cols", "attn_units", "kv_ranks",
    "sw_cols", "sw_split", "sw_units", "x_tiles", "owners",
    "head_tiles", "head_splits", "head_klen", "head_units", "syncs_per_layer",
)


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """What `ds_make_plan` computes, in the C entry's order."""

    grid: int
    stages: int
    piece_bytes: int
    smem: int
    scratch_bytes: int
    qkv_cols: int
    qkv_tiles: int
    qkv_splits: int
    qkv_klen: int
    qkv_units: int
    q_blocks: int
    wo_cols: int
    attn_units: int
    kv_ranks: int
    sw_cols: int
    sw_split: int
    sw_units: int
    x_tiles: int
    owners: int
    head_tiles: int
    head_splits: int
    head_klen: int
    head_units: int
    syncs_per_layer: int

    def syncs_per_launch(self, kind: int, n_layer: int) -> int:
        """Grid syncs of one launch: three a layer, and the slow step's one
        for its head (a fast frame's step hands its head's partials to the
        sampler launch that follows it)."""
        return self.syncs_per_layer * n_layer + (1 if kind == SLOW else 0)

    def syncs_per_call(self, kind: int, n_layer: int, steps: int = 1) -> int:
        """Grid syncs of one call: a slow step is one launch, a fast frame
        one launch a codebook step."""
        return self.syncs_per_launch(kind, n_layer) * (1 if kind == SLOW else steps)

    def kv_exchanges(self, n_layer: int, positions, steps: int = 1) -> int:
        """Key-split exchanges a call makes on each head's counter: two a
        layer for every row whose keys 0..pos span more than SPLIT_TILES
        tiles (the fast frame's rows never do)."""
        split = sum(1 for p in positions if self.kv_ranks > 1 and p // KV_TILE + 1 > SPLIT_TILES)
        return 2 * n_layer * steps * split

    def segments(self, block: int) -> list:
        """(matrix, row0, col0, rows, 8-column pieces a row, pieces a
        thread) of each weight segment block `block` streams a layer, in
        the order it takes them; matrix "w13" is w1 and w3 interleaved."""
        segs = []
        for u in range(block, self.qkv_units, self.grid):
            s = u % self.qkv_splits
            rows = min(self.qkv_klen, self._d - s * self.qkv_klen)
            cpr = self.qkv_cols // 8
            segs.append(("wqkv", s * self.qkv_klen, (u // self.qkv_splits) * self.qkv_cols, rows,
                         cpr, rows * cpr // THREADS))
        for u in range(block, self.attn_units, self.grid):
            cpr = self.wo_cols // 8
            segs.append(("wo", (u // self.q_blocks) * HEAD_DIM, (u % self.q_blocks) * self.wo_cols,
                         HEAD_DIM, cpr, HEAD_DIM * cpr // THREADS))
        for u in range(block, self.sw_units, self.grid):
            t, h = divmod(u, self.sw_split)
            cpr = self.sw_cols // 8
            kr = self._d // self.sw_split
            gs = self.sw_cols // self.sw_split
            segs.append(("w13", h * kr, t * self.sw_cols, kr, cpr, 2 * kr * cpr // THREADS))
            segs.append(("w2", t * self.sw_cols + h * gs, 0, gs, self._d // 8,
                         gs * (self._d // 8) // THREADS))
        return segs

    @property
    def _d(self) -> int:
        return self.x_tiles * 8


def _ksplit(k: int, n: int, cols: int, grid: int):
    tiles = -(-n // cols)
    chunks = k // 32
    s = min(max(grid // tiles, 1), chunks)
    klen = -(-chunks // s) * 32
    splits = -(-k // klen)
    return tiles, splits, klen, tiles * splits


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def stack_plan(kind: int, d: int, n_head: int, kv: int, f: int, head_n: int, cache_len: int,
               int8: bool, grid: int):
    """The plan for a stack of width d, n_head query and kv KV heads of
    dim 64, ffn f; head_n head columns (the slow step's gathered W, the
    fast frame's V); cache_len keys (the fast frame: C); on `grid` blocks.
    None when the kernel does not take the shapes."""
    if (grid < 1 or kv < 1 or n_head % kv or n_head * HEAD_DIM != d or f < 64 or f % 64
            or head_n < 1 or cache_len < 1 or (kind == FAST and head_n > 4 * 1024)
            or d not in DIMS):
        return None
    piece_bytes = 8 if int8 else 16
    # QKV and w1/w3 tiles are whole 128-byte lines a row
    qkv_cols = 128 if int8 else 64
    qkv_tiles, qkv_splits, qkv_klen, qkv_units = _ksplit(
        d, (n_head + 2 * kv) * HEAD_DIM, qkv_cols, grid)
    q = min(MAX_Q, _pow2_floor(max(grid // n_head, 1)), d // 32)
    sw_cols = 128 if int8 else 64
    if f % sw_cols:
        return None
    split = min(4, _pow2_floor(max(grid // (f // sw_cols), 1)))
    while split > 1 and (d % (split * 32) or sw_cols // split < 8):
        split //= 2
    sw_units = f // sw_cols * split
    if sw_units > grid and split > 1:
        return None
    x_tiles = d // 8
    owners = min(x_tiles, grid)
    head_tiles, head_splits, head_klen, head_units = _ksplit(d, head_n, TILE, grid)
    segs = (-(-qkv_units // grid) + -(-(n_head * q) // grid) + 2 * -(-sw_units // grid))
    if segs > MAX_SEGS or 3 + f // sw_cols + n_head + 4 > STATE_WORDS:
        return None

    off = 2 * _align(MAX_ROWS * d * 2, 16)  # x, h
    off += _align(MAX_ROWS * HEAD_DIM * 2, 16)  # attention output
    off += _align(MAX_ROWS * sw_cols * 2, 16)  # g
    off += 512  # segments and the weight table
    s_pad = _align(cache_len, KV_TILE)
    scr = max(RED_BYTES,
              4 * (s_pad + 2 * (s_pad // KV_TILE) + 2 * MAX_Q + MAX_Q * HEAD_DIM + 6 * HEAD_DIM),
              4 * 4 * MAX_ROWS * TILE)
    off += _align(scr, 16)
    stages = min(MAX_STAGES, (SMEM_LIMIT - off - 16) // (16 + THREADS * piece_bytes))
    if stages < 2:
        return None
    smem = _align(off + 16 * stages, 16) + stages * THREADS * piece_bytes
    if smem > SMEM_LIMIT:
        return None
    scratch = (_align(2 * MAX_ROWS * d * 2, 256) + _align(qkv_units * MAX_ROWS * qkv_cols * 4, 256)
               + _align(n_head * MAX_ROWS * d * 4, 256)
               + _align(sw_units * MAX_ROWS * 2 * sw_cols * 4, 256)
               + _align(sw_units * MAX_ROWS * d * 4, 256)
               + _align(head_units * MAX_ROWS * TILE * 4, 256)
               + _align(n_head * MAX_Q * (2 + HEAD_DIM) * 4, 256)
               + _align(d * 2, 256))
    return StackPlan(
        grid=grid, stages=stages, piece_bytes=piece_bytes, smem=smem, scratch_bytes=scratch,
        qkv_cols=qkv_cols, qkv_tiles=qkv_tiles, qkv_splits=qkv_splits, qkv_klen=qkv_klen,
        qkv_units=qkv_units,
        q_blocks=q, wo_cols=d // q, attn_units=n_head * q, kv_ranks=q,
        sw_cols=sw_cols, sw_split=split, sw_units=sw_units, x_tiles=x_tiles, owners=owners,
        head_tiles=head_tiles, head_splits=head_splits, head_klen=head_klen,
        head_units=head_units, syncs_per_layer=3)


def _pow2_floor(v: int) -> int:
    p = 1
    while p * 2 <= v:
        p *= 2
    return p


def grid_of(device) -> int:
    """One block on every SM of the card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_on_card(kind: int, d: int, n_head: int, kv: int, f: int, head_n: int, cache_len: int,
                 int8: bool):
    """The plan as the built kernel computes it on the current card
    (fs_decode_stack_plan), or None when it does not take the shapes."""
    import ctypes

    out = (ctypes.c_int * len(PLAN_FIELDS))()
    rc = _cuda_build.load_library().fs_decode_stack_plan(
        kind, d, n_head, kv, f, head_n, cache_len, int(int8), ctypes.addressof(out))
    if rc != 0:
        return None
    return StackPlan(*list(out))


_state = {}  # (device index, stream) -> the sync state of calls made outside an engine


def new_sync_state(device) -> torch.Tensor:
    """A grid sync state of its own (STATE_WORDS int32, zero), as each
    engine holds one, so that persistent launches in flight on two
    streams never count into the same words. Made outside any CUDA graph
    capture, so that it lies outside the graph's pool. Every call leaves
    its counters zeroed (the last block of a launch sets them back), so a
    captured graph can replay the kernel without clearing them; that block
    also counts the launch and writes its counts into the last words
    (`launch_counts`, `last_call_counts`). On the CPU (an engine's plain
    path) it is a tensor no kernel reads."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("decode_stack: call the fused kernels once before capturing a "
                           "CUDA graph, so their sync state exists outside the graph's pool")
    return torch.zeros(STATE_WORDS, dtype=torch.int32, device=device)


def sync_state(device) -> torch.Tensor:
    """The sync state of calls made outside an engine on this device and
    its current stream: made at the first such call, so call once on the
    capturing stream before capturing a CUDA graph."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    state = _state.get(key)
    if state is None:
        state = new_sync_state(torch.device("cuda", idx))
        _state[key] = state
    return state


def last_call_counts(device, state=None) -> tuple:
    """(grid syncs, key-split exchanges of head 0) of the last finished
    persistent launch on `state` (by default that of the device's current
    stream), as its last block counted them (synchronizes the device)."""
    words = (sync_state(device) if state is None else state)[-2:].tolist()
    return words[0], words[1]


def launch_counts(device, state=None) -> tuple:
    """(persistent launches, sampler launches) finished on `state` (by
    default that of the device's current stream) so far, each counted by
    the launch itself (synchronizes the device)."""
    sampler, persistent = (sync_state(device) if state is None else state)[-4:-2].tolist()
    return persistent, sampler


def rows_launch_count(device, state=None) -> int:
    """Launches of the row kernel (`csrc/slow_step_rows.cu`) finished on
    `state` (by default that of the device's current stream) so far, as
    the kernel counted them (synchronizes the device)."""
    return int((sync_state(device) if state is None else state)[ROWS_LAUNCHES_WORD])


# -- the slow step's row kernel (5 rows and more) ---------------------------------

ROWS_GROUP = 32  # rows one launch takes (the group): 16 rows one launch, 64 two
ROWS_TILE = 128  # columns of a weight tile, 16 a consumer warp
ROWS_STAGE_ROWS = 32  # K-rows of a ring stage of the stack's weights (8 KB bf16, 4 KB int8)
ROWS_MAX_SEGS = 16
ROWS_MAX_STAGES = 64
ROWS_MIN_STAGES = 4
ROWS_MAX_STEPS = 16  # key tiles an attention rank takes
ROWS_MAX_SPLITS = 16  # QKV K-splits the attention's gather adds at once
ROWS_SEG_BYTES = 1024
ROWS_LAUNCHES_WORD = STATE_WORDS - 5  # the row kernel's launches so far

ROWS_PLAN_FIELDS = (
    "grid", "stages", "stage_bytes", "smem", "scratch_bytes",
    "qkv_tiles", "qkv_splits", "qkv_klen", "qkv_units",
    "q_blocks", "wo_tiles", "attn_units", "attn_ranks", "attn_rows",
    "sw_slices", "sw_split", "sw_units", "w2_tiles", "x_tiles", "owners",
    "head_tiles", "head_splits", "head_klen", "head_units", "syncs_per_layer",
)

@dataclasses.dataclass(frozen=True)
class RowsPlan:
    """What `sr_make_plan` computes, in fs_slow_step_rows_plan's order.

    Work units, each a weight segment a block streams through its ring
    (unit u on block u mod grid): QKV `qkv_tiles` 128-column tiles x
    `qkv_splits` K-splits of `qkv_klen` rows; attention + wo `q_blocks`
    units a query head (the head's rows b = q, q + Q, ..., then wo's K-rows
    of the head x `wo_tiles` tiles); w1 + w3 `sw_slices` 128-column slices
    of F x `sw_split` K-splits, after which each split forms the slice's g
    and takes those 128 K-rows of w2 for its `w2_tiles` of D's column tiles
    (an element of x then has `sw_slices` w2 partials); the head
    `head_tiles` x `head_splits`. A row's keys are dealt to `attn_ranks`
    warps."""

    grid: int
    stages: int
    stage_bytes: int
    smem: int
    scratch_bytes: int
    qkv_tiles: int
    qkv_splits: int
    qkv_klen: int
    qkv_units: int
    q_blocks: int
    wo_tiles: int
    attn_units: int
    attn_ranks: int
    attn_rows: int
    sw_slices: int
    sw_split: int
    sw_units: int
    w2_tiles: int
    x_tiles: int
    owners: int
    head_tiles: int
    head_splits: int
    head_klen: int
    head_units: int
    syncs_per_layer: int

    def syncs_per_launch(self, n_layer: int) -> int:
        """Grid syncs of one launch: three a layer and the head's."""
        return self.syncs_per_layer * n_layer + 1

    def head_exchanges(self, n_layer: int) -> int:
        """Exchanges a launch makes on each query head's counter: one a
        layer (its units' attention outputs)."""
        return n_layer

    def segments(self, block: int, kind: str = "layer") -> list:
        """(matrix, row0, col0, K-rows, tiles of 128 columns) of each weight
        segment block `block` streams, in the order it takes them: a
        layer's ("layer") or the head's ("head"); matrix "w13" is w1 and w3
        in turns."""
        d = self.x_tiles * 8
        if kind == "head":
            return [("head", (u % self.head_splits) * self.head_klen,
                     (u // self.head_splits) * ROWS_TILE,
                     min(self.head_klen, d - (u % self.head_splits) * self.head_klen), 1)
                    for u in range(block, self.head_units, self.grid)]
        segs = []
        for u in range(block, self.qkv_units, self.grid):
            k0 = (u % self.qkv_splits) * self.qkv_klen
            segs.append(("wqkv", k0, (u // self.qkv_splits) * ROWS_TILE,
                         min(self.qkv_klen, d - k0), 1))
        for u in range(block, self.attn_units, self.grid):
            segs.append(("wo", (u // self.q_blocks) * HEAD_DIM,
                         (u % self.q_blocks) * self.wo_tiles * ROWS_TILE, HEAD_DIM, self.wo_tiles))
        kr = d // self.sw_split
        for u in range(block, self.sw_units, self.grid):
            t, h = divmod(u, self.sw_split)
            segs.append(("w13", h * kr, t * ROWS_TILE, kr, 1))
            segs.append(("w2", t * ROWS_TILE, h * self.w2_tiles * ROWS_TILE, ROWS_TILE,
                         self.w2_tiles))
        return segs


@functools.lru_cache(maxsize=None)
def rows_plan(d: int, n_head: int, kv: int, f: int, head_n: int, cache_len: int, int8: bool,
              grid: int, work_bytes: int = 0, extra_scratch: int = 0) -> Optional[RowsPlan]:
    """The row kernel's plan for a stack of width d, n_head query and kv
    KV heads of dim 64, ffn f, a head of head_n columns and a cache of
    cache_len keys, on `grid` blocks: a function of the shapes alone (never
    of the rows, so one object for every batch), or None when the kernel
    does not take them. work_bytes: shared memory the caller uses between
    passes over the normalised rows and the attention's scratch (the batched
    frame's draw); extra_scratch: global scratch of the caller's own, after
    the plan's (the batched frame's K/V history)."""
    if (grid < 1 or n_head < 1 or kv < 1 or n_head % kv or n_head * HEAD_DIM != d
            or f < ROWS_TILE or f % ROWS_TILE or head_n < 1 or cache_len < 1 or d not in DIMS):
        return None
    qkv = (n_head + 2 * kv) * HEAD_DIM
    stage_bytes = ROWS_STAGE_ROWS * ROWS_TILE * (1 if int8 else 2)
    qkv_tiles, qkv_splits, qkv_klen, qkv_units = _ksplit(d, qkv, ROWS_TILE, grid)
    if qkv % ROWS_TILE or qkv_splits > ROWS_MAX_SPLITS:
        return None
    q = min(MAX_Q, _pow2_floor(max(grid // n_head, 1)))
    while q > 1 and (d // q) % ROWS_TILE:
        q //= 2
    ranks = 2 if cache_len <= 1024 else THREADS // 32
    if cache_len > ranks * KV_TILE * ROWS_MAX_STEPS:
        return None
    attn_rows = -(-ROWS_GROUP // q)
    slices = f // ROWS_TILE
    split = min(4, _pow2_floor(max(grid // slices, 1)))
    while split > 1 and (d // split) % ROWS_TILE:
        split //= 2
    sw_units = slices * split
    if sw_units > grid and split > 1:
        return None
    x_tiles = d // 8
    head_tiles, head_splits, head_klen, head_units = _ksplit(d, head_n, ROWS_TILE, grid)
    segs = (-(-qkv_units // grid) + -(-(n_head * q) // grid) + 2 * -(-sw_units // grid)
            + -(-head_units // grid))
    if segs > ROWS_MAX_SEGS or 3 + slices + n_head > ROWS_LAUNCHES_WORD:
        return None
    warps = THREADS // 32
    off = _align(ROWS_GROUP * (d + 8) * 2, 128)  # the normalised rows
    off += _align(ROWS_GROUP * (HEAD_DIM + 8) * 2, 16)  # a head's attention outputs
    off += _align(ROWS_GROUP * (ROWS_TILE + 8) * 2, 16)  # a slice's g
    off += 2 * d * 2  # a layer's ffn norm and the next norm
    att = _align(4 * (attn_rows * 3 * HEAD_DIM + 2 * warps + warps * HEAD_DIM
                      + warps * ROWS_MAX_STEPS * KV_TILE), 16)  # attention
    if work_bytes > off + att:  # the caller's work over the rows and the attention's scratch
        att = _align(work_bytes - off, 16)
    off += att
    off += ROWS_SEG_BYTES  # the segment and matrix tables, the positions
    # the ring's stages at 1024-byte boundaries, the 128-byte swizzle's
    stages = min(ROWS_MAX_STAGES, (SMEM_LIMIT - off - 1024) // (16 + stage_bytes))
    if stages < ROWS_MIN_STAGES:
        return None
    smem = _align(off + 16 * stages, 1024) + stages * stage_bytes
    if smem > SMEM_LIMIT:
        return None
    scratch = (_align(2 * ROWS_GROUP * d * 2, 256)
               + _align(qkv_units * ROWS_GROUP * ROWS_TILE * 4, 256)
               + _align(n_head * ROWS_GROUP * HEAD_DIM * 2, 256)
               + _align(n_head * ROWS_GROUP * d * 4, 256)
               + _align(sw_units * 2 * ROWS_GROUP * ROWS_TILE * 4, 256)
               + _align(slices * ROWS_GROUP * d * 4, 256)
               + _align(head_units * ROWS_GROUP * ROWS_TILE * 4, 256)
               + _align(extra_scratch, 256))
    return RowsPlan(
        grid=grid, stages=stages, stage_bytes=stage_bytes, smem=smem, scratch_bytes=scratch,
        qkv_tiles=qkv_tiles, qkv_splits=qkv_splits, qkv_klen=qkv_klen, qkv_units=qkv_units,
        q_blocks=q, wo_tiles=d // q // ROWS_TILE, attn_units=n_head * q, attn_ranks=ranks,
        attn_rows=attn_rows, sw_slices=slices, sw_split=split, sw_units=sw_units,
        w2_tiles=d // split // ROWS_TILE,
        x_tiles=x_tiles, owners=min(x_tiles, grid), head_tiles=head_tiles,
        head_splits=head_splits, head_klen=head_klen, head_units=head_units, syncs_per_layer=3)


def rows_plan_on_card(d: int, n_head: int, kv: int, f: int, head_n: int, cache_len: int,
                      int8: bool):
    """The row kernel's plan as the built kernel computes it on the
    current card (fs_slow_step_rows_plan), or None when it does not take
    the shapes."""
    import ctypes

    out = (ctypes.c_int * len(ROWS_PLAN_FIELDS))()
    rc = _cuda_build.load_library().fs_slow_step_rows_plan(
        d, n_head, kv, f, head_n, cache_len, int(int8), ctypes.addressof(out))
    if rc != 0:
        return None
    return RowsPlan(*list(out))


# -- the batched fast frame's kernel -----------------------------------------------

FRAME_LAUNCHES_WORD = STATE_WORDS - 6  # the batched frame kernel's launches so far
FRAME_MAX_VOCAB = 4096  # codebook entries its draw takes
DRAW_WARPS = THREADS // 32  # the draw runs on a block's consumer threads


def draw_sort_width(k: int) -> int:
    """Keys the draw sorts for a top-k of k: a power of two, at least 32."""
    n = 32
    while n < k:
        n *= 2
    return n


def draw_smem_bytes(vocab: int, k_dyn: int) -> int:
    """Shared memory of the draw (codebook_sampler.cuh::rd_smem_bytes): the
    selected keys, the logits, three 256-bin histograms, the three
    reductions, the best key and the compaction's slot count."""
    return 8 * draw_sort_width(k_dyn) + 4 * vocab + 3 * 256 * 4 + 3 * 4 * DRAW_WARPS \
        + 8 * DRAW_WARPS + 16


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """What `fr_make_plan` computes, in fs_fast_frame_batched_plan's order:
    the layer pass's plan (`rows`: S = C keys, a head of V columns), the
    draw's shared memory (over the normalised rows and the attention's
    scratch, free after the head), the keys its sort takes at k_dyn, and
    the bytes of the rows' K/V history (L, 32, KV, C, 64) x 2 in the
    scratch."""

    rows: RowsPlan
    draw_bytes: int
    sort_keys: int
    hist_bytes: int

    @staticmethod
    def syncs_per_call(n_layer: int, n_cb: int) -> int:
        """Grid syncs of one frame: each step three a layer and one after
        the head's partials, and one after each draw but the last."""
        return n_cb * (3 * n_layer + 2) - 1

    @staticmethod
    def head_exchanges(n_layer: int, n_cb: int) -> int:
        """Exchanges a frame makes on each query head's counter: one a
        layer of each step."""
        return n_layer * n_cb


@functools.lru_cache(maxsize=None)
def frame_plan(n_layer: int, d: int, n_head: int, kv: int, f: int, n_cb: int, vocab: int,
               k_dyn: int, int8: bool, grid: int) -> Optional[FramePlan]:
    """The batched frame kernel's plan for a fast stack of n_layer layers
    (width d, n_head query and kv KV heads of dim 64, ffn f), n_cb codebook
    steps of vocab entries and a top-k cap k_dyn, on `grid` blocks: a
    function of the shapes alone (one object for every batch), or None
    when the kernel does not take them."""
    if (n_layer < 1 or n_cb < 1 or not 1 <= vocab <= FRAME_MAX_VOCAB or vocab % 8
            or not 1 <= k_dyn <= vocab or kv < 1):
        return None
    draw = draw_smem_bytes(vocab, k_dyn)
    hist = 2 * n_layer * ROWS_GROUP * kv * n_cb * HEAD_DIM * 2
    rows = rows_plan(d, n_head, kv, f, vocab, n_cb, int8, grid, draw, hist)
    if rows is None or 3 + rows.sw_slices + n_head > FRAME_LAUNCHES_WORD:
        return None
    return FramePlan(rows=rows, draw_bytes=draw, sort_keys=draw_sort_width(k_dyn),
                     hist_bytes=hist)


def frame_plan_on_card(n_layer: int, d: int, n_head: int, kv: int, f: int, n_cb: int,
                       vocab: int, k_dyn: int, int8: bool) -> Optional[FramePlan]:
    """The batched frame kernel's plan as the built kernel computes it on
    the current card (fs_fast_frame_batched_plan), or None when it does
    not take the shapes."""
    import ctypes

    n = len(ROWS_PLAN_FIELDS)
    out = (ctypes.c_int * (n + 3))()
    rc = _cuda_build.load_library().fs_fast_frame_batched_plan(
        n_layer, d, n_head, kv, f, n_cb, vocab, k_dyn, int(int8), ctypes.addressof(out))
    if rc != 0:
        return None
    vals = list(out)
    return FramePlan(RowsPlan(*vals[:n]), *vals[n:])


def frame_launch_count(device, state=None) -> int:
    """Launches of the batched frame's kernel (`csrc/fast_frame_batched.cu`)
    finished on `state` (by default that of the device's current stream)
    so far, as the kernel counted them (synchronizes the device)."""
    return int((sync_state(device) if state is None else state)[FRAME_LAUNCHES_WORD])


_frame_scratch = {}  # id(sync state) -> the batched frame's scratch that goes with it


def frame_scratch(sync: torch.Tensor, nbytes: int) -> torch.Tensor:
    """The batched frame kernel's scratch (partials, the published x, the
    rows' K/V history) that goes with a sync state: made at the first call
    on that state, kept with it and freed with it, so frames reuse it and
    a CUDA graph's replay finds it. Like the state, it must exist before a
    graph that uses it is captured."""
    key = id(sync)
    scratch = _frame_scratch.get(key)
    if scratch is None or scratch.numel() < nbytes:
        if sync.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fused_fast_frame_batched: call it once before capturing a CUDA "
                               "graph, so its scratch exists outside the graph's pool")
        if scratch is None:
            weakref.finalize(sync, _frame_scratch.pop, key, None)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=sync.device)
        _frame_scratch[key] = scratch
    return scratch
