// The layer pass of a group of up to 32 rows on one cooperative persistent
// launch, on the tensor cores, shared by the slow step's row kernel
// (slow_step_rows.cu) and the batched fast frame (fast_frame_batched.cu),
// for Hopper (sm_90a). A kernel of either file sets up its tables
// (sr_tables), starts the producer warp (sr_produce), and its consumers
// run sr_layer for each layer pass, then the head's partials
// (sr_head_partials); the last block to finish counts the launch
// (sr_finish). Rounding points, int8 rescale and silu on the unrounded
// f32 w1 product are dual_ar_layer.cuh's (the TPU kernels',
// slow_step_pallas.py:152-174, 198-207, 229-334, fast_frame_pallas.py:
// 200-301, 532, 569-573, 595-604).
//
// * One cooperative launch a group of SR_ROWS = 32 rows, one block an SM,
//   for every layer and the head: a 16-row step is 1 launch, 64 rows 2.
//   32 because the group's normalised rows, the tensor cores' B operand
//   (66 KB at D = 1024), fit beside a ring of 15 stages (120 KB), and 64
//   rows then take 2 launches instead of 4. The group size is a constant:
//   fewer rows leave the padded rows zero, and they write nothing.
// * The plan (sr_make_plan; mirrored by ops/decode_stack.py::rows_plan) is
//   a function of D, H, KV, F, the head width, S, the weight type and the
//   grid, never of the rows, their positions or the group. Every sum runs
//   in an order the plan fixes, so a row's logits, hidden and cache rows
//   are the same bits alone as among 31 co-tenants.
// * The weights stream ahead. A producer warp walks the block's weight
//   tiles across phases and layers in one fixed order and copies each
//   stage (32 K-rows x 128 columns, 8 KB bf16, 4 KB int8) with its 32
//   lanes' 16-byte cp.async copies (whole 128-byte lines an instruction)
//   into a ring, laid out as a TMA copy with the 128-byte swizzle lays it
//   out (bank-conflict-free ldmatrix), whose mbarriers count the copies
//   (full) and the eight consumer warps' releases (empty). It keeps
//   fetching the coming phases while the consumers wait at a grid sync or
//   compute attention. Each warp owns 16 columns of a tile over the unit's
//   whole K, so no warp waits for another to consume a stage. A 2D TMA
//   tensor map a matrix (cp.async.bulk.tensor.2d, one lane issuing each
//   stage's boxes) was timed against these cp.async copies, in turns on
//   one card (NVIDIA H100 80GB HBM3, 700 W; scripts/time_decode_stack.py
//   on a side build): at 16 rows 1.4861 and 1.4875 ms (TMA) against
//   1.4502 and 1.4524 (cp.async) bf16, 1.4919 and 1.5023 against 1.5108
//   and 1.5094 int8; at 32 and 64 rows cp.async led by 1-3%. cp.async was
//   kept, and the TMA copy left the source.
// * The consumers compute on the tensor cores: mma.sync.m16n8k16, bf16
//   in, f32 accumulate, with rows_gemm's fragments (tensor_core.cuh): the
//   weights are the A operand through ldmatrix.trans (int8: one
//   ldmatrix.trans of the bytes as b16 pairs serves two k16 steps, then
//   an exact conversion to bf16 in registers), the group's normalised rows
//   the B operand in n8 tiles from shared memory, two tiles an ldmatrix.
//   wgmma's 64-row tile would be
//   three-quarters padding at 16 rows, and the bytes, not the issue rate,
//   bound the step, so mma.sync stays.
// * Three grid syncs a layer, as in decode_stack.cuh: (a) QKV partials (column tiles
//   x K-splits); sync. (b) Attention units (query head h, part q): the
//   head's rows b = q, q + Q, ... from the QKV partials (the splits added
//   in order), RoPE, the K/V row write (the group's first head), and the
//   attention of (row, head) with its 32-key tiles dealt round-robin to
//   the row's ranks (warps, a number fixed by S); the head's Q blocks
//   exchange their rows' outputs behind the head's counter, and each
//   computes the wo partials of its columns for all rows. (c) RMSNorm,
//   the w1 + w3 partials of a 128-column slice of F (K-split over 4
//   blocks), the split group's exchange, the slice's g (each of the 4
//   blocks forms all of it), the w2 partials of its 128 K-rows for a
//   quarter of D's columns, so an element of x has F / 128 w2 partials,
//   not F / 32. A reduce-broadcast ends (b) and (c): every block arrives,
//   owner blocks add the partials of their 8-column tiles in a fixed order
//   and publish the new x, every block reads it (32 KB at 16 rows) and
//   normalises it, eight threads a row, with the norm's weights copied to
//   shared memory at the layer's start. Every sum of partials (the QKV
//   splits, the K-split group's, the owners') loads four columns at once.
//   Then the head's partials, f32 and unrounded (sr_head_partials), which
//   the caller reduces after one more sync.
// * The sync state is the caller's (an engine's own): monotonic counters
//   the last block zeroes, so a CUDA graph replays without clearing; every
//   wait traps after DS_TIMEOUT_NS; the kernel counts its launches, its
//   grid syncs and head 0's exchanges itself. Scratch (partials,
//   exchanges, the published x) is the wrapper's.
// * What holds it back (scripts/trace_decode_stack.py --part rows, PERF.md
//   section 6): a chain of dependent L2 round trips (~1 us each beside the
//   weight stream), syncs and exchanges, not the bytes: no ring stage is
//   waited for (the ring runs ahead of every product), yet the products
//   take ~0.2-0.35 us a stage of ring mechanics and accumulator chains;
//   attention is a chain of one round trip a key tile; the registers:
//   nine warps a block leave 168 a thread (an SM sub-partition holds three
//   of them), so every array that stays live across a loop spills (a
//   predicated load into an array element kept last round's value live
//   and tripled the spills: loads fill every element). Folding the
//   producer into a consumer thread (255 registers) starved the stream
//   and was slower. Past ~1000 keys a row's attention (one unit a query
//   head, so the 8 heads of a KV group each read the group's keys) is
//   bound by each SM's L2 reads: 8 rows at 2048 keys run slower than the
//   slow step's launch sequence the row kernel replaced, whose attention
//   shared the group's tiles.

#pragma once

#include "decode_stack.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int SR_ROWS = 32;         // rows of a group: one launch
constexpr int SR_NT = SR_ROWS / 8;  // mma n8 tiles of a group
constexpr int SR_TILE = 128;        // columns of a weight tile (16 a consumer warp)
constexpr int SR_STAGE_ROWS = 32;   // K-rows of a ring stage of the stack's weights
constexpr int SR_MAX_SEGS = 16;     // weight segments a block streams (a layer and the head)
constexpr int SR_MAX_STAGES = 64;
constexpr int SR_MIN_STAGES = 4;
constexpr int SR_MAX_STEPS = 16;    // key tiles an attention rank takes
constexpr int SR_MAX_SPLITS = 16;   // QKV K-splits the attention's gather adds at once
constexpr int SR_SEG_BYTES = 1024;  // the segment and matrix tables, the positions
constexpr int SR_PLAN_INTS = 25;
constexpr int SR_LAUNCHES_WORD = DS_STATE_WORDS - 5;  // this kernel's launches so far

// ---------------------------------------------------------------------------
// The plan: a function of the shapes, the weight type and the grid
// ---------------------------------------------------------------------------

struct SrPlan {
  // the numbers fs_slow_step_rows_plan reports, in this order
  int grid, stages, stage_bytes, smem, scratch_bytes;
  int qkv_tiles, qkv_splits, qkv_klen, qkv_units;
  int q_blocks, wo_tiles, attn_units, attn_ranks, attn_rows;
  int sw_slices, sw_split, sw_units, w2_tiles;
  int x_tiles, owners;
  int head_tiles, head_splits, head_klen, head_units;
  int syncs_per_layer;
  // shared memory pitches (elements) and offsets (bytes)
  int h_pitch, a_pitch, g_pitch;
  int sm_h, sm_a, sm_g, sm_nw, sm_att, sm_seg, sm_bar, sm_ring;
  // global scratch offsets (bytes); sc_extra: the caller's own scratch
  int sc_x, sc_qkv, sc_ax, sc_wo, sc_sw, sc_w2, sc_head, sc_extra;
};

// W: the head's columns; S: the cache length. work_bytes: shared memory
// the caller uses between passes over [sm_h, sm_seg) (the region then
// holds at least that many bytes); extra_scratch: global scratch bytes of
// the caller's own, at sc_extra. Returns false for shapes outside the
// kernel's limits.
inline bool sr_make_plan(int D, int H, int KV, int F, int W, int S, bool int8, int grid,
                         SrPlan& p, int work_bytes = 0, int extra_scratch = 0) {
  p = SrPlan{};
  if (grid < 1 || H < 1 || KV < 1 || H % KV != 0 || H * HDIM != D || F < SR_TILE ||
      F % SR_TILE != 0 || W < 1 || S < 1)
    return false;
  if (D != 256 && D != 512 && D != 1024 && D != 2048) return false;
  const int QKV = (H + 2 * KV) * HDIM;
  p.grid = grid;
  p.stage_bytes = SR_STAGE_ROWS * SR_TILE * (int8 ? 1 : 2);
  // QKV: 128-column tiles x K-splits (multiples of 32 rows)
  ds_ksplit(D, QKV, SR_TILE, grid, p.qkv_tiles, p.qkv_splits, p.qkv_klen, p.qkv_units);
  if (QKV % SR_TILE != 0 || p.qkv_splits > SR_MAX_SPLITS) return false;
  // attention + wo: Q units a query head, each Q-th of wo's columns
  int q = ds_pow2_floor(grid / H > 0 ? grid / H : 1);
  if (q > DS_MAX_Q) q = DS_MAX_Q;
  while (q > 1 && (D / q) % SR_TILE != 0) q /= 2;
  p.q_blocks = q;
  p.wo_tiles = D / q / SR_TILE;
  p.attn_units = H * q;
  p.attn_ranks = S <= 1024 ? 2 : DS_WARPS;  // warps a row's keys are dealt to
  p.attn_rows = (SR_ROWS + q - 1) / q;
  if (S > p.attn_ranks * DS_KV_TILE * SR_MAX_STEPS) return false;
  // w1 + w3: 128-column slices of F, each over sw_split K-splits whose
  // blocks exchange their partial sums; each split then forms the slice's
  // 128 g columns and takes those K-rows of w2 for its w2_tiles of D's
  // column tiles, so an element of x has sw_slices w2 partials
  p.sw_slices = F / SR_TILE;
  int split = ds_pow2_floor(grid / p.sw_slices > 0 ? grid / p.sw_slices : 1);
  if (split > 4) split = 4;
  while (split > 1 && (D / split) % SR_TILE != 0) split /= 2;
  p.sw_split = split;
  p.sw_units = p.sw_slices * split;
  p.w2_tiles = D / split / SR_TILE;
  if (p.sw_units > grid && split > 1) return false;  // a K-split group must run at once
  p.x_tiles = D / 8;
  p.owners = p.x_tiles < grid ? p.x_tiles : grid;
  ds_ksplit(D, W, SR_TILE, grid, p.head_tiles, p.head_splits, p.head_klen, p.head_units);
  p.syncs_per_layer = 3;
  auto per = [grid](int units) { return (units + grid - 1) / grid; };
  if (per(p.qkv_units) + per(p.attn_units) + 2 * per(p.sw_units) + per(p.head_units) >
          SR_MAX_SEGS ||
      3 + p.sw_slices + H > SR_LAUNCHES_WORD)
    return false;

  // shared memory
  p.h_pitch = D + 8;  // rows 16 bytes apart from a bank multiple: conflict-free B loads
  p.a_pitch = HDIM + 8;
  p.g_pitch = SR_TILE + 8;
  int off = 0;
  p.sm_h = off; off += ds_align(SR_ROWS * p.h_pitch * 2, 128);
  p.sm_a = off; off += ds_align(SR_ROWS * p.a_pitch * 2, 16);
  p.sm_g = off; off += ds_align(SR_ROWS * p.g_pitch * 2, 16);
  p.sm_nw = off; off += 2 * D * 2;  // a layer's ffn norm and the next norm
  p.sm_att = off;  // q/k/v of the unit's rows, the ranks' (max, sum), PV partials, scores
  int att = ds_align(4 * (p.attn_rows * 3 * HDIM + 2 * DS_WARPS + DS_WARPS * HDIM +
                          DS_WARPS * SR_MAX_STEPS * DS_KV_TILE),
                     16);
  if (work_bytes > p.sm_att - p.sm_h + att) att = ds_align(work_bytes - (p.sm_att - p.sm_h), 16);
  off += att;
  p.sm_seg = off; off += SR_SEG_BYTES;  // the segment and matrix tables, the positions
  p.sm_bar = off;
  // the ring's stages at 1024-byte boundaries, the 128-byte swizzle's
  int stages = (DS_SMEM_LIMIT - off - 1024) / (16 + p.stage_bytes);
  if (stages > SR_MAX_STAGES) stages = SR_MAX_STAGES;
  if (stages < SR_MIN_STAGES) return false;
  p.stages = stages;
  p.sm_ring = ds_align(off + 16 * stages, 1024);
  p.smem = p.sm_ring + stages * p.stage_bytes;
  if (p.smem > DS_SMEM_LIMIT) return false;

  // global scratch, each buffer SR_ROWS rows a unit
  int g = 0;
  p.sc_x = g; g += ds_align(2 * SR_ROWS * D * 2, 256);  // the published x, two buffers
  p.sc_qkv = g; g += ds_align(p.qkv_units * SR_ROWS * SR_TILE * 4, 256);
  p.sc_ax = g; g += ds_align(H * SR_ROWS * HDIM * 2, 256);  // the heads' attention outputs
  p.sc_wo = g; g += ds_align(H * SR_ROWS * D * 4, 256);
  p.sc_sw = g; g += ds_align(p.sw_units * 2 * SR_ROWS * SR_TILE * 4, 256);
  p.sc_w2 = g; g += ds_align(p.sw_slices * SR_ROWS * D * 4, 256);
  p.sc_head = g; g += ds_align(p.head_units * SR_ROWS * SR_TILE * 4, 256);
  p.sc_extra = g; g += ds_align(extra_scratch, 256);
  p.scratch_bytes = g;
  return true;
}

inline void sr_plan_ints(const SrPlan& p, int* out) {
  const int v[SR_PLAN_INTS] = {
      p.grid, p.stages, p.stage_bytes, p.smem, p.scratch_bytes,
      p.qkv_tiles, p.qkv_splits, p.qkv_klen, p.qkv_units,
      p.q_blocks, p.wo_tiles, p.attn_units, p.attn_ranks, p.attn_rows,
      p.sw_slices, p.sw_split, p.sw_units, p.w2_tiles, p.x_tiles, p.owners,
      p.head_tiles, p.head_splits, p.head_klen, p.head_units, p.syncs_per_layer};
  for (int i = 0; i < SR_PLAN_INTS; ++i) out[i] = v[i];
}

// stack_product with the column's scale already loaded as a float (see
// sr_scale4), so that the scale's load need not wait behind the partial
// sums it scales.
template <typename W>
__device__ __forceinline__ float sr_product(float y, float sc) {
  if constexpr (std::is_same<W, int8_t>::value)
    return round_bf16(__fmul_rn(round_bf16(y), sc));
  else
    return y;
}

__device__ __forceinline__ void unpack_bf16x8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// A weight segment a block streams: krows K-rows from row0 of matrix `mat`
// (0 wqkv, 1 wo, 2 w1 and w3 in turns, 4 w2, 5 the head), ntiles tiles of
// 128 columns from col0; tiles in order, each tile's stages K ascending.
struct SrSeg {
  int mat, row0, col0, krows, ntiles;
};

// The segments' six matrices (wqkv, wo, w1, w3, w2, the head): their
// bytes, row pitch and layer stride (the head has no layers); the bytes
// between two steps' column blocks of the head (the fast frame's
// depthwise head; else 0); the number of segments of a layer and of the
// head.
struct SrMats {
  const unsigned char* base[6];
  long long ld[6], stride[6];
  long long head_step;
  int nseg, nhead;
};

// A ring stage holds rps K-rows x 128 columns as a TMA copy would lay
// them out with the 128-byte swizzle: boxes of rps rows x 128 bytes (two of 64 columns
// for bf16, one of 128 for int8), 1024-byte aligned, in which the 16-byte
// piece c of row r sits at piece c ^ (r % 8) of the row, so the eight rows
// an ldmatrix phase reads fall in distinct banks. Bytes of a stage:
// rps * 128 * sizeof(element).

// The producer's copies: the producer warp's 32 lanes copy a stage's
// 16-byte pieces with cp.async in row order (whole 128-byte lines an
// instruction) to their swizzled places; pieces at or past `valid` bytes
// of a row are zero-filled.
template <bool BF16>
__device__ __forceinline__ void sr_stage_copy(uint32_t dst, const unsigned char* src,
                                              long long ld, long long valid, int rows,
                                              int lane) {
  constexpr int CPR = BF16 ? 16 : 8;  // 16-byte pieces a row
  for (int i = 0; i < rows * CPR / 32; ++i) {
    const int pc = i * 32 + lane;
    const int r = pc / CPR, c = pc % CPR;
    const bool ok = c * 16 < valid;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     dst + (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4)),
                 "l"(src + (long long)r * ld + (ok ? c * 16 : 0)), "r"(ok ? 16 : 0)
                 : "memory");
  }
}
constexpr int SR_FULL_ARRIVALS = 32;  // a stage's cp.async arrivals, one a lane

// The producer warp: for each of `steps` steps, the block's segments for
// L layer passes, then the head's (step s's column block), one stage at a
// time (tiles in order, each tile's stages K ascending, w1 and w3 in
// turns) into the ring, after the eight consumer warps released the
// stage's previous round; the 32 lanes' cp.async copies complete the
// stage's `full` barrier. A stage of the stack's weights holds 32 K-rows;
// of the bf16 head, stage_bytes / 256 (16 beside an int8 stack). The
// order never depends on the activations, so the ring runs ahead across
// layers and steps while the consumers wait at a sync or draw a token.
template <typename W>
__device__ __noinline__ void sr_produce(const SrSeg* segs, const SrMats* mats, int L, int steps,
                                        unsigned char* ring, uint32_t full, uint32_t empty,
                                        int stages, int stage_bytes) {
  const int lane = threadIdx.x - DS_THREADS;
  const uint32_t ring_a = ds_smem_addr(ring);
  int st = 0;
  int round = 0;
  for (int pass = 0; pass < steps * (L + 1); ++pass) {
    const int layer = pass % (L + 1);
    const long long head_off = (pass / (L + 1)) * mats->head_step;
    const bool head = layer == L;
    const int s0 = head ? mats->nseg : 0;
    const int s1 = head ? mats->nseg + mats->nhead : mats->nseg;
    for (int si = s0; si < s1; ++si) {
      const SrSeg sg = segs[si];
      const bool bf = head || sizeof(W) == 2;
      const int rps = stage_bytes / (SR_TILE * (bf ? 2 : 1));
      const int parts = sg.mat == 2 ? 2 : 1;
      for (int t = 0; t < sg.ntiles; ++t) {
        const int col = sg.col0 + t * SR_TILE;
        for (int k = 0; k < sg.krows; k += rps)
          for (int part = 0; part < parts; ++part) {
            const int m = sg.mat + part;  // w3 follows w1
            if (round > 0) ds_mbar_wait(empty + 8 * st, (round - 1) & 1);
            const uint32_t dst = ring_a + (uint32_t)st * stage_bytes;
            const uint32_t bar = full + 8 * st;
            const long long cb = (head ? head_off : 0) + (long long)col * (bf ? 2 : 1);
            const unsigned char* src = mats->base[m] + (head ? 0 : layer * mats->stride[m]) +
                                       (long long)(sg.row0 + k) * mats->ld[m] + cb;
            if (bf)
              sr_stage_copy<true>(dst, src, mats->ld[m], mats->ld[m] - cb, rps, lane);
            else
              sr_stage_copy<false>(dst, src, mats->ld[m], mats->ld[m] - cb, rps, lane);
            asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar)
                         : "memory");
            if (++st == stages) {
              st = 0;
              ++round;
            }
          }
      }
    }
  }
}

// The consumers' side of the ring: every warp takes every stage, in the
// producer's order, and releases it (one arrival a warp) when its share is
// read.
struct SrRing {
  const unsigned char* ring;
  uint32_t full, empty;
  int stages, stage_bytes, cst;
  uint32_t cph;

  __device__ __forceinline__ const unsigned char* wait() {
    ds_mbar_wait(full + 8 * cst, cph);
    return ring + (size_t)cst * stage_bytes;
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(empty + 8 * cst) : "memory");
    if (++cst == stages) {
      cst = 0;
      cph ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// Tensor-core products of the ring's stages
// ---------------------------------------------------------------------------

// acc[t] += the stage's RPS K-rows of this warp's columns x B rows t * 8..
// of bsm (pitch elements a row) at K index kb.., for n-tiles t < nt. The
// A fragments (the swizzled boxes): bf16, one ldmatrix.trans a k16 step
// (warp w's columns: pieces 2 (w % 4), + 1 of box w / 4); int8, one
// ldmatrix.trans of piece w of 32 K-rows as b16 pairs for two k16 steps,
// each lane's pairs of two adjacent rows the bytes int8_a_frag_words
// converts. The B fragments of two n-tiles: one ldmatrix (lane l: row
// (l / 16) * 8 + l % 8 of the pair, K half (l / 8) % 2).
template <typename T, int RPS>
__device__ __forceinline__ void sr_mma_stage(float (&acc)[SR_NT][4], const unsigned char* stage,
                                             const bf16* bsm, int pitch, int kb, int nt,
                                             int lane) {
  const int w = threadIdx.x >> 5;
  const bf16* bl = bsm + ((lane >> 4) * 8 + (lane & 7)) * pitch + kb + ((lane >> 3) & 1) * 8;
  auto step = [&](const unsigned (&a)[4], int j) {
#pragma unroll
    for (int tp = 0; tp < SR_NT / 2; ++tp)
      if (2 * tp < nt) {
        unsigned b[4];
        ldmatrix_x4(b, bl + tp * 16 * pitch + j * 16);
        mma_bf16(acc[2 * tp], a, b[0], b[1]);
        if (2 * tp + 1 < nt) mma_bf16(acc[2 * tp + 1], a, b[2], b[3]);
      }
  };
  if constexpr (std::is_same<T, int8_t>::value) {
#pragma unroll
    for (int j2 = 0; j2 < RPS / 32; ++j2) {
      const int r = j2 * 32 + lane;
      unsigned wv[4];
      ldmatrix_x4_trans(wv, stage + r * 128 + ((w ^ (r & 7)) << 4));
      unsigned a[4];
      int8_a_frag_words(a, wv[0], wv[1]);
      step(a, 2 * j2);
      int8_a_frag_words(a, wv[2], wv[3]);
      step(a, 2 * j2 + 1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < RPS / 16; ++j) {
      const int r = j * 16 + ((lane >> 4) << 3) + (lane & 7);
      const int c = ((w & 3) << 1) | ((lane >> 3) & 1);
      unsigned a[4];
      ldmatrix_x4_trans(a, stage + (w >> 2) * (RPS * 128) + r * 128 + ((c ^ (r & 7)) << 4));
      step(a, j);
    }
  }
}

// The warp's 16 columns of tile `tile`: acc to dst[b * ld + tile * 128 + c]
// for rows b < nb (fragment element (m, n) of n-tile t is column
// warp * 16 + m, permuted for int8, and row t * 8 + n).
template <typename T>
__device__ __forceinline__ void sr_emit(const float (&acc)[SR_NT][4], int tile, int nt, int nb,
                                        float* dst, int ld) {
  const int lane = threadIdx.x & 31;
  const int c0 = (threadIdx.x >> 5) * 16;
  const int g = lane >> 2;
  const int cq = lane & 3;
#pragma unroll
  for (int t = 0; t < SR_NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = g + (e >> 1) * 8;
      const int col = std::is_same<T, int8_t>::value ? int8_a_column(c0, m) : c0 + m;
      const int b = t * 8 + 2 * cq + (e & 1);
      if (t < nt && b < nb) dst[(size_t)b * ld + tile * SR_TILE + col] = acc[t][e];
    }
}

// One segment of `ntiles` tiles x krows K-rows from the ring (RPS K-rows a
// stage) times the B rows bsm (K index k0..), each warp its 16 columns of
// a tile over all the K-rows: f32 partial sums to dst (sr_emit). Trace
// mark `mark` (if >= 0): the segment's first stage has arrived.
template <typename T, int RPS = SR_STAGE_ROWS>
__device__ __forceinline__ void sr_gemm(SrRing& rg, const bf16* bsm, int pitch, int k0,
                                        int krows, int ntiles, int nt, int nb, float* dst, int ld,
                                        int pass = 0, int mark = -1) {
  const int lane = threadIdx.x & 31;
  for (int tile = 0; tile < ntiles; ++tile) {
    float acc[SR_NT][4] = {};
    for (int k = 0; k < krows; k += RPS) {
      const unsigned char* st = rg.wait();
      if (tile == 0 && k == 0 && mark >= 0) DS_MARK(pass, mark);
      sr_mma_stage<T, RPS>(acc, st, bsm, pitch, k0 + k, nt, lane);
      rg.release();
    }
    sr_emit<T>(acc, tile, nt, nb, dst, ld);
  }
}

// w1 and w3 over one 128-column tile: their stages come in turns. Trace
// mark `mark`: the first stage has arrived.
template <typename T>
__device__ __forceinline__ void sr_gemm_pair(SrRing& rg, const bf16* bsm, int pitch, int k0,
                                          int krows, int nt, int nb, float* dst1, float* dst3,
                                          int ld, int pass, int mark) {
  const int lane = threadIdx.x & 31;
  float a1[SR_NT][4] = {};
  float a3[SR_NT][4] = {};
  for (int k = 0; k < krows; k += SR_STAGE_ROWS) {
    const unsigned char* st = rg.wait();
    if (k == 0) DS_MARK(pass, mark);
    sr_mma_stage<T, SR_STAGE_ROWS>(a1, st, bsm, pitch, k0 + k, nt, lane);
    rg.release();
    sr_mma_stage<T, SR_STAGE_ROWS>(a3, rg.wait(), bsm, pitch, k0 + k, nt, lane);
    rg.release();
  }
  sr_emit<T>(a1, 0, nt, nb, dst1, ld);
  sr_emit<T>(a3, 0, nt, nb, dst3, ld);
}

// ---------------------------------------------------------------------------
// The kernel's arguments and its block-level pieces
// ---------------------------------------------------------------------------

template <typename W>
struct SrArgs {
  Stack<W> stack;
  const bf16* final_norm;  // (D,)
  const bf16* head;        // (D, head_ld): the gathered head padded to 16-byte rows
  int head_ld, head_n;
  const float* cos_t;
  const float* sin_t;
  bf16* ck;  // the group's first row of the (L, cache_b, KV, S, 64) caches
  bf16* cv;
  int cache_b, S;
  const int* pos;  // the group's (nb,) positions
  const bf16* x0;  // (nb, D)
  float* logits;   // (nb, head_n)
  bf16* hidden;    // (nb, D)
  int nb, L, D, H, KV, F;
  float eps;
  unsigned char* scratch;
  unsigned* state;
  SrPlan plan;
};

// h_s[b] <- bf16(RMSNorm(x[b]) * w) for rows b < nb of x (nb, D) bf16,
// eight threads a row (thread t: row t / 8, the 16-byte pieces t % 8 +
// 8 i): each reads its pieces past L1 into h_s (up to 16 in flight) and
// adds their squares in piece and column order; the row's eight sums meet
// in a fixed butterfly, and each thread normalises its own pieces, so no
// block barrier sits inside and a row's bits depend on its own values
// alone. w: the norm weights, in shared or global memory (shared: copied
// before the caller's last block barrier). Trace mark `mark` (if >= 0):
// thread 0 has read its pieces of x.
__device__ __noinline__ void sr_norm(const bf16* x, int nb, int D, const bf16* w, bf16* h_s,
                                     int pitch, float eps, int pass = 0, int mark = -1) {
  const int tid = threadIdx.x;
  const int r = tid >> 3, sub = tid & 7;
  const bool active = r < nb;
  const int per = D / 64;  // pieces a thread: 4..32
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)r * D) + sub;
  bf16* row = h_s + (size_t)r * pitch + sub * 8;
  float ss = 0.f;
  for (int i0 = 0; i0 < per; i0 += 16) {
    uint4 v[16];  // every element defined in every round: no value lives across rounds
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = active && i0 + k < per ? __ldcg(src + 8 * (i0 + k)) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (active && i0 + k < per) {
        float f[8];
        unpack_bf16x8(v[k], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss = __fadd_rn(ss, __fmul_rn(f[e], f[e]));
        *reinterpret_cast<uint4*>(row + 64 * (i0 + k)) = v[k];
      }
  }
  if (mark >= 0) DS_MARK(pass, mark);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) ss += __shfl_xor_sync(FULL, ss, off);
  if (!active) return;
  const float inv = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)D), eps));
  for (int i = 0; i < per; ++i) {
    float f[8], nw[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(row + 64 * i), f);
    unpack_bf16x8(*reinterpret_cast<const uint4*>(w + (sub + 8 * i) * 8), nw);
    uint4 o;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      h2[e] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f[2 * e], inv), nw[2 * e]),
                                    __fmul_rn(__fmul_rn(f[2 * e + 1], inv), nw[2 * e + 1]));
    *reinterpret_cast<uint4*>(row + 64 * i) = o;
  }
}

// The four columns sum_{i < n} src[i * stride] (n >= 1; src 16-byte
// aligned) in index order, read past L1: straight-line code, N loads at
// once (predicated off past n), then the adds; more than N terms take
// further rounds of N. Four columns a load cut the loads of a sum 4x.
template <int N>
__device__ __forceinline__ float4 sr_sum4(const float* src, size_t stride, int n) {
  float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = 0; base < n; base += N) {
    float4 v[N];  // every element defined in every round: no value lives across rounds
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = base + i < n
                 ? __ldcg(reinterpret_cast<const float4*>(src + (size_t)(base + i) * stride))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (base + i < n) {
        if (base + i == 0) {
          y = v[i];
        } else {
          y.x += v[i].x;
          y.y += v[i].y;
          y.z += v[i].z;
          y.w += v[i].w;
        }
      }
  }
  return y;
}

// Four bf16 values at p (8-byte aligned) as floats.
__device__ __forceinline__ void sr_load_bf16x4(const bf16* p, float (&f)[4]) {
  const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}

// The four scales of an int8 stack's columns n..n+3 (zeros for bf16).
template <typename W>
__device__ __forceinline__ void sr_scale4(const bf16* scale, int n, float (&sc)[4]) {
  if constexpr (std::is_same<W, int8_t>::value) {
    sr_load_bf16x4(scale + n, sc);
  } else {
    sc[0] = sc[1] = sc[2] = sc[3] = 0.f;
  }
}

// Four floats rounded to bf16, as 8 bytes.
__device__ __forceinline__ uint2 sr_pack_bf16x4(float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
}

// Attention unit u = (query head h, part q) of layer `layer`: the head's
// rows b = q, q + Q, ... (< nb). Their q, k and v from the QKV partials
// (the splits added in order, each product rounded to bf16), RoPE at
// pos[b], and, in the head group's first head's units, the new K/V row;
// then the attention of each (row, head): its 32-key tiles dealt
// round-robin to the row's R ranks (warps), scores in shared memory, each
// rank's max m_r and sum l_r of exp(s - m_r) (lane order, then a
// butterfly), m = max m_r and l = sum_r l_r exp(m_r - m) in rank order,
// the weights exp(s - m) / l rounded to bf16, each rank's PV over its
// tiles, the ranks added in order. Key pos comes from the unit's own
// rotated k and v, never from the cache. Writes the bf16 outputs to
// ax[h][b][64].
template <typename W>
__device__ __noinline__ void sr_attention(const SrArgs<W>& a, int layer, int u, const int* pos,
                                          const float* part_qkv, const bf16* s_qkv, float* att,
                                          bf16* ax, int pass) {
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int H = a.H, KV = a.KV, S = a.S, nb = a.nb;
  const int Q = P.q_blocks, R = P.attn_ranks, RW = DS_WARPS / R;
  const int h = u / Q, q = u % Q, group = H / KV, g = h / group;
  const bool write = h % group == 0;
  const int cnt = q < nb ? (nb - q + Q - 1) / Q : 0;
  float* ml = att + P.attn_rows * 3 * HDIM;  // [warp][max, sum]
  float* pv = ml + 2 * DS_WARPS;            // [warp][64]
  float* scw = pv + DS_WARPS * HDIM + warp * SR_MAX_STEPS * DS_KV_TILE;  // this warp's scores
  auto cache_off = [&](int b) {
    return (((size_t)layer * a.cache_b + b) * KV + g) * (size_t)S * HDIM;
  };

  // 1. q, k and v of the unit's rows, four columns (two RoPE pairs) a
  //    thread: the sum of the QKV splits' partials, each split's four
  //    columns one load, all at once; then RoPE and the cache row
  const size_t split_stride = (size_t)SR_ROWS * SR_TILE;
  for (int o = tid; o < cnt * 48; o += DS_THREADS) {
    const int i = o / 48, pr = o % 48, which = pr >> 4, d = 4 * (pr & 15);
    const int n = (which == 0 ? h : (which == 1 ? H + g : H + KV + g)) * HDIM + d;
    const int b = q + Q * i;
    const int p = pos[b];
    // the rotation's loads first, so that they do not wait behind the sums'
    float cs[2] = {0.f, 0.f}, sn[2] = {0.f, 0.f};
    if (which < 2) {
      const float2 c2 = __ldg(reinterpret_cast<const float2*>(a.cos_t + (size_t)p * (HDIM / 2) + d / 2));
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(a.sin_t + (size_t)p * (HDIM / 2) + d / 2));
      cs[0] = c2.x;
      cs[1] = c2.y;
      sn[0] = s2.x;
      sn[1] = s2.y;
    }
    const float4 y = sr_sum4<SR_MAX_SPLITS>(
        part_qkv + ((size_t)(n / SR_TILE) * P.qkv_splits * SR_ROWS + q + Q * i) * SR_TILE +
            n % SR_TILE,
        split_stride, P.qkv_splits);
    float sc[4];
    sr_scale4<W>(s_qkv, n, sc);
    float r[4] = {round_bf16(sr_product<W>(y.x, sc[0])), round_bf16(sr_product<W>(y.y, sc[1])),
                  round_bf16(sr_product<W>(y.z, sc[2])), round_bf16(sr_product<W>(y.w, sc[3]))};
    float* dst = att + (i * 3 + which) * HDIM + d;
    if (which < 2) {
      rope_pair(r[0], r[1], cs[0], sn[0], dst);
      rope_pair(r[2], r[3], cs[1], sn[1], dst + 2);
    } else {
      for (int e = 0; e < 4; ++e) dst[e] = r[e];
    }
    if (write && which > 0)
      *reinterpret_cast<uint2*>((which == 1 ? a.ck : a.cv) + cache_off(b) + (size_t)p * HDIM +
                                d) = sr_pack_bf16x4(dst[0], dst[1], dst[2], dst[3]);
  }
  ds_sync();
  DS_MARK(pass, 3);

  // 2. the rows, RW at a time: row i0 + warp / R, rank warp % R
  const float scale = 1.0f / sqrtf((float)HDIM);
  for (int i0 = 0; i0 < cnt; i0 += RW) {
    const int i = i0 + warp / R;
    const int rank = warp % R;
    const bool active = i < cnt;
    const int b = q + Q * (active ? i : i0);
    const int p = pos[b];
    const float* qf = att + i * 3 * HDIM;
    const float* kf = qf + HDIM;
    const float* vf = kf + HDIM;
    const bf16* kc = a.ck + cache_off(b);
    const bf16* vc = a.cv + cache_off(b);
    const int tiles = p / DS_KV_TILE + 1;
    const int ns = active && rank < tiles ? (tiles - rank + R - 1) / R : 0;
    // scores of the rank's keys, one a lane; the next step's K row in flight
    float mx = -INFINITY;
    auto load_k = [&](int s, uint4 (&kr)[8]) {
      const int j = min((rank + R * s) * DS_KV_TILE + lane, p > 0 ? p - 1 : 0);
#pragma unroll
      for (int c = 0; c < HDIM / 8; ++c)
        kr[c] = __ldcg(reinterpret_cast<const uint4*>(kc + (size_t)j * HDIM) + c);
    };
    uint4 kcur[8], knxt[8];
    if (ns > 0) load_k(0, kcur);
    for (int s = 0; s < ns; ++s) {
      if (s + 1 < ns) load_k(s + 1, knxt);
      const int j = (rank + R * s) * DS_KV_TILE + lane;
      float sj = -INFINITY;
      if (j <= p) {
        float d = 0.f;
        if (j == p) {
#pragma unroll
          for (int e = 0; e < HDIM; ++e) d = fmaf(qf[e], kf[e], d);
        } else {
#pragma unroll
          for (int c = 0; c < HDIM / 8; ++c) {
            float kv[8];
            unpack_bf16x8(kcur[c], kv);
#pragma unroll
            for (int e = 0; e < 8; ++e) d = fmaf(qf[c * 8 + e], kv[e], d);
          }
        }
        sj = __fmul_rn(d, scale);
      }
      scw[s * DS_KV_TILE + lane] = sj;
      mx = fmaxf(mx, sj);
#pragma unroll
      for (int c = 0; c < HDIM / 8; ++c) kcur[c] = knxt[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    float es = 0.f;
    for (int s = 0; s < ns; ++s) es += expf(__fsub_rn(scw[s * DS_KV_TILE + lane], mx));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) es += __shfl_xor_sync(FULL, es, off);
    if (lane == 0) {
      ml[2 * warp] = mx;
      ml[2 * warp + 1] = ns > 0 ? es : 0.f;
    }
    ds_sync();
    DS_MARK(pass, 24);
    // the row's m and l; the rank's PV (lane l holds dims 2l, 2l + 1)
    float a0 = 0.f, a1 = 0.f;
    if (ns > 0) {
      const int w0 = warp - rank;
      float m = -INFINITY;
      for (int r = 0; r < R; ++r)
        if (ml[2 * (w0 + r) + 1] > 0.f) m = fmaxf(m, ml[2 * (w0 + r)]);
      float l = 0.f;
      for (int r = 0; r < R; ++r) {
        const float lr = ml[2 * (w0 + r) + 1];
        if (lr > 0.f) l = __fadd_rn(l, __fmul_rn(lr, expf(__fsub_rn(ml[2 * (w0 + r)], m))));
      }
      for (int s = 0; s < ns; ++s) {
        // the tile's V rows at once (lane l: dims 2l, 2l + 1 of keys j0..p-1)
        __nv_bfloat162 vcur[DS_KV_TILE];
        {
          const int j0 = (rank + R * s) * DS_KV_TILE;
          const int last = max(min(j0 + DS_KV_TILE, p) - 1, 0);
#pragma unroll
          for (int k = 0; k < DS_KV_TILE; ++k)
            vcur[k] = __ldcg(reinterpret_cast<const __nv_bfloat162*>(
                                 vc + (size_t)min(j0 + k, last) * HDIM) + lane);
        }
        const int j0 = (rank + R * s) * DS_KV_TILE;
        const int jn = p - j0 < DS_KV_TILE ? p - j0 : DS_KV_TILE;  // cache keys of the tile
        const float wj = j0 + lane <= p
                             ? round_bf16(__fdiv_rn(expf(__fsub_rn(scw[s * DS_KV_TILE + lane], m)), l))
                             : 0.f;
#pragma unroll
        for (int k = 0; k < DS_KV_TILE; ++k) {
          const float wk = __shfl_sync(FULL, wj, k);
          if (k < jn) {
            const float2 v2 = __bfloat1622float2(vcur[k]);
            a0 = fmaf(wk, v2.x, a0);
            a1 = fmaf(wk, v2.y, a1);
          }
        }
        if (p < j0 + DS_KV_TILE) {  // key p, the tile's last
          const float wp = __shfl_sync(FULL, wj, p - j0);
          a0 = fmaf(wp, vf[2 * lane], a0);
          a1 = fmaf(wp, vf[2 * lane + 1], a1);
        }
      }
    }
    pv[warp * HDIM + 2 * lane] = a0;
    pv[warp * HDIM + 2 * lane + 1] = a1;
    ds_sync();
    DS_MARK(pass, 25);
    for (int o = tid; o < RW * HDIM; o += DS_THREADS) {
      const int ri = o / HDIM, d = o % HDIM, ii = i0 + ri;
      if (ii < cnt) {
        float sum = pv[ri * R * HDIM + d];
        for (int r = 1; r < R; ++r) sum = __fadd_rn(sum, pv[(ri * R + r) * HDIM + d]);
        ax[((size_t)h * SR_ROWS + q + Q * ii) * HDIM + d] = __float2bfloat16(sum);
      }
    }
    ds_sync();  // ml and pv are free for the next rows
  }
}

// g = bf16(bf16(silu(p(y1))) * bf16(p(y3))) of a slice's 128 columns
// (n0.. of F) for rows b < nb, into g_s (pitch elements a row): y1 and y3
// the sums of the slice's `split` K-split partials part[s][0 / 1][b][c]
// (each (2, SR_ROWS, 128) f32) in split order; silu sees the unrounded
// f32 w1 product (bf16 body) or the rescaled bf16 one (int8). Four
// columns a load; two groups of four a thread at once.
template <typename W>
__device__ __noinline__ void sr_swiglu_g(const float* part, int split, int nb,
                                         const bf16* s_1, const bf16* s_3, int n0, bf16* g_s,
                                         int pitch) {
  const size_t ss = (size_t)2 * SR_ROWS * SR_TILE;  // floats between splits
  // a thread's four columns are the same in every round (DS_THREADS is a
  // multiple of 32): their scales once
  const int c4 = (threadIdx.x % (SR_TILE / 4)) * 4;
  float sc1[4], sc3[4];
  sr_scale4<W>(s_1, n0 + c4, sc1);
  sr_scale4<W>(s_3, n0 + c4, sc3);
  const int groups = nb * (SR_TILE / 4);
  for (int base = 0; base < groups; base += 2 * DS_THREADS) {
    float4 y1[2], y3[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int o = min(base + (int)threadIdx.x + k * DS_THREADS, groups - 1);
      const float* src = part + (size_t)(o / (SR_TILE / 4)) * SR_TILE + c4;
      y1[k] = sr_sum4<4>(src, ss, split);
      y3[k] = sr_sum4<4>(src + (size_t)SR_ROWS * SR_TILE, ss, split);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int o = base + threadIdx.x + k * DS_THREADS;
      if (o < groups) {
        const float a1[4] = {y1[k].x, y1[k].y, y1[k].z, y1[k].w};
        const float a3[4] = {y3[k].x, y3[k].y, y3[k].z, y3[k].w};
        float gv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y0 = sr_product<W>(a1[e], sc1[e]);
          const float gate = round_bf16(__fdiv_rn(y0, __fadd_rn(1.f, expf(-y0))));
          const float up = round_bf16(sr_product<W>(a3[e], sc3[e]));
          gv[e] = __fmul_rn(gate, up);
        }
        *reinterpret_cast<uint2*>(g_s + (o / (SR_TILE / 4)) * pitch + c4) =
            sr_pack_bf16x4(gv[0], gv[1], gv[2], gv[3]);
      }
    }
  }
}

// A reduce-broadcast ending phase (b) or (c), grid sync si: x_new = x_old
// + bf16(p(sum of the partials)), part: ncontrib partials of (SR_ROWS, D)
// f32. Every block arrives; the owners (blocks grid-1, grid-2, ...) wait
// for all arrivals and add the partials of their 8-column tiles, each
// element over 4 lanes (contributors c = lane % 4 + 4 i, in order), then a
// fixed butterfly; they write x_new (and `hidden`, if given) and count
// themselves on `pub`; every block waits until pub reaches pub_target and
// normalises x_new with norm_w into h_s. Trace marks `mark` (7 or 15: the
// owners saw every arrival), mark + 1 (they published), 9 or 18 (the
// block saw the publishes) and 19 or 23 (it has read x).
template <typename W>
__device__ __noinline__ void sr_reduce_broadcast(const SrArgs<W>& a, const float* part,
                                                 int ncontrib, const bf16* scale,
                                                 const bf16* x_old, bf16* x_new, bf16* hidden,
                                                 unsigned si, unsigned pub_target,
                                                 const bf16* norm_w, bf16* h_s, int pass,
                                                 int mark) {
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  const int D = a.D, nb = a.nb;
  unsigned* cnt = a.state;
  unsigned* pub = a.state + 2;
  ds_arrive(cnt);
  const int o = G - 1 - (int)blockIdx.x;
  if (o < P.owners) {
    ds_wait_count(cnt, (si + 1) * (unsigned)G);
    DS_MARK(pass, mark);
    // thread t: row t / 8, columns (t / 4) % 2 * 4.. of the tile, and the
    // contributors c = t % 4 + 4 i, four columns a load; the four
    // threads' sums meet in a fixed butterfly
    const size_t cs = (size_t)SR_ROWS * D;  // floats between contributors
    const int cl = tid & 3, b = tid >> 3, c4 = ((tid >> 2) & 1) * 4;
    const bool active = b < nb;
    for (int t = o; t < P.x_tiles && warp * 4 < nb; t += P.owners) {
      const int off = b * D + t * 8 + c4;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      float xo[4], sc[4];
      if (active) {
        sr_load_bf16x4(x_old + off, xo);
        sr_scale4<W>(scale, t * 8 + c4, sc);
        if (cl < ncontrib) y = sr_sum4<8>(part + (size_t)cl * cs + off, 4 * cs, (ncontrib - cl + 3) / 4);
      }
#pragma unroll
      for (int m = 1; m <= 2; m <<= 1) {
        y.x += __shfl_xor_sync(FULL, y.x, m);
        y.y += __shfl_xor_sync(FULL, y.y, m);
        y.z += __shfl_xor_sync(FULL, y.z, m);
        y.w += __shfl_xor_sync(FULL, y.w, m);
      }
      if (active && cl == 0) {
        const float yv[4] = {y.x, y.y, y.z, y.w};
        float xn[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xn[e] = __fadd_rn(xo[e], round_bf16(sr_product<W>(yv[e], sc[e])));
        const uint2 v = sr_pack_bf16x4(xn[0], xn[1], xn[2], xn[3]);
        *reinterpret_cast<uint2*>(x_new + off) = v;
        if (hidden != nullptr) *reinterpret_cast<uint2*>(hidden + off) = v;
      }
    }
    ds_sync();
    if (tid == 0) ds_red_release(pub, 1u);
    DS_MARK(pass, mark + 1);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");  // this thread's copies of the norm weights
  ds_wait_count(pub, pub_target);
  DS_MARK(pass, mark == 7 ? 9 : 18);
  sr_norm(x_new, nb, D, norm_w, h_s, P.h_pitch, a.eps, pass, mark == 7 ? 19 : 23);
  ds_sync();
}

// ---------------------------------------------------------------------------
// What a kernel of the group shares: its memory, a layer pass, the head,
// the end of the launch
// ---------------------------------------------------------------------------

// The shared memory and scratch of a launch, as the plan lays them out.
struct SrMem {
  bf16* h_s;   // the group's normalised rows (SR_ROWS x h_pitch)
  bf16* a_s;   // a head's attention outputs
  bf16* g_s;   // a slice's g
  bf16* nw_s;  // [2][D]: a layer's ffn norm and the next norm
  float* att;
  SrSeg* segs;
  SrMats* mats;
  int* pos_s;  // the group's positions
  bf16* xg;    // [2][SR_ROWS][D]: the published x
  float* part_qkv;
  bf16* ax;
  float* part_wo;
  float* part_sw;
  float* part_w2;
  float* part_head;

  __device__ __forceinline__ static SrMem of(unsigned char* smem, unsigned char* scratch,
                                             const SrPlan& P) {
    SrMem m;
    m.h_s = reinterpret_cast<bf16*>(smem + P.sm_h);
    m.a_s = reinterpret_cast<bf16*>(smem + P.sm_a);
    m.g_s = reinterpret_cast<bf16*>(smem + P.sm_g);
    m.nw_s = reinterpret_cast<bf16*>(smem + P.sm_nw);
    m.att = reinterpret_cast<float*>(smem + P.sm_att);
    m.segs = reinterpret_cast<SrSeg*>(smem + P.sm_seg);
    m.mats = reinterpret_cast<SrMats*>(smem + P.sm_seg + SR_MAX_SEGS * sizeof(SrSeg));
    m.pos_s = reinterpret_cast<int*>(smem + P.sm_seg + SR_SEG_BYTES - 4 * SR_ROWS);
    m.xg = reinterpret_cast<bf16*>(scratch + P.sc_x);
    m.part_qkv = reinterpret_cast<float*>(scratch + P.sc_qkv);
    m.ax = reinterpret_cast<bf16*>(scratch + P.sc_ax);
    m.part_wo = reinterpret_cast<float*>(scratch + P.sc_wo);
    m.part_sw = reinterpret_cast<float*>(scratch + P.sc_sw);
    m.part_w2 = reinterpret_cast<float*>(scratch + P.sc_w2);
    m.part_head = reinterpret_cast<float*>(scratch + P.sc_head);
    return m;
  }
};

// The consumers' place in a launch: grid syncs and publishes of x so far,
// the xg buffer of the next publish, and the residual x.
struct SrFlow {
  unsigned si;  // grid syncs so far (sync i completes at (i + 1) * grid arrivals)
  unsigned np;  // x publishes so far (each counts `owners` on pub)
  int buf;
  const bf16* x_prev;
};

// The launch's first steps, by the whole block: the B operands' padded
// rows zero; then thread 0 lays out this block's segments in the order
// its phases take them, the matrix table (head_step: bytes between two
// steps' column blocks of the head) and the ring's mbarriers. The caller
// sets its positions and then syncs the whole block.
template <typename W>
__device__ __forceinline__ void sr_setup(const SrArgs<W>& a, const SrMem& m, unsigned char* smem,
                                         long long head_step) {
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int G = gridDim.x;
  const int D = a.D, F = a.F;
  const int QKV = (a.H + 2 * a.KV) * HDIM;
  const int Q = P.q_blocks;
  const int kr = D / P.sw_split;
  for (int i = tid; i < (P.sm_att - P.sm_h) / 16; i += DS_BLOCK)
    reinterpret_cast<uint4*>(smem + P.sm_h)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid != 0) return;
  SrSeg* segs = m.segs;
  SrMats* mats = m.mats;
  int n = 0;
  for (int u = blk; u < P.qkv_units; u += G) {
    const int k0 = (u % P.qkv_splits) * P.qkv_klen;
    segs[n++] = {0, k0, (u / P.qkv_splits) * SR_TILE, min(P.qkv_klen, D - k0), 1};
  }
  for (int u = blk; u < P.attn_units; u += G)
    segs[n++] = {1, (u / Q) * HDIM, (u % Q) * P.wo_tiles * SR_TILE, HDIM, P.wo_tiles};
  for (int u = blk; u < P.sw_units; u += G) {
    const int t = u / P.sw_split, hh = u % P.sw_split;
    segs[n++] = {2, hh * kr, t * SR_TILE, kr, 1};
    segs[n++] = {4, t * SR_TILE, hh * P.w2_tiles * SR_TILE, SR_TILE, P.w2_tiles};
  }
  mats->nseg = n;
  for (int u = blk; u < P.head_units; u += G) {
    const int k0 = (u % P.head_splits) * P.head_klen;
    segs[n++] = {5, k0, (u / P.head_splits) * SR_TILE, min(P.head_klen, D - k0), 1};
  }
  mats->nhead = n - mats->nseg;
  const Stack<W>& st = a.stack;
  const long long es = sizeof(W);
  const void* bases[6] = {st.wqkv, st.wo, st.w1, st.w3, st.w2, a.head};
  const long long cols[6] = {QKV, D, F, F, D, a.head_ld};
  const int rows[6] = {D, D, D, D, F, D};
  for (int i = 0; i < 6; ++i) {
    const long long ld = cols[i] * (i == 5 ? 2 : es);
    mats->base[i] = static_cast<const unsigned char*>(bases[i]);
    mats->ld[i] = ld;
    mats->stride[i] = i == 5 ? 0 : rows[i] * ld;
  }
  mats->head_step = head_step;
  for (int i = 0; i < P.stages; ++i) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     ds_smem_addr(smem + P.sm_bar + 8 * i)),
                 "r"(SR_FULL_ARRIVALS)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                     ds_smem_addr(smem + P.sm_bar + 8 * (P.stages + i))),
                 "r"(DS_WARPS)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One grid sync of the consumers: every block arrives, every block waits
// for all arrivals.
__device__ __forceinline__ void sr_grid_sync(unsigned* cnt, unsigned& si) {
  ds_arrive(cnt);
  ds_wait_count(cnt, (si + 1) * (unsigned)gridDim.x);
  ++si;
}

// Layer l of the stack on the group's rows (positions pos_s), entered with
// h_s = RMSNorm(x) under the layer's attention norm and fl.x_prev = x;
// left with h_s = RMSNorm(x') under the next layer's norm (the final norm
// after the last layer) and fl.x_prev = x'. pass: the launch's layer passes
// before this one (its trace slot, and each head's and F slice's
// exchanges so far); hidden, if given, gets x'. before(): the caller's
// work at the pass's start (the row kernel's cache prefetch).
template <typename W, typename Before>
__device__ __forceinline__ void sr_layer(const SrArgs<W>& a, const SrMem& m, SrRing& rg,
                                         SrFlow& fl, int l, int pass, bf16* hidden,
                                         Before before) {
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int G = gridDim.x;
  const int D = a.D, H = a.H, KV = a.KV, F = a.F, L = a.L, nb = a.nb;
  const int QKV = (H + 2 * KV) * HDIM;
  const int nt = (nb + 7) / 8;
  const int Q = P.q_blocks;
  const int kr = D / P.sw_split;
  unsigned* grp = a.state + 3;   // each F slice's K-split group, then each head's exchanges
  unsigned* hcnt = grp + P.sw_slices;
  // the layer's stack, its pointers taken where used (none held across the layer)
  auto lw = [&]() { return a.stack.layer(l, D, QKV, F); };
  DS_MARK(pass, 0);
  DS_MARK_CLK(pass, 30);
  before();
  {
    // the layer's ffn norm and the next norm into shared memory, by
    // cp.async; each thread waits for its own copies before the norm that
    // reads them, whose block barrier makes them everyone's
    const bf16* next = l + 1 < L ? a.stack.layer(l + 1, D, QKV, F).attn_norm : a.final_norm;
    for (int i = tid; i < 2 * D / 8; i += DS_THREADS) {
      const bf16* src = (i < D / 8 ? lw().ffn_norm : next - D) + i * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       ds_smem_addr(m.nw_s + i * 8)),
                   "l"(src)
                   : "memory");
    }
  }

  // (a) QKV partials
  for (int u = blk; u < P.qkv_units; u += G) {
    const int k0 = (u % P.qkv_splits) * P.qkv_klen;
    sr_gemm<W>(rg, m.h_s, P.h_pitch, k0, min(P.qkv_klen, D - k0), 1, nt, nb,
               m.part_qkv + (size_t)u * SR_ROWS * SR_TILE, SR_TILE, pass, 28);
  }
  DS_MARK(pass, 1);
  sr_grid_sync(a.state, fl.si);
  DS_MARK(pass, 2);

  // (b) attention of the block's heads; their exchange; wo partials
  for (int u = blk; u < P.attn_units; u += G) {
    const int h = u / Q;
    sr_attention<W>(a, l, u, m.pos_s, m.part_qkv, lw().s_qkv, m.att, m.ax, pass);
    DS_MARK(pass, 4);
    unsigned hx = (unsigned)pass;  // this head's exchanges before this pass's
    ds_head_exchange(hcnt + h, hx, Q);
    DS_MARK(pass, 5);
    for (int o = tid; o < nb * (HDIM / 8); o += DS_THREADS) {
      const int b = o / (HDIM / 8), c = o % (HDIM / 8);
      *reinterpret_cast<uint4*>(m.a_s + b * P.a_pitch + c * 8) =
          __ldcg(reinterpret_cast<const uint4*>(m.ax + ((size_t)h * SR_ROWS + b) * HDIM) + c);
    }
    ds_sync();
    sr_gemm<W>(rg, m.a_s, P.a_pitch, 0, HDIM, P.wo_tiles, nt, nb,
               m.part_wo + (size_t)h * SR_ROWS * D + (u % Q) * P.wo_tiles * SR_TILE, D, pass,
               29);
    ds_sync();  // a_s is free for the next unit
  }
  DS_MARK(pass, 6);
  sr_reduce_broadcast<W>(a, m.part_wo, H, lw().s_o, fl.x_prev, m.xg + fl.buf * SR_ROWS * D,
                         nullptr, fl.si, (fl.np + 1) * (unsigned)P.owners, m.nw_s, m.h_s, pass, 7);
  fl.x_prev = m.xg + fl.buf * SR_ROWS * D;
  ++fl.si;
  ++fl.np;
  fl.buf ^= 1;
  DS_MARK(pass, 10);

  // (c) w1 + w3 partials, the K-split group's exchange, g, w2 partials
  for (int u = blk; u < P.sw_units; u += G) {
    const int t = u / P.sw_split, hh = u % P.sw_split;
    float* mine = m.part_sw + (size_t)u * 2 * SR_ROWS * SR_TILE;
    sr_gemm_pair<W>(rg, m.h_s, P.h_pitch, hh * kr, kr, nt, nb, mine, mine + SR_ROWS * SR_TILE,
                    SR_TILE, pass, 26);
    DS_MARK(pass, 11);
    ds_sync();
    if (tid == 0) {
      ds_red_release(grp + t, 1u);
      ds_spin_geq(grp + t, (unsigned)(pass + 1) * P.sw_split);
    }
    ds_sync();
    DS_MARK(pass, 12);
    sr_swiglu_g<W>(m.part_sw + (size_t)t * P.sw_split * 2 * SR_ROWS * SR_TILE, P.sw_split, nb,
                   lw().s_1, lw().s_3, t * SR_TILE, m.g_s, P.g_pitch);
    ds_sync();
    DS_MARK(pass, 13);
    sr_gemm<W>(rg, m.g_s, P.g_pitch, 0, SR_TILE, P.w2_tiles, nt, nb,
               m.part_w2 + (size_t)t * SR_ROWS * D + hh * P.w2_tiles * SR_TILE, D, pass, 27);
    ds_sync();  // g_s is free for the next unit
  }
  DS_MARK(pass, 14);
  // the new x, normalised for the next layer (or the head)
  sr_reduce_broadcast<W>(a, m.part_w2, P.sw_slices, lw().s_2, fl.x_prev,
                         m.xg + fl.buf * SR_ROWS * D, hidden, fl.si,
                         (fl.np + 1) * (unsigned)P.owners, m.nw_s + D, m.h_s, pass, 15);
  fl.x_prev = m.xg + fl.buf * SR_ROWS * D;
  ++fl.si;
  ++fl.np;
  fl.buf ^= 1;
  DS_MARK(pass, 17);
  DS_MARK_CLK(pass, 31);
}

// The head's partials of this block's units (step `head` columns of the
// ring's head segments) from h_s: f32, unrounded, to part_head.
template <typename W>
__device__ __forceinline__ void sr_head_partials(const SrArgs<W>& a, const SrMem& m, SrRing& rg) {
  const SrPlan& P = a.plan;
  const int nb = a.nb;
  for (int u = blockIdx.x; u < P.head_units; u += gridDim.x) {
    const int k0 = (u % P.head_splits) * P.head_klen;
    // the bf16 head's stages hold as many K-rows as half the stack's (int8)
    float* dst = m.part_head + (size_t)u * SR_ROWS * SR_TILE;
    sr_gemm<bf16, sizeof(W) == 2 ? SR_STAGE_ROWS : SR_STAGE_ROWS / 2>(
        rg, m.h_s, P.h_pitch, k0, min(P.head_klen, a.D - k0), 1, (nb + 7) / 8, nb, dst, SR_TILE);
  }
}

// The launch's end: the last block to finish counts the launch in word
// `launches_word`, reports its grid syncs and head 0's exchanges (the last
// two state words) and sets the sync counters back to zero: arrivals,
// finished blocks, publishes, each F slice's group and each head's
// exchanges.
template <typename W>
__device__ __forceinline__ void sr_finish(const SrArgs<W>& a, int launches_word) {
  const SrPlan& P = a.plan;
  unsigned* cnt = a.state;
  unsigned* done = a.state + 1;
  unsigned* pub = a.state + 2;
  unsigned* grp = a.state + 3;
  ds_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      atomicAdd(a.state + launches_word, 1u);
      a.state[DS_STATE_WORDS - 2] = ds_ld_relaxed(cnt) / gridDim.x;
      a.state[DS_STATE_WORDS - 1] = ds_ld_relaxed(grp + P.sw_slices) / (unsigned)P.q_blocks;
      *cnt = 0;
      *pub = 0;
      for (int i = 0; i < P.sw_slices + a.H; ++i) grp[i] = 0;
      *done = 0;
      __threadfence();
    }
  }
}

}  // namespace
