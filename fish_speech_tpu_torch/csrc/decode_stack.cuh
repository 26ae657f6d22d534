// The persistent decode stack shared by the fused slow step (slow_step.cu)
// and the fused batch-1 fast frame (fast_frame.cu), for Hopper (sm_90a).
//
// One cooperative launch runs every layer of a stack and its head (the
// slow step's, or one codebook step of the fast frame up to its head's
// partials, whose draw ds_sampler_kernel makes next) on one block per SM (cudaLaunchKernelEx with the cooperative attribute: every block is
// resident, so the grid syncs below cannot deadlock beside other streams'
// kernels). What bounds this work on the H100 is the weight stream (bytes:
// at B <= 4 a weight element feeds <= 8 flops) and the chain of dependent
// phases between the layers' reductions. A layer's ~30 MB of bf16 weights
// take ~9 us at the card's 3.35 TB/s; the weights never depend on the
// activations, so the design streams them ahead of the chain:
//
// * The plan. Each GEMV is cut into work units from the shapes, the
//   weight type and the grid alone (ds_make_plan; mirrored by
//   ops/decode_stack.py::stack_plan): QKV into tiles of whole 128-byte
//   lines a row (64 bf16 or 128 int8 columns) x K-splits (units <= grid);
//   wo into (head h, column part q) units, Q parts a head, so the block
//   that owns (h, q) also computes head h's attention; w1 + w3 into
//   line-wide slices of F, each K-split over 2 (bf16) or 4 (int8) blocks
//   that exchange their partial sums, after which the block of split h
//   owns the slice's g columns h * sw_cols / split.. and those K-rows of w2
//   (all D columns). Unit u of a phase runs on block u mod grid. The plan
//   never depends on the batch or the data, so a row's bits do not depend
//   on its co-tenants.
// * The weight ring. A ninth warp of each block, the producer, walks the
//   block's units' weight pieces across phases and layers in one fixed
//   order and copies them (cp.async, 16 bytes bf16 or 8 bytes
//   int8 a thread's piece) into a ring of ~40-90 stages (~180 KB a block,
//   ~24 MB across the card) whose mbarriers count the copies (full) and
//   the 256 consumer threads' releases (empty). A consumer thread reads
//   only its own slot of a stage, so taking a piece needs no block
//   barrier; the producer keeps fetching the coming phases while the
//   consumers wait at a grid sync or compute attention. (Bulk copies
//   (cp.async.bulk) of each row's tile were tried: on 128-256-byte rows
//   the stream was half as fast.)
// * Few grid syncs, three a layer: (a) RMSNorm + QKV partials; sync; (b)
//   QKV reduced on read by the attention blocks, RoPE, K/V row write,
//   attention, wo partials; sync, after which every block adds the 16
//   heads' wo partials of all of x itself; (c) RMSNorm, w1 + w3 partials,
//   the K-split group's exchange, g, w2 partials; reduce-broadcast: every
//   block arrives on one counter, `owners` blocks wait for all arrivals,
//   each adds the 128 partials of its 8-column tiles of x in fixed order
//   (lane-strided, then a fixed butterfly), writes them to xg and counts
//   itself on a publish counter, and every block waits for all owners and
//   reads the new x. The residual x (B x D bf16) is replicated in every
//   block's shared memory and is bit-identical in all of them.
// * Grid sync state. Monotonic counters (arrivals: sync i completes at
//   (i + 1) * grid; publishes; each F slice's group; each head's key-split
//   exchanges) and a counter of finished blocks: the last block to finish
//   counts the launch, writes its grid syncs and head 0's exchanges into
//   the last state words and sets the counters back to 0, so every call
//   (and every CUDA graph replay) starts from zeros and the wrapper never
//   clears them. Every wait gives up with a trap after DS_TIMEOUT_NS
//   instead of hanging the card.
// * Attention of (row, head) on the head's Q blocks, in decode_attention.cu's
//   scheme: the keys in 32-key tiles dealt round-robin to P = Q ranks,
//   per-rank max m_r and sum l_r, m = max m_r, l = sum_r l_r exp(m_r - m)
//   in rank order, weights exp(s - m) / l rounded to bf16 before PV,
//   per-rank PV partials added in rank order. Up to DS_SPLIT_TILES tiles
//   (256 keys: a tile a rank) each of the Q blocks computes all ranks
//   itself, a warp a rank, and they exchange nothing; past that
//   block q is rank q and the head's blocks exchange their (m_r, l_r) and
//   their PV partials through global scratch behind a per-head counter, so
//   a 4096-key cache is read once per head, by all Q blocks together. Key
//   pos comes from each block's own rotated k/v, never from the cache row
//   that the head's first block writes. The cache rows are prefetched into
//   L2 a layer ahead.
// * Every bf16 rounding sits where dual_ar_layer.cuh lists it; int8
//   products are stack_product's (exact conversion, f32 sum, bf16, times
//   the scale, bf16). Heads (the slow stack's gathered head, the fast
//   head's codebook block) are read with direct loads, prefetched into L2
//   during the last layer, since the slow head's rows (1025 columns) are
//   not 16-byte aligned.
// * What still holds it back (scripts/trace_decode_stack.py's phase trace,
//   PERF.md section 6): the consumers' dependent chain, not the weight
//   stream. A slow-step layer pass takes ~32 us against ~9 us of weight
//   bytes, and about as long when the producer moves no weights (PERF.md
//   section 6): ~170 cycles a ring piece, ~0.25 us a block barrier step,
//   ~1.5 us a grid sync and ~1 us an L2 round trip, on 8 consumer warps
//   an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// A phase trace, compiled only into an instrumented copy built with
// -DDS_TRACE (scripts/trace_decode_stack.py): thread 0 of each block
// writes %globaltimer at DS_TRACE_MARKS marks of each layer pass (the
// fast frame's sampler launch into block 0's slots of its step's last
// pass).
#ifdef DS_TRACE
namespace {
constexpr int DS_TRACE_PASSES = 48;  // the batched frame adds a pass a step for its draw
constexpr int DS_TRACE_MARKS = 32;
__device__ unsigned long long ds_trace_buf[1024 * DS_TRACE_PASSES * DS_TRACE_MARKS];
__device__ __forceinline__ void ds_trace_at(int pass, int k, unsigned long long v) {
  if (threadIdx.x == 0 && pass < DS_TRACE_PASSES)
    ds_trace_buf[(blockIdx.x * DS_TRACE_PASSES + pass) * DS_TRACE_MARKS + k] = v;
}
__device__ __forceinline__ unsigned long long ds_trace_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
}  // namespace
#define DS_MARK(pass, k) ds_trace_at((pass), (k), ds_trace_now())
// the SM's cycle counter, for the clock rate over a pass (marks 30, 31)
#define DS_MARK_CLK(pass, k) ds_trace_at((pass), (k), clock64())
#else
#define DS_MARK(pass, k) \
  do {                   \
  } while (0)
#define DS_MARK_CLK(pass, k) \
  do {                       \
  } while (0)
#endif

#include "codebook_sampler.cuh"
#include "dual_ar_layer.cuh"

namespace {

constexpr int DS_THREADS = 256;     // consumer threads: every phase's compute
constexpr int DS_WARPS = DS_THREADS / 32;
constexpr int DS_BLOCK = DS_THREADS + 32;  // and one producer warp that fills the ring
constexpr int DS_MAX_ROWS = 4;       // batch rows the slow step takes
constexpr int DS_TILE = 64;          // columns of a head tile (and of a bf16 QKV tile)
constexpr int DS_KV_TILE = 32;       // keys of an attention tile
constexpr int DS_MAX_Q = 8;          // blocks (and key ranks) a head
constexpr int DS_SMEM_LIMIT = 232448;  // dynamic shared memory a block may use on sm_90
constexpr int DS_MAX_STAGES = 128;
constexpr int DS_MAX_SEGS = 16;      // weight segments a block streams each layer
constexpr int DS_STATE_WORDS = 1024;  // arrivals, finished blocks, publishes, F-slice groups,
                                      // heads' exchanges; the last four: launches of the
                                      // sampler and of the persistent kernel so far, the
                                      // last launch's grid syncs and head 0's exchanges
constexpr int DS_SPLIT_TILES = 8;    // attention of more key tiles is split over a head's blocks
constexpr int DS_PLAN_INTS = 24;
constexpr unsigned long long DS_TIMEOUT_NS = 4000000000ull;


// ---------------------------------------------------------------------------
// The plan: a function of the shapes, the weight type and the grid
// ---------------------------------------------------------------------------

struct DsPlan {
  // the numbers fs_decode_stack_plan reports, in this order
  int grid, stages, piece_bytes, smem, scratch_bytes;
  int qkv_cols, qkv_tiles, qkv_splits, qkv_klen, qkv_units;
  int q_blocks, wo_cols, attn_units, kv_ranks;
  int sw_cols, sw_split, sw_units;
  int x_tiles, owners;
  int head_tiles, head_splits, head_klen, head_units;
  int syncs_per_layer;
  // shared memory offsets (bytes)
  int sm_x, sm_h, sm_attn, sm_g, sm_seg, sm_scr, sm_bar, sm_ring, s_pad;
  // global scratch offsets (bytes)
  int sc_x, sc_qkv, sc_wo, sc_sw, sc_w2, sc_head, sc_xch, sc_xn;
};

inline int ds_pow2_floor(int v) {
  int p = 1;
  while (p * 2 <= v) p *= 2;
  return p;
}
inline int ds_align(int v, int a) { return (v + a - 1) / a * a; }

// A (K, N) product as `cols`-column tiles x K-splits of klen rows
// (multiples of 32), as many splits as keep tiles * splits within the grid.
inline void ds_ksplit(int K, int N, int cols, int grid, int& tiles, int& splits, int& klen,
                      int& units) {
  tiles = (N + cols - 1) / cols;
  const int chunks = K / 32;
  int s = grid / tiles;
  if (s < 1) s = 1;
  if (s > chunks) s = chunks;
  klen = (chunks + s - 1) / s * 32;
  splits = (K + klen - 1) / klen;
  units = tiles * splits;
}

// Bytes of the GEMV reduction scratch: every thread's 8 column sums of
// each row.
constexpr int DS_RED_BYTES = DS_THREADS * DS_MAX_ROWS * 8 * 4;

// fast: 0 for the slow step, 1 for the fast frame. head_n: the head's
// columns (the slow step's W, the fast frame's V); S: the cache length
// (the fast frame's C). Returns false when the shapes are outside the
// kernel's limits.
inline bool ds_make_plan(int fast, int D, int H, int KV, int F, int head_n, int S, bool int8,
                         int grid, DsPlan& p) {
  p = DsPlan{};
  if (grid < 1 || KV < 1 || H % KV != 0 || H * HDIM != D || F < 64 || F % 64 != 0 ||
      head_n < 1 || S < 1 || (fast && head_n > 4 * 1024))
    return false;
  if (D != 256 && D != 512 && D != 1024 && D != 2048) return false;
  p.grid = grid;
  p.piece_bytes = int8 ? 8 : 16;
  const int QKV = (H + 2 * KV) * HDIM;
  // QKV and w1/w3 tiles of whole 128-byte lines a row: 64 bf16 or 128
  // int8 columns (the card keeps a bounded number of line requests in
  // flight an SM, so half lines halve the stream)
  p.qkv_cols = int8 ? 128 : 64;
  ds_ksplit(D, QKV, p.qkv_cols, grid, p.qkv_tiles, p.qkv_splits, p.qkv_klen, p.qkv_units);
  int q = ds_pow2_floor(grid / H > 0 ? grid / H : 1);
  if (q > DS_MAX_Q) q = DS_MAX_Q;
  if (q > D / 32) q = D / 32;
  p.q_blocks = q;
  p.wo_cols = D / q;
  p.attn_units = H * q;
  p.kv_ranks = q;
  // w1/w3: sw_cols-column slices of F, each over sw_split K-splits whose
  // blocks exchange their partial sums; the block of split h then owns the
  // slice's g columns h * sw_cols / sw_split.. and those K-rows of w2
  p.sw_cols = int8 ? 128 : 64;
  if (F % p.sw_cols != 0) return false;
  int split = ds_pow2_floor(grid / (F / p.sw_cols) > 0 ? grid / (F / p.sw_cols) : 1);
  if (split > 4) split = 4;
  while (split > 1 && (D % (split * 32) != 0 || p.sw_cols / split < 8)) split /= 2;
  p.sw_split = split;
  p.sw_units = F / p.sw_cols * split;
  if (p.sw_units > grid && split > 1) return false;  // a K-split group must run at once
  p.x_tiles = D / 8;
  p.owners = p.x_tiles < grid ? p.x_tiles : grid;
  ds_ksplit(D, head_n, DS_TILE, grid, p.head_tiles, p.head_splits, p.head_klen, p.head_units);
  p.syncs_per_layer = 3;
  const int segs = (p.qkv_units + grid - 1) / grid + (p.attn_units + grid - 1) / grid +
                   2 * ((p.sw_units + grid - 1) / grid);
  if (segs > DS_MAX_SEGS || 3 + F / p.sw_cols + H + 4 > DS_STATE_WORDS) return false;

  // shared memory
  int off = 0;
  p.sm_x = off; off += ds_align(DS_MAX_ROWS * D * 2, 16);
  p.sm_h = off; off += ds_align(DS_MAX_ROWS * D * 2, 16);
  p.sm_attn = off; off += ds_align(DS_MAX_ROWS * HDIM * 2, 16);
  p.sm_g = off; off += ds_align(DS_MAX_ROWS * p.sw_cols * 2, 16);
  p.sm_seg = off; off += 512;  // DS_MAX_SEGS segments and the weight table
  int scr = DS_RED_BYTES;
  p.s_pad = ds_align(S, DS_KV_TILE);
  const int attn = 4 * (p.s_pad + 2 * (p.s_pad / DS_KV_TILE) + 2 * DS_MAX_Q + DS_MAX_Q * HDIM +
                        6 * HDIM);
  scr = scr > attn ? scr : attn;
  const int head_red = 4 * 4 * DS_MAX_ROWS * DS_TILE;
  scr = scr > head_red ? scr : head_red;
  p.sm_scr = off; off += ds_align(scr, 16);
  p.sm_bar = off;
  const int stage = 16 + DS_THREADS * p.piece_bytes;  // two mbarriers and the pieces
  int stages = (DS_SMEM_LIMIT - off - 16) / stage;
  if (stages > DS_MAX_STAGES) stages = DS_MAX_STAGES;
  if (stages < 2) return false;
  p.stages = stages;
  p.sm_ring = ds_align(off + 16 * stages, 16);
  p.smem = p.sm_ring + stages * DS_THREADS * p.piece_bytes;
  if (p.smem > DS_SMEM_LIMIT) return false;

  // global scratch: x (two buffers) and the partial sums of each phase
  int g = 0;
  p.sc_x = g; g += ds_align(2 * DS_MAX_ROWS * D * 2, 256);
  p.sc_qkv = g; g += ds_align(p.qkv_units * DS_MAX_ROWS * p.qkv_cols * 4, 256);
  p.sc_wo = g; g += ds_align(H * DS_MAX_ROWS * D * 4, 256);
  p.sc_sw = g; g += ds_align(p.sw_units * DS_MAX_ROWS * 2 * p.sw_cols * 4, 256);
  p.sc_w2 = g; g += ds_align(p.sw_units * DS_MAX_ROWS * D * 4, 256);
  p.sc_head = g; g += ds_align(p.head_units * DS_MAX_ROWS * DS_TILE * 4, 256);
  p.sc_xch = g; g += ds_align(H * DS_MAX_Q * (2 + HDIM) * 4, 256);  // heads' key-split exchanges
  p.sc_xn = g; g += ds_align(D * 2, 256);  // the fast frame's next x, from its sampler
  p.scratch_bytes = g;
  return true;
}

inline void ds_plan_ints(const DsPlan& p, int* out) {
  const int v[DS_PLAN_INTS] = {
      p.grid, p.stages, p.piece_bytes, p.smem, p.scratch_bytes,
      p.qkv_cols, p.qkv_tiles, p.qkv_splits, p.qkv_klen, p.qkv_units,
      p.q_blocks, p.wo_cols, p.attn_units, p.kv_ranks,
      p.sw_cols, p.sw_split, p.sw_units, p.x_tiles, p.owners,
      p.head_tiles, p.head_splits, p.head_klen, p.head_units, p.syncs_per_layer};
  for (int i = 0; i < DS_PLAN_INTS; ++i) out[i] = v[i];
}

// The grid: one block on every SM of the current device.
inline cudaError_t ds_grid(int& grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&grid, cudaDevAttrMultiProcessorCount, dev);
}

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ds_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long ds_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool ds_mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned ds_ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void ds_prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// sum_{i < n} src[i * stride] in index order (n >= 1), read past L1. The
// loads of each group of NW are issued together (clamped addresses, the
// adds predicated), so a sum waits for one L2 round trip per NW terms
// instead of one per term.
template <int NW = 8>
__device__ __forceinline__ float ds_sum_strided(const float* src, size_t stride, int n) {
  float y = 0.f;
  for (int base = 0; base < n; base += NW) {
    float v[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) v[i] = __ldcg(src + (size_t)min(base + i, n - 1) * stride);
#pragma unroll
    for (int i = 0; i < NW; ++i)
      if (base + i < n) y = (base + i == 0) ? v[i] : y + v[i];
  }
  return y;
}

// Spin (one thread) until *p >= target, then a fence, so the reads that
// follow see what the arrivals released; a wait past DS_TIMEOUT_NS is a
// fault.
__device__ __noinline__ void ds_spin_slow(const unsigned* p, unsigned target) {
  const unsigned long long t0 = ds_now();
  while (ds_ld_relaxed(p) < target)
    if (ds_now() - t0 > DS_TIMEOUT_NS) __trap();
}

__device__ __forceinline__ void ds_spin_geq(const unsigned* p, unsigned target) {
  if (ds_ld_relaxed(p) < target) ds_spin_slow(p, target);
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

// Adds v to *p with release semantics at the card's scope: what this
// block wrote before (ordered by the barrier before it) is visible to a
// thread that sees the sum.
__device__ __forceinline__ void ds_red_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// ---------------------------------------------------------------------------
// The weight ring
// ---------------------------------------------------------------------------

// One weight segment a block streams each layer: rows row0.. of matrix
// `mat` (0 wqkv, 1 wo, 2 w1 and w3 interleaved, 4 w2), columns col0..,
// 2^cpl pieces of 8 columns a row; `pieces` per thread.
struct Seg {
  int mat, row0, col0, rows, cpl, pieces;
};

// The five matrices of layer 0 (bytes), their row pitch and layer stride.
struct MatTab {
  const unsigned char* base[5];
  long long ld[5];
  long long stride[5];
  int nseg;
};

__device__ __noinline__ void ds_mbar_slow(uint32_t bar, uint32_t parity) {
  const unsigned long long t0 = ds_now();
  while (!ds_mbar_test(bar, parity))
    if (ds_now() - t0 > DS_TIMEOUT_NS) __trap();
}

// The code of this kernel is larger than an SM's instruction cache, so
// the long helpers below are single out-of-line copies (__noinline__) and
// only the short paths of the weight loop are inlined.
__device__ __forceinline__ void ds_mbar_wait(uint32_t bar, uint32_t parity) {
  if (!ds_mbar_test(bar, parity)) ds_mbar_slow(bar, parity);
}

// The consumer threads' barrier (named barrier 1): the producer warp never
// joins it.
__device__ __forceinline__ void ds_sync() { asm volatile("bar.sync 1, %0;" ::"n"(DS_THREADS) : "memory"); }

// The producer warp: walks the block's segments for `passes` layer passes
// and fills each ring stage with one piece for each of the 256 consumer
// threads (lane l copies those of threads l, l + 32, ..., l + 224, 16
// bytes bf16 or 8 bytes int8 with cp.async), after the consumers released
// the stage's previous round (`empty`, 256 arrivals); the copies of the 32
// lanes complete the stage's `full` barrier. Thread t's piece (row
// t >> cpl of the stage's rows, columns (t & (cpr - 1)) * 8..) sits at byte
// t * PB of the stage. The producer stalls on the card's copy capacity
// without holding up the consumers.
template <typename W>
__device__ __noinline__ void ds_produce(const Seg* segs, const MatTab* mats, int L, int passes,
                           unsigned char* ring, uint32_t full, uint32_t empty, int stages) {
  constexpr int PB = 8 * (int)sizeof(W);
  const int lane = threadIdx.x - DS_THREADS;
  const int nseg = mats->nseg;
  int st = 0;
  int round = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int layer = pass % L;
    for (int si = 0; si < nseg; ++si) {
      const Seg sg = segs[si];
      const int m = sg.mat == 2 ? 2 : sg.mat;
      const long long ld = mats->ld[m];
      const long long step = (long long)(DS_THREADS >> sg.cpl) * ld;
      const unsigned char* b0 = mats->base[m] + layer * mats->stride[m];
      const unsigned char* b1 = sg.mat == 2 ? mats->base[3] + layer * mats->stride[3] : b0;
      long long off[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = lane + 32 * i;
        off[i] = (long long)(sg.row0 + (t >> sg.cpl)) * ld +
                 (long long)(sg.col0 + (t & ((1 << sg.cpl) - 1)) * 8) * (long long)sizeof(W);
      }
      for (int j = 0; j < sg.pieces; ++j) {
        const bool second = sg.mat == 2 && (j & 1);
        const unsigned char* base = (second ? b1 : b0) + (sg.mat == 2 ? j >> 1 : j) * step;
        if (round > 0) ds_mbar_wait(empty + 8 * st, (round - 1) & 1);
        unsigned char* slot = ring + (size_t)st * DS_THREADS * PB;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t dst = ds_smem_addr(slot + (lane + 32 * i) * PB);
          const unsigned char* src = base + off[i];
          if constexpr (PB == 16)
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src)
                         : "memory");
          else
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src)
                         : "memory");
        }
        asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(full + 8 * st)
                     : "memory");
        if (++st == stages) {
          st = 0;
          ++round;
        }
      }
    }
  }
}

// The consumers' side of the ring: the pieces in the producer's order.
template <typename W>
struct Ring {
  static constexpr int PB = 8 * (int)sizeof(W);  // bytes of a piece
  const unsigned char* ring;
  uint32_t full, empty;
  int stages, cst;
  uint32_t cph;

  // The next piece as 8 floats; then the slot is released to the producer.
  __device__ __forceinline__ void take(float (&w)[8]) {
    ds_mbar_wait(full + 8 * cst, cph);
    const unsigned char* slot = ring + ((size_t)cst * DS_THREADS + threadIdx.x) * PB;
    if constexpr (PB == 16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(slot);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = __bfloat1622float2(h[e]);
        w[2 * e] = v.x;
        w[2 * e + 1] = v.y;
      }
    } else {
      // each byte, offset to 0..255, becomes the low mantissa bits of 2^23,
      // and 2^23 + 128 is subtracted again: an exact conversion
      const uint2 raw = *reinterpret_cast<const uint2*>(slot);
      const unsigned words[2] = {raw.x, raw.y};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const unsigned u = words[i] ^ 0x80808080u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[4 * i + e] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)),
                                   8388736.f);
      }
    }
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(empty + 8 * cst) : "memory");
    if (++cst == stages) {
      cst = 0;
      cph ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// Block-level pieces of a layer
// ---------------------------------------------------------------------------

// acc[b][e]: this thread's sums of column piece cp = tid & (2^cpl - 1)
// (columns cp*8 + e) over its rows. Adds them over the threads of each
// column piece in a fixed order (a lane butterfly, then warps or row slots
// ascending) and calls out(b, col, y) once for every (b, col < 2^cpl * 8).
template <int NB, typename Out>
__device__ __forceinline__ void ds_reduce_cols(float (&acc)[NB][8], int cpl, float* red, Out out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cpr = 1 << cpl;
  for (int off = cpr; off < 32; off <<= 1)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[b][e] += __shfl_xor_sync(FULL, acc[b][e], off);
  const int ng = cpr <= 32 ? DS_WARPS : (DS_THREADS >> cpl);
  const int grp = cpr <= 32 ? warp : (tid >> cpl);
  const int cp = tid & (cpr - 1);
  ds_sync();  // the previous reduction's reads of red are done
  if (cpr >= 32 || lane < cpr)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[((grp * cpr + cp) * NB + b) * 8 + e] = acc[b][e];
  ds_sync();
  for (int o = tid; o < cpr * 8 * NB; o += DS_THREADS) {
    const int e = o & 7;
    const int b = (o >> 3) % NB;
    const int c = o / (8 * NB);
    float s = red[(c * NB + b) * 8 + e];
#pragma unroll 1
    for (int gi = 1; gi < ng; ++gi) s += red[((gi * cpr + c) * NB + b) * 8 + e];
    out(b, c * 8 + e, s);
  }
}

// n pieces of 2^cpl column pieces a row from the ring, multiplied by the
// input rows in_s (NB rows of pitch in_ld, row index k0 + the piece's row).
template <typename W, int NB>
__device__ __forceinline__ void ds_gemv(Ring<W>& rg, const bf16* in_s, int in_ld, int k0, int n,
                                        int cpl, float (&acc)[NB][8]) {
  const int rpc = DS_THREADS >> cpl;
  int k = k0 + (threadIdx.x >> cpl);
  int i = 0;
  for (; i + 1 < n; i += 2, k += 2 * rpc) {  // two pieces at a time, summed in order
    float w0[8], w1[8];
    rg.take(w0);
    rg.take(w1);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float x0 = bf(in_s[b * in_ld + k]);
      const float x1 = bf(in_s[b * in_ld + k + rpc]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(x1, w1[e], fmaf(x0, w0[e], acc[b][e]));
    }
  }
  if (i < n) {
    float w[8];
    rg.take(w);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const float xv = bf(in_s[b * in_ld + k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
    }
  }
}

template <int NB>
__device__ __forceinline__ void ds_zero(float (&acc)[NB][8]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[b][e] = 0.f;
}

// Prefetch a norm weight (D,) into L2.
__device__ __forceinline__ void ds_prefetch_norm(const bf16* w, int D) {
  if ((int)threadIdx.x < D / 64) ds_prefetch_l2(w + threadIdx.x * 64);
}

// The start of a (row, query head)'s attention: q, k and v from the QKV
// partials (qkv_part: [tile][split][row][64] partial sums; heads h, H + g,
// H + KV + g, the splits added in order, each product rounded to bf16)
// into raw, then RoPE at p of q and k (thread i < 32 holds the cos and sin
// of pair i at p: rc, rs) into qf, kf, and v into vf; when `write` (the
// head group's first block) the new k/v row p of the (S, 64) cache slice
// kc/vc.
template <typename W>
__device__ __forceinline__ void ds_attention_qkv(const float* qkv_part, const bf16* s_qkv,
                                                 int qkv_cols, int qkv_splits, int b, int h,
                                                 int g, int H, int KV, int p, float rc, float rs,
                                                 bf16* kc, bf16* vc, bool write, float* raw,
                                                 float* qf, float* kf, float* vf) {
  const int tid = threadIdx.x;
  if (tid < 3 * HDIM) {
    const int which = tid / HDIM;
    const int n = (which == 0 ? h : (which == 1 ? H + g : H + KV + g)) * HDIM + tid % HDIM;
    const float* src = qkv_part + ((size_t)(n / qkv_cols) * qkv_splits * DS_MAX_ROWS + b) *
                                      qkv_cols + n % qkv_cols;
    const float y = ds_sum_strided(src, (size_t)DS_MAX_ROWS * qkv_cols, qkv_splits);
    raw[tid] = round_bf16(stack_product<W>(y, s_qkv, n));
  }
  ds_sync();
  if (tid < HDIM / 2) {
    const int d = 2 * tid;
    rope_pair(raw[d], raw[d + 1], rc, rs, &qf[d]);
    rope_pair(raw[HDIM + d], raw[HDIM + d + 1], rc, rs, &kf[d]);
    vf[d] = raw[2 * HDIM + d];
    vf[d + 1] = raw[2 * HDIM + d + 1];
    if (write) {
      kc[(size_t)p * HDIM + d] = __float2bfloat16(kf[d]);
      kc[(size_t)p * HDIM + d + 1] = __float2bfloat16(kf[d + 1]);
      vc[(size_t)p * HDIM + d] = __float2bfloat16(vf[d]);
      vc[(size_t)p * HDIM + d + 1] = __float2bfloat16(vf[d + 1]);
    }
  }
}

// Attention of one (row, query head) over keys 0..p of its cache slice
// kc/vc (see ds_attention_qkv), on one block: the keys in 32-key tiles
// dealt round-robin to P ranks, every rank computed here (rows of at most
// DS_SPLIT_TILES tiles; longer ones take ds_attention_split). Leaves the
// bf16 output in out_s[0..63].
template <typename W>
__device__ __noinline__ void ds_attention(const float* qkv_part, const bf16* s_qkv, int qkv_cols, int qkv_splits,
                             int b,
                             int h, int g, int H, int KV, int p, float rc, float rs, bf16* kc,
                             bf16* vc, bool write, int P, float* scr, bf16* out_s, int pass) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int s_pad = (p + DS_KV_TILE) / DS_KV_TILE * DS_KV_TILE;
  float* sc = scr;                  // [p + 1] scores, then weights
  float* mt = sc + s_pad;           // [tiles] tile max
  float* lt = mt + s_pad / DS_KV_TILE;  // [tiles] tile exp sums
  float* mr = lt + s_pad / DS_KV_TILE;  // [P] rank max
  float* lr = mr + DS_MAX_Q;        // [P] rank sums
  float* pv = lr + DS_MAX_Q;        // [P][64] rank PV partials
  float* raw = pv + DS_MAX_Q * HDIM;  // [192] q, k, v before RoPE
  float* qf = raw + 3 * HDIM;       // [64] rotated q; kf, vf follow
  float* kf = qf + HDIM;
  float* vf = kf + HDIM;

  // 1-2. q, k, v; RoPE; the new cache row
  ds_attention_qkv<W>(qkv_part, s_qkv, qkv_cols, qkv_splits, b, h, g, H, KV, p, rc, rs, kc, vc,
                      write, raw, qf, kf, vf);
  ds_sync();
  DS_MARK(pass, 24);
  const float scale = 1.0f / sqrtf((float)HDIM);
  const int nt = p / DS_KV_TILE + 1;
  const int nr = nt < P ? nt : P;
  if (P == DS_WARPS && nt <= P) {
    // Every rank holds one tile (keys below 32 * P): warp w is rank w. The
    // same sums in the same order as the general path below, with the
    // scores, the rank's max and sum, and the weights in registers, and
    // the tile's V rows loaded together with its K rows.
    float a0 = 0.f, a1 = 0.f;
    if (warp < nt) {
      const int j0 = warp * DS_KV_TILE;
      const int j = j0 + lane;
      const int jn = p - j0 < DS_KV_TILE ? p - j0 : DS_KV_TILE;  // cache keys of the tile
      __nv_bfloat162 v[DS_KV_TILE];
      if (jn > 0) {
#pragma unroll
        for (int i = 0; i < DS_KV_TILE; ++i)
          v[i] = __ldcg(reinterpret_cast<const __nv_bfloat162*>(
                            vc + (size_t)(j0 + min(i, jn - 1)) * HDIM) + lane);
      }
      float sj = -INFINITY;
      if (j <= p) {
        float d = 0.f;
        if (j == p) {
#pragma unroll
          for (int e = 0; e < HDIM; ++e) d = fmaf(qf[e], kf[e], d);
        } else {
          const uint4* krow = reinterpret_cast<const uint4*>(kc + (size_t)j * HDIM);
#pragma unroll
          for (int c = 0; c < HDIM / 8; ++c) {
            const uint4 raw4 = __ldcg(krow + c);
            const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw4);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 kv = __bfloat1622float2(k2[e]);
              d = fmaf(qf[c * 8 + 2 * e], kv.x, d);
              d = fmaf(qf[c * 8 + 2 * e + 1], kv.y, d);
            }
          }
        }
        sj = __fmul_rn(d, scale);
      }
      float m = sj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      float e = j <= p ? expf(__fsub_rn(sj, m)) : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(FULL, e, off);
      if (lane == 0) {
        mr[warp] = m;
        lr[warp] = __fadd_rn(0.f, e);
      }
      ds_sync();
      float mg = mr[0];
      for (int r = 1; r < nr; ++r) mg = fmaxf(mg, mr[r]);
      float l = 0.f;
      for (int r = 0; r < nr; ++r) l = __fadd_rn(l, __fmul_rn(lr[r], expf(__fsub_rn(mr[r], mg))));
      const float wj = j <= p ? round_bf16(__fdiv_rn(expf(__fsub_rn(sj, mg)), l)) : 0.f;
#pragma unroll
      for (int i = 0; i < DS_KV_TILE; ++i) {
        const float wi = __shfl_sync(FULL, wj, i);
        if (i < jn) {
          const float2 vf2 = __bfloat1622float2(v[i]);
          a0 = fmaf(wi, vf2.x, a0);
          a1 = fmaf(wi, vf2.y, a1);
        }
      }
      if (p < j0 + DS_KV_TILE) {  // key p, the tile's last
        const float wp = __shfl_sync(FULL, wj, p - j0);
        a0 = fmaf(wp, vf[2 * lane], a0);
        a1 = fmaf(wp, vf[2 * lane + 1], a1);
      }
      pv[warp * HDIM + 2 * lane] = a0;
      pv[warp * HDIM + 2 * lane + 1] = a1;
    } else {
      ds_sync();  // the ranks' (max, sum) are written
    }
    ds_sync();
    if (tid < HDIM) {
      float o = pv[tid];
      for (int r = 1; r < nr; ++r) o = __fadd_rn(o, pv[r * HDIM + tid]);
      out_s[tid] = __float2bfloat16(o);
    }
    ds_sync();
    return;
  }
  // 3. scores of keys 0..p, one key a thread; key p from kf
  for (int j = tid; j <= p; j += DS_THREADS) {
    float s = 0.f;
    if (j == p) {
#pragma unroll
      for (int d = 0; d < HDIM; ++d) s = fmaf(qf[d], kf[d], s);
    } else {
      const uint4* krow = reinterpret_cast<const uint4*>(kc + (size_t)j * HDIM);
#pragma unroll
      for (int c = 0; c < HDIM / 8; ++c) {
        const uint4 raw4 = __ldcg(krow + c);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kv = __bfloat1622float2(k2[e]);
          s = fmaf(qf[c * 8 + 2 * e], kv.x, s);
          s = fmaf(qf[c * 8 + 2 * e + 1], kv.y, s);
        }
      }
    }
    sc[j] = __fmul_rn(s, scale);
  }
  ds_sync();
  DS_MARK(pass, 25);
  // 4. tile max, rank max m_r
  for (int t = warp; t < nt; t += DS_WARPS) {
    const int j = t * DS_KV_TILE + lane;
    float v = j <= p ? sc[j] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) mt[t] = v;
  }
  ds_sync();
  if (tid < P) {
    float m = -INFINITY;
    for (int t = tid; t < nt; t += P) m = fmaxf(m, mt[t]);
    mr[tid] = m;
  }
  ds_sync();
  // 5. tile sums of exp(s - m_r), rank sums l_r (tiles ascending)
  for (int t = warp; t < nt; t += DS_WARPS) {
    const int j = t * DS_KV_TILE + lane;
    float e = j <= p ? expf(__fsub_rn(sc[j], mr[t % P])) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(FULL, e, off);
    if (lane == 0) lt[t] = e;
  }
  ds_sync();
  if (tid < P) {
    float l = 0.f;
    for (int t = tid; t < nt; t += P) l = __fadd_rn(l, lt[t]);
    lr[tid] = l;
  }
  ds_sync();
  // 6. m = max m_r, l = sum_r l_r exp(m_r - m) in rank order; the weights
  //    exp(s - m) / l rounded to bf16
  float m = mr[0];
  for (int r = 1; r < nr; ++r) m = fmaxf(m, mr[r]);
  float l = 0.f;
  for (int r = 0; r < nr; ++r) l = __fadd_rn(l, __fmul_rn(lr[r], expf(__fsub_rn(mr[r], m))));
  for (int j = tid; j <= p; j += DS_THREADS)
    sc[j] = round_bf16(__fdiv_rn(expf(__fsub_rn(sc[j], m)), l));
  ds_sync();
  DS_MARK(pass, 26);
  // 7. PV partial of each rank (its keys ascending), then the ranks added
  //    in order. A warp takes a rank's tile: lane l holds dims 2l, 2l + 1
  //    and loads each key's (dim pair) with one 4-byte load, all keys of
  //    the tile at once.
  for (int r = warp; r < nr; r += DS_WARPS) {
    float a0 = 0.f, a1 = 0.f;
    for (int t = r; t < nt; t += P) {
      const int j0 = t * DS_KV_TILE;
      const int jn = p - j0 < DS_KV_TILE ? p - j0 : DS_KV_TILE;  // cache keys of the tile
      if (jn > 0) {
        // all the tile's loads at once (rows past jn clamped, not used)
        __nv_bfloat162 v[DS_KV_TILE];
#pragma unroll
        for (int i = 0; i < DS_KV_TILE; ++i)
          v[i] = __ldcg(reinterpret_cast<const __nv_bfloat162*>(
                            vc + (size_t)(j0 + min(i, jn - 1)) * HDIM) + lane);
#pragma unroll
        for (int i = 0; i < DS_KV_TILE; ++i)
          if (i < jn) {
            const float2 vf2 = __bfloat1622float2(v[i]);
            a0 = fmaf(sc[j0 + i], vf2.x, a0);
            a1 = fmaf(sc[j0 + i], vf2.y, a1);
          }
      }
      if (p < j0 + DS_KV_TILE) {  // key p, the tile's last
        a0 = fmaf(sc[p], vf[2 * lane], a0);
        a1 = fmaf(sc[p], vf[2 * lane + 1], a1);
      }
    }
    pv[r * HDIM + 2 * lane] = a0;
    pv[r * HDIM + 2 * lane + 1] = a1;
  }
  ds_sync();
  if (tid < HDIM) {
    float o = pv[tid];
    for (int r = 1; r < nr; ++r) o = __fadd_rn(o, pv[r * HDIM + tid]);
    out_s[tid] = __float2bfloat16(o);
  }
  ds_sync();
}

// ---------------------------------------------------------------------------
// Grid syncs
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ds_arrive(unsigned* cnt) {
  ds_sync();
  if (threadIdx.x == 0) ds_red_release(cnt, 1u);
}

__device__ __forceinline__ void ds_wait_count(const unsigned* cnt, unsigned target) {
  if (threadIdx.x == 0) ds_spin_geq(cnt, target);
  ds_sync();
}

// After a grid sync: x += bf16(p(sum of the partials)) in every block,
// each adding all columns itself (ncontrib partial rows of (DS_MAX_ROWS,
// D) f32, contributors in order), so every replica gets the same bits.
// h_s <- bf16(RMSNorm(x) * w) from this thread's columns tid + i * 256
// (i < E) of each row, given in xv (bf16 values): squares added over i
// in order, a lane butterfly, the warps in order. wv: the thread's norm
// weights of those columns.
template <int NB>
__device__ __forceinline__ void ds_norm_cols(const float (&xv)[NB][8], const float (&wv)[8],
                                             bf16* h_s, int D, float eps, float* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int E = D / DS_THREADS;
  float* inv = red + DS_WARPS * DS_MAX_ROWS;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < E) ss = __fadd_rn(ss, __fmul_rn(xv[b][i], xv[b][i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(FULL, ss, off);
    if (lane == 0) red[warp * DS_MAX_ROWS + b] = ss;
  }
  ds_sync();
  if (tid < NB) {
    float s = 0.f;
    for (int wi = 0; wi < DS_WARPS; ++wi) s += red[wi * DS_MAX_ROWS + tid];
    inv[tid] = rsqrtf(__fadd_rn(__fdiv_rn(s, (float)D), eps));
  }
  ds_sync();
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < E)
        h_s[b * D + tid + i * DS_THREADS] =
            __float2bfloat16(__fmul_rn(__fmul_rn(xv[b][i], inv[b]), wv[i]));
  ds_sync();
}

// This thread's norm weights of columns tid + i * 256, loaded at once.
__device__ __forceinline__ void ds_norm_weights_cols(const bf16* __restrict__ w, int D,
                                                     float (&wv)[8]) {
  const int E = D / DS_THREADS;
#pragma unroll
  for (int i = 0; i < 8; ++i) wv[i] = bf(w[threadIdx.x + min(i, E - 1) * DS_THREADS]);
}

template <typename W, int NB>
__device__ __noinline__ void ds_residual_all(const float* part, int ncontrib, const bf16* scale,
                                             bf16* x_s, int D, const bf16* norm_w, bf16* h_s,
                                             float eps, float* red) {
  const int tid = threadIdx.x;
  const int E = D / DS_THREADS;  // columns tid + i * 256, i < E <= 8
  const size_t stride = (size_t)DS_MAX_ROWS * D;
  float wv[8];
  ds_norm_weights_cols(norm_w, D, wv);
  float xv[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    float y[8];
    for (int base = 0; base < ncontrib; base += 8) {
      float v[8][8];  // 8 contributors x 8 columns, loaded at once
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[c][i] = __ldcg(part + (size_t)min(base + c, ncontrib - 1) * stride + (size_t)b * D +
                           tid + min(i, E - 1) * DS_THREADS);
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (base + c < ncontrib) y[i] = (base + c == 0) ? v[c][i] : y[i] + v[c][i];
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      xv[b][i] = 0.f;
      if (i < E) {
        const int n = tid + i * DS_THREADS;
        const bf16 xn = __float2bfloat16(
            __fadd_rn(bf(x_s[b * D + n]), round_bf16(stack_product<W>(y[i], scale, n))));
        x_s[b * D + n] = xn;
        xv[b][i] = bf(xn);
      }
    }
  }
  // then h_s <- RMSNorm(x) * norm_w
  ds_norm_cols<NB>(xv, wv, h_s, D, eps, red);
}

// Sync `si` of a residual update whose partials are too many for every
// block to add: x += bf16(p(sum of the partials)). part: ncontrib partial
// rows of (DS_MAX_ROWS, D) f32. Every block arrives; the owners (blocks
// grid-1, grid-2, ...) wait for all arrivals, add the partials of their
// 8-column tiles in contributor order (lane-strided, then a fixed
// butterfly), write the new x to xg and count themselves on `pub`; every
// block waits until pub reaches pub_target and reads the new x.
template <typename W, int NB>
__device__ __noinline__ void ds_reduce_broadcast(const float* part, int ncontrib, const bf16* scale, bf16* x_s,
                                    bf16* xg, int D, unsigned* cnt, unsigned* pub, unsigned si,
                                    unsigned pub_target, const DsPlan& P, int pass,
                                    const bf16* norm_w, bf16* h_s, float eps, float* red) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int G = gridDim.x;
  ds_arrive(cnt);
  const int o = G - 1 - (int)blockIdx.x;
  if (o < P.owners) {
    ds_wait_count(cnt, (si + 1) * (unsigned)G);
    DS_MARK(pass, 8);
    for (int t = o; t < P.x_tiles; t += P.owners) {
      for (int oi = warp; oi < 8 * NB; oi += DS_WARPS) {
        const int b = oi >> 3;
        const int n = t * 8 + (oi & 7);
        const float* src = part + (size_t)b * D + n;
        // lane l adds contributors l, l + 32, ... (all loads at once)
        float s = lane < ncontrib ? ds_sum_strided(src + (size_t)lane * DS_MAX_ROWS * D,
                                                   (size_t)32 * DS_MAX_ROWS * D,
                                                   (ncontrib - lane + 31) / 32)
                                  : 0.f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
        if (lane == 0)
          xg[b * D + n] = __float2bfloat16(
              __fadd_rn(bf(x_s[b * D + n]), round_bf16(stack_product<W>(s, scale, n))));
      }
    }
    ds_sync();
    if (tid == 0) ds_red_release(pub, 1u);
    DS_MARK(pass, 9);
  }
  float wv[8];
  ds_norm_weights_cols(norm_w, D, wv);
  ds_wait_count(pub, pub_target);
  // the new x, this thread's columns tid + i * 256, then h_s <- RMSNorm(x) * norm_w
  const int E = D / DS_THREADS;
  float xv[NB][8];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = tid + min(i, E - 1) * DS_THREADS;
      const bf16 xn = __ldcg(xg + b * D + n);
      xv[b][i] = i < E ? bf(xn) : 0.f;
      if (i < E) x_s[b * D + n] = xn;
    }
  ds_norm_cols<NB>(xv, wv, h_s, D, eps, red);
}

// One head unit: columns t*64.. (< N) of head (ld), rows k0..k0+rows,
// times the normalised rows h_s; direct loads (the slow head's rows are
// not 16-byte aligned), four row groups a column added in order. Writes
// the (NB, 64) partial to dst.
template <int NB>
__device__ __noinline__ void ds_head_unit(const bf16* __restrict__ head, int ld, int N, int t, int k0, int rows,
                             const bf16* h_s, int D, float* red, float* dst) {
  const int tid = threadIdx.x;
  const int c = tid & (DS_TILE - 1);
  const int kg = tid / DS_TILE;
  const int n = t * DS_TILE + c;
  float acc[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  if (n < N) {
    // the column's rows k0 + kg, + 4, ... in groups of 8 loads at once
    const bf16* col = head + n;
    constexpr int KS = DS_THREADS / DS_TILE;
    const int cnt = (rows - kg + KS - 1) / KS;
    for (int base = 0; base < cnt; base += 8) {
      float w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = bf(__ldg(col + (size_t)(k0 + kg + min(base + i, cnt - 1) * KS) * ld));
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (base + i < cnt) {
          const int k = k0 + kg + (base + i) * KS;
#pragma unroll
          for (int b = 0; b < NB; ++b) acc[b] = fmaf(bf(h_s[b * D + k]), w[i], acc[b]);
        }
    }
  }
  ds_sync();  // red's previous readers are done
#pragma unroll
  for (int b = 0; b < NB; ++b) red[(kg * NB + b) * DS_TILE + c] = acc[b];
  ds_sync();
  if (tid < NB * DS_TILE) {
    const int b = tid / DS_TILE;
    const int cc = tid % DS_TILE;
    float s = red[b * DS_TILE + cc];
    for (int g = 1; g < DS_THREADS / DS_TILE; ++g) s += red[(g * NB + b) * DS_TILE + cc];
    dst[b * DS_TILE + cc] = s;
  }
}

// Prefetch into L2 the head rows of this block's head units.
__device__ __noinline__ void ds_prefetch_head(const bf16* head, int ld, int N, const DsPlan& P,
                                                 int D) {
  for (int u = blockIdx.x; u < P.head_units; u += gridDim.x) {
    const int t = u / P.head_splits;
    const int k0 = (u % P.head_splits) * P.head_klen;
    const int rows = min(P.head_klen, D - k0);
    const int c1 = min(t * DS_TILE + DS_TILE, N) - 1;
    for (int i = threadIdx.x; i < 2 * rows; i += DS_THREADS) {
      const size_t row = (size_t)(k0 + i / 2) * ld;
      ds_prefetch_l2(head + row + ((i & 1) ? c1 : t * DS_TILE));
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename W>
struct DsArgs {
  Stack<W> stack;
  const bf16* final_norm;  // (D,): the slow norm, or fast_norm
  const bf16* head;        // (D, head_ld): the gathered slow head, or fast_output
  int head_ld, head_n;     // fast: step cb reads columns cb * V.. when depthwise_output
  const float* cos_t;
  const float* sin_t;
  bf16* ck;                // (L, Bc, KV, S, 64) caches; fast: the frame's history, Bc = 1
  bf16* cv;
  int S;
  const int* pos;          // slow: (B,) positions
  const bf16* x0;          // (B, D): slow x0, fast hidden
  float* logits;           // slow (B, W); fast (C, V)
  bf16* hidden;            // slow (B, D)
  const bf16* emb;         // fast: embeddings, window, noise, EOS flag, tokens
  const int* window;
  const float* gumbel;
  const unsigned char* is_eos;
  int* tokens;
  int C, step, depthwise_output, depthwise_wte, window_len, k_eff, rep_enabled;
  float temp, top_p, penalty;
  int L, D, H, KV, F;
  float eps;
  unsigned char* scratch;
  unsigned* state;
  DsPlan plan;
};

// One head-group exchange: this block's writes before it are visible to
// the head's other P - 1 blocks after it, and theirs to this block.
__device__ __forceinline__ void ds_head_exchange(unsigned* hcnt, unsigned& hx, int P) {
  ds_sync();
  if (threadIdx.x == 0) {
    ds_red_release(hcnt, 1u);
    ds_spin_geq(hcnt, (hx + 1) * (unsigned)P);
  }
  ds_sync();
  ++hx;
}

// Whether a row at position p takes ds_attention_split.
__device__ __forceinline__ bool ds_splits(const DsPlan& P, int p) {
  return P.kv_ranks > 1 && p / DS_KV_TILE + 1 > DS_SPLIT_TILES;
}

// Attention of row b and attention unit u (query head h = u / Q, rank
// q = u % Q) of layer `layer`, when the row's keys span more than DS_SPLIT_TILES
// tiles: split over the head's P = Q blocks (all running this row at
// once). The scores, max m_r and sum l_r of this rank's tiles t = q + i * P
// (i < nq); one exchange (xch_ml, [P][2] f32 of the plan's sc_xch scratch,
// behind the head's counter hcnt) gives every block all P pairs, m = max
// m_r and l = sum_r l_r exp(m_r - m) in rank order; the rank's weights
// exp(s - m) / l, rounded to bf16, times its V rows (the 8 warps' tiles
// i = w, w + 8, ..., added in warp order); a second exchange (xch_pv,
// [P][64] f32) gives every block the P PV partials, added in rank order
// into out_s[0..63]. The rest as ds_attention, whose arguments it derives
// from a itself (a short call keeps the kernel's registers unspilled).
template <typename W, int NB, bool FAST>
__device__ __noinline__ void ds_attention_split(const DsArgs<W>& a, int layer, int b, int u, float rc,
                                                float rs, float* scr, bf16* out_s) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const DsPlan& pl = a.plan;
  const int H = a.H, KV = a.KV, P = pl.kv_ranks;
  const int h = u / pl.q_blocks, rank = u % pl.q_blocks, g = h / (H / KV);
  const int p = FAST ? a.step : a.pos[b];
  const size_t co = (((size_t)layer * (FAST ? 1 : NB) + b) * KV + g) * a.S * HDIM;
  bf16* kc = a.ck + co;
  bf16* vc = a.cv + co;
  // the exchanges on the head's counter before this row: two for each
  // split row of the earlier layers and of this layer's earlier rows
  unsigned rows = 0, hx = 0;
  for (int r = 0; r < NB; ++r) {
    const bool sp = ds_splits(pl, FAST ? a.step : a.pos[r]);
    rows += sp;
    hx += sp && r < b;
  }
  hx = 2 * (layer * rows + hx);
  unsigned* hcnt = a.state + 3 + a.F / pl.sw_cols + h;
  float* xch_ml = reinterpret_cast<float*>(a.scratch + pl.sc_xch) + h * DS_MAX_Q * 2;
  float* xch_pv = reinterpret_cast<float*>(a.scratch + pl.sc_xch) + (2 * H + h * HDIM) * DS_MAX_Q;
  const int s_pad = (p + DS_KV_TILE) / DS_KV_TILE * DS_KV_TILE;
  float* sc = scr;                      // [nq * 32] the rank's scores, then weights
  float* mt = sc + s_pad;               // [nq] tile max
  float* lt = mt + s_pad / DS_KV_TILE;  // [nq] tile exp sums
  float* mr = lt + s_pad / DS_KV_TILE;  // [P] rank max
  float* lr = mr + DS_MAX_Q;            // [P] rank sums
  float* pv = lr + DS_MAX_Q;            // [8][64] the warps' PV partials
  float* raw = pv + DS_MAX_Q * HDIM;    // [192] q, k, v before RoPE
  float* qf = raw + 3 * HDIM;           // [64] rotated q; kf, vf follow
  float* kf = qf + HDIM;
  float* vf = kf + HDIM;
  ds_attention_qkv<W>(reinterpret_cast<const float*>(a.scratch + pl.sc_qkv),
                      a.stack.layer(layer, a.D, (H + 2 * KV) * HDIM, a.F).s_qkv, pl.qkv_cols,
                      pl.qkv_splits, b, h, g, H, KV, p, rc, rs, kc, vc,
                      rank == 0 && h % (H / KV) == 0, raw, qf, kf, vf);
  ds_sync();
  const float scale = 1.0f / sqrtf((float)HDIM);
  const int nt = p / DS_KV_TILE + 1;
  const int nq = (nt - rank + P - 1) / P;  // >= 1: nt > DS_SPLIT_TILES >= P
  // scores of the rank's keys (-inf past p), one key a thread; key p from kf
  for (int o = tid; o < nq * DS_KV_TILE; o += DS_THREADS) {
    const int j = (rank + (o / DS_KV_TILE) * P) * DS_KV_TILE + o % DS_KV_TILE;
    float s = -INFINITY;
    if (j <= p) {
      float d = 0.f;
      if (j == p) {
#pragma unroll
        for (int e = 0; e < HDIM; ++e) d = fmaf(qf[e], kf[e], d);
      } else {
        const uint4* krow = reinterpret_cast<const uint4*>(kc + (size_t)j * HDIM);
#pragma unroll
        for (int c = 0; c < HDIM / 8; ++c) {
          const uint4 raw4 = __ldcg(krow + c);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 kv = __bfloat1622float2(k2[e]);
            d = fmaf(qf[c * 8 + 2 * e], kv.x, d);
            d = fmaf(qf[c * 8 + 2 * e + 1], kv.y, d);
          }
        }
      }
      s = __fmul_rn(d, scale);
    }
    sc[o] = s;
  }
  ds_sync();
  // tile max, the rank's max m_r; tile sums of exp(s - m_r), its sum l_r
  // (tiles ascending)
  for (int i = warp; i < nq; i += DS_WARPS) {
    float v = sc[i * DS_KV_TILE + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
    if (lane == 0) mt[i] = v;
  }
  ds_sync();
  if (tid == 0) {
    float m = -INFINITY;
    for (int i = 0; i < nq; ++i) m = fmaxf(m, mt[i]);
    mr[0] = m;
  }
  ds_sync();
  const float mq = mr[0];
  for (int i = warp; i < nq; i += DS_WARPS) {
    const int j = (rank + i * P) * DS_KV_TILE + lane;
    float e = j <= p ? expf(__fsub_rn(sc[i * DS_KV_TILE + lane], mq)) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(FULL, e, off);
    if (lane == 0) lt[i] = e;
  }
  ds_sync();
  if (tid == 0) {
    float l = 0.f;
    for (int i = 0; i < nq; ++i) l = __fadd_rn(l, lt[i]);
    xch_ml[2 * rank] = mq;
    xch_ml[2 * rank + 1] = l;
  }
  ds_head_exchange(hcnt, hx, P);
  // every rank's pair; m and l in rank order; the rank's weights
  if (tid < P) {
    mr[tid] = __ldcg(xch_ml + 2 * tid);
    lr[tid] = __ldcg(xch_ml + 2 * tid + 1);
  }
  ds_sync();
  float m = mr[0];
  for (int r = 1; r < P; ++r) m = fmaxf(m, mr[r]);
  float l = 0.f;
  for (int r = 0; r < P; ++r) l = __fadd_rn(l, __fmul_rn(lr[r], expf(__fsub_rn(mr[r], m))));
  for (int o = tid; o < nq * DS_KV_TILE; o += DS_THREADS) {
    const int j = (rank + (o / DS_KV_TILE) * P) * DS_KV_TILE + o % DS_KV_TILE;
    sc[o] = j <= p ? round_bf16(__fdiv_rn(expf(__fsub_rn(sc[o], m)), l)) : 0.f;
  }
  ds_sync();
  // the rank's PV: warp w takes its tiles i = w, w + 8, ...; lane l holds
  // dims 2l, 2l + 1 and loads a tile's V rows at once
  float a0 = 0.f, a1 = 0.f;
  for (int i = warp; i < nq; i += DS_WARPS) {
    const int j0 = (rank + i * P) * DS_KV_TILE;
    const float* w = sc + i * DS_KV_TILE;
    const int jn = p - j0 < DS_KV_TILE ? p - j0 : DS_KV_TILE;  // cache keys of the tile
    if (jn > 0) {
      __nv_bfloat162 v[DS_KV_TILE];
#pragma unroll
      for (int k = 0; k < DS_KV_TILE; ++k)
        v[k] = __ldcg(reinterpret_cast<const __nv_bfloat162*>(
                          vc + (size_t)(j0 + min(k, jn - 1)) * HDIM) + lane);
#pragma unroll
      for (int k = 0; k < DS_KV_TILE; ++k)
        if (k < jn) {
          const float2 vf2 = __bfloat1622float2(v[k]);
          a0 = fmaf(w[k], vf2.x, a0);
          a1 = fmaf(w[k], vf2.y, a1);
        }
    }
    if (p < j0 + DS_KV_TILE) {  // key p, the tile's last
      a0 = fmaf(w[p - j0], vf[2 * lane], a0);
      a1 = fmaf(w[p - j0], vf[2 * lane + 1], a1);
    }
  }
  pv[warp * HDIM + 2 * lane] = a0;
  pv[warp * HDIM + 2 * lane + 1] = a1;
  ds_sync();
  if (tid < HDIM) {
    const int nw = nq < DS_WARPS ? nq : DS_WARPS;
    float o = pv[tid];
    for (int w = 1; w < nw; ++w) o = __fadd_rn(o, pv[w * HDIM + tid]);
    xch_pv[rank * HDIM + tid] = o;
  }
  ds_head_exchange(hcnt, hx, P);
  if (tid < HDIM) {
    float o = __ldcg(xch_pv + tid);
    for (int r = 1; r < P; ++r) o = __fadd_rn(o, __ldcg(xch_pv + r * HDIM + tid));
    out_s[tid] = __float2bfloat16(o);
  }
  ds_sync();
}

// The fast frame's draw for step `step` on one block of SAMPLER_THREADS:
// the head's splits added in order into f32 logits (written to a.logits),
// the repetition penalty, the top-k/top-p Gumbel draw (or the argmax) and
// the EOS rule give the token (a.tokens[step]); its embedding row, the
// next step's x, goes to x_next unless this is the last step.
template <int ITEMS, typename W>
__device__ __noinline__ void ds_sample(const DsArgs<W>& a, const float* part_head, int head_splits,
                                       int step, bf16* x_next, float* scr, int pass) {
  const int tid = threadIdx.x;
  const int V = a.head_n;
  const int D = a.D;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(scr);
  float* red = reinterpret_cast<float*>(keys + SAMPLER_THREADS * ITEMS);
  unsigned long long* best_red = reinterpret_cast<unsigned long long*>(red + 32);
  int* win_s = reinterpret_cast<int*>(best_red + 32);
  int* top_s = win_s + MAX_WINDOW;
  int* tok_s = top_s + 1;
  // the logits: each item's head splits added in order; the loads of all
  // items and up to 8 splits at once
  float lg[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) lg[it] = 0.f;
  for (int base = 0; base < head_splits; base += 8) {
    float v[ITEMS][8];
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int n = min(tid + it * SAMPLER_THREADS, V - 1);
      const float* src = part_head + (size_t)(n / DS_TILE) * head_splits * DS_MAX_ROWS * DS_TILE +
                         n % DS_TILE;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[it][i] = __ldcg(src + (size_t)min(base + i, head_splits - 1) * DS_MAX_ROWS * DS_TILE);
    }
#pragma unroll
    for (int it = 0; it < ITEMS; ++it)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (base + i < head_splits) lg[it] = (base + i == 0) ? v[it][i] : lg[it] + v[it][i];
  }
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int n = tid + it * SAMPLER_THREADS;
    if (n < V)
      a.logits[(size_t)step * V + n] = lg[it];
    else
      lg[it] = -INFINITY;
  }
  DS_MARK(pass, 20);
  const int* win = a.rep_enabled ? a.window + (size_t)step * a.window_len : nullptr;
  if (win != nullptr && tid < a.window_len) win_s[tid] = win[tid];
  __syncthreads();
  if (win != nullptr) apply_penalty<ITEMS>(lg, V, win_s, a.window_len, a.penalty);
  int tok;
  if (a.temp <= 1e-7f) {
    unsigned long long best = 0;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int n = tid + it * SAMPLER_THREADS;
      if (n < V) best = max(best, rank_key(lg[it], n));
    }
    tok = block_best(best, best_red);
  } else {
    const float sum = softmax_exp<ITEMS>(lg, V, a.temp, red);
    DS_MARK(pass, 21);
    tok = sorted_draw<ITEMS>(lg, sum, V, a.k_eff, a.top_p > 0.f && a.top_p < 1.f,
                                         a.top_p, a.gumbel + (size_t)step * a.k_eff, keys, red,
                                         best_red, top_s);
  }
  DS_MARK(pass, 22);
  if (tid == 0) {
    *tok_s = a.is_eos[0] ? 0 : tok;
    a.tokens[step] = *tok_s;
  }
  __syncthreads();
  if (step + 1 < a.C) {
    const bf16* row = a.emb + (a.depthwise_wte ? (size_t)step * V * D : 0) + (size_t)(*tok_s) * D;
    for (int i = tid; i < D; i += SAMPLER_THREADS) x_next[i] = row[i];
  }
  __syncthreads();
}

// Shared memory of ds_sample<ITEMS>: the sort's keys, the reductions, the
// rep-pen window, the top token and the token.
__host__ __device__ constexpr int ds_sampler_smem(int items) {
  return 8 * SAMPLER_THREADS * items + 4 * 32 + 8 * 32 + 4 * MAX_WINDOW + 16;
}

// The fast frame's draw for codebook step `step`, after the step's
// persistent launch: one block of SAMPLER_THREADS (ITEMS * 1024 >= V) with
// codebook_sampler.cuh's shared-memory sort, as the batched frame's
// sampler; the next step's x goes to the plan's sc_xn scratch, which the
// next persistent launch reads as its x0.
template <typename W, int ITEMS>
__global__ void __launch_bounds__(SAMPLER_THREADS, 1)
    ds_sampler_kernel(const __grid_constant__ DsArgs<W> a) {
  __shared__ __align__(16) unsigned char smem[ds_sampler_smem(ITEMS)];
  const DsPlan& P = a.plan;
  const int pass = a.step * a.L + a.L - 1;
  DS_MARK(pass, 12);
  ds_sample<ITEMS>(a, reinterpret_cast<const float*>(a.scratch + P.sc_head), P.head_splits,
                   a.step, reinterpret_cast<bf16*>(a.scratch + P.sc_xn),
                   reinterpret_cast<float*>(smem), pass);
  if (threadIdx.x == 0) atomicAdd(a.state + DS_STATE_WORDS - 4, 1u);  // launches so far
  DS_MARK(pass, 13);
}

// The slow step (FAST false, NB rows) or codebook step a.step of the fast
// frame (FAST true, one row, up to its head's partials): one block per
// SM, cooperative launch.
template <typename W, int NB, bool FAST>
__global__ void __launch_bounds__(DS_BLOCK, 1)
    decode_stack_kernel(const __grid_constant__ DsArgs<W> a) {
  extern __shared__ __align__(16) unsigned char ds_smem[];
  const DsPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int G = gridDim.x;
  const int D = a.D, H = a.H, KV = a.KV, F = a.F, L = a.L;
  const int QKV = (H + 2 * KV) * HDIM;
  const int group = H / KV;
  const int Q = P.q_blocks;
  bf16* x_s = reinterpret_cast<bf16*>(ds_smem + P.sm_x);
  bf16* h_s = reinterpret_cast<bf16*>(ds_smem + P.sm_h);
  bf16* attn_s = reinterpret_cast<bf16*>(ds_smem + P.sm_attn);
  bf16* g_s = reinterpret_cast<bf16*>(ds_smem + P.sm_g);
  Seg* segs = reinterpret_cast<Seg*>(ds_smem + P.sm_seg);
  MatTab* mats = reinterpret_cast<MatTab*>(ds_smem + P.sm_seg + DS_MAX_SEGS * sizeof(Seg));
  float* scr = reinterpret_cast<float*>(ds_smem + P.sm_scr);
  bf16* xg = reinterpret_cast<bf16*>(a.scratch + P.sc_x);  // [2][DS_MAX_ROWS][D]
  float* part_qkv = reinterpret_cast<float*>(a.scratch + P.sc_qkv);
  float* part_wo = reinterpret_cast<float*>(a.scratch + P.sc_wo);
  float* part_sw = reinterpret_cast<float*>(a.scratch + P.sc_sw);
  float* part_w2 = reinterpret_cast<float*>(a.scratch + P.sc_w2);
  float* part_head = reinterpret_cast<float*>(a.scratch + P.sc_head);
  unsigned* cnt = a.state;      // arrivals: sync i completes at (i + 1) * G
  unsigned* done = a.state + 1;  // blocks that finished
  unsigned* pub = a.state + 2;   // owners' publishes of x
  unsigned* grp = a.state + 3;   // arrivals of each F slice's K-split group, then of each
                                 // head's key-split exchanges
  const int cpl_wo = __ffs(P.wo_cols / 8) - 1;
  const int cpl_sw = __ffs(P.sw_cols / 8) - 1;
  const int cpl_qkv = __ffs(P.qkv_cols / 8) - 1;
  const int gs = P.sw_cols / P.sw_split;  // g columns (w2 K-rows) of a split
  const int cpl_d = __ffs(D / 8) - 1;

  // 1. this block's weight segments, in the order its phases take them,
  //    and the ring's mbarriers
  if (tid == 0) {
    int n = 0;
    for (int u = blk; u < P.qkv_units; u += G) {
      const int s = u % P.qkv_splits;
      const int rows = min(P.qkv_klen, D - s * P.qkv_klen);
      segs[n++] = {0, s * P.qkv_klen, (u / P.qkv_splits) * P.qkv_cols, rows, cpl_qkv,
                   rows * (P.qkv_cols / 8) / DS_THREADS};
    }
    for (int u = blk; u < P.attn_units; u += G)
      segs[n++] = {1, (u / Q) * HDIM, (u % Q) * P.wo_cols, HDIM, cpl_wo,
                   HDIM * (P.wo_cols / 8) / DS_THREADS};
    for (int u = blk; u < P.sw_units; u += G) {
      const int t = u / P.sw_split, h = u % P.sw_split;
      const int kr = D / P.sw_split;
      segs[n++] = {2, h * kr, t * P.sw_cols, kr, cpl_sw, 2 * kr * (P.sw_cols / 8) / DS_THREADS};
      segs[n++] = {4, t * P.sw_cols + h * gs, 0, gs, cpl_d, gs * (D / 8) / DS_THREADS};
    }
    const Stack<W>& st = a.stack;
    const long long es = sizeof(W);
    const void* bases[5] = {st.wqkv, st.wo, st.w1, st.w3, st.w2};
    const long long lds[5] = {QKV, D, F, F, D};
    const long long strides[5] = {(long long)D * QKV, (long long)D * D, (long long)D * F,
                                  (long long)D * F, (long long)F * D};
    for (int m = 0; m < 5; ++m) {
      mats->base[m] = static_cast<const unsigned char*>(bases[m]);
      mats->ld[m] = lds[m] * es;
      mats->stride[m] = strides[m] * es;
    }
    mats->nseg = n;
    for (int i = 0; i < P.stages; ++i) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       ds_smem_addr(ds_smem + P.sm_bar + 8 * i)),
                   "r"(32)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                       ds_smem_addr(ds_smem + P.sm_bar + 8 * (P.stages + i))),
                   "r"(DS_THREADS)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the whole block, producer warp included: the last time
  const uint32_t full = ds_smem_addr(ds_smem + P.sm_bar);
  const uint32_t empty = full + 8 * P.stages;
  if (tid >= DS_THREADS) {
    ds_produce<W>(segs, mats, L, L, ds_smem + P.sm_ring, full, empty, P.stages);
    return;
  }
  Ring<W> rg{ds_smem + P.sm_ring, full, empty, P.stages, 0, 0u};

  // 2. the input rows; this thread's elements of the first norm
  {
    const uint4* s4 = reinterpret_cast<const uint4*>(a.x0);
    uint4* x4 = reinterpret_cast<uint4*>(x_s);
    for (int i = tid; i < NB * D / 8; i += DS_THREADS) x4[i] = s4[i];
  }
  ds_prefetch_norm(a.stack.attn_norm, D);
  // the cache rows 0..pos-1 of layer l that the block's attention units
  // read, into L2; the blocks of a KV head take a share each
  auto prefetch_kv = [&](int l, int step = 0) {
    for (int u = blk; u < P.attn_units; u += G) {
      const int h = u / Q;
      const int share = (h % group) * Q + u % Q;
      for (int b = 0; b < NB; ++b) {
        const int p = FAST ? step : a.pos[b];
        const size_t co = (((size_t)l * (FAST ? 1 : NB) + b) * KV + h / group) * a.S * HDIM;
        for (int j = share + tid * group * Q; j < p; j += DS_THREADS * group * Q) {
          ds_prefetch_l2(a.ck + co + (size_t)j * HDIM);
          ds_prefetch_l2(a.cv + co + (size_t)j * HDIM);
        }
      }
    }
  };
  if (!FAST) prefetch_kv(0);

  unsigned si = 0;  // grid syncs so far
  unsigned nb = 0;  // x publishes so far (each counts `owners` on pub)
  int buf = 0;      // xg buffer of the next publish
  const int step = FAST ? a.step : 0;
  const bf16* head = a.head + (FAST && a.depthwise_output ? (size_t)step * a.head_n : 0);
  for (int l = 0; l < L; ++l) {
    const Stack<W> lw = a.stack.layer(l, D, QKV, F);
    const size_t layer_rows = (size_t)l * (FAST ? 1 : NB);
    const int pass = step * L + l;

    // (a) h = RMSNorm(x); QKV partials. Meanwhile the cache rows that
    //     attention reads go to L2 and the RoPE rows to registers.
    DS_MARK(pass, 0);
    DS_MARK_CLK(pass, 30);
    if (l == 0) {  // later layers' norm came with the last update of x
      float xv[NB][8], wv[8];
      ds_norm_weights_cols(lw.attn_norm, D, wv);
      ds_sync();  // x_s is complete
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          xv[b][i] = i < D / DS_THREADS ? bf(x_s[b * D + tid + i * DS_THREADS]) : 0.f;
      ds_norm_cols<NB>(xv, wv, h_s, D, a.eps, scr);
    }
    float rc[NB], rs[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      const int p = FAST ? step : a.pos[b];
      rc[b] = rs[b] = 0.f;
      if (tid < HDIM / 2 && p >= 0 && p < a.S) {
        rc[b] = a.cos_t[(size_t)p * (HDIM / 2) + tid];
        rs[b] = a.sin_t[(size_t)p * (HDIM / 2) + tid];
      }
    }
    if (FAST)
      prefetch_kv(l, step);  // rows of earlier steps
    else if (l + 1 < L)
      prefetch_kv(l + 1);  // a layer ahead
    if (l == L - 1) ds_prefetch_head(head, a.head_ld, a.head_n, P, D);
    for (int u = blk; u < P.qkv_units; u += G) {
      const int k0 = (u % P.qkv_splits) * P.qkv_klen;
      const int rows = min(P.qkv_klen, D - k0);
      float acc[NB][8];
      ds_zero(acc);
      ds_gemv<W, NB>(rg, h_s, D, k0, rows * (P.qkv_cols / 8) / DS_THREADS, cpl_qkv, acc);
      const int qc = P.qkv_cols;
      float* dst = part_qkv + (size_t)u * DS_MAX_ROWS * qc;
      ds_reduce_cols<NB>(acc, cpl_qkv, scr, [&](int b, int c, float y) { dst[b * qc + c] = y; });
    }
    DS_MARK(pass, 1);
    ds_arrive(cnt);
    ds_wait_count(cnt, (si + 1) * (unsigned)G);
    ++si;
    DS_MARK(pass, 2);

    // (b) attention of the block's heads; wo partials
    ds_prefetch_norm(lw.ffn_norm, D);
    for (int u = blk; u < P.attn_units; u += G) {
      const int h = u / Q;
      const int q = u % Q;
      const int g = h / group;
      for (int b = 0; b < NB; ++b) {
        const int p = FAST ? step : a.pos[b];
        if (p < 0 || p >= a.S) __trap();  // a position outside the cache
        const size_t co = ((layer_rows + b) * KV + g) * a.S * HDIM;
        if (ds_splits(P, p))
          ds_attention_split<W, NB, FAST>(a, l, b, u, rc[b], rs[b], scr, attn_s + b * HDIM);
        else
          ds_attention<W>(part_qkv, lw.s_qkv, P.qkv_cols, P.qkv_splits, b, h, g, H, KV, p,
                          rc[b], rs[b], a.ck + co, a.cv + co, q == 0 && h % group == 0,
                          P.kv_ranks, scr, attn_s + b * HDIM, pass);
      }
      DS_MARK(pass, 3);
      float acc[NB][8];
      ds_zero(acc);
      ds_gemv<W, NB>(rg, attn_s, HDIM, 0, HDIM * (P.wo_cols / 8) / DS_THREADS, cpl_wo, acc);
      float* dst = part_wo + (size_t)h * DS_MAX_ROWS * D + q * P.wo_cols;
      ds_reduce_cols<NB>(acc, cpl_wo, scr,
                         [&](int b, int c, float y) { dst[(size_t)b * D + c] = y; });
    }
    DS_MARK(pass, 4);
    ds_arrive(cnt);
    ds_wait_count(cnt, (si + 1) * (unsigned)G);
    ++si;
    ds_residual_all<W, NB>(part_wo, H, lw.s_o, x_s, D, lw.ffn_norm, h_s, a.eps, scr);
    DS_MARK(pass, 5);

    // (c) h = RMSNorm(x); g = silu(h @ w1) * (h @ w3) for the block's F
    //     slice; w2 partials of those K-rows
    ds_prefetch_norm(l + 1 < L ? a.stack.layer(l + 1, D, QKV, F).attn_norm : a.final_norm, D);
    DS_MARK(pass, 6);
    for (int u = blk; u < P.sw_units; u += G) {
      const int t = u / P.sw_split;
      const int h = u % P.sw_split;
      const int sw = P.sw_cols;
      const int kr = D / P.sw_split;
      const int rpc = DS_THREADS >> cpl_sw;
      float a1[NB][8], a3[NB][8];
      ds_zero(a1);
      ds_zero(a3);
      int k = h * kr + (tid >> cpl_sw);
      for (int i = 0; i < kr / rpc; ++i, k += rpc) {
        float w1[8], w3[8];
        rg.take(w1);
        rg.take(w3);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float xv = bf(h_s[b * D + k]);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            a1[b][e] = fmaf(xv, w1[e], a1[b][e]);
            a3[b][e] = fmaf(xv, w3[e], a3[b][e]);
          }
        }
      }
      DS_MARK(pass, 16);
      // this split's partial sums of both products, then the group's
      // exchange: every split's partials of the g slice, added in order
      float* mine = part_sw + (size_t)u * DS_MAX_ROWS * 2 * sw;
      if constexpr (2 * NB <= DS_MAX_ROWS) {
        float a13[2 * NB][8];  // both products in one pass: rows b (w1), NB + b (w3)
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            a13[b][e] = a1[b][e];
            a13[NB + b][e] = a3[b][e];
          }
        ds_reduce_cols<2 * NB>(a13, cpl_sw, scr, [&](int r, int c, float y) {
          mine[((r % NB) * 2 + r / NB) * sw + c] = y;
        });
      } else {
        ds_reduce_cols<NB>(a1, cpl_sw, scr,
                           [&](int b, int c, float y) { mine[(b * 2) * sw + c] = y; });
        ds_reduce_cols<NB>(a3, cpl_sw, scr,
                           [&](int b, int c, float y) { mine[(b * 2 + 1) * sw + c] = y; });
      }
      ds_sync();
      if (tid == 0) {
        ds_red_release(grp + t, 1u);
        ds_spin_geq(grp + t, (unsigned)(l + 1) * P.sw_split);
      }
      ds_sync();
      DS_MARK(pass, 17);
      for (int o = tid; o < NB * gs; o += DS_THREADS) {
        const int b = o / gs;
        const int c = h * gs + o % gs;
        const float* src = part_sw + ((size_t)t * P.sw_split * DS_MAX_ROWS + b) * 2 * sw + c;
        const float y1 = ds_sum_strided(src, (size_t)DS_MAX_ROWS * 2 * sw, P.sw_split);
        const float y3 = ds_sum_strided(src + sw, (size_t)DS_MAX_ROWS * 2 * sw, P.sw_split);
        const int n = t * sw + c;
        const float y0 = stack_product<W>(y1, lw.s_1, n);
        const float gate = round_bf16(__fdiv_rn(y0, __fadd_rn(1.f, expf(-y0))));
        const float up = round_bf16(stack_product<W>(y3, lw.s_3, n));
        g_s[b * gs + o % gs] = __float2bfloat16(__fmul_rn(gate, up));
      }
      ds_sync();
      float acc[NB][8];
      ds_zero(acc);
      ds_gemv<W, NB>(rg, g_s, gs, 0, gs * (D / 8) / DS_THREADS, cpl_d, acc);
      DS_MARK(pass, 18);
      float* dst = part_w2 + (size_t)u * DS_MAX_ROWS * D;
      ds_reduce_cols<NB>(acc, cpl_d, scr,
                         [&](int b, int c, float y) { dst[(size_t)b * D + c] = y; });
    }
    DS_MARK(pass, 7);
    // the new x, normalised for the next layer (or the head)
    const bf16* next_norm = l + 1 < L ? a.stack.layer(l + 1, D, QKV, F).attn_norm : a.final_norm;
    ds_reduce_broadcast<W, NB>(part_w2, P.sw_units, lw.s_2, x_s, xg + buf * DS_MAX_ROWS * D, D,
                               cnt, pub, si, (nb + 1) * (unsigned)P.owners, P, pass, next_norm,
                               h_s, a.eps, scr);
    ++si;
    ++nb;
    buf ^= 1;
    DS_MARK(pass, 10);
    DS_MARK_CLK(pass, 31);
  }

  // the final norm and the head's partials (the fast frame's draw is the
  // next launch, ds_sampler_kernel)
  const int pass = step * L + L - 1;
  for (int u = blk; u < P.head_units; u += G) {
    const int k0 = (u % P.head_splits) * P.head_klen;
    ds_head_unit<NB>(head, a.head_ld, a.head_n, u / P.head_splits, k0,
                     min(P.head_klen, D - k0), h_s, D, scr,
                     part_head + (size_t)u * DS_MAX_ROWS * DS_TILE);
  }
  DS_MARK(pass, 11);
  if constexpr (!FAST) {
    // owners of the head tiles add the splits in order: f32 logits, unrounded
    ds_arrive(cnt);
    const unsigned target = (si + 1) * (unsigned)G;
    for (int t = G - 1 - blk; t < P.head_tiles; t += G) {
      ds_wait_count(cnt, target);
      for (int o = tid; o < NB * DS_TILE; o += DS_THREADS) {
        const int b = o / DS_TILE;
        const int n = t * DS_TILE + o % DS_TILE;
        if (n >= a.head_n) continue;
        const float* src = part_head + ((size_t)t * P.head_splits * DS_MAX_ROWS + b) * DS_TILE +
                           o % DS_TILE;
        a.logits[(size_t)b * a.head_n + n] =
            ds_sum_strided(src, (size_t)DS_MAX_ROWS * DS_TILE, P.head_splits);
      }
    }
    DS_MARK(pass, 12);
    if (blk == 0)
      for (int i = tid; i < NB * D; i += DS_THREADS) a.hidden[i] = x_s[i];
  }

  // 3. the last block to finish counts the launch, reports its grid syncs
  //    and head 0's key-split exchanges (the last two state words) and
  //    sets the sync counters back to zero
  ds_sync();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(done, 1u) == (unsigned)G - 1) {
      atomicAdd(a.state + DS_STATE_WORDS - 3, 1u);
      a.state[DS_STATE_WORDS - 2] = ds_ld_relaxed(cnt) / (unsigned)G;
      a.state[DS_STATE_WORDS - 1] = ds_ld_relaxed(grp + F / P.sw_cols) / (unsigned)P.kv_ranks;
      *cnt = 0;
      *pub = 0;
      for (int i = 0; i < F / P.sw_cols + H; ++i) grp[i] = 0;
      *done = 0;
      __threadfence();
    }
  }
}

// One cooperative launch of `kernel` (argument a) on `grid` blocks of
// `threads` threads with `smem` bytes of dynamic shared memory: every
// block resident, one an SM, so its grid syncs cannot deadlock. smem_set and
// smem_checked are the kernel's own record of the size its limit was
// raised to and its residency checked at: both happen once per size,
// never while a CUDA graph is captured after a warm-up call.
template <typename K, typename A>
cudaError_t ds_coop_launch(K kernel, const A& a, int grid, int threads, int smem,
                           cudaStream_t st, int& smem_set, int& smem_checked) {
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  if (smem != smem_checked) {
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    smem_checked = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// One cooperative launch of decode_stack_kernel<W, NB, FAST>.
template <typename W, int NB, bool FAST>
cudaError_t ds_launch(const DsArgs<W>& a, cudaStream_t st) {
  static int smem_set = 0;
  static int smem_checked = 0;
  return ds_coop_launch(decode_stack_kernel<W, NB, FAST>, a, a.plan.grid, DS_BLOCK, a.plan.smem,
                        st, smem_set, smem_checked);
}

// One launch of ds_sampler_kernel<W, ITEMS> for step a.step.
template <typename W, int ITEMS>
cudaError_t ds_sampler_launch(const DsArgs<W>& a, cudaStream_t st) {
  ds_sampler_kernel<W, ITEMS><<<1, SAMPLER_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

// The stack arguments of the C entries: norms, the five weights and their
// scales (all null for bf16, all set for int8).
inline bool ds_int8(const void* const* scales, bool& int8) {
  int8 = scales[0] != nullptr;
  for (int i = 0; i < 5; ++i)
    if ((scales[i] != nullptr) != int8) return false;
  return true;
}

}  // namespace
