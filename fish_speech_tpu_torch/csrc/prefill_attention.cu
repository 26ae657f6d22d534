// Flash prefill attention for Hopper (sm_90a), on the tensor cores.
//
// Replaces the TPU kernel fish_speech_tpu/ops/prefill_pallas.py::
// flash_prefill_attention: grouped-query softmax attention of a
// right-padded prompt chunk over the cache rows, with the mask computed
// in the kernel. Query i of batch row b sits at absolute position
// offset + i; key j is visible iff
//     j <= offset + i                  (causal)
//     offset + i - j < window          (sliding window)
//     j <  offset + seq_lens[b]        (this chunk's right padding)
//     j <  E                           (the read extent)
// Masked scores take the finite NEG_INF = -1e9 (here before the scale,
// which only matters to a row with no visible key: uniform weights in
// both), so no output is NaN.
// As in the TPU kernel, the unnormalised weights exp(s - m) are rounded
// to bf16 before the PV product, the normaliser sums them unrounded in
// float32, and the output is acc / l in float32 (as acc times 1 / l),
// rounded to bf16; a row with l == 0 writes 0.
//
// What bounds it on this card: for long prompts the operations of QK^T
// and PV (4 * H * visible pairs * hd) on the bf16 tensor cores, and with
// hd = 64 nearly as much the exponentials (one ex2 a score on the SFU,
// 16 a clock an SM, as many clocks as the two products take on the
// tensor cores); for the main path's 40-token prompt, launch latency.
//
// Design:
// * One CTA owns one (row b, KV head g, query block) and takes all the
//   group's G = H / KV query heads: its M rows are (q head, query) pairs,
//   G heads x 64 / G queries for each of its two consumer warpgroups. So
//   each K/V tile enters shared memory once for the whole group.
// * A producer warp loads Q (one TMA box a warpgroup) and then the K and
//   V tiles of 64 keys with TMA into a ring of 4 stages behind full and
//   empty mbarriers. A key or query row of hd = 64 bf16 is 128 bytes, so
//   the tensor maps' 128-byte swizzle is the layout wgmma reads. Keys at
//   E and past are zero-filled by the copy (the cache rows past E are
//   real memory) and masked by index.
// * Each consumer warpgroup computes S = Q K^T with wgmma m64n64k16 (Q
//   and K from shared memory), the online softmax in registers (the scale
//   and log2(e) folded into one FFMA before each ex2), rounds P to bf16 in the
//   registers the accumulator layout already puts in wgmma's A-fragment
//   order, and accumulates O += P V with wgmma (P from registers, V from
//   shared memory with the transpose bit).
// * The key range of a query block is computed from offset, window and
//   seq_lens[b]; tiles outside it are never loaded. Only tiles that cross
//   the diagonal, the window edge or the padding/extent edge apply the
//   per-element mask.
// * Work balance. Causal blocks differ in length, so the longest query
//   blocks are scheduled first, and a block's key range is cut into
//   chunks of at most `chunk` tiles, one CTA each (up to 8): a block of
//   one chunk writes its output itself; the chunks of a longer one write
//   their (O, m, l) partials and a second launch combines them in chunk
//   order. The chunk is about twice the work one CTA slot of the card
//   would take if the prompt's work were spread evenly, so the
//   prefix-reuse shape (128 queries over 2048 keys, 16 blocks) fills the
//   card, 512-1024 keys split in two and 2048-4096 not at all. The plan
//   (fs_prefill_plan, mirrored by ops/prefill_attention.py::
//   prefill_plan) depends on (S_pad, E, H, KV, SM count) only, never on
//   B, offset or seq_lens, so a row's bits do not depend on the rows
//   beside it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;                  // head dim: one 128-byte row a key or query
constexpr int BN = 64;                  // keys a tile
constexpr int WG_ROWS = 64;             // M rows of a consumer warpgroup
constexpr int NWG = 2;                  // consumer warpgroups a CTA
constexpr int STAGES = 4;               // stages of the K/V ring
constexpr int CONSUMERS = 128 * NWG;
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_SPLITS = 8;
constexpr int MAX_DEVICES = 64;
constexpr int TILE_BYTES = BN * HD * 2;
constexpr int Q_BYTES = WG_ROWS * HD * 2;
constexpr int SMEM_BYTES = 1024 + NWG * Q_BYTES + 2 * STAGES * TILE_BYTES + 8 * (2 * STAGES + 1);
constexpr int CTA_ROWS = NWG * WG_ROWS;
// floats of one split's partials: O (CTA_ROWS x HD), then m and l a row
constexpr int PART_FLOATS = CTA_ROWS * HD + 2 * CTA_ROWS;
constexpr float NEG_INF = -1e9f;
constexpr float RUNNING_MIN = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Plan {
  int queries;   // queries a CTA (NWG x 64 / G)
  int qblocks;   // query blocks a (row, KV head)
  int splits;    // CTAs a query block's keys may be split over
  int chunk;     // key tiles a split takes
  int ctas;      // CTAs a batch row: KV x qblocks x splits
};

// Shapes only: never B, offset, window or seq_lens. A block's key range is
// cut into chunks of `chunk` tiles, one CTA each. The chunk is the
// extent's tiles halved (at most MAX_SPLITS ways) until it is no longer
// than twice the tiles each of the card's 2 x sms CTA slots would take
// if the work of a full-length prompt at the end of the extent were
// spread evenly (and never below 4 tiles): a split costs a partial write
// and a combine, so only a block much longer than a slot's share is cut.
Plan make_plan(int S_pad, int E, int H, int KV, int sms) {
  Plan p;
  const int G = H / KV;
  p.queries = NWG * (WG_ROWS / G);
  p.qblocks = (S_pad + p.queries - 1) / p.queries;
  const int tiles = (E + BN - 1) / BN;
  const int off0 = max(0, E - S_pad);
  long long total = 0;
  for (int qb = 0; qb < p.qblocks; ++qb)
    total += (min(E, off0 + min(S_pad, (qb + 1) * p.queries)) + BN - 1) / BN;
  total *= KV;
  const long long slots = 2LL * sms;
  const int target = 2 * (int)max(2LL, (total + slots - 1) / slots);
  p.splits = 1;
  while (p.splits < MAX_SPLITS && (tiles + p.splits - 1) / p.splits > target) p.splits *= 2;
  p.chunk = (tiles + p.splits - 1) / p.splits;
  p.ctas = KV * p.qblocks * p.splits;
  return p;
}

// The key tiles [t0, t0 + n) that query block qb of a row with this
// seq_len needs: from the window's start of its first query to the last
// key its last (or padding) query sees. Tile j covers keys [BN j, BN j +
// BN).
struct Range {
  int t0, n;
};

__host__ __device__ __forceinline__ Range block_range(int qb, int queries, int S_pad, int E,
                                            int offset, int seq_len, int window) {
  const int q0 = qb * queries;
  const int q_hi = min(q0 + queries, S_pad);
  const int lim = min(E, offset + seq_len);
  const int key_begin = max(0, offset + q0 - window + 1);
  const int key_end = min(lim, offset + q_hi);
  const int t0 = key_begin / BN;
  return {t0, key_end > key_begin ? (key_end + BN - 1) / BN - t0 : 0};
}

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

#ifdef PA_TRACE
// Trace build (scripts/trace_prefill_attention.py): thread 0 of each CTA
// records %globaltimer at its start, when Q arrived, when its first K/V
// tile arrived, after its last tile and at its end, with its SM, its
// tile count and whether it wrote the output itself.
constexpr int TRACE_CTAS = 8192;
__device__ unsigned long long pa_trace[TRACE_CTAS * 8];
#define PA_MARK(i) (pa_tr[i] = now_ns())
#else
#define PA_MARK(i) ((void)0)
#endif

// Wait for the completion of the barrier's phase of this parity. A wait
// that lasts 4 s traps (an "unspecified launch failure") instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  unsigned long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if (t0 == 0) t0 = now_ns();
    else if (now_ns() - t0 > 4000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows written by a
// TMA copy with the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO),
// layout type B128. K-major (Q, K): a k16 step moves the start 32 bytes
// along the row. MN-major (V, read with the transpose bit): a k16 step is
// 16 rows, 2048 bytes; its 64 columns are one swizzle atom wide, so the
// leading offset is never used.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Tell the compiler the accumulator registers change here (the async
// products write them between issue and wait).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FS_D32(d)                                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),  \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FS_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, A and B from shared memory, both K-major: D = A (64 x 16) x
// B^T where B is 64 rows of 16 k.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %34, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS_R32
      ", %32, %33, p, 1, 1, 0, 0;\n\t}"
      : FS_D32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16 bf16) from registers in the mma fragment order, B
// (16 k-rows of 64 n, n contiguous) from shared memory, transposed.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FS_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n\t}"
      : FS_D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The CTA's work, from its index: longest query blocks first.
struct Work {
  int b, g, qb, sp;
};

__host__ __device__ __forceinline__ Work cta_work(int x, int B, int KV, int qblocks, int splits) {
  const int per_qb = B * KV * splits;
  const int r = x % per_qb;
  return {r / (KV * splits), (r / splits) % KV, qblocks - 1 - x / per_qb, r % splits};
}

// This split's chunk of its block's tiles: [ts, ts + n).
__host__ __device__ __forceinline__ Range cta_chunk(Range block, int sp, int chunk) {
  const int ts = block.t0 + min(block.n, sp * chunk);
  return {ts, block.t0 + min(block.n, (sp + 1) * chunk) - ts};
}

// grid: B * plan.ctas CTAs of THREADS threads, SMEM_BYTES of dynamic
// shared memory. q_map: q as (hd, S_pad, B * H); k_map / v_map: the cache
// views as (hd, E, KV, B). part: the split partials (splits > 1 only).
__global__ void __launch_bounds__(THREADS, 2)
    prefill_attention_kernel(__grid_constant__ const CUtensorMap q_map,
                             __grid_constant__ const CUtensorMap k_map,
                             __grid_constant__ const CUtensorMap v_map,
                             const int* __restrict__ seq_lens, __nv_bfloat16* __restrict__ out,
                             float* __restrict__ part, int B, int H, int KV, int S_pad, int E,
                             int offset, int window, float scale_log2, int qblocks, int splits,
                             int chunk) {
#ifdef PA_TRACE
  unsigned long long pa_tr[4] = {now_ns(), 0, 0, 0};
#endif
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle's alignment
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + NWG * Q_BYTES;
  const uint32_t v_s = k_s + STAGES * TILE_BYTES;
  const uint32_t full_bar = v_s + STAGES * TILE_BYTES;  // STAGES barriers, then STAGES empty
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t q_bar = empty_bar + 8 * STAGES;

  const int G = H / KV;
  const int qpw = WG_ROWS / G;  // queries a warpgroup
  const Work w = cta_work(blockIdx.x, B, KV, qblocks, splits);
  const int q0 = w.qb * NWG * qpw;
  const int seq_len = seq_lens[w.b];
  const int lim = min(E, offset + seq_len);  // keys from lim on are masked for every row
  const Range kr = block_range(w.qb, NWG * qpw, S_pad, E, offset, seq_len, window);
  // this CTA's chunk of the block's tiles; a block of one chunk writes
  // the output itself, the chunks of a longer one their partials
  const Range ck = cta_chunk(kr, w.sp, chunk);
  const int ts = ck.t0, n = ck.n;
  const bool direct = kr.n <= chunk;
  if (w.sp > 0 && n == 0) return;  // the whole CTA: nothing to do
  const int live_wgs = min(NWG, (S_pad - q0 + qpw - 1) / qpw);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full_bar + 8 * i, 1);
      mbar_init(empty_bar + 8 * i, 4 * NWG);  // one arrival a consumer warp
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: lane 0 issues every copy
    if (threadIdx.x == CONSUMERS && n > 0) {
      mbar_expect_tx(q_bar, live_wgs * G * qpw * HD * 2);
      for (int i = 0; i < live_wgs; ++i)
        tma_load_3d(q_s + i * Q_BYTES, &q_map, 0, q0 + i * qpw, w.b * H + w.g * G, q_bar);
      for (int t = 0; t < n; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty_bar + 8 * st, ((t / STAGES) - 1) & 1);
        mbar_expect_tx(full_bar + 8 * st, 2 * TILE_BYTES);
        const int j0 = (ts + t) * BN;
        tma_load_4d(k_s + st * TILE_BYTES, &k_map, 0, j0, w.g, w.b, full_bar + 8 * st);
        tma_load_4d(v_s + st * TILE_BYTES, &v_map, 0, j0, w.g, w.b, full_bar + 8 * st);
      }
    }
    return;
  }

  // a consumer warpgroup: rows r0 = 16 warp + lane / 4 and r1 = r0 + 8 of
  // its 64, row r being q head r / qpw of the group, query r % qpw
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int qw0 = q0 + wg * qpw;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int hl0 = r0 / qpw, hl1 = r1 / qpw;
  const int qi0 = qw0 + r0 % qpw, qi1 = qw0 + r1 % qpw;
  // each row's visible keys: [lo, hi]
  const int lo0 = offset + qi0 - window + 1, hi0 = min(offset + qi0, lim - 1);
  const int lo1 = offset + qi1 - window + 1, hi1 = min(offset + qi1, lim - 1);
  // a tile [j0, j0 + BN) is visible in full to every row of this warpgroup
  // iff j0 >= full_lo and j0 + BN - 1 <= full_hi
  const int qw_hi = min(qw0 + qpw, S_pad);
  const int full_lo = offset + qw_hi - window;
  const int full_hi = min(offset + qw0, lim - 1);
  const int cq = 2 * (lane % 4);  // the first of this thread's two columns in each 8

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = RUNNING_MIN, m1 = RUNNING_MIN, l0 = 0.f, l1 = 0.f;

  if (wg < live_wgs) {
    if (n > 0) mbar_wait(q_bar, 0);
    PA_MARK(1);
    const uint32_t qa = q_s + wg * Q_BYTES;
    float s[32];
    for (int t = 0; t < n; ++t) {
      const int st = t % STAGES;
      mbar_wait(full_bar + 8 * st, (t / STAGES) & 1);
      if (t == 0) PA_MARK(2);
      const uint32_t ka = k_s + st * TILE_BYTES, va = v_s + st * TILE_BYTES;

      // S = Q K^T (raw scores; the scale is folded into the exponent)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss(s, smem_desc(qa + 32 * kk), smem_desc(ka + 32 * kk), kk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // mask where the tile is not visible in full, running max
      const int j0 = (ts + t) * BN;
      if (!(j0 >= full_lo && j0 + BN - 1 <= full_hi)) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = j0 + 8 * j + cq + e;
            s[4 * j + e] = (kp >= lo0 && kp <= hi0) ? s[4 * j + e] : NEG_INF;
            s[4 * j + 2 + e] = (kp >= lo1 && kp <= hi1) ? s[4 * j + 2 + e] : NEG_INF;
          }
        }
      }
      float mx0 = RUNNING_MIN, mx1 = RUNNING_MIN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = ex2((m0 - mn0) * scale_log2), a1 = ex2((m1 - mn1) * scale_log2);
      const float ms0 = mn0 * scale_log2, ms1 = mn1 * scale_log2;
      m0 = mn0;
      m1 = mn1;

      // P = exp(scale (s - m)) = 2^(s scale log2(e) - m scale log2(e)), one
      // FFMA and one ex2 a score, rounded to bf16 in the A-fragment order;
      // the normaliser sums the unrounded weights
      uint32_t p[BN / 4];
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float w00 = ex2(fmaf(s[4 * j], scale_log2, -ms0));
        const float w01 = ex2(fmaf(s[4 * j + 1], scale_log2, -ms0));
        const float w10 = ex2(fmaf(s[4 * j + 2], scale_log2, -ms1));
        const float w11 = ex2(fmaf(s[4 * j + 3], scale_log2, -ms1));
        rs0 += w00 + w01;
        rs1 += w10 + w11;
        p[2 * j] = pack_bf16(w00, w01);
        p[2 * j + 1] = pack_bf16(w10, w11);
      }
      l0 = l0 * a0 + rs0;
      l1 = l1 * a1 + rs1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }

      // O += P V
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 smem_desc(va + 2048 * kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    }
  } else {
    // no query of this warpgroup is inside S_pad: release the tiles only
    for (int t = 0; t < n; ++t) {
      const int st = t % STAGES;
      mbar_wait(full_bar + 8 * st, (t / STAGES) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    }
    return;
  }

  PA_MARK(3);
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);

  if (direct) {
    const int h0 = w.g * G + hl0, h1 = w.g * G + hl1;
    const bool ok0 = hl0 < G && qi0 < S_pad, ok1 = hl1 < G && qi1 < S_pad;
    uint32_t* o0 = reinterpret_cast<uint32_t*>(out + (((size_t)w.b * H + h0) * S_pad + qi0) * HD + cq);
    uint32_t* o1 = reinterpret_cast<uint32_t*>(out + (((size_t)w.b * H + h1) * S_pad + qi1) * HD + cq);
    // acc / l as acc * (1 / l): one division a row, within an ulp of float32
    const float i0 = l0 > 0.f ? 1.f / l0 : 0.f, i1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      if (ok0) o0[4 * j] = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (ok1) o1[4 * j] = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  } else {
    // this split's partials: O unnormalised, m (log2 domain) and l a row
    float* pp = part + (((size_t)(w.b * KV + w.g) * qblocks + w.qb) * splits + w.sp) * PART_FLOATS;
    const int rr0 = wg * WG_ROWS + r0, rr1 = rr0 + 8;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      *reinterpret_cast<float2*>(pp + rr0 * HD + 8 * j + cq) = make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(pp + rr1 * HD + 8 * j + cq) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
    if (lane % 4 == 0) {
      m0 *= scale_log2;  // the combine works in the log2 domain
      m1 *= scale_log2;
      pp[CTA_ROWS * HD + rr0] = m0;
      pp[CTA_ROWS * HD + rr1] = m1;
      pp[CTA_ROWS * HD + CTA_ROWS + rr0] = l0;
      pp[CTA_ROWS * HD + CTA_ROWS + rr1] = l1;
    }
  }
#ifdef PA_TRACE
  if (threadIdx.x == 0 && blockIdx.x < TRACE_CTAS) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    unsigned long long* rec = pa_trace + blockIdx.x * 8;
    for (int i = 0; i < 4; ++i) rec[i] = pa_tr[i];
    rec[4] = now_ns();
    rec[5] = smid;
    rec[6] = n;
    rec[7] = direct;
  }
#endif
}

// grid: B * KV * qblocks blocks of COMBINE_THREADS threads, each taking 8
// columns of one row of a query block at a time; a block of more than
// one chunk gets out = (sum_c O_c 2^(m_c - M)) / (sum_c l_c 2^(m_c - M)),
// M the row's largest m, summed in chunk order.
constexpr int COMBINE_THREADS = 512;

__global__ void __launch_bounds__(COMBINE_THREADS)
    prefill_combine_kernel(const float* __restrict__ part, const int* __restrict__ seq_lens,
                           __nv_bfloat16* __restrict__ out, int H, int KV, int S_pad, int E,
                           int offset, int window, int qblocks, int splits, int chunk) {
  const int G = H / KV, qpw = WG_ROWS / G;
  const int blk = blockIdx.x;  // (b * KV + g) * qblocks + qb
  const int qb = blk % qblocks, g = (blk / qblocks) % KV, b = blk / (qblocks * KV);
  const Range kr = block_range(qb, NWG * qpw, S_pad, E, offset, seq_lens[b], window);
  if (kr.n <= chunk) return;  // one chunk: written by its CTA
  const int chunks = (kr.n + chunk - 1) / chunk;
  const float* pp = part + (size_t)blk * splits * PART_FLOATS;
  for (int it = threadIdx.x; it < 8 * CTA_ROWS; it += COMBINE_THREADS) {
    const int rr = it / 8, c = 8 * (it % 8), r = rr % WG_ROWS;
    const int hl = r / qpw, qi = qb * NWG * qpw + (rr / WG_ROWS) * qpw + r % qpw;
    if (hl >= G || qi >= S_pad) continue;
    float mx = RUNNING_MIN;
    for (int s = 0; s < chunks; ++s) mx = fmaxf(mx, pp[s * PART_FLOATS + CTA_ROWS * HD + rr]);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float l = 0.f;
    for (int s = 0; s < chunks; ++s) {
      const float* ps = pp + s * PART_FLOATS;
      const float wt = ex2(ps[CTA_ROWS * HD + rr] - mx);
      l += ps[CTA_ROWS * HD + CTA_ROWS + rr] * wt;
      const float4 x = *reinterpret_cast<const float4*>(ps + rr * HD + c);
      const float4 y = *reinterpret_cast<const float4*>(ps + rr * HD + c + 4);
      acc[0] += x.x * wt;
      acc[1] += x.y * wt;
      acc[2] += x.z * wt;
      acc[3] += x.w * wt;
      acc[4] += y.x * wt;
      acc[5] += y.y * wt;
      acc[6] += y.z * wt;
      acc[7] += y.w * wt;
    }
    const float il = l > 0.f ? 1.f / l : 0.f;
    const uint4 v = make_uint4(pack_bf16(acc[0] * il, acc[1] * il), pack_bf16(acc[2] * il, acc[3] * il),
                               pack_bf16(acc[4] * il, acc[5] * il), pack_bf16(acc[6] * il, acc[7] * il));
    *reinterpret_cast<uint4*>(out + (((size_t)b * H + g * G + hl) * S_pad + qi) * HD + c) = v;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle over `rank` dims (dim 0 =
// the 64 contiguous elements of a row), zero fill past the ends.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides_bytes, const cuuint32_t* box) {
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
            strides_bytes, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ENCODE_FAILED = 10000;  // + the CUresult of a refused tensor map

}  // namespace

#ifdef PA_TRACE
// Copies the trace records of the first n CTAs (8 words each) to host
// memory dst, then clears every record (a CTA that returns at once, an
// empty split, leaves its record 0).
extern "C" int fs_prefill_trace(void* dst, int n) {
  void* addr = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&addr, pa_trace);
  if (err == cudaSuccess)
    err = cudaMemcpy(dst, addr, (size_t)n * 8 * sizeof(unsigned long long), cudaMemcpyDeviceToHost);
  if (err == cudaSuccess) err = cudaMemset(addr, 0, sizeof(pa_trace));
  return (int)err;
}
#endif

// The launch plan of fs_prefill_attention at these shapes on a card of
// `sms` SMs: plan[0..10] = queries a
// CTA, query blocks, key splits, tiles a split, CTAs a batch row, rows a
// CTA, keys a tile, ring stages, threads a CTA, dynamic shared memory
// bytes, floats of one split's partials. Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int fs_prefill_plan(int S_pad, int E, int H, int KV, int sms, int* plan) {
  if (KV <= 0 || H % KV != 0 || H / KV > WG_ROWS || S_pad <= 0 || E <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(S_pad, E, H, KV, sms);
  const int v[11] = {p.queries, p.qblocks, p.splits, p.chunk, p.ctas, CTA_ROWS, BN, STAGES,
                     THREADS, SMEM_BYTES, PART_FLOATS};
  for (int i = 0; i < 11; ++i) plan[i] = v[i];
  return 0;
}

// The work of each of the B * plan.ctas CTAs of fs_prefill_attention at
// these shapes, from the index arithmetic the kernel runs (cta_work,
// block_range, cta_chunk): work[8 x + 0..7] = row b, KV head g, query
// block, split, the block's first tile and tile count, the CTA's first
// tile and tile count. seq_lens: B ints in host memory. Returns 0, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int fs_prefill_cta_work(int S_pad, int E, int H, int KV, int sms, int B, int offset,
                                   int window, const int* seq_lens, int* work) {
  if (KV <= 0 || H % KV != 0 || H / KV > WG_ROWS || B <= 0 || S_pad <= 0 || E <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(S_pad, E, H, KV, sms);
  for (int x = 0; x < B * p.ctas; ++x) {
    const Work w = cta_work(x, B, KV, p.qblocks, p.splits);
    const Range kr = block_range(w.qb, p.queries, S_pad, E, offset, seq_lens[w.b], window);
    const Range ck = cta_chunk(kr, w.sp, p.chunk);
    const int v[8] = {w.b, w.g, w.qb, w.sp, kr.t0, kr.n, ck.t0, ck.n};
    for (int i = 0; i < 8; ++i) work[8 * x + i] = v[i];
  }
  return 0;
}

// q (B, H, S_pad, 64) and out contiguous; k/v (B, KV, E, 64) with rows of
// 64 contiguous bf16 and element strides k_sb (batch) and k_skv (KV
// head), shared by k and v; seq_lens (B,) int32; sms: the SM count the
// plan is made for (the caller's fs_prefill_plan gives the same plan);
// scratch: B * plan.ctas * PART_FLOATS floats when the plan splits keys,
// else unused (may be null). Two launches when the plan splits keys (the blocks, then the
// combine), else one; *launched (host memory) is set to the number of kernels launched.
// Returns 0, the first launch's cudaGetLastError(), or ENCODE_FAILED + the driver's code if a
// tensor map is refused.
extern "C" int fs_prefill_attention(const void* q, const void* k, const void* v,
                                    const void* seq_lens, void* out, void* scratch, int B, int H,
                                    int KV, int S_pad, int E, int k_sb, int k_skv, int offset,
                                    int window, float scale, int sms, void* stream,
                                    int* launched) {
  *launched = 0;
  if (KV <= 0 || H % KV != 0 || H / KV > WG_ROWS || B <= 0 || S_pad <= 0 || E <= 0 || sms <= 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(S_pad, E, H, KV, sms);
  if (p.splits > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;

  const int G = H / KV;
  CUtensorMap q_map, k_map, v_map;
  {
    const cuuint64_t dims[3] = {HD, (cuuint64_t)S_pad, (cuuint64_t)B * H};
    const cuuint64_t strides[2] = {HD * 2, (cuuint64_t)S_pad * HD * 2};
    const cuuint32_t box[3] = {HD, (cuuint32_t)(WG_ROWS / G), (cuuint32_t)G};
    const CUresult rc = encode(fn, &q_map, q, 3, dims, strides, box);
    if (rc != CUDA_SUCCESS) return ENCODE_FAILED + (int)rc;
  }
  {
    const cuuint64_t dims[4] = {HD, (cuuint64_t)E, (cuuint64_t)KV, (cuuint64_t)B};
    const cuuint64_t strides[3] = {HD * 2, (cuuint64_t)k_skv * 2, (cuuint64_t)k_sb * 2};
    const cuuint32_t box[4] = {HD, BN, 1, 1};
    CUresult rc = encode(fn, &k_map, k, 4, dims, strides, box);
    if (rc == CUDA_SUCCESS) rc = encode(fn, &v_map, v, 4, dims, strides, box);
    if (rc != CUDA_SUCCESS) return ENCODE_FAILED + (int)rc;
  }

  // the dynamic shared-memory limit is raised once for each device
  static bool attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(prefill_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(scratch);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  prefill_attention_kernel<<<B * p.ctas, THREADS, SMEM_BYTES, st>>>(
      q_map, k_map, v_map, static_cast<const int*>(seq_lens), o, part, B, H, KV, S_pad, E, offset,
      window, scale * LOG2E, p.qblocks, p.splits, p.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  if (p.splits > 1) {
    prefill_combine_kernel<<<B * KV * p.qblocks, COMBINE_THREADS, 0, st>>>(
        part, static_cast<const int*>(seq_lens), o, H, KV, S_pad, E, offset, window, p.qblocks,
        p.splits, p.chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    *launched = 2;
  }
  return 0;
}
