// One whole fast (codebook) frame for B <= 32 rows with per-row sampling,
// for Hopper (sm_90a): one cooperative persistent launch a frame.
//
// Replaces the TPU kernel fish_speech_tpu/ops/fast_frame_pallas.py::
// fused_fast_frame_batched (l.884, its pallas_call l.1007), bf16 body and
// int8 body (_make_kernel_batched(quantized=True), l.532). For codebook
// steps cb = 0..C-1 and every row b: the fast layers run on x[b] (the
// row's slow hidden at cb = 0, then the embedding of its previous token)
// with RoPE at position cb and attention over the row's own K/V history
// 0..cb; the fast norm and head (the step's column block when
// depthwise_output) give f32 logits, unrounded; the row's repetition
// penalty, its top-k/top-p draw with its own temp, top_p, top_k and Gumbel
// draws (indexed by rank), and the EOS rule give the token, and the
// token's embedding row (the step's row block when depthwise_wte) is the
// row's next x. Rounding points, int8 rescale and silu are
// dual_ar_layer.cuh's (the TPU kernel's, fast_frame_pallas.py:569-573,
// 595-604, 706-712).
//
// What bounds it on this card: bytes, and the chain of dependent phases.
// The fast stack is ~120 MB at Fish-1.5 width, more than the 50 MB L2,
// so each codebook step streams it again (~0.97 GB a frame); all rows
// share that stream. At 16 rows a weight element feeds 16 multiply-adds,
// far below the tensor cores' balance point. Each step also has three
// cross-block reductions a layer, the head and the draw, which waits for
// the head.
//
// Design: the layer pass of the slow step's row kernel (rows_stack.cuh:
// the plan, the producer warp's cp.async weight ring, mma.sync on the
// tensor cores, three grid syncs a layer) run C times in one launch, one
// block an SM. The sequence this replaces (22 launches a codebook step,
// 176 a frame at Fish-1.5 depth, from a host loop) paid each launch's
// fixed cost, moved no weight byte while attention, the head and the draw
// ran, and sorted all V logits of a row on 1024 threads. Here:
// * A step: the L layers on the group's x, the history's K/V rows written
//   at position cb of each row's (L, 32, KV, C, 64) history in the plan's
//   scratch, attention over positions 0..cb (one key tile); the fast norm
//   and the head's partials over the step's column block; one grid sync;
//   block b < B adds row b's head splits in the plan's order into its
//   logits and draws its token (codebook_sampler.cuh's rd_sample: a radix
//   select of the k_eff largest keys, a sort of those alone, the scan and
//   the Gumbel draw), writes it and publishes the token's embedding row as
//   the row's next x; one grid sync, and the next step's first norm reads
//   it. C (3 L + 2) - 1 grid syncs a frame.
// * The producer warps stream the next step's weights in the same fixed
//   order while the heads and the draws run: the ring runs ahead across
//   layers and steps.
// * The plan (fr_make_plan; mirrored by ops/decode_stack.py::frame_plan)
//   is a function of L, D, H, KV, F, C, V, k_dyn, the weight type and the
//   grid, never of the rows, their knobs or their data; every
//   sum runs in an order it fixes, so a row's tokens and logits are the
//   same bits alone as among 31 co-tenants.
// * The sync state is the caller's (an engine's own): the kernel counts
//   its launches (word FR_LAUNCHES_WORD), grid syncs and head 0's
//   exchanges into it and leaves its counters zeroed; every wait traps
//   after DS_TIMEOUT_NS.
// * What holds it back (scripts/trace_decode_stack.py --part frame on an
//   NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): the layer pass's
//   chain, as in the row kernel, ~46 us a pass at 16 rows (the two
//   reduce-broadcasts; attention's chain of round trips, even over one key
//   tile); a step's head, draw and two syncs add ~30 us (the draw ~20-22
//   us of barriers and dependent loads); and the first layer after a draw
//   runs ~10 us longer, with the drawing blocks' attention about twice as
//   long as the other blocks' (their instruction cache refilled after the
//   draw's code, by the trace's split of blocks).
// rows_gemm below, the frame's GEMMs of the launch sequence this replaces,
// stays as the C entry fs_rows_gemm for the card's per-GEMM checks; no
// path of the port launches it. The TPU kernel's row-block grid, flat-lane
// E/R matrices, lane rolls, one-hot embedding matmul and sel_rows scatter
// are Mosaic workarounds and are not ported.

#include <cooperative_groups.h>

#include "rows_stack.cuh"
#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// The frame
// ---------------------------------------------------------------------------

constexpr int FR_MAX_VOCAB = 4096;  // codebook entries a draw takes
constexpr int FR_LAUNCHES_WORD = DS_STATE_WORDS - 6;  // this kernel's launches so far

// The frame's plan: the layer pass's (S = C, the head's V columns), the
// draw's shared memory (over [sm_h, sm_seg), free after the head), the
// keys its sort takes at k_dyn, and the rows' K/V history (at sc_extra).
struct FrPlan {
  SrPlan core;
  int draw_bytes, sort_keys, hist_bytes;
};

inline bool fr_make_plan(int L, int D, int H, int KV, int F, int C, int V, int k_dyn,
                         bool int8, int grid, FrPlan& p) {
  p = FrPlan{};
  if (L < 1 || C < 1 || V < 1 || V > FR_MAX_VOCAB || V % 8 != 0 || k_dyn < 1 || k_dyn > V ||
      KV < 1)
    return false;
  p.draw_bytes = rd_smem_bytes(V, k_dyn);
  p.sort_keys = rd_sort_width(k_dyn);
  p.hist_bytes = 2 * L * SR_ROWS * KV * C * HDIM * 2;
  if (!sr_make_plan(D, H, KV, F, V, C, int8, grid, p.core, p.draw_bytes, p.hist_bytes))
    return false;
  return 3 + p.core.sw_slices + H <= FR_LAUNCHES_WORD;  // the counters below the reports
}

template <typename W>
struct FrArgs {
  // the fast stack and fast_norm, the head (fast_output), x0 = the rows'
  // slow hiddens, the history as the cache (cache_b = SR_ROWS, S = C),
  // logits (C, nb, V)
  SrArgs<W> s;
  const bf16* emb;
  const int* window;     // (nb, C, window_len)
  const float* gumbel;   // (nb, C, k_dyn)
  const float* temp;     // (nb,) each
  const float* top_p;
  const int* top_k;
  const float* penalty;
  const unsigned char* is_eos;
  int* tokens;  // (nb, C)
  int C, V, depthwise_output, depthwise_wte, window_len, k_dyn, rep_enabled;
};

// Row b's draw at step cb, on block b's consumers: the row's knobs,
// window and first Gumbel draws loaded ahead; the head's splits added in
// order into the f32 logits, four adjacent columns a thread (written to
// logits[cb, b]), divided by the row's penalty where its window holds the
// column and by max(temp, 1e-6); rd_sample; the EOS rule; tokens[b, cb];
// unless this is the last step, the token's embedding row (step cb's
// block when depthwise_wte) to x_next[b]. Trace marks in pass `pass`: 3
// logits gathered and divided, rd_sample's (11, 12, 4, 13, 14, 5, 6), 7
// token published.
template <typename W>
__device__ __noinline__ void fr_draw(const FrArgs<W>& f, const SrMem& m, unsigned char* smem,
                                     int b, int cb, bf16* x_next, int pass) {
  const SrArgs<W>& a = f.s;
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int V = f.V, D = a.D, C = f.C;
  const RdSmem s = RdSmem::at(smem + P.sm_h, V, f.k_dyn);
  const bool eos = f.is_eos[b] != 0;
  const float temp = f.temp[b], top_p = f.top_p[b], penalty = f.penalty[b];
  const int top_k = f.top_k[b];
  const int wl = f.rep_enabled ? f.window_len : 0;
  const int* win = f.window + ((size_t)b * C + cb) * f.window_len;
  const int w_lo = lane < wl ? win[lane] : -1;
  const int w_hi = lane + 32 < wl ? win[lane + 32] : -1;
  const float* gumbel = f.gumbel + ((size_t)b * C + cb) * f.k_dyn;
  const float g0 = tid < f.k_dyn ? gumbel[tid] : 0.f;
  s.hist[tid] = 0u;  // rd_sample's first two histograms
  s.hist[RD_THREADS + tid] = 0u;
  if (tid == 0) *s.slots = 0;
  const float t = fmaxf(temp, 1e-6f);
  float* out = a.logits + ((size_t)cb * a.nb + b) * V;
  float mx = -INFINITY;
  for (int base = 0; base < V; base += RD_ITEMS * RD_THREADS) {
    const int c4 = base + RD_ITEMS * tid;
    const bool ok = c4 < V;  // V % 8 == 0: a thread's four columns all or none
    const float4 y = ok ? sr_sum4<16>(m.part_head +
                                          ((size_t)(c4 / SR_TILE) * P.head_splits * SR_ROWS + b) *
                                              SR_TILE +
                                          c4 % SR_TILE,
                                      (size_t)SR_ROWS * SR_TILE, P.head_splits)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    bool member[RD_ITEMS] = {false, false, false, false};
    for (int w = 0; w < wl; ++w) {
      const int e = __shfl_sync(FULL, w < 32 ? w_lo : w_hi, w & 31);
#pragma unroll
      for (int k = 0; k < RD_ITEMS; ++k) member[k] |= e == c4 + k;
    }
    if (ok) {
      *reinterpret_cast<float4*>(out + c4) = y;
      const float yv[RD_ITEMS] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int k = 0; k < RD_ITEMS; ++k) {
        const float x = __fdiv_rn(member[k] ? __fdiv_rn(yv[k], penalty) : yv[k], t);
        s.p[c4 + k] = x;
        mx = fmaxf(mx, x);
      }
    }
  }
  DS_MARK(pass, 3);
  const int tok = eos ? 0 : rd_sample(s, V, mx, temp, top_p, top_k, f.k_dyn, gumbel, g0, pass);
  if (tid == 0) f.tokens[(size_t)b * C + cb] = tok;
  if (cb + 1 < C) {
    const uint4* row = reinterpret_cast<const uint4*>(
        f.emb + ((f.depthwise_wte ? (size_t)cb * V : 0) + tok) * (size_t)D);
    for (int i = tid; i < D / 8; i += RD_THREADS)
      reinterpret_cast<uint4*>(x_next + (size_t)b * D)[i] = __ldg(row + i);
  }
  DS_MARK(pass, 7);
}

// The whole frame for nb <= 32 rows: one block per SM, cooperative
// launch. Trace: pass cb * L + l holds step cb's layer l (rows_stack.cuh's
// marks), pass C * L + cb its head and draw (0 the last layer done, 1 the
// head's partials done, 2 after their sync, 3-7 and 11-14 the draw's
// (fr_draw, rd_sample), 8 after the draw's sync, 9 the next x read).
template <typename W>
__global__ void __launch_bounds__(DS_BLOCK, 1)
    fast_frame_rows_kernel(const __grid_constant__ FrArgs<W> f) {
  extern __shared__ __align__(128) unsigned char sr_smem[];
  const SrArgs<W>& a = f.s;
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int D = a.D, L = a.L, nb = a.nb, C = f.C;
  const SrMem m = SrMem::of(sr_smem, a.scratch, P);

  // 1. the tables (the head's steps V columns apart when depthwise_output)
  sr_setup(a, m, sr_smem, f.depthwise_output ? 2ll * f.V : 0ll);
  if (tid < SR_ROWS) m.pos_s[tid] = 0;
  __syncthreads();  // the whole block, producer warp included: the last time
  const uint32_t full = ds_smem_addr(sr_smem + P.sm_bar);
  const uint32_t empty = full + 8 * P.stages;
  if (tid >= DS_THREADS) {
    sr_produce<W>(m.segs, m.mats, L, C, sr_smem + P.sm_ring, full, empty, P.stages,
                  P.stage_bytes);
    return;
  }
  SrRing rg{sr_smem + P.sm_ring, full, empty, P.stages, P.stage_bytes, 0, 0u};
  sr_norm(a.x0, nb, D, a.stack.attn_norm, m.h_s, P.h_pitch, a.eps);
  ds_sync();

  // 2. the steps
  SrFlow fl{0u, 0u, 0, a.x0};
  for (int cb = 0;; ++cb) {
    const int dpass = C * L + cb;
    if (tid < SR_ROWS) m.pos_s[tid] = cb;  // read after the first layer's QKV sync
    for (int l = 0; l < L; ++l) sr_layer<W>(a, m, rg, fl, l, cb * L + l, nullptr, [] {});
    DS_MARK(dpass, 0);
    sr_head_partials<W>(a, m, rg);
    DS_MARK(dpass, 1);
    sr_grid_sync(a.state, fl.si);
    DS_MARK(dpass, 2);
    bf16* x_next = m.xg + fl.buf * SR_ROWS * D;  // the buffer x_prev is not
    if (blk < nb) fr_draw<W>(f, m, sr_smem, blk, cb, x_next, dpass);
    if (cb + 1 == C) break;
    sr_grid_sync(a.state, fl.si);
    DS_MARK(dpass, 8);
    fl.x_prev = x_next;
    fl.buf ^= 1;
    sr_norm(x_next, nb, D, a.stack.attn_norm, m.h_s, P.h_pitch, a.eps, dpass, 9);
    ds_sync();
  }

  // 3. the last block to finish counts the launch and resets the counters
  sr_finish(a, FR_LAUNCHES_WORD);
}

template <typename W>
cudaError_t fr_launch(const FrArgs<W>& f, cudaStream_t st) {
  static int smem_set = 0;
  static int smem_checked = 0;
  return ds_coop_launch(fast_frame_rows_kernel<W>, f, f.s.plan.grid, DS_BLOCK, f.s.plan.smem, st,
                        smem_set, smem_checked);
}

// ---------------------------------------------------------------------------
// rows_gemm: out[b, n] = epilogue(p(sum_k in'[b, k] * w[k, n])), b < nb <= 32
// (the GEMMs of the launch sequence the frame kernel replaced; the C entry
// fs_rows_gemm only)
// ---------------------------------------------------------------------------

constexpr int MAX_BATCH_ROWS = 32;

// ---------------------------------------------------------------------------
// rows_gemm: out[b, n] = epilogue(p(sum_k in'[b, k] * w[k, n])), b < nb <= 32
// ---------------------------------------------------------------------------

constexpr int RG_TN = 64;            // output columns of a cluster (and of each block)
constexpr int RG_BK = 64;            // rows of K in one pipeline stage
constexpr int RG_STAGES = 8;         // stages of the cp.async ring (4 where 8 do not fit)
constexpr int RG_MAX_SPLITS = 8;     // blocks of a cluster, split over K (portable size)
constexpr int RG_MIN_BLOCKS = 128;   // the plan splits K until the grid has this many
constexpr int RG_THREADS = 128;      // 4 warps, 16 columns each
constexpr int RG_MAX_SMEM = 232448 - 1024;  // dynamic shared memory a block may use on
                                            // sm_90, less a margin for the static part
constexpr int RG_HALF_SM_SMEM = 113 * 1024;  // two such blocks fit on one SM

// Bytes of one weight row of a stage in shared memory: the tile's 64
// columns plus 16 bytes, so that the 8 rows one ldmatrix reads (bf16),
// or the 4 rows one int8 fragment reads, fall in distinct banks.
template <typename W>
__host__ __device__ constexpr int rg_pitch() {
  return RG_TN * (int)sizeof(W) + 16;
}

// The launch plan of one GEMM: a function of (K, N, mode, weight type)
// only, never of the number of rows, so a row's sums run in one order
// whatever its co-tenants (ops/fast_frame_batched.py::rows_plan mirrors
// it). tiles x splits blocks; each cluster of `splits` blocks owns 64
// columns, each block `kb` rows of K.
struct RowsPlan {
  int tiles, splits, kb, stages, smem;
};

// Ring slots in use: every chunk of a block's slice in flight at once
// where the slice has fewer chunks than stages.
inline int rows_slots(int kb, int stages) {
  const int chunks = (kb + RG_BK - 1) / RG_BK;
  return chunks < stages ? chunks : stages;
}

inline int rows_smem(int mode, bool int8, int kb, int stages) {
  const int na = mode == kSwiglu ? 2 : 1;
  const int pitch = int8 ? rg_pitch<int8_t>() : rg_pitch<bf16>();
  return rows_slots(kb, stages) * na * RG_BK * pitch  // the weight ring
         + MAX_BATCH_ROWS * (2 * kb + 16)             // the staged input rows
         + 2 * kb + 16                                // the slice of the norm weights
         + na * MAX_BATCH_ROWS * RG_TN * 4;           // the f32 partials of the splits
}

inline RowsPlan rows_plan(int K, int N, int mode, bool int8) {
  RowsPlan p;
  p.tiles = (N + RG_TN - 1) / RG_TN;
  p.splits = 1;
  while (p.splits < RG_MAX_SPLITS && p.tiles * p.splits < RG_MIN_BLOCKS &&
         K >= 2 * p.splits * RG_BK)
    p.splits *= 2;
  p.kb = ((K + p.splits - 1) / p.splits + 15) / 16 * 16;
  // clusters of 4 or 8 are placed within one GPC, whose SMs must all hold
  // one: a block that leaves room for a second on its SM keeps every
  // cluster of a 128-block grid resident at once
  const int budget = p.splits >= 4 ? RG_HALF_SM_SMEM : RG_MAX_SMEM;
  p.stages = rows_smem(mode, int8, p.kb, RG_STAGES) <= budget ? RG_STAGES : RG_STAGES / 2;
  p.smem = rows_smem(mode, int8, p.kb, p.stages);
  return p;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// The two halves of cluster.sync(): a block arrives as it starts and
// waits before its first store into another block's shared memory, which
// is legal only once every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The A fragment (16 columns x 16 k) of weight tile rows k..k+15 at the
// warp's columns c0..c0+15, for mma.m16n8k16 with the weights as A
// ("swap-AB": the columns are M, the rows of the batch N).
//   bf16: ldmatrix.trans of four 8x8 blocks; fragment row m is column
//         c0 + m.
//   int8: each lane reads 2 bytes from each of its 4 k rows: columns
//         c0 + 2g and c0 + 2g + 1, which become fragment rows g and g + 8
//         (so fragment row m is column c0 + 2m for m < 8, c0 + 2(m-8) + 1
//         otherwise); converted to bf16 as the fragment is formed.
template <typename W>
struct Frag;

template <>
struct Frag<bf16> {
  __device__ __forceinline__ static void load(unsigned (&a)[4], const unsigned char* tile, int k,
                                              int c0, int lane) {
    const int mi = lane >> 3;
    const int row = k + (mi >> 1) * 8 + (lane & 7);
    const int col = c0 + (mi & 1) * 8;
    ldmatrix_x4_trans(a, tile + row * rg_pitch<bf16>() + col * 2);
  }
  __device__ __forceinline__ static int column(int c0, int m) { return c0 + m; }
};

template <>
struct Frag<int8_t> {
  __device__ __forceinline__ static void load(unsigned (&a)[4], const unsigned char* tile, int k,
                                              int c0, int lane) {
    int8_a_frag<rg_pitch<int8_t>()>(a, tile, k, c0, lane);
  }
  __device__ __forceinline__ static int column(int c0, int m) { return int8_a_column(c0, m); }
};

// out[b, n] = epilogue(p(sum_k in'[b, k] * w[k, n])) for b < nb, n < N:
// the modes, roundings and int8 rescale p of dual_ar_layer.cuh's
// gemv_kernel. in: (nb, K) contiguous bf16; w (and w_b): K rows of stride
// ldw. grid: tiles * splits blocks in clusters of `splits` (rank = K
// slice); dynamic shared memory: rows_smem(). Rows nb..NB of the staged
// input are zero and their results are not written.
template <int MODE, typename W, int NB, int STAGES>
__global__ void __launch_bounds__(RG_THREADS)
    rows_gemm_kernel(const bf16* __restrict__ in, const bf16* __restrict__ norm_w,
                     const W* __restrict__ w, const W* __restrict__ w_b,
                     const bf16* __restrict__ scale, const bf16* __restrict__ scale_b, int nb,
                     int K, int N, int ldw, float eps, bf16* out, float* __restrict__ out_f32,
                     int kb) {
  constexpr bool NORM = MODE != kResidual;
  constexpr int NA = MODE == kSwiglu ? 2 : 1;
  constexpr int NT = NB / 8;                       // n-tiles of 8 rows
  constexpr int WARPS = RG_THREADS / 32;
  constexpr int PITCH = rg_pitch<W>();
  constexpr int PIECES = RG_TN * (int)sizeof(W) / 16;  // 16-byte copies a row
  constexpr int ELEMS = 16 / (int)sizeof(W);          // weights a copy

  extern __shared__ __align__(16) unsigned char rg_smem[];
  unsigned char* ring = rg_smem;                                  // [STAGES][NA][BK][PITCH]
  const int chunks = (kb + RG_BK - 1) / RG_BK;
  const int slots = min(chunks, STAGES);
  unsigned char* xs = ring + slots * NA * RG_BK * PITCH;          // [32][2 kb + 16]
  unsigned char* nws = xs + MAX_BATCH_ROWS * (2 * kb + 16);       // [kb + 8] bf16
  float* red = reinterpret_cast<float*>(nws + 2 * kb + 16);       // [splits][NA][32][per]
  __shared__ float inv_rms[NB];

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int splits = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = (blockIdx.x / splits) * RG_TN;
  const int k0 = rank * kb;
  const int k_end = min(K, k0 + kb);
  const int xpitch = 2 * kb + 16;

  // the RMS pre-pass's first loads go out before any copy is queued:
  // each warp takes NB / 4 rows at once, each lane 8 elements (16 bytes)
  // of a row at a time, UNR of them loaded before any is used (zeros past
  // nb and K add exactly nothing)
  constexpr int RPW = NB / WARPS;  // rows a warp
  constexpr int UNR = 16 / RPW;    // 16-byte loads of a row in flight
  float ss[RPW];
  uint4 rv[RPW][UNR];
  auto load_rms = [&](int i0) {
#pragma unroll
    for (int j = 0; j < RPW; ++j)
#pragma unroll
      for (int u = 0; u < UNR; ++u) {
        const int b = warp + WARPS * j;
        const int i = i0 + 32 * u;
        rv[j][u] = b < nb && i < K / 8 ? reinterpret_cast<const uint4*>(in + (size_t)b * K)[i]
                                       : make_uint4(0u, 0u, 0u, 0u);
      }
  };
  if (NORM) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) ss[j] = 0.f;
    load_rms(lane);
  }

  // 1. the input slice and the weight stream, by 16-byte cp.async: group
  //    0 holds this block's slice of the input rows (zero past nb and K),
  //    of the norm weights, and weight chunk 0; group c weight chunk c, in
  //    ring slot c % STAGES (rows past the slice, columns past N zero)
  const int chunks8 = kb / 8;  // K % 8 == 0: a chunk lies all in or all past K
  for (int i = tid; i < NB * chunks8; i += RG_THREADS) {
    const int b = i / chunks8;
    const int k = k0 + 8 * (i - b * chunks8);
    const bool ok = b < nb && k < k_end;
    cp_async16(xs + b * xpitch + (i - b * chunks8) * 16,
               ok ? (const void*)(in + (size_t)b * K + k) : (const void*)in, ok ? 16 : 0);
  }
  if (NORM)
    for (int i = tid; i < chunks8; i += RG_THREADS) {
      const bool ok = k0 + 8 * i < k_end;
      cp_async16(nws + 16 * i, ok ? (const void*)(norm_w + k0 + 8 * i) : (const void*)norm_w,
                 ok ? 16 : 0);
    }
  auto issue = [&](int c) {
    if (c < chunks) {
      unsigned char* slot = ring + (c % STAGES) * NA * RG_BK * PITCH;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const W* src = a == 0 ? w : w_b;
        for (int i = tid; i < RG_BK * PIECES; i += RG_THREADS) {
          const int r = i / PIECES;
          const int piece = i - r * PIECES;
          const int k = k0 + c * RG_BK + r;
          const int n = n0 + piece * ELEMS;
          const bool ok = k < k_end && n < N;
          cp_async16(slot + (a * RG_BK + r) * PITCH + piece * 16,
                     ok ? (const void*)(src + (size_t)k * ldw + n) : (const void*)src, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();  // an empty group past the last chunk keeps the count
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // the epilogue's items (row, column) of this thread; in the residual
  // mode their residual values are loaded now, while the copies fly
  constexpr int EPI = NB * RG_TN / RG_THREADS;  // most items a thread takes
  const int per = RG_TN / splits;               // columns this rank finishes
  const int items = nb * per;
  float res_pf[EPI];
#pragma unroll
  for (int j = 0; j < EPI; ++j) {
    res_pf[j] = 0.f;
    const int i = tid + j * RG_THREADS;
    const int b = i / per;
    const int n = n0 + rank * per + (i - b * per);
    if (MODE == kResidual && i < items && n < N) res_pf[j] = bf(out[(size_t)b * N + n]);
  }

  if (NORM) {
    // 2. RMS of each input row over the whole of K (the first batch of
    //    loads is in flight since the start)
    for (int i0 = lane; i0 < K / 8; i0 += 32 * UNR) {
      if (i0 != lane) load_rms(i0);
#pragma unroll
      for (int u = 0; u < UNR; ++u)
#pragma unroll
        for (int j = 0; j < RPW; ++j) {
          float f[8];
          unpack8(rv[j][u], f);
#pragma unroll
          for (int e = 0; e < 8; ++e) ss[j] = __fadd_rn(ss[j], __fmul_rn(f[e], f[e]));
        }
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss[j] += __shfl_xor_sync(FULL, ss[j], off);
      const int b = warp + WARPS * j;
      if (lane == 0 && b < nb) inv_rms[b] = rsqrtf(__fadd_rn(__fdiv_rn(ss[j], (float)K), eps));
    }

    // 3. normalise the staged slice in place, rounded to bf16
    cp_async_wait<STAGES - 2>();  // group 0: the slices
    __syncthreads();              // the slices and inv_rms visible to all
    for (int i = tid; i < nb * chunks8; i += RG_THREADS) {
      const int b = i / chunks8;
      const int k = k0 + 8 * (i - b * chunks8);
      if (k >= k_end) continue;
      uint4* dst = reinterpret_cast<uint4*>(xs + b * xpitch + (i - b * chunks8) * 16);
      float f[8], nw[8];
      unpack8(*dst, f);
      unpack8(*reinterpret_cast<const uint4*>(nws + 2 * (k - k0)), nw);
      uint4 v;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        h[e] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f[2 * e], inv_rms[b]), nw[2 * e]),
                                     __fmul_rn(__fmul_rn(f[2 * e + 1], inv_rms[b]), nw[2 * e + 1]));
      *dst = v;
    }
  }

  // 4. the products on the tensor cores, chunk by chunk, k ascending
  const int g = lane >> 2;
  const int cq = lane & 3;
  const int c0 = warp * 16;
  float acc[NA][NT][4];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][t][e] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed for all; slot (c - 1) % STAGES consumed
    issue(c + STAGES - 1);
    const unsigned char* slot = ring + (c % STAGES) * NA * RG_BK * PITCH;
    const int steps = min(RG_BK, kb - c * RG_BK) / 16;
    for (int s = 0; s < steps; ++s) {
      const int kx = c * RG_BK + s * 16;  // within the slice
      unsigned bfrag[NT][2];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const unsigned char* xrow = xs + (t * 8 + g) * xpitch + (kx + 2 * cq) * 2;
        bfrag[t][0] = *reinterpret_cast<const unsigned*>(xrow);
        bfrag[t][1] = *reinterpret_cast<const unsigned*>(xrow + 16);
      }
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        unsigned afrag[4];
        Frag<W>::load(afrag, slot + a * RG_BK * PITCH, s * 16, c0, lane);
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_bf16(acc[a][t], afrag, bfrag[t][0], bfrag[t][1]);
      }
    }
  }
  cp_async_wait<0>();

  // 5. the block's partial sums, pushed to the rank that finishes each
  //    column (columns [q * per, q * per + per) to rank q), into slot
  //    [rank] of its buffer red[splits][NA][32][per]: fragment element
  //    (m, n) of n-tile t is column Frag::column(c0, m), row 8 t + n
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = Frag<W>::column(c0, g + (e >> 1) * 8);
        const int row = t * 8 + 2 * cq + (e & 1);
        const int q = col / per;
        cluster.map_shared_rank(red, q)[((rank * NA + a) * MAX_BATCH_ROWS + row) * per +
                                        (col - q * per)] = acc[a][t][e];
      }
  // every rank's pushes have landed; after this no block touches another's
  // shared memory, so each may finish and leave on its own
  cluster.sync();

  // 6. epilogue: each rank adds the splits' partials of its own columns
  //    in rank order, from its own shared memory, then applies the mode
#pragma unroll
  for (int j = 0; j < EPI; ++j) {
    const int i = tid + j * RG_THREADS;
    const int b = i / per;
    const int cl = i - b * per;  // column within this rank's share
    const int n = n0 + rank * per + cl;
    if (i >= items || n >= N) continue;
    float y[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      y[a] = red[(a * MAX_BATCH_ROWS + b) * per + cl];
      for (int r = 1; r < splits; ++r) y[a] += red[((r * NA + a) * MAX_BATCH_ROWS + b) * per + cl];
    }
    const size_t o = (size_t)b * N + n;
    const float y0 = stack_product<W>(y[0], scale, n);
    if (MODE == kQkv) {
      out[o] = __float2bfloat16(y0);
    } else if (MODE == kResidual) {
      out[o] = __float2bfloat16(__fadd_rn(res_pf[j], round_bf16(y0)));
    } else if (MODE == kSwiglu) {
      const float gate = round_bf16(__fdiv_rn(y0, __fadd_rn(1.f, expf(-y0))));
      const float up = round_bf16(stack_product<W>(y[NA - 1], scale_b, n));
      out[o] = __float2bfloat16(__fmul_rn(gate, up));
    } else {
      out_f32[o] = y0;
    }
  }
}

template <int MODE, typename W, int NB, int STAGES>
cudaError_t launch_rows_gemm_st(const RowsPlan& p, int nb, const bf16* in, const bf16* norm_w,
                                const W* w, const W* w_b, const bf16* scale,
                                const bf16* scale_b, int K, int N, int ldw, float eps, bf16* out,
                                float* out_f32, cudaStream_t st) {
  auto kern = rows_gemm_kernel<MODE, W, NB, STAGES>;
  // raise the dynamic shared memory limit once per kernel and size, not
  // per launch (and not while a CUDA graph is captured after warm-up)
  static int smem_set = 0;
  if (p.smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    smem_set = p.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles * p.splits);
  cfg.blockDim = dim3(RG_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, in, norm_w, w, w_b, scale, scale_b, nb,
                                             K, N, ldw, eps, out, out_f32, p.kb);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int MODE, typename W, int NB>
cudaError_t launch_rows_gemm_nb(const RowsPlan& p, int nb, const bf16* in, const bf16* norm_w,
                                const W* w, const W* w_b, const bf16* scale,
                                const bf16* scale_b, int K, int N, int ldw, float eps, bf16* out,
                                float* out_f32, cudaStream_t st) {
  if (p.stages == RG_STAGES)
    return launch_rows_gemm_st<MODE, W, NB, RG_STAGES>(p, nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
  return launch_rows_gemm_st<MODE, W, NB, RG_STAGES / 2>(p, nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
}

template <int MODE, typename W>
cudaError_t launch_rows_gemm(int nb, const bf16* in, const bf16* norm_w, const W* w,
                             const W* w_b, const bf16* scale, const bf16* scale_b, int K,
                             int N, int ldw, float eps, bf16* out, float* out_f32,
                             cudaStream_t st) {
  constexpr int ELEMS = 16 / (int)sizeof(W);
  const RowsPlan p = rows_plan(K, N, MODE, std::is_same<W, int8_t>::value);
  // a row is read in 16-byte pieces up to N rounded up to a whole piece:
  // a ragged N (the slow head's 1025 columns) needs a stride padded past it
  if (K < 1 || K % 8 || N < 1 || ldw % ELEMS || ldw < (N + ELEMS - 1) / ELEMS * ELEMS ||
      p.smem > RG_MAX_SMEM ||
      reinterpret_cast<uintptr_t>(in) % 16 ||
      (norm_w != nullptr && reinterpret_cast<uintptr_t>(norm_w) % 16) ||
      reinterpret_cast<uintptr_t>(w) % 16 || (w_b != nullptr && reinterpret_cast<uintptr_t>(w_b) % 16))
    return cudaErrorInvalidValue;
  if (nb <= 8)
    return launch_rows_gemm_nb<MODE, W, 8>(p, nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
  if (nb <= 16)
    return launch_rows_gemm_nb<MODE, W, 16>(p, nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
  if (nb <= MAX_BATCH_ROWS)
    return launch_rows_gemm_nb<MODE, W, 32>(p, nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// hidden (B, D) bf16, the rows' slow hiddens, B <= 32. The fast-layer
// stack as in fs_slow_step (norms, five weights bf16 or int8, five scales
// or nulls); fast_norm (D,); head: the fast output (D, head_ld), whose
// columns [cb*V, cb*V + V) serve step cb when depthwise_output, else
// columns [0, V); emb: the fast embeddings, rows [cb*V, cb*V + V) for step
// cb's token when depthwise_wte, else rows [0, V). window (B, C,
// window_len) int32 rep-pen windows (read when rep_enabled); gumbel (B, C,
// k_dyn) f32; temp, top_p, penalty (B,) f32; top_k (B,) int32; is_eos (B,)
// bool. Out: tokens (B, C) int32; logits, (C, B, V) f32, each step's
// penalty-free head logits. scratch: scratch_bytes of device memory (at
// least the plan's); state: DS_STATE_WORDS words, its counters zero, left
// zero (the last two words: the launch's grid syncs and head 0's
// exchanges; word DS_STATE_WORDS - 6 counts this kernel's launches). One
// launch. Returns its CUDA error (0 on success).
extern "C" int fs_fast_frame_batched(
    const void* hidden, const void* attn_norm, const void* ffn_norm, const void* wqkv,
    const void* wo, const void* w1, const void* w3, const void* w2, const void* s_qkv,
    const void* s_o, const void* s_1, const void* s_3, const void* s_2,
    const void* fast_norm, const void* head, const void* emb, const void* cos_t,
    const void* sin_t, const void* window, const void* gumbel, const void* temp,
    const void* top_p, const void* top_k, const void* penalty, const void* is_eos,
    void* tokens, void* logits, void* scratch, void* state, int B, int L, int D, int H,
    int KV, int F, int C, int V, int head_ld, int depthwise_output, int depthwise_wte,
    int window_len, int k_dyn, int rep_enabled, int scratch_bytes, float eps, void* stream) {
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  bool int8 = false;
  if (B < 1 || B > SR_ROWS || !ds_int8(scales, int8) || head_ld % 8 != 0 ||
      head_ld < (depthwise_output ? C : 1) * V || window_len < 1 || window_len > MAX_WINDOW)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  FrPlan plan;
  if (!fr_make_plan(L, D, H, KV, F, C, V, k_dyn, int8, grid, plan) ||
      scratch_bytes < plan.core.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto stack) -> int {
    using Wt = typename std::remove_cv<
        typename std::remove_pointer<decltype(stack.wqkv)>::type>::type;
    FrArgs<Wt> f = {};
    SrArgs<Wt>& a = f.s;
    bf16* hist = reinterpret_cast<bf16*>(static_cast<unsigned char*>(scratch) + plan.core.sc_extra);
    a.stack = stack;
    a.final_norm = static_cast<const bf16*>(fast_norm);
    a.head = static_cast<const bf16*>(head);
    a.head_ld = head_ld;
    a.head_n = V;
    a.cos_t = static_cast<const float*>(cos_t);
    a.sin_t = static_cast<const float*>(sin_t);
    a.ck = hist;
    a.cv = hist + (size_t)L * SR_ROWS * KV * C * HDIM;
    a.cache_b = SR_ROWS;
    a.S = C;
    a.x0 = static_cast<const bf16*>(hidden);
    a.logits = static_cast<float*>(logits);
    a.nb = B;
    a.L = L;
    a.D = D;
    a.H = H;
    a.KV = KV;
    a.F = F;
    a.eps = eps;
    a.scratch = static_cast<unsigned char*>(scratch);
    a.state = static_cast<unsigned*>(state);
    a.plan = plan.core;
    f.emb = static_cast<const bf16*>(emb);
    f.window = static_cast<const int*>(window);
    f.gumbel = static_cast<const float*>(gumbel);
    f.temp = static_cast<const float*>(temp);
    f.top_p = static_cast<const float*>(top_p);
    f.top_k = static_cast<const int*>(top_k);
    f.penalty = static_cast<const float*>(penalty);
    f.is_eos = static_cast<const unsigned char*>(is_eos);
    f.tokens = static_cast<int*>(tokens);
    f.C = C;
    f.V = V;
    f.depthwise_output = depthwise_output;
    f.depthwise_wte = depthwise_wte;
    f.window_len = window_len;
    f.k_dyn = k_dyn;
    f.rep_enabled = rep_enabled;
    return (int)fr_launch<Wt>(f, static_cast<cudaStream_t>(stream));
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}

// The plan fast_frame_rows_kernel runs for these shapes on the current
// device, as SR_PLAN_INTS + 3 ints into out: SrPlan's, then the draw's
// shared memory bytes, its sort's keys and the history's bytes. Returns
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int fs_fast_frame_batched_plan(int L, int D, int H, int KV, int F, int C, int V,
                                          int k_dyn, int int8, void* out) {
  int grid = 0;
  const cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  FrPlan plan;
  if (!fr_make_plan(L, D, H, KV, F, C, V, k_dyn, int8 != 0, grid, plan))
    return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  sr_plan_ints(plan.core, o);
  o[SR_PLAN_INTS] = plan.draw_bytes;
  o[SR_PLAN_INTS + 1] = plan.sort_keys;
  o[SR_PLAN_INTS + 2] = plan.hist_bytes;
  return 0;
}

#ifdef DS_TRACE
// The instrumented copy's phase trace (this file's kernel): n words of
// ds_trace_buf into out.
extern "C" int fs_fast_frame_batched_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ds_trace_buf, (size_t)n * sizeof(unsigned long long));
}
#endif

namespace {

template <typename W>
int rows_gemm_entry(int mode, const void* in, const void* norm_w, const void* w, const void* w_b,
                    const void* scale, const void* scale_b, int nb, int K, int N, int ldw,
                    float eps, void* out, void* out_f32, cudaStream_t st) {
  const bf16* x = static_cast<const bf16*>(in);
  const bf16* nw = static_cast<const bf16*>(norm_w);
  const W* wa = static_cast<const W*>(w);
  const W* wb = static_cast<const W*>(w_b);
  const bf16* sa = static_cast<const bf16*>(scale);
  const bf16* sb = static_cast<const bf16*>(scale_b);
  bf16* o = static_cast<bf16*>(out);
  float* of = static_cast<float*>(out_f32);
  switch (mode) {
    case kQkv: return (int)launch_rows_gemm<kQkv, W>(nb, x, nw, wa, nullptr, sa, nullptr, K, N, ldw, eps, o, nullptr, st);
    case kResidual: return (int)launch_rows_gemm<kResidual, W>(nb, x, nullptr, wa, nullptr, sa, nullptr, K, N, ldw, eps, o, nullptr, st);
    case kSwiglu: return (int)launch_rows_gemm<kSwiglu, W>(nb, x, nw, wa, wb, sa, sb, K, N, ldw, eps, o, nullptr, st);
    default:
      if constexpr (std::is_same<W, bf16>::value)
        return (int)launch_rows_gemm<kHead, bf16>(nb, x, nw, wa, nullptr, nullptr, nullptr, K, N, ldw, eps, nullptr, of, st);
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One rows_gemm launch, as the frame makes it (for the card's checks and
// timings): mode 0..3 = kQkv, kResidual, kSwiglu, kHead. in (nb, K) bf16;
// norm_w (K,) bf16 in the norm modes (all but kResidual); w (K rows of
// stride ldw >= N rounded up to 16 bytes) and, for kSwiglu, w_b: bf16, or
// int8 when scale (and, for kSwiglu, scale_b) (N,) bf16 is given; kHead
// takes bf16 only. out (nb, N) bf16, updated in place for kResidual;
// out_f32 (nb, N) f32 for kHead. Returns the launch's CUDA error (0 on
// success).
extern "C" int fs_rows_gemm(int mode, const void* in, const void* norm_w, const void* w,
                            const void* w_b, const void* scale, const void* scale_b, int nb,
                            int K, int N, int ldw, float eps, void* out, void* out_f32,
                            void* stream) {
  const bool int8 = scale != nullptr;
  if (mode < kQkv || mode > kHead || nb < 1 || nb > MAX_BATCH_ROWS || in == nullptr ||
      w == nullptr || (mode == kSwiglu) != (w_b != nullptr) ||
      (int8 && (mode == kSwiglu) != (scale_b != nullptr)) ||
      (mode != kResidual && norm_w == nullptr) || (mode == kHead && (int8 || out_f32 == nullptr)) ||
      (mode != kHead && out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8)
    return rows_gemm_entry<int8_t>(mode, in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out, out_f32, st);
  return rows_gemm_entry<bf16>(mode, in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out, out_f32, st);
}

// The plan rows_gemm launches with for (K, N, mode, int8): plan[0..5] =
// columns per cluster, splits (blocks a cluster, over K), rows of K a
// block, pipeline stages, dynamic shared memory bytes a block, blocks.
extern "C" int fs_rows_gemm_plan(int K, int N, int mode, int int8, int* plan) {
  if (K < 1 || N < 1 || mode < kQkv || mode > kHead || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const RowsPlan p = rows_plan(K, N, mode, int8 != 0);
  plan[0] = RG_TN;
  plan[1] = p.splits;
  plan[2] = p.kb;
  plan[3] = p.stages;
  plan[4] = p.smem;
  plan[5] = p.tiles * p.splits;
  return 0;
}

