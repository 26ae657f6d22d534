// One whole fast (codebook) frame for B <= 32 rows with per-row sampling,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/fast_frame_pallas.py::
// fused_fast_frame_batched. For codebook steps cb = 0..C-1 and every row
// b: the fast layers run on x[b] (the row's slow hidden at cb = 0, then
// the embedding of its previous token) with RoPE at position cb and
// attention over the row's own K/V history 0..cb; the fast norm and head
// (the step's column block when depthwise_output) give f32 logits; the
// row's repetition penalty, its top-k/top-p draw with its own temp,
// top_p, top_k and Gumbel draws (indexed by rank), and the EOS rule give
// the token, and the token's embedding row (the step's row block when
// depthwise_wte) is the row's next x. Tokens and embeddings stay on the
// card: nothing is read by the host inside the frame. The stack may be
// int8 with bf16 per-column scales (ops/quant.py): the TPU kernel's
// quantized body (fast_frame_pallas.py:532, 569-573, 595-604, 706-712),
// the same launches with rows_gemm reading int8 weights.
//
// What bounds it on this card: bytes. The fast stack is ~120 MB at
// Fish-1.5 width, more than the 50 MB L2, so each codebook step streams
// it again (~0.97 GB a frame, the same bytes as the batch-1 frame). The
// point of the TPU kernel is that all rows share that stream, and so do
// they here: each block of a layer's GEMM reads its weight columns once
// and computes every row from them. At B = 16 a weight element feeds 16
// multiply-adds, far below the tensor cores' balance point, so a GEMM
// is bound by its weight bytes plus the latency of its few steps (~1-3
// us of byte bound each at Fish-1.5 width).
//
// Design: a fixed sequence of launches from this C entry on the caller's
// stream, 22 per step at Fish-1.5 depth (176 a frame), as in the batch-1
// frame:
//   per layer: rows_gemm<kQkv> (RMSNorm + wqkv), rope_attention (one
//   block per (row, query head) over the row's history, from
//   dual_ar_layer.cuh), rows_gemm<kResidual> (wo), rows_gemm<kSwiglu>
//   (RMSNorm + w1, w3), rows_gemm<kResidual> (w2);
//   then rows_gemm<kHead> and one sampler block per row.
// rows_gemm (redesigned for Hopper; the first version ran on the CUDA
// cores with 64-80 blocks and one shared-memory load per two FMAs):
// * Tensor cores, mma.sync.m16n8k16 bf16 with f32 accumulation, in the
//   "swap-AB" form: a weight tile is the A operand (16 columns x 16 k,
//   M = columns) and the batch rows are N (8 a tile, 8/16/32 rows), so no
//   row is padded past the next multiple of 8. mma.sync was picked over
//   wgmma: at N <= 32 rows a block's work is a few dozen 16x8x16 products
//   per warp, wgmma's 64-row warpgroup tile would need four warps on 64
//   columns of one K slice, and the bytes, not the issue rate, bound it.
//   bf16 A fragments come from the weight ring by ldmatrix.trans; int8
//   ones are read as 2-byte pairs of adjacent columns from the int8 ring
//   (which stays int8, at half the bytes) and converted to bf16 as the
//   fragment is formed (exact for -128..127). B fragments are 32-bit
//   loads of the staged input rows.
// * Weight stream: an 8-stage ring of 64-row chunks (4 where 8 would
//   not fit, or would keep a cluster of 4-8 blocks from finding room for
//   all its blocks at once) filled by 16-byte cp.async copies (columns past
//   N and rows past K zero-filled), up to 7 chunks in flight, so
//   every weight byte is read from HBM once per step in 16-byte requests.
//   The block's slices of the input rows and norm weights come by
//   cp.async too, with the first chunk, and the residuals the epilogue
//   adds are loaded then, so the RMS pre-pass runs while all of them are
//   in flight. Rows of
//   the ring and of the staged input are padded by 16 bytes, so the
//   fragment loads hit distinct banks.
// * K-split: the grid is column tiles (64 columns) x K-splits; the split
//   blocks of a tile form one cluster: each block pushes the f32 partials
//   of every column to the rank that finishes it (distributed shared
//   memory stores), one cluster.sync(), and each rank adds its columns'
//   partials from its own shared memory in fixed rank order and applies
//   the epilogue once to its 64 / splits columns. No global workspace, no
//   second launch, no remote load on the way out. Every Fish-1.5 GEMM at
//   B = 16 launches >= 128 blocks (wo, w2, head 16 x 8; QKV 20 x 8;
//   w1 + w3 64 x 2).
// * The plan (tile width, splits, rows of K a block, stages; rows_plan)
//   is a function of (K, N, mode, weight type) only, never of the row
//   count, and each output element's sum runs in one order (k ascending
//   within a block, blocks in rank order) whatever the rows beside it:
//   a row gives the same bits alone as among 31 co-tenants.
// * Each block recomputes the RMS of the input rows over the whole of K
//   (<= 256 KB, from L2, in 16-byte loads), then stages its slice of K
//   normalised and rounded to bf16.
// An int8 product is rounded and rescaled as dual_ar_layer.cuh's
// stack_product does. The sampler reads each row's knobs from device
// arrays and is codebook_sampler.cuh's sort, scan and draw. The TPU
// kernel's row-block grid, flat-lane E/R matrices, lane rolls, one-hot
// embedding matmul and sel_rows scatter are Mosaic workarounds and are
// not ported.

#include <cooperative_groups.h>

#include "codebook_sampler.cuh"
#include "dual_ar_layer.cuh"
#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

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

// One codebook step's draw for row b = blockIdx.x, the semantics of
// fast_frame_pallas.py:735-848 and of ops/sampling.py::
// sample_top_k_top_p_dynamic in the port: logits of the row's window
// members are divided by the row's penalty; p = softmax(logits /
// max(temp, 1e-6)); k_eff = top_k if 0 < top_k <= k_dyn, else k_dyn;
// p_eff = top_p if 0 < top_p < 1, else 1; rank r is kept when r < k_eff
// and its exclusive mass < p_eff, and the token maximises log p +
// gumbel[b, cb, r]; rows with temp <= 1e-7 take the rank-0 token; EOS
// rows take 0. Writes tokens[b, cb] and, when emb is not null, the
// token's embedding row to x_next[b].
template <int ITEMS>
__global__ void __launch_bounds__(SAMPLER_THREADS)
    rows_sample_kernel(const float* __restrict__ logits, int V, const int* __restrict__ window,
                       int window_len, int C, int cb, const float* __restrict__ temp,
                       const float* __restrict__ top_p, const int* __restrict__ top_k,
                       const float* __restrict__ penalty,
                       const unsigned char* __restrict__ is_eos,
                       const float* __restrict__ gumbel, int k_dyn,
                       const bf16* __restrict__ emb, int D, int* __restrict__ tokens,
                       bf16* __restrict__ x_next) {
  __shared__ unsigned long long keys[SAMPLER_THREADS * ITEMS];
  __shared__ float red[SAMPLER_WARPS];
  __shared__ unsigned long long best_red[SAMPLER_WARPS];
  __shared__ int win_s[MAX_WINDOW];
  __shared__ int top_s;
  __shared__ int tok_s;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int* win = window != nullptr ? window + ((size_t)b * C + cb) * window_len : nullptr;
  if (win != nullptr && tid < window_len) win_s[tid] = win[tid];
  __syncthreads();

  float lg[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = tid + it * SAMPLER_THREADS;
    lg[it] = i < V ? logits[(size_t)b * V + i] : -INFINITY;
  }
  if (win != nullptr) apply_penalty(lg, V, win_s, window_len, penalty[b]);
  const float t = temp[b];
  const float sum = softmax_exp(lg, V, fmaxf(t, 1e-6f), red);
  const int tk = top_k[b];
  const float tp = top_p[b];
  const int k_eff = (tk <= 0 || tk > k_dyn) ? k_dyn : tk;
  const float p_eff = (tp <= 0.f || tp >= 1.f) ? 1.f : tp;
  const int drawn = sorted_draw(lg, sum, V, k_eff, true, p_eff,
                                gumbel + ((size_t)b * C + cb) * k_dyn, keys, red, best_red,
                                &top_s);
  if (tid == 0) {
    tok_s = is_eos[b] ? 0 : (t <= 1e-7f ? top_s : drawn);
    tokens[(size_t)b * C + cb] = tok_s;
  }
  __syncthreads();
  if (emb != nullptr) {
    const bf16* row = emb + (size_t)tok_s * D;
    for (int d = tid; d < D; d += SAMPLER_THREADS) x_next[(size_t)b * D + d] = row[d];
  }
}

// One decode layer for B rows (the five launches above) on x (B, D),
// updated in place, with layer lw of a stack; attention over the history
// rows 0..cb of each row.
template <typename W>
cudaError_t run_rows_layer(bf16* x, const Stack<W>& lw, const float* cos_t, const float* sin_t,
                           int cb, bf16* k_hist, bf16* v_hist, int layer, bf16* qkv, bf16* attn,
                           bf16* ffn, int B, int D, int H, int KV, int F, int C, float eps,
                           cudaStream_t st) {
  const int QKV = (H + 2 * KV) * HDIM;
  cudaError_t err;
  err = launch_rows_gemm<kQkv, W>(B, x, lw.attn_norm, lw.wqkv, nullptr, lw.s_qkv, nullptr, D, QKV, QKV, eps, qkv, nullptr, st);
  if (err != cudaSuccess) return err;
  err = launch_rope_attention(qkv, cos_t, sin_t, nullptr, cb, k_hist, v_hist, attn, B, H, KV, C,
                              layer, st);
  if (err != cudaSuccess) return err;
  err = launch_rows_gemm<kResidual, W>(B, attn, nullptr, lw.wo, nullptr, lw.s_o, nullptr, H * HDIM, D, D, eps, x, nullptr, st);
  if (err != cudaSuccess) return err;
  err = launch_rows_gemm<kSwiglu, W>(B, x, lw.ffn_norm, lw.w1, lw.w3, lw.s_1, lw.s_3, D, F, F, eps, ffn, nullptr, st);
  if (err != cudaSuccess) return err;
  return launch_rows_gemm<kResidual, W>(B, ffn, nullptr, lw.w2, nullptr, lw.s_2, nullptr, F, D, D, eps, x, nullptr, st);
}

// The C steps of one frame for B rows with the layer stack of type W.
template <typename W>
int fast_frame_batched(const bf16* hidden, const Stack<W>& stack, const bf16* fast_norm,
                       const bf16* head, const bf16* emb, const float* cos_t,
                       const float* sin_t, const int* window, const float* gumbel,
                       const float* temp, const float* top_p, const int* top_k,
                       const float* penalty, const unsigned char* eos, int* tokens, bf16* x,
                       bf16* qkv_buf, bf16* attn_buf, bf16* ffn_buf, float* logits_buf,
                       bf16* k_hist, bf16* v_hist, int B, int L, int D, int H, int KV, int F,
                       int C, int V, int head_ld, int depthwise_output, int depthwise_wte,
                       int window_len, int k_dyn, int rep_enabled, float eps,
                       cudaStream_t st) {
  const int QKV = (H + 2 * KV) * HDIM;
  cudaError_t err = cudaMemcpyAsync(x, hidden, (size_t)B * D * sizeof(bf16),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const int items = (V + SAMPLER_THREADS - 1) / SAMPLER_THREADS;
  const int* win = rep_enabled ? window : nullptr;
  for (int cb = 0; cb < C; ++cb) {
    float* logits = logits_buf + (size_t)cb * B * V;
    for (int l = 0; l < L; ++l) {
      err = run_rows_layer<W>(x, stack.layer(l, D, QKV, F), cos_t, sin_t, cb, k_hist, v_hist, l,
                              qkv_buf, attn_buf, ffn_buf, B, D, H, KV, F, C, eps, st);
      if (err != cudaSuccess) return (int)err;
    }
    const bf16* head_cb = head + (depthwise_output ? (size_t)cb * V : 0);
    err = launch_rows_gemm<kHead, bf16>(B, x, fast_norm, head_cb, nullptr, nullptr, nullptr, D,
                                        V, head_ld, eps, nullptr, logits, st);
    if (err != cudaSuccess) return (int)err;
    // the last step's tokens need no embedding
    const bf16* emb_cb = cb + 1 < C ? emb + (depthwise_wte ? (size_t)cb * V * D : 0) : nullptr;
    if (items <= 1)
      rows_sample_kernel<1><<<B, SAMPLER_THREADS, 0, st>>>(logits, V, win, window_len, C, cb, temp, top_p, top_k, penalty, eos, gumbel, k_dyn, emb_cb, D, tokens, x);
    else if (items <= 2)
      rows_sample_kernel<2><<<B, SAMPLER_THREADS, 0, st>>>(logits, V, win, window_len, C, cb, temp, top_p, top_k, penalty, eos, gumbel, k_dyn, emb_cb, D, tokens, x);
    else
      rows_sample_kernel<4><<<B, SAMPLER_THREADS, 0, st>>>(logits, V, win, window_len, C, cb, temp, top_p, top_k, penalty, eos, gumbel, k_dyn, emb_cb, D, tokens, x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// hidden (B, D) bf16, the rows' slow hiddens. The fast-layer stack as in
// fs_slow_step (norms, five weights bf16 or int8, five scales or nulls);
// fast_norm (D,); head: the fast output (D, head_ld),
// whose columns [cb*V, cb*V + V) serve step cb when depthwise_output, else
// columns [0, V); emb: the fast embeddings, rows [cb*V, cb*V + V) for step
// cb's token when depthwise_wte, else rows [0, V). window (B, C,
// window_len) int32 rep-pen windows (read when rep_enabled); gumbel (B, C,
// k_dyn) f32; temp, top_p, penalty (B,) f32; top_k (B,) int32; is_eos (B,)
// bool. Out: tokens (B, C) int32; logits, (C, B, V) f32, holds each step's
// penalty-free head logits. Scratch: x (B, D), qkv (B, QKV), attn (B, D),
// ffn (B, F) bf16, k_hist and v_hist (L, B, KV, C, 64) bf16. Returns the
// first CUDA error of the launches (0 on success).
extern "C" int fs_fast_frame_batched(
    const void* hidden, const void* attn_norm, const void* ffn_norm, const void* wqkv,
    const void* wo, const void* w1, const void* w3, const void* w2, const void* s_qkv,
    const void* s_o, const void* s_1, const void* s_3, const void* s_2,
    const void* fast_norm, const void* head, const void* emb, const void* cos_t,
    const void* sin_t, const void* window, const void* gumbel, const void* temp,
    const void* top_p, const void* top_k, const void* penalty, const void* is_eos,
    void* tokens, void* x_buf, void* qkv_buf, void* attn_buf, void* ffn_buf,
    void* logits_buf, void* k_hist, void* v_hist, int B, int L, int D, int H, int KV,
    int F, int C, int V, int head_ld, int depthwise_output, int depthwise_wte,
    int window_len, int k_dyn, int rep_enabled, float eps, void* stream) {
  if (B < 1 || B > MAX_BATCH_ROWS || KV <= 0 || H % KV != 0 || H * HDIM != D ||
      D % 8 != 0 || F % 8 != 0 || L < 1 || C < 1 || V < 1 || V > 4 * SAMPLER_THREADS ||
      window_len > MAX_WINDOW || (rep_enabled && window_len < 1) || k_dyn < 1 ||
      k_dyn > V)
    return (int)cudaErrorInvalidValue;
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  const bool int8 = s_qkv != nullptr;
  for (const void* s : scales)
    if ((s != nullptr) != int8) return (int)cudaErrorInvalidValue;
  auto run = [&](auto stack) {
    return fast_frame_batched(
        static_cast<const bf16*>(hidden), stack, static_cast<const bf16*>(fast_norm),
        static_cast<const bf16*>(head), static_cast<const bf16*>(emb),
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<const int*>(window), static_cast<const float*>(gumbel),
        static_cast<const float*>(temp), static_cast<const float*>(top_p),
        static_cast<const int*>(top_k), static_cast<const float*>(penalty),
        static_cast<const unsigned char*>(is_eos), static_cast<int*>(tokens),
        static_cast<bf16*>(x_buf), static_cast<bf16*>(qkv_buf), static_cast<bf16*>(attn_buf),
        static_cast<bf16*>(ffn_buf), static_cast<float*>(logits_buf),
        static_cast<bf16*>(k_hist), static_cast<bf16*>(v_hist), B, L, D, H, KV, F, C, V,
        head_ld, depthwise_output, depthwise_wte, window_len, k_dyn, rep_enabled, eps,
        static_cast<cudaStream_t>(stream));
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}

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
