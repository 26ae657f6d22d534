// Device code shared by the fused slow step (slow_step.cu) and the fused
// fast frames (fast_frame.cu, fast_frame_batched.cu): the kernels one
// DualAR decode layer is made of at batch B <= 4, for Hopper (sm_90a).
//
// One layer is five launches on the caller's stream:
//   1. gemv<kQkv>      RMSNorm(x) @ wqkv            -> qkv  (B, QKV) bf16
//   2. rope_attention  RoPE(q, k) at pos, K/V row write at pos, softmax
//                      attention over rows 0..pos   -> attn (B, H*hd) bf16
//   3. gemv<kResidual> x += attn @ wo
//   4. gemv<kSwiglu>   h = RMSNorm(x); g = silu(h @ w1) * (h @ w3)
//                                                   -> g    (B, F) bf16
//   5. gemv<kResidual> x += g @ w2
// and a stack ends with gemv<kHead>: RMSNorm(x) @ head -> f32 logits.
//
// The layer weights are bf16, or int8 with one bf16 scale per output
// column (ops/quant.py; the TPU kernels' quantized bodies,
// slow_step_pallas.py:152-174, 198-207, 313-323 and fast_frame_pallas.py:
// 127-151, 174-186, 284-294). The GEMVs are templated on the weight type;
// the head is always bf16.
//
// What bounds these kernels: bytes. At B <= 4 a GEMV does 2 * B flops per
// weight element (2 bytes in bf16, 1 in int8), ~1000x below the ratio at
// which the tensor cores become the limit, so the time is the weight
// stream.
//
// Design:
// * Weights are stored (in, out) and applied as x @ W, so a GEMV reads
//   rows of W. Threads walk the out dimension in 16-column tiles (one
//   tile per block); each thread loads 16 bytes of a row at a time: in
//   bf16 a pair of threads covers the tile's 32 bytes (one sector), in
//   int8 one thread covers its 16 bytes. The block's threads split the in
//   dimension; the partial sums are added in a fixed order
//   (deterministic). Four rows are loaded before they are used, to keep
//   loads in flight.
// * The input rows (B x K bf16) sit in shared memory; the norm modes
//   normalise them there, each block on its own (the 2 KB row is read
//   from L2 by every block, instead of a separate norm launch). The
//   partial sums reuse the same shared memory once the products are done.
// * Every bf16 rounding sits where the TPU kernels
//   (fish_speech_tpu/ops/slow_step_pallas.py:229-334,
//   fast_frame_pallas.py:200-301) and the port's plain versions put it:
//   the norm output; each product (f32 sum, then bf16); RoPE in f32,
//   then bf16; the softmax weights before PV; silu of the unrounded f32
//   product, then bf16, times the bf16 w3 product. Products that the
//   plain version computes in separate PyTorch ops use the _rn
//   intrinsics, so nvcc does not fuse them into one FMA.
// * An int8 product is the TPU kernels' _wdot: each weight converts to
//   float exactly, the f32 sum rounds to bf16, is multiplied by the
//   column's bf16 scale in f32 and rounds to bf16 again. silu sees that
//   rescaled bf16 w1 product, not an unrounded one.
// * Attention runs one block per (row, query head). Rows 0..pos-1 are
//   read from the cache; row pos is taken from shared memory, so the
//   blocks of one KV group never read the row that the group's first
//   block writes. The TPU kernel's masked read-modify-write of the whole
//   window (a Mosaic workaround) is not ported: keys past pos take
//   exp(-inf) = 0 there, so skipping them changes nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int HDIM = 64;       // head dim the attention kernel takes
constexpr int MAX_ROWS = 4;    // batch rows a GEMV takes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ---------------------------------------------------------------------------
// GEMV
// ---------------------------------------------------------------------------

enum GemvMode { kQkv = 0, kResidual = 1, kSwiglu = 2, kHead = 3 };

// VEC consecutive weights of one row, loaded in one instruction and
// converted to float.
template <typename W, int VEC>
struct WRow;

template <>
struct WRow<bf16, 8> {
  static constexpr int TILE = 16;  // columns per block
  uint4 raw;
  __device__ __forceinline__ void load(const bf16* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_float(float (&f)[8]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = __bfloat1622float2(h[e]);
      f[2 * e] = v.x;
      f[2 * e + 1] = v.y;
    }
  }
};

template <>
struct WRow<bf16, 1> {
  static constexpr int TILE = 32;
  bf16 raw;
  __device__ __forceinline__ void load(const bf16* p) { raw = __ldg(p); }
  __device__ __forceinline__ void to_float(float (&f)[1]) const { f[0] = bf(raw); }
};

// 16 int8 weights (16 bytes, the whole tile of one row). Each converts to
// float exactly without an int-to-float instruction: the byte, offset to
// 0..255, becomes the low mantissa bits of 2^23, and 2^23 + 128 is
// subtracted again.
template <>
struct WRow<int8_t, 16> {
  static constexpr int TILE = 16;
  uint4 raw;
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void to_float(float (&f)[16]) const {
    const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned u = words[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[4 * i + e] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)),
                                 8388736.f);
    }
  }
};

// The stack product of column n as the TPU kernels' _wdot gives it: the
// f32 sum y for bf16 weights; bf16(bf16(y) * s[n]) for int8 weights.
template <typename W>
__device__ __forceinline__ float stack_product(float y, const bf16* __restrict__ scale, int n) {
  if constexpr (std::is_same<W, int8_t>::value)
    return round_bf16(__fmul_rn(round_bf16(y), bf(scale[n])));
  else
    return y;
}

// out[b, n] = epilogue(p(sum_k in'[b, k] * w[k, n])) for n in [0, N),
// where in' is RMSNorm(in) * norm_w (rounded to bf16) for the norm modes
// and in otherwise, and p is stack_product (with scale, int8 only). in:
// (NB, K) contiguous bf16; w: K rows of stride ldw.
//   kQkv:      out (NB, N) bf16 = bf16(y)
//   kResidual: out (NB, N) bf16 += bf16(y), in place (the residual x)
//   kSwiglu:   out (NB, N) bf16 = bf16(bf16(silu(y)) * bf16(y_b)), y_b
//              the same product with w_b (and scale_b)
//   kHead:     out_f32 (NB, N) = y, unrounded (bf16 weights only)
// grid: ceil(N / TILE) blocks; dynamic shared memory: the larger of
// NB * K bf16 (the input rows) and KS * TILE floats (the partial sums).
template <int MODE, typename W, int VEC, int NB>
__global__ void __launch_bounds__(THREADS)
    gemv_kernel(const bf16* __restrict__ in, const bf16* __restrict__ norm_w,
                const W* __restrict__ w, const W* __restrict__ w_b,
                const bf16* __restrict__ scale, const bf16* __restrict__ scale_b,
                int K, int N, int ldw, float eps, bf16* out,
                float* __restrict__ out_f32) {
  constexpr bool NORM = MODE != kResidual;
  constexpr int NA = MODE == kSwiglu ? 2 : 1;  // weight matrices
  constexpr int TILE = WRow<W, VEC>::TILE;
  constexpr int CT = TILE / VEC;      // threads across a tile
  constexpr int KS = THREADS / CT;    // slices of the in dimension
  constexpr int TPC = THREADS / TILE; // reducing threads per column
  constexpr int PER = KS / TPC;       // partial sums each one adds
  constexpr int U = 4;                // rows loaded ahead

  extern __shared__ __align__(16) unsigned char gemv_smem[];
  bf16* in_s = reinterpret_cast<bf16*>(gemv_smem);  // [NB][K], steps 1-2
  float* red = reinterpret_cast<float*>(gemv_smem); // [KS][TILE], step 3
  __shared__ float nred[NWARPS][NB];
  __shared__ float inv_rms[NB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. stage the input rows; normalise them in the norm modes
  for (int i = tid; i < NB * K; i += THREADS) in_s[i] = in[i];
  if (NORM) {
    __syncthreads();
    float ss[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      ss[b] = 0.f;
      for (int i = tid; i < K; i += THREADS) {
        const float v = bf(in_s[b * K + i]);
        ss[b] = __fadd_rn(ss[b], __fmul_rn(v, v));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss[b] += __shfl_xor_sync(FULL, ss[b], off);
      if (lane == 0) nred[warp][b] = ss[b];
    }
    __syncthreads();
    if (tid < NB) {
      float s = 0.f;
      for (int wi = 0; wi < NWARPS; ++wi) s += nred[wi][tid];
      inv_rms[tid] = rsqrtf(__fadd_rn(__fdiv_rn(s, (float)K), eps));
    }
    __syncthreads();
    for (int i = tid; i < NB * K; i += THREADS) {
      const int b = i / K;
      const float v = __fmul_rn(bf(in_s[i]), inv_rms[b]);
      in_s[i] = __float2bfloat16(__fmul_rn(v, bf(norm_w[i - b * K])));
    }
  }
  __syncthreads();

  // 2. partial products over this thread's slice of the in dimension
  const int ct = tid % CT;
  const int ks = tid / CT;
  const int n0 = blockIdx.x * TILE + ct * VEC;
  float acc[NA][NB][VEC];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[a][b][v] = 0.f;

  if (n0 < N) {
    const W* wp[NA];
    wp[0] = w + n0;
    if (NA == 2) wp[NA - 1] = w_b + n0;
    int k = ks;
    for (; k + (U - 1) * KS < K; k += U * KS) {
      WRow<W, VEC> r[NA][U];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int a = 0; a < NA; ++a) r[a][u].load(wp[a] + (size_t)(k + u * KS) * ldw);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          float wf[VEC];
          r[a][u].to_float(wf);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float xv = bf(in_s[b * K + k + u * KS]);
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[a][b][v] = fmaf(xv, wf[v], acc[a][b][v]);
          }
        }
      }
    }
    for (; k < K; k += KS) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        WRow<W, VEC> r;
        r.load(wp[a] + (size_t)k * ldw);
        float wf[VEC];
        r.to_float(wf);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float xv = bf(in_s[b * K + k]);
#pragma unroll
          for (int v = 0; v < VEC; ++v) acc[a][b][v] = fmaf(xv, wf[v], acc[a][b][v]);
        }
      }
    }
  }

  // 3. add the KS partial sums of each column in a fixed order (the first
  //    barrier also ends every read of in_s, whose memory red reuses)
  const int col = tid / TPC;
  const int part = tid % TPC;
  float y[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      __syncthreads();
#pragma unroll
      for (int v = 0; v < VEC; ++v) red[ks * TILE + ct * VEC + v] = acc[a][b][v];
      __syncthreads();
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) s += red[(part * PER + i) * TILE + col];
#pragma unroll
      for (int off = TPC / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      y[a][b] = s;
    }
  }

  // 4. epilogue
  const int n = blockIdx.x * TILE + col;
  if (part != 0 || n >= N) return;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const size_t o = (size_t)b * N + n;
    const float y0 = stack_product<W>(y[0][b], scale, n);
    if (MODE == kQkv) {
      out[o] = __float2bfloat16(y0);
    } else if (MODE == kResidual) {
      out[o] = __float2bfloat16(__fadd_rn(bf(out[o]), round_bf16(y0)));
    } else if (MODE == kSwiglu) {
      const float gate = round_bf16(__fdiv_rn(y0, __fadd_rn(1.f, expf(-y0))));
      const float up = round_bf16(stack_product<W>(y[NA - 1][b], scale_b, n));
      out[o] = __float2bfloat16(__fmul_rn(gate, up));
    } else {
      out_f32[o] = y0;
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int MODE, typename W, int VEC>
cudaError_t launch_gemv_vec(int nb, const bf16* in, const bf16* norm_w,
                            const W* w, const W* w_b, const bf16* scale,
                            const bf16* scale_b, int K, int N, int ldw,
                            float eps, bf16* out, float* out_f32,
                            cudaStream_t st) {
  constexpr int TILE = WRow<W, VEC>::TILE;
  constexpr int KS = THREADS / (TILE / VEC);
  const int grid = (N + TILE - 1) / TILE;
  const size_t in_bytes = (size_t)nb * K * sizeof(bf16);
  const size_t red_bytes = (size_t)KS * TILE * sizeof(float);
  const size_t smem = in_bytes > red_bytes ? in_bytes : red_bytes;
  switch (nb) {
    case 1:
      gemv_kernel<MODE, W, VEC, 1><<<grid, THREADS, smem, st>>>(in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32);
      break;
    case 2:
      gemv_kernel<MODE, W, VEC, 2><<<grid, THREADS, smem, st>>>(in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32);
      break;
    case 3:
      gemv_kernel<MODE, W, VEC, 3><<<grid, THREADS, smem, st>>>(in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32);
      break;
    case 4:
      gemv_kernel<MODE, W, VEC, 4><<<grid, THREADS, smem, st>>>(in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// Each thread loads 16 bytes of a row (8 bf16 or 16 int8 weights), so
// rows must be 16-byte aligned; the head of the slow stack (W = 1025
// gathered bf16 columns) takes the 1-wide path.
template <int MODE, typename W>
cudaError_t launch_gemv(int nb, const bf16* in, const bf16* norm_w, const W* w,
                        const W* w_b, const bf16* scale, const bf16* scale_b,
                        int K, int N, int ldw, float eps, bf16* out,
                        float* out_f32, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(W);
  const bool vec = N % VEC == 0 && ldw % VEC == 0 && aligned16(w) &&
                   (w_b == nullptr || aligned16(w_b));
  if (vec)
    return launch_gemv_vec<MODE, W, VEC>(nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
  if constexpr (MODE == kHead && std::is_same<W, bf16>::value)
    return launch_gemv_vec<MODE, W, 1>(nb, in, norm_w, w, w_b, scale, scale_b, K, N, ldw, eps, out, out_f32, st);
  return cudaErrorInvalidValue;  // the wrappers check the other widths
}

// The bf16 head: RMSNorm(x) @ head -> f32 logits, unrounded.
inline cudaError_t launch_head(int nb, const bf16* x, const bf16* norm_w, const bf16* head,
                               int K, int N, int ldw, float eps, float* logits,
                               cudaStream_t st) {
  return launch_gemv<kHead, bf16>(nb, x, norm_w, head, nullptr, nullptr, nullptr, K, N, ldw,
                                  eps, nullptr, logits, st);
}

// A layer stack: norms (L, D) bf16; weights (L, in, out) of type W;
// scales (L, 1, out) bf16 for int8 weights, null for bf16 ones.
template <typename W>
struct Stack {
  const bf16* attn_norm;
  const bf16* ffn_norm;
  const W* wqkv;
  const W* wo;
  const W* w1;
  const W* w3;
  const W* w2;
  const bf16* s_qkv;
  const bf16* s_o;
  const bf16* s_1;
  const bf16* s_3;
  const bf16* s_2;

  // Layer l of a stack of width D, QKV and F: the same fields, offset.
  Stack layer(int l, int D, int QKV, int F) const {
    const size_t L = (size_t)l;
    auto sc = [L](const bf16* s, int n) { return s ? s + L * n : nullptr; };
    return {attn_norm + L * D, ffn_norm + L * D,
            wqkv + L * D * QKV, wo + L * D * D, w1 + L * D * F, w3 + L * D * F, w2 + L * F * D,
            sc(s_qkv, QKV), sc(s_o, D), sc(s_1, F), sc(s_3, F), sc(s_2, D)};
  }
};

// The C entries' stack arguments: norms, the five weights in the order
// wqkv, wo, w1, w3, w2 and their five scales (null for bf16).
template <typename W>
Stack<W> make_stack(const void* attn_norm, const void* ffn_norm, const void* const* wts,
                    const void* const* scales) {
  auto b = [](const void* p) { return static_cast<const bf16*>(p); };
  auto q = [](const void* p) { return static_cast<const W*>(p); };
  return {b(attn_norm), b(ffn_norm), q(wts[0]), q(wts[1]), q(wts[2]), q(wts[3]), q(wts[4]),
          b(scales[0]), b(scales[1]), b(scales[2]), b(scales[3]), b(scales[4])};
}

// ---------------------------------------------------------------------------
// RoPE + K/V row write + attention
// ---------------------------------------------------------------------------

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < NWARPS; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Rotate one interleaved pair in f32 and round to bf16, as
// ops/rope.py::apply_rope_interleaved does in separate PyTorch ops.
__device__ __forceinline__ void rope_pair(float x0, float x1, float c, float s,
                                          float* o) {
  o[0] = round_bf16(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
  o[1] = round_bf16(__fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c)));
}

// qkv: (B, (H + 2 KV) * HDIM) bf16, q heads then k heads then v heads.
// Position p = pos_arr[b], or pos_const when pos_arr is null. Writes the
// rotated key and the value at row p of cache layer `layer`
// ((L, B, KV, S, HDIM) bf16, in place) and attn (B, H * HDIM).
// grid: B * H blocks; dynamic shared memory: (S + NWARPS * HDIM) floats.
__global__ void __launch_bounds__(THREADS)
    rope_attention_kernel(const bf16* __restrict__ qkv,
                          const float* __restrict__ cos_t,
                          const float* __restrict__ sin_t,
                          const int* __restrict__ pos_arr, int pos_const,
                          bf16* ck, bf16* cv, bf16* __restrict__ out, int B,
                          int H, int KV, int S, int layer, float scale) {
  extern __shared__ float att_smem[];
  float* scores = att_smem;             // [S]
  float* partial = att_smem + S;        // [NWARPS][HDIM]
  __shared__ float q_s[HDIM];
  __shared__ float k_s[HDIM];
  __shared__ float v_s[HDIM];
  __shared__ float red[NWARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int group = H / KV;
  const int g = h / group;
  const int p = pos_arr ? pos_arr[b] : pos_const;
  if (p < 0 || p >= S) __trap();  // a position outside the cache

  const bf16* row = qkv + (size_t)b * (H + 2 * KV) * HDIM;
  const bf16* qr = row + h * HDIM;
  const bf16* kr = row + (H + g) * HDIM;
  const bf16* vr = row + (H + KV + g) * HDIM;
  const size_t cache_off = (((size_t)layer * B + b) * KV + g) * (size_t)S * HDIM;
  bf16* kc = ck + cache_off;
  bf16* vc = cv + cache_off;

  // 1. RoPE of q and k at p; the group's first head writes row p
  if (tid < HDIM / 2) {
    const float c = cos_t[(size_t)p * (HDIM / 2) + tid];
    const float s = sin_t[(size_t)p * (HDIM / 2) + tid];
    const int d = 2 * tid;
    rope_pair(bf(qr[d]), bf(qr[d + 1]), c, s, &q_s[d]);
    rope_pair(bf(kr[d]), bf(kr[d + 1]), c, s, &k_s[d]);
    v_s[d] = bf(vr[d]);
    v_s[d + 1] = bf(vr[d + 1]);
    if (h % group == 0) {
      kc[(size_t)p * HDIM + d] = __float2bfloat16(k_s[d]);
      kc[(size_t)p * HDIM + d + 1] = __float2bfloat16(k_s[d + 1]);
      vc[(size_t)p * HDIM + d] = vr[d];
      vc[(size_t)p * HDIM + d + 1] = vr[d + 1];
    }
  }
  __syncthreads();

  // 2. scores of keys 0..p, one key per thread
  const int n = p + 1;
  float lmax = -INFINITY;
  for (int j = tid; j < n; j += THREADS) {
    float s = 0.f;
    if (j == p) {
#pragma unroll
      for (int d = 0; d < HDIM; ++d) s = fmaf(q_s[d], k_s[d], s);
    } else {
      const uint4* krow = reinterpret_cast<const uint4*>(kc + (size_t)j * HDIM);
#pragma unroll
      for (int c = 0; c < HDIM / 8; ++c) {
        const uint4 raw = krow[c];
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(k2[e]);
          s = fmaf(q_s[c * 8 + 2 * e], kf.x, s);
          s = fmaf(q_s[c * 8 + 2 * e + 1], kf.y, s);
        }
      }
    }
    s = __fmul_rn(s, scale);
    scores[j] = s;
    lmax = fmaxf(lmax, s);
  }
  const float m = block_reduce(lmax, red, true);

  // 3. exp and sum
  float lsum = 0.f;
  for (int j = tid; j < n; j += THREADS) {
    const float e = expf(__fsub_rn(scores[j], m));
    scores[j] = e;
    lsum += e;
  }
  const float sum = block_reduce(lsum, red, false);

  // 4. PV with the normalised weights rounded to bf16, f32 sums; one warp
  //    per key stripe, two head dims per lane
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int j = warp; j < n; j += NWARPS) {
    const float wj = round_bf16(__fdiv_rn(scores[j], sum));
    float v0, v1;
    if (j == p) {
      v0 = v_s[2 * lane];
      v1 = v_s[2 * lane + 1];
    } else {
      const float2 vf = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(vc + (size_t)j * HDIM)[lane]);
      v0 = vf.x;
      v1 = vf.y;
    }
    a0 = fmaf(wj, v0, a0);
    a1 = fmaf(wj, v1, a1);
  }
  partial[warp * HDIM + 2 * lane] = a0;
  partial[warp * HDIM + 2 * lane + 1] = a1;
  __syncthreads();
  for (int i = tid; i < HDIM; i += THREADS) {
    float r = partial[i];
    for (int wi = 1; wi < NWARPS; ++wi) r += partial[wi * HDIM + i];
    out[((size_t)b * H + h) * HDIM + i] = __float2bfloat16(r);
  }
}

inline cudaError_t launch_rope_attention(const bf16* qkv, const float* cos_t,
                                         const float* sin_t, const int* pos_arr,
                                         int pos_const, bf16* ck, bf16* cv,
                                         bf16* out, int B, int H, int KV, int S,
                                         int layer, cudaStream_t st) {
  const size_t smem = ((size_t)S + (size_t)NWARPS * HDIM) * sizeof(float);
  // raise the dynamic shared memory limit once per size, never while a
  // CUDA graph is being captured after a warm-up call
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rope_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  rope_attention_kernel<<<B * H, THREADS, smem, st>>>(
      qkv, cos_t, sin_t, pos_arr, pos_const, ck, cv, out, B, H, KV, S, layer,
      1.0f / sqrtf((float)HDIM));
  return cudaGetLastError();
}

// One decode layer (the five launches above) on rows x (B, D), updated in
// place, with layer lw of a stack (Stack::layer): wqkv (D, QKV), wo
// (H*HDIM, D), w1/w3 (D, F), w2 (F, D), norms (D,). Scratch: qkv
// (B, QKV), attn (B, D), ffn (B, F).
template <typename W>
cudaError_t run_layer(bf16* x, const Stack<W>& lw, const float* cos_t,
                      const float* sin_t, const int* pos_arr, int pos_const,
                      bf16* ck, bf16* cv, int layer, bf16* qkv, bf16* attn,
                      bf16* ffn, int B, int D, int H, int KV, int F, int S,
                      float eps, cudaStream_t st) {
  const int QKV = (H + 2 * KV) * HDIM;
  cudaError_t err;
  err = launch_gemv<kQkv, W>(B, x, lw.attn_norm, lw.wqkv, nullptr, lw.s_qkv, nullptr, D, QKV, QKV, eps, qkv, nullptr, st);
  if (err != cudaSuccess) return err;
  err = launch_rope_attention(qkv, cos_t, sin_t, pos_arr, pos_const, ck, cv, attn, B, H, KV, S, layer, st);
  if (err != cudaSuccess) return err;
  err = launch_gemv<kResidual, W>(B, attn, nullptr, lw.wo, nullptr, lw.s_o, nullptr, H * HDIM, D, D, eps, x, nullptr, st);
  if (err != cudaSuccess) return err;
  err = launch_gemv<kSwiglu, W>(B, x, lw.ffn_norm, lw.w1, lw.w3, lw.s_1, lw.s_3, D, F, F, eps, ffn, nullptr, st);
  if (err != cudaSuccess) return err;
  return launch_gemv<kResidual, W>(B, ffn, nullptr, lw.w2, nullptr, lw.s_2, nullptr, F, D, D, eps, x, nullptr, st);
}

}  // namespace
