// Device code shared by the decode kernels of the DualAR stacks, for
// Hopper (sm_90a): the batched fast frame's layer launches
// (fast_frame_batched.cu: rope_attention_kernel, the rows_gemm modes) and
// the persistent batch-1 kernels (decode_stack.cuh, for slow_step.cu and
// fast_frame.cu: the helpers, Stack and stack_product).
//
// The layer weights are bf16, or int8 with one bf16 scale per output
// column (ops/quant.py; the TPU kernels' quantized bodies,
// slow_step_pallas.py:152-174, 198-207, 313-323 and fast_frame_pallas.py:
// 127-151, 174-186, 284-294); the heads are always bf16.
//
// Every bf16 rounding of a layer sits where the TPU kernels
// (fish_speech_tpu/ops/slow_step_pallas.py:229-334,
// fast_frame_pallas.py:200-301) and the port's plain versions put it:
// the norm output; each product (f32 sum, then bf16); RoPE in f32, then
// bf16; the softmax weights before PV; silu of the unrounded f32 product,
// then bf16, times the bf16 w3 product. Products that the plain version
// computes in separate PyTorch ops use the _rn intrinsics, so nvcc does
// not fuse them into one FMA. An int8 product is the TPU kernels' _wdot
// (stack_product): each weight converts to float exactly, the f32 sum
// rounds to bf16, is multiplied by the column's bf16 scale in f32 and
// rounds to bf16 again; silu sees that rescaled bf16 w1 product.
//
// rope_attention_kernel runs one block per (row, query head). Rows
// 0..pos-1 are read from the cache; row pos is taken from shared memory,
// so the blocks of one KV group never read the row that the group's first
// block writes. The TPU kernel's masked read-modify-write of the whole
// window (a Mosaic workaround) is not ported: keys past pos take
// exp(-inf) = 0 there, so skipping them changes nothing.

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
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The modes of the batched frame's rows_gemm (fast_frame_batched.cu).
enum GemvMode { kQkv = 0, kResidual = 1, kSwiglu = 2, kHead = 3 };

// The stack product of column n as the TPU kernels' _wdot gives it: the
// f32 sum y for bf16 weights; bf16(bf16(y) * s[n]) for int8 weights.
template <typename W>
__device__ __forceinline__ float stack_product(float y, const bf16* __restrict__ scale, int n) {
  if constexpr (std::is_same<W, int8_t>::value)
    return round_bf16(__fmul_rn(round_bf16(y), bf(scale[n])));
  else
    return y;
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
  __host__ __device__ Stack layer(int l, int D, int QKV, int F) const {
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

}  // namespace
