// Device code shared by the decode kernels of the DualAR stacks, for
// Hopper (sm_90a): the helpers, Stack, stack_product and rope_pair of the
// persistent kernels (decode_stack.cuh, rows_stack.cuh) and rows_gemm's
// modes (fast_frame_batched.cu).
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

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int HDIM = 64;  // head dim the kernels take
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// The modes of rows_gemm (fast_frame_batched.cu).
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
// RoPE
// ---------------------------------------------------------------------------

// Rotate one interleaved pair in f32 and round to bf16, as
// ops/rope.py::apply_rope_interleaved does in separate PyTorch ops.
__device__ __forceinline__ void rope_pair(float x0, float x1, float c, float s,
                                          float* o) {
  o[0] = round_bf16(__fsub_rn(__fmul_rn(x0, c), __fmul_rn(x1, s)));
  o[1] = round_bf16(__fadd_rn(__fmul_rn(x0, s), __fmul_rn(x1, c)));
}

}  // namespace
