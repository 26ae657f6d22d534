// The whole slow-stack decode step, for Hopper (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/slow_step_pallas.py::
// fused_slow_step. For B rows at per-row positions pos[b]: every layer
// runs RMSNorm -> wqkv -> interleaved RoPE at pos[b] -> in-place K/V
// write at row pos[b] -> GQA over rows 0..pos[b] -> wo + residual ->
// RMSNorm -> SwiGLU + residual; then the final RMSNorm and the gathered
// head give f32 logits, unrounded as in the TPU kernel.
//
// The stack may be int8 with bf16 per-column scales (ops/quant.py): the TPU
// kernel's quantized body (slow_step_pallas.py:152-174, 198-207,
// 313-323), the same launches with the int8 GEMVs of dual_ar_layer.cuh.
//
// What bounds it on this card: bytes. A step reads ~717 MiB of bf16
// layer weights (half of it in int8, plus ~0.6 MB of scales) and the
// 2.1 MB head once; the flops are ~1000x below the tensor cores' rate.
//
// Design: the TPU kernel is one kernel whose grid walks the layers, so
// Pallas prefetches layer l+1's weights while layer l computes and the
// activation stays in VMEM. On the H100 a layer's ~30 MB of weights is
// spread over all SMs instead, so this C entry launches a fixed sequence
// of the kernels in dual_ar_layer.cuh (five per layer, one for the head)
// on the caller's stream: 121 launches at Fish-1.5 depth, issued from C
// without Python in between. The activation (B x D bf16) passes between
// launches through L2. The TPU kernel's flat-lane 0/1 matrices
// (E/R/P/Sel) and its masked full-window cache rewrite are Mosaic
// workarounds and are not ported.

#include "dual_ar_layer.cuh"

namespace {

template <typename W>
int slow_step(const bf16* x0, const int* pos, const Stack<W>& stack, const bf16* norm,
              const bf16* head, const float* cos_t, const float* sin_t, bf16* ck, bf16* cv,
              float* logits, bf16* x, bf16* qkv_buf, bf16* attn_buf, bf16* ffn_buf, int B,
              int L, int D, int H, int KV, int F, int W_, int S, float eps, cudaStream_t st) {
  const int QKV = (H + 2 * KV) * HDIM;
  cudaError_t err = cudaMemcpyAsync(x, x0, (size_t)B * D * sizeof(bf16),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < L; ++l) {
    err = run_layer<W>(x, stack.layer(l, D, QKV, F), cos_t, sin_t, pos, 0, ck, cv, l, qkv_buf,
                       attn_buf, ffn_buf, B, D, H, KV, F, S, eps, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_head(B, x, norm, head, D, W_, W_, eps, logits, st);
}

}  // namespace

// x0 (B, D) bf16; the stack's norms attn_norm/ffn_norm (L, D) bf16, its
// weights wqkv (L, D, QKV), wo (L, D, D), w1/w3 (L, D, F), w2 (L, F, D),
// all bf16, or all int8 with scales (L, 1, out) bf16 (null for bf16); norm
// (D,) and head (D, W) bf16; all contiguous; pos (B,) int32; cos_t/sin_t
// (P, 32) f32 RoPE tables; ck/cv (L, B, KV, S, 64) bf16, updated in
// place. Out: logits (B, W) f32, hidden (B, D) bf16 (the residual after
// the last layer; it is also the working activation). Scratch: qkv
// (B, QKV), attn (B, D), ffn (B, F) bf16. Returns the first CUDA error
// of the launches (0 on success).
extern "C" int fs_slow_step(const void* x0, const void* pos, const void* attn_norm,
                            const void* ffn_norm, const void* wqkv, const void* wo,
                            const void* w1, const void* w3, const void* w2,
                            const void* s_qkv, const void* s_o, const void* s_1,
                            const void* s_3, const void* s_2, const void* norm,
                            const void* head, const void* cos_t, const void* sin_t, void* ck,
                            void* cv, void* logits, void* hidden, void* qkv_buf,
                            void* attn_buf, void* ffn_buf, int B, int L, int D, int H, int KV,
                            int F, int W, int S, float eps, void* stream) {
  if (B < 1 || B > MAX_ROWS || KV <= 0 || H % KV != 0 || H * HDIM != D ||
      D % 8 != 0 || F % 8 != 0 || L < 1 || S < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  const bool int8 = s_qkv != nullptr;
  for (const void* s : scales)
    if ((s != nullptr) != int8) return (int)cudaErrorInvalidValue;
  auto run = [&](auto stack) {
    return slow_step(static_cast<const bf16*>(x0), static_cast<const int*>(pos), stack,
                     static_cast<const bf16*>(norm), static_cast<const bf16*>(head),
                     static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
                     static_cast<bf16*>(ck), static_cast<bf16*>(cv), static_cast<float*>(logits),
                     static_cast<bf16*>(hidden), static_cast<bf16*>(qkv_buf),
                     static_cast<bf16*>(attn_buf), static_cast<bf16*>(ffn_buf), B, L, D, H, KV,
                     F, W, S, eps, static_cast<cudaStream_t>(stream));
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}
