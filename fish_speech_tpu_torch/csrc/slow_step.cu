// The whole slow-stack decode step, for Hopper (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/slow_step_pallas.py::
// fused_slow_step. For B rows at per-row positions pos[b]: every layer
// runs RMSNorm -> wqkv -> interleaved RoPE at pos[b] -> in-place K/V
// write at row pos[b] -> GQA over rows 0..pos[b] -> wo + residual ->
// RMSNorm -> SwiGLU + residual; then the final RMSNorm and the gathered
// head give f32 logits, unrounded as in the TPU kernel.
//
// What bounds it on this card: bytes. A step reads ~717 MiB of layer
// weights and the 2.1 MB head once; at B = 1 that is ~0.22 ms at
// 3.35 TB/s, and the flops are ~1000x below the tensor cores' rate.
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

// x0 (B, D), stacked layer weights attn_norm/ffn_norm (L, D), wqkv
// (L, D, QKV), wo (L, D, D), w1/w3 (L, D, F), w2 (L, F, D), norm (D,),
// head (D, W), all bf16 and contiguous; pos (B,) int32; cos_t/sin_t
// (P, 32) f32 RoPE tables; ck/cv (L, B, KV, S, 64) bf16, updated in
// place. Out: logits (B, W) f32, hidden (B, D) bf16 (the residual after
// the last layer; it is also the working activation). Scratch: qkv
// (B, QKV), attn (B, D), ffn (B, F) bf16. Returns the first CUDA error
// of the launches (0 on success).
extern "C" int fs_slow_step(const void* x0, const void* pos,
                            const void* attn_norm, const void* wqkv,
                            const void* wo, const void* ffn_norm,
                            const void* w1, const void* w3, const void* w2,
                            const void* norm, const void* head,
                            const void* cos_t, const void* sin_t, void* ck,
                            void* cv, void* logits, void* hidden,
                            void* qkv_buf, void* attn_buf, void* ffn_buf,
                            int B, int L, int D, int H, int KV, int F, int W,
                            int S, float eps, void* stream) {
  if (B < 1 || B > MAX_ROWS || KV <= 0 || H % KV != 0 || H * HDIM != D ||
      D % 8 != 0 || F % 8 != 0 || L < 1 || S < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int QKV = (H + 2 * KV) * HDIM;
  bf16* x = static_cast<bf16*>(hidden);
  cudaError_t err = cudaMemcpyAsync(x, x0, (size_t)B * D * sizeof(bf16),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const bf16* an = static_cast<const bf16*>(attn_norm);
  const bf16* fn = static_cast<const bf16*>(ffn_norm);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wo_ = static_cast<const bf16*>(wo);
  const bf16* w1_ = static_cast<const bf16*>(w1);
  const bf16* w3_ = static_cast<const bf16*>(w3);
  const bf16* w2_ = static_cast<const bf16*>(w2);
  for (int l = 0; l < L; ++l) {
    err = run_layer(x, an + (size_t)l * D, wq + (size_t)l * D * QKV,
                    wo_ + (size_t)l * D * D, fn + (size_t)l * D,
                    w1_ + (size_t)l * D * F, w3_ + (size_t)l * D * F,
                    w2_ + (size_t)l * F * D, static_cast<const float*>(cos_t),
                    static_cast<const float*>(sin_t), static_cast<const int*>(pos),
                    0, static_cast<bf16*>(ck), static_cast<bf16*>(cv), l,
                    static_cast<bf16*>(qkv_buf), static_cast<bf16*>(attn_buf),
                    static_cast<bf16*>(ffn_buf), B, D, H, KV, F, S, eps, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_gemv<kHead>(B, x, static_cast<const bf16*>(norm),
                           static_cast<const bf16*>(head), nullptr, D, W, W,
                           eps, nullptr, static_cast<float*>(logits), st);
  return (int)err;
}
