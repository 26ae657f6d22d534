// The whole slow-stack decode step for 5 and more rows, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/slow_step_pallas.py::
// fused_slow_step in its batched domain (B >= 5 with B * S <= 16384 and
// cache windows within 48 MiB, slow_step_pallas.py:469-497), bf16 body
// and int8 body (_make_kernel(quantized=True), l.152); 1-4 rows run the
// persistent kernel (slow_step.cu). For every row b: all slow layers on
// x0[b] with RoPE at pos[b], the in-place K/V write at row pos[b] of the
// row's cache and attention over rows 0..pos[b]; then the final norm and
// the gathered head, a float32 unrounded product. Rounding points, int8
// rescale and silu on the unrounded f32 w1 product are dual_ar_layer.cuh's
// (the TPU kernel's, slow_step_pallas.py:229-334).
//
// What bounds it on this card: bytes. A step reads the slow stack once
// (720.7 MB bf16, 362.7 MB int8 at Fish-1.5 width, far more than the
// 50 MB L2) for all rows, and each row's keys and values 0..pos once. At
// 16 rows a weight element feeds 16 multiply-adds, far below the ~295
// operations a byte at which the tensor cores become the limit.
//
// Design: a fixed sequence of launches from this C entry on the caller's
// stream, of the kernels the batched fast frame runs, so all rows share
// each layer's weight stream:
//   copy x0's rows into hidden (a device copy, not a kernel);
//   per layer: rows_gemm<kQkv> (RMSNorm + wqkv on the tensor cores, into
//   the packed QKV rows), fs_rope_decode_attention (decode_attention.cu's
//   clusters over keys, reading q, k, v from the packed rows and rotating
//   q and k itself, with the K/V write), rows_gemm<kResidual> (wo),
//   rows_gemm<kSwiglu> (RMSNorm + w1, w3), rows_gemm<kResidual> (w2);
//   rows_gemm<kHead> (final norm + head, f32 logits).
// 5 L + 1 kernel launches (121 at Fish-1.5's 24 layers) for a group of
// at most 32 rows (rows_gemm's most); more rows run the same sequence
// again, group by group. Every launch's plan is a function of the shapes
// (rows_gemm: K, N, mode, weight type; attention: S) and never of the
// rows, their positions or their group, so a row's logits, hidden and
// cache rows are the same bits alone as among any co-tenants.
// The gathered head's width (1025 at Fish-1.5: im_end and the 1024
// semantic columns; 2 at Fish <= 1.4) is not a whole number of 16-byte
// pieces: rows_gemm reads the last tile from a copy of the head padded to
// head_ld columns (the wrapper's, made once by the engine) and writes
// only the W real columns.
// Not ported: the TPU kernel's flat-lane 0/1 matrices E/R/P/Sel, its
// masked full-window KV read-modify-write and its row-block grid, which
// are Mosaic workarounds (slow_step_pallas.py:19-35).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "c_entries.cuh"

namespace {

constexpr int GROUP_ROWS = 32;  // rows one pass of the sequence takes (rows_gemm's most)
constexpr int HD = 64;          // head dim
enum Mode { kQkv = 0, kResidual = 1, kSwiglu = 2, kHead = 3 };  // fs_rows_gemm's modes

}  // namespace

// x0 (B, D) bf16, the embedded rows; pos (B,) int32; the slow stack as in
// fs_slow_step (attn_norm, ffn_norm (L, D) bf16; wqkv, wo, w1, w3, w2
// (L, in, out), bf16 or int8 with five (L, 1, out) bf16 scales, else five
// nulls); norm (D,) bf16; head (D, head_ld) bf16, whose first W columns
// are the gathered head (head_ld a multiple of 8, >= W); cos_t, sin_t
// (positions, 32) f32; ck, cv (L, B, KV, S, 64) bf16, written in place at
// row pos[b]. Out: logits (B, W) f32, hidden (B, D) bf16. Scratch: qkv
// (min(B, 32), (H + 2 KV) * 64), attn (min(B, 32), D), ffn (min(B, 32), F)
// bf16. cluster: decode attention's blocks a (row, KV head) for caches of
// S (ops/decode_attention.py::decode_plan). *launched: the kernels
// launched. Returns the first CUDA error of the launches (0 on success).
extern "C" int fs_slow_step_rows(
    const void* x0, const void* pos, const void* attn_norm, const void* ffn_norm,
    const void* wqkv, const void* wo, const void* w1, const void* w3, const void* w2,
    const void* s_qkv, const void* s_o, const void* s_1, const void* s_3, const void* s_2,
    const void* norm, const void* head, const void* cos_t, const void* sin_t, void* ck,
    void* cv, void* logits, void* hidden, void* qkv_buf, void* attn_buf, void* ffn_buf, int B,
    int L, int D, int H, int KV, int F, int W, int head_ld, int S, int cluster, float eps,
    void* stream, int* launched) {
  if (launched == nullptr) return (int)cudaErrorInvalidValue;
  *launched = 0;
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  const bool int8 = s_qkv != nullptr;
  for (const void* s : scales)
    if ((s != nullptr) != int8) return (int)cudaErrorInvalidValue;
  if (B < 1 || L < 1 || KV < 1 || H % KV != 0 || H * HD != D || D % 8 != 0 || F % 8 != 0 ||
      W < 1 || head_ld < W || head_ld % 8 != 0 || S < 1)
    return (int)cudaErrorInvalidValue;
  const int QKV = (H + 2 * KV) * HD;
  const size_t esz = int8 ? 1 : 2;
  const char* wts[5] = {static_cast<const char*>(wqkv), static_cast<const char*>(wo),
                        static_cast<const char*>(w1), static_cast<const char*>(w3),
                        static_cast<const char*>(w2)};
  const int k_in[5] = {D, D, D, D, F};     // rows of each weight
  const int n_out[5] = {QKV, D, F, F, D};  // columns of each weight
  const float scale = 1.0f / sqrtf((float)HD);
  const size_t cache_row = (size_t)KV * S * HD;  // elements of one row of a cache layer
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* x_in = static_cast<const __nv_bfloat16*>(x0);
  __nv_bfloat16* x = static_cast<__nv_bfloat16*>(hidden);
  const int* rows_pos = static_cast<const int*>(pos);
  __nv_bfloat16* kc = static_cast<__nv_bfloat16*>(ck);
  __nv_bfloat16* vc = static_cast<__nv_bfloat16*>(cv);
  const __nv_bfloat16* an = static_cast<const __nv_bfloat16*>(attn_norm);
  const __nv_bfloat16* fn = static_cast<const __nv_bfloat16*>(ffn_norm);
  float* out = static_cast<float*>(logits);

  int err;
  for (int b0 = 0; b0 < B; b0 += GROUP_ROWS) {
    const int nb = B - b0 < GROUP_ROWS ? B - b0 : GROUP_ROWS;
    __nv_bfloat16* xg = x + (size_t)b0 * D;
    err = (int)cudaMemcpyAsync(xg, x_in + (size_t)b0 * D, (size_t)nb * D * sizeof(__nv_bfloat16),
                               cudaMemcpyDeviceToDevice, st);
    if (err != 0) return err;
    for (int l = 0; l < L; ++l) {
      // layer l's weight i and its scales (null for bf16)
      auto w = [&](int i) { return wts[i] + (size_t)l * k_in[i] * n_out[i] * esz; };
      auto s = [&](int i) -> const void* {
        return int8 ? static_cast<const __nv_bfloat16*>(scales[i]) + (size_t)l * n_out[i]
                    : nullptr;
      };
      err = fs_rows_gemm(kQkv, xg, an + (size_t)l * D, w(0), nullptr, s(0), nullptr, nb, D, QKV,
                         QKV, eps, qkv_buf, nullptr, stream);
      if (err != 0) return err;
      ++*launched;
      err = fs_rope_decode_attention(qkv_buf, cos_t, sin_t, rows_pos + b0, kc + b0 * cache_row,
                                     vc + b0 * cache_row, attn_buf, nb, H, KV, S, B, L, l,
                                     cluster, scale, stream);
      if (err != 0) return err;
      ++*launched;
      err = fs_rows_gemm(kResidual, attn_buf, nullptr, w(1), nullptr, s(1), nullptr, nb, D, D, D,
                         eps, xg, nullptr, stream);
      if (err != 0) return err;
      ++*launched;
      err = fs_rows_gemm(kSwiglu, xg, fn + (size_t)l * D, w(2), w(3), s(2), s(3), nb, D, F, F,
                         eps, ffn_buf, nullptr, stream);
      if (err != 0) return err;
      ++*launched;
      err = fs_rows_gemm(kResidual, ffn_buf, nullptr, w(4), nullptr, s(4), nullptr, nb, F, D, D,
                         eps, xg, nullptr, stream);
      if (err != 0) return err;
      ++*launched;
    }
    err = fs_rows_gemm(kHead, xg, norm, head, nullptr, nullptr, nullptr, nb, D, W, head_ld, eps,
                       nullptr, out + (size_t)b0 * W, stream);
    if (err != 0) return err;
    ++*launched;
  }
  return 0;
}
