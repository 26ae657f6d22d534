// One whole fast (codebook) frame at batch 1, for Hopper (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/fast_frame_pallas.py::
// fused_fast_frame. For codebook steps cb = 0..C-1: the fast layers run
// on x (the slow hidden at cb = 0, then the embedding of the previous
// step's token) with RoPE at position cb and attention over the frame's
// own K/V history 0..cb; the fast norm and head (the step's column block
// when depthwise_output) give f32 logits; the repetition penalty, the
// top-k/top-p Gumbel draw and the EOS rule give the token, and the
// token's embedding row (the step's row block when depthwise_wte) is the
// next step's x. The whole frame stays on the card: each token is
// written to device memory and the next step reads it there, with no
// host read per codebook. The stack may be int8 with bf16 per-column
// scales (ops/quant.py): the TPU kernel's quantized body
// (fast_frame_pallas.py:127-151, 174-186, 284-294), the same launches with
// the int8 GEMVs of dual_ar_layer.cuh.
//
// What bounds it on this card: bytes. The fast stack is ~120 MB at
// Fish-1.5 width (4 layers x ~29.9 MB), more than the 50 MB L2 and the
// SMs' shared memory together, so the TPU kernel's "weights fetched once
// per frame" (it keeps them in 128 MiB of VMEM) cannot be had: each
// codebook step streams the weights again, ~0.96 GB a frame.
//
// Design: a fixed sequence of launches from this C entry on the caller's
// stream; per step the layer kernels of dual_ar_layer.cuh (five a
// layer), the head GEMV and one sampler block (22 launches per step at
// Fish-1.5 depth, 176 a frame). The K/V history is a (L, 1, KV, C, 64)
// scratch cache that the attention kernel writes at row cb. The sampler
// is one block of 1024 threads over the codebook vocabulary: a bitonic
// sort of (p, index) pairs gives the order of lax.top_k (probability
// descending, ties by lower index) and a block scan the exclusive mass.
// The sort, scan and draw are codebook_sampler.cuh's, shared with the
// batched frame. The TPU kernel's j-tiled rank matrices, one-hot embedding
// matmul and flat-lane 0/1 matrices are Mosaic workarounds and are not
// ported.

#include "codebook_sampler.cuh"
#include "dual_ar_layer.cuh"

namespace {

// One codebook draw, the semantics of fast_frame_pallas.py:303-370 and of
// ops/sampling.py::sample_top_k_top_p in the port:
//   logits of the window's members are divided by the penalty (entries
//   of -1 match no token); temp <= 1e-7 takes the argmax (lowest index on
//   ties); else p = softmax(logits / temp), tokens ranked by p
//   descending, ties by index; rank < k_eff and, when 0 < top_p < 1,
//   exclusive mass < top_p are kept; the token maximises log p +
//   gumbel[rank] (lowest index on ties). is_eos forces token 0.
// Writes the token to *tok_out and, when emb is not null, the token's
// embedding row (D bf16) to x_next. ITEMS * 1024 >= V.
template <int ITEMS>
__global__ void __launch_bounds__(SAMPLER_THREADS)
    codebook_sample_kernel(const float* __restrict__ logits, int V,
                           const int* __restrict__ window, int window_len,
                           float penalty, float temp, float top_p, int k_eff,
                           const float* __restrict__ gumbel,
                           const unsigned char* __restrict__ is_eos,
                           const bf16* __restrict__ emb, int D,
                           int* __restrict__ tok_out, bf16* __restrict__ x_next) {
  __shared__ unsigned long long keys[SAMPLER_THREADS * ITEMS];
  __shared__ float red[SAMPLER_WARPS];
  __shared__ unsigned long long best_red[SAMPLER_WARPS];
  __shared__ int win_s[MAX_WINDOW];
  __shared__ int top_s;
  __shared__ int tok_s;

  const int tid = threadIdx.x;
  if (window != nullptr && tid < window_len) win_s[tid] = window[tid];
  __syncthreads();

  float lg[ITEMS];
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = tid + it * SAMPLER_THREADS;
    lg[it] = i < V ? logits[i] : -INFINITY;
  }
  if (window != nullptr) apply_penalty(lg, V, win_s, window_len, penalty);

  int tok;
  if (temp <= 1e-7f) {
    unsigned long long best = 0;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * SAMPLER_THREADS;
      if (i < V) best = max(best, rank_key(lg[it], i));
    }
    tok = block_best(best, best_red);
  } else {
    const float sum = softmax_exp(lg, V, temp, red);
    tok = sorted_draw(lg, sum, V, k_eff, top_p > 0.f && top_p < 1.f, top_p, gumbel, keys,
                      red, best_red, &top_s);
  }

  if (tid == 0) {
    tok_s = is_eos[0] ? 0 : tok;
    *tok_out = tok_s;
  }
  __syncthreads();
  if (emb != nullptr) {
    const bf16* row = emb + (size_t)tok_s * D;
    for (int d = tid; d < D; d += SAMPLER_THREADS) x_next[d] = row[d];
  }
}

// The C steps of one frame with the layer stack of type W.
template <typename W>
int fast_frame(const bf16* hidden, const Stack<W>& stack, const bf16* fast_norm,
               const bf16* head, const bf16* emb, const float* cos_t, const float* sin_t,
               const int* window, const float* gumbel, const unsigned char* eos, int* tokens,
               bf16* x, bf16* qkv_buf, bf16* attn_buf, bf16* ffn_buf, float* logits_buf,
               bf16* k_hist, bf16* v_hist, int L, int D, int H, int KV, int F, int C, int V,
               int head_ld, int depthwise_output, int depthwise_wte, int window_len,
               int k_eff, int rep_enabled, float temp, float top_p, float penalty, float eps,
               cudaStream_t st) {
  const int QKV = (H + 2 * KV) * HDIM;
  cudaError_t err = cudaMemcpyAsync(x, hidden, (size_t)D * sizeof(bf16),
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return (int)err;
  for (int cb = 0; cb < C; ++cb) {
    float* logits = logits_buf + (size_t)cb * V;
    for (int l = 0; l < L; ++l) {
      err = run_layer<W>(x, stack.layer(l, D, QKV, F), cos_t, sin_t, nullptr, cb, k_hist,
                         v_hist, l, qkv_buf, attn_buf, ffn_buf, 1, D, H, KV, F, C, eps, st);
      if (err != cudaSuccess) return (int)err;
    }
    const bf16* head_cb = head + (depthwise_output ? (size_t)cb * V : 0);
    err = launch_head(1, x, fast_norm, head_cb, D, V, head_ld, eps, logits, st);
    if (err != cudaSuccess) return (int)err;
    // the last step's token needs no embedding
    const bf16* emb_cb = cb + 1 < C ? emb + (depthwise_wte ? (size_t)cb * V * D : 0) : nullptr;
    const int* win = rep_enabled ? window + (size_t)cb * window_len : nullptr;
    const float* gum = gumbel ? gumbel + (size_t)cb * k_eff : nullptr;
    int* tok = tokens + cb;
    const int items = (V + SAMPLER_THREADS - 1) / SAMPLER_THREADS;
    if (items <= 1)
      codebook_sample_kernel<1><<<1, SAMPLER_THREADS, 0, st>>>(logits, V, win, window_len, penalty, temp, top_p, k_eff, gum, eos, emb_cb, D, tok, x);
    else if (items <= 2)
      codebook_sample_kernel<2><<<1, SAMPLER_THREADS, 0, st>>>(logits, V, win, window_len, penalty, temp, top_p, k_eff, gum, eos, emb_cb, D, tok, x);
    else
      codebook_sample_kernel<4><<<1, SAMPLER_THREADS, 0, st>>>(logits, V, win, window_len, penalty, temp, top_p, k_eff, gum, eos, emb_cb, D, tok, x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// hidden (1, D) bf16, the slow hidden. The fast-layer stack as in
// fs_slow_step (norms, five weights bf16 or int8, five scales or nulls);
// fast_norm (D,); head: the fast output (D, head_ld), whose
// columns [cb*V, cb*V + V) serve step cb when depthwise_output, else
// columns [0, V); emb: the fast embeddings, rows [cb*V, cb*V + V) for
// step cb's token when depthwise_wte, else rows [0, V). window (C,
// window_len) int32 rep-pen windows; gumbel (C, k_eff) f32, null in argmax
// mode; is_eos (1,) bool. Out: tokens (C,) int32; logits, (C, V) f32,
// holds each step's penalty-free head logits. Scratch: x (1, D), qkv
// (1, QKV), attn (1, D), ffn (1, F) bf16, k_hist and v_hist
// (L, 1, KV, C, 64) bf16. Returns the first CUDA error of the launches
// (0 on success).
extern "C" int fs_fast_frame(
    const void* hidden, const void* attn_norm, const void* ffn_norm, const void* wqkv,
    const void* wo, const void* w1, const void* w3, const void* w2, const void* s_qkv,
    const void* s_o, const void* s_1, const void* s_3, const void* s_2,
    const void* fast_norm, const void* head, const void* emb,
    const void* cos_t, const void* sin_t, const void* window,
    const void* gumbel, const void* is_eos, void* tokens, void* x_buf,
    void* qkv_buf, void* attn_buf, void* ffn_buf, void* logits_buf,
    void* k_hist, void* v_hist, int L, int D, int H, int KV, int F, int C,
    int V, int head_ld, int depthwise_output, int depthwise_wte,
    int window_len, int k_eff, int rep_enabled, float temp, float top_p,
    float penalty, float eps, void* stream) {
  if (KV <= 0 || H % KV != 0 || H * HDIM != D || D % 8 != 0 || F % 8 != 0 ||
      L < 1 || C < 1 || V < 1 || V > 4 * SAMPLER_THREADS ||
      window_len > MAX_WINDOW || (rep_enabled && window_len < 1) ||
      (temp > 1e-7f && (gumbel == nullptr || k_eff < 1)))
    return (int)cudaErrorInvalidValue;
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  const bool int8 = s_qkv != nullptr;
  for (const void* s : scales)
    if ((s != nullptr) != int8) return (int)cudaErrorInvalidValue;
  auto run = [&](auto stack) {
    return fast_frame(static_cast<const bf16*>(hidden), stack,
                      static_cast<const bf16*>(fast_norm), static_cast<const bf16*>(head),
                      static_cast<const bf16*>(emb), static_cast<const float*>(cos_t),
                      static_cast<const float*>(sin_t), static_cast<const int*>(window),
                      static_cast<const float*>(gumbel),
                      static_cast<const unsigned char*>(is_eos), static_cast<int*>(tokens),
                      static_cast<bf16*>(x_buf), static_cast<bf16*>(qkv_buf),
                      static_cast<bf16*>(attn_buf), static_cast<bf16*>(ffn_buf),
                      static_cast<float*>(logits_buf), static_cast<bf16*>(k_hist),
                      static_cast<bf16*>(v_hist), L, D, H, KV, F, C, V, head_ld,
                      depthwise_output, depthwise_wte, window_len, k_eff, rep_enabled, temp,
                      top_p, penalty, eps, static_cast<cudaStream_t>(stream));
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}
