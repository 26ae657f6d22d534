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
// FMAs, still far below the tensor cores' balance point, so the GEMM
// runs on the CUDA cores.
//
// Design: a fixed sequence of launches from this C entry on the caller's
// stream, 22 per step at Fish-1.5 depth (176 a frame), as in the batch-1
// frame:
//   per layer: rows_gemm<kQkv> (RMSNorm + wqkv), rope_attention (one
//   block per (row, query head) over the row's history, from
//   dual_ar_layer.cuh), rows_gemm<kResidual> (wo), rows_gemm<kSwiglu>
//   (RMSNorm + w1, w3), rows_gemm<kResidual> (w2);
//   then rows_gemm<kHead> and one sampler block per row.
// rows_gemm stages the input rows in shared memory a chunk of K at a
// time (the w2 input is 16 x 4096 bf16 = 128 KB at B = 16), so the rows
// the GEMV of dual_ar_layer.cuh takes (4) do not bound B here. Each
// thread owns two adjacent columns (one bf16x2 or two int8 loaded at
// once) and a slice of K and keeps one f32 sum per (row, column); the
// slices are added in one fixed order, whatever B and the weight type, so
// a row's results are deterministic and do not depend on the rows beside
// it. An int8 product is rounded and rescaled as dual_ar_layer.cuh's
// stack_product does. The sampler reads each row's knobs from device arrays and
// is codebook_sampler.cuh's sort, scan and draw. The TPU
// kernel's row-block grid, flat-lane E/R matrices, lane rolls, one-hot
// embedding matmul and sel_rows scatter are Mosaic workarounds and are
// not ported.

#include "codebook_sampler.cuh"
#include "dual_ar_layer.cuh"

namespace {

constexpr int RG_TILE = 16;                // columns per block
constexpr int RG_VEC = 2;                  // columns per thread (one bf16x2)
constexpr int RG_CT = RG_TILE / RG_VEC;    // threads across a tile
constexpr int RG_KS = THREADS / RG_CT;     // slices of the in dimension
constexpr int RG_KC = 256;                 // in-dimension chunk staged at once
constexpr int MAX_BATCH_ROWS = 32;

// Two adjacent weights of one row, loaded at once and converted to float.
template <typename W>
struct WPair;

template <>
struct WPair<bf16> {
  __nv_bfloat162 raw;
  __device__ __forceinline__ void load(const bf16* p) {
    raw = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ float2 to_float() const { return __bfloat1622float2(raw); }
};

template <>
struct WPair<int8_t> {
  char2 raw;
  __device__ __forceinline__ void load(const int8_t* p) {
    raw = __ldg(reinterpret_cast<const char2*>(p));
  }
  __device__ __forceinline__ float2 to_float() const {
    return make_float2((float)raw.x, (float)raw.y);
  }
};

// out[b, n] = epilogue(p(sum_k in'[b, k] * w[k, n])) for b < nb, n < N:
// the modes, roundings and int8 rescale p of dual_ar_layer.cuh's
// gemv_kernel, for up to NB rows. in: (nb, K) contiguous bf16; w: K rows
// of stride ldw. Rows nb..NB of the staged input are zero, and their
// results are not written. grid: ceil(N / RG_TILE) blocks.
template <int MODE, typename W, int NB>
__global__ void __launch_bounds__(THREADS)
    rows_gemm_kernel(const bf16* __restrict__ in, const bf16* __restrict__ norm_w,
                     const W* __restrict__ w, const W* __restrict__ w_b,
                     const bf16* __restrict__ scale, const bf16* __restrict__ scale_b, int nb,
                     int K, int N, int ldw, float eps, bf16* out,
                     float* __restrict__ out_f32) {
  constexpr bool NORM = MODE != kResidual;
  constexpr int NA = MODE == kSwiglu ? 2 : 1;
  constexpr int PASS = 8;                          // rows reduced at once
  constexpr int NPASS = (NB + PASS - 1) / PASS;
  constexpr int PARTS = THREADS / (PASS * RG_TILE);  // threads per (row, column)
  constexpr int PER = RG_KS / PARTS;               // partial sums each adds
  constexpr int U = 4;                             // rows of w loaded ahead

  __shared__ __align__(16) bf16 in_s[NB * RG_KC];
  __shared__ float red[RG_KS * PASS * RG_TILE];
  __shared__ float inv_rms[NB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. RMS of each input row over the whole of K (norm modes)
  if (NORM) {
    for (int b = warp; b < nb; b += NWARPS) {
      float ss = 0.f;
      for (int i = lane; i < K; i += 32) {
        const float v = bf(in[(size_t)b * K + i]);
        ss = __fadd_rn(ss, __fmul_rn(v, v));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(FULL, ss, off);
      if (lane == 0) inv_rms[b] = rsqrtf(__fadd_rn(__fdiv_rn(ss, (float)K), eps));
    }
  }

  // 2. partial products: chunk by chunk of K, the staged input rows
  //    (normalised in the norm modes) times this thread's slice of W
  const int ct = tid % RG_CT;
  const int ks = tid / RG_CT;
  const int n0 = blockIdx.x * RG_TILE + ct * RG_VEC;
  float acc[NA][NB][RG_VEC];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int v = 0; v < RG_VEC; ++v) acc[a][b][v] = 0.f;

  for (int k0 = 0; k0 < K; k0 += RG_KC) {
    const int kc = min(RG_KC, K - k0);
    __syncthreads();  // inv_rms written; the previous chunk consumed
    for (int i = tid; i < NB * RG_KC; i += THREADS) {
      const int b = i / RG_KC;
      const int kk = i - b * RG_KC;
      bf16 v = __float2bfloat16(0.f);
      if (b < nb && kk < kc) {
        v = in[(size_t)b * K + k0 + kk];
        if (NORM) {
          const float h = __fmul_rn(bf(v), inv_rms[b]);
          v = __float2bfloat16(__fmul_rn(h, bf(norm_w[k0 + kk])));
        }
      }
      in_s[i] = v;
    }
    __syncthreads();
    if (n0 >= N) continue;
    const W* wp[NA];
    wp[0] = w + (size_t)k0 * ldw + n0;
    if (NA == 2) wp[NA - 1] = w_b + (size_t)k0 * ldw + n0;
    int k = ks;
    for (; k + (U - 1) * RG_KS < kc; k += U * RG_KS) {
      WPair<W> r[NA][U];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int a = 0; a < NA; ++a) r[a][u].load(wp[a] + (size_t)(k + u * RG_KS) * ldw);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
          const float2 wf = r[a][u].to_float();
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            const float xv = bf(in_s[b * RG_KC + k + u * RG_KS]);
            acc[a][b][0] = fmaf(xv, wf.x, acc[a][b][0]);
            acc[a][b][1] = fmaf(xv, wf.y, acc[a][b][1]);
          }
        }
      }
    }
    for (; k < kc; k += RG_KS) {
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        WPair<W> r;
        r.load(wp[a] + (size_t)k * ldw);
        const float2 wf = r.to_float();
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float xv = bf(in_s[b * RG_KC + k]);
          acc[a][b][0] = fmaf(xv, wf.x, acc[a][b][0]);
          acc[a][b][1] = fmaf(xv, wf.y, acc[a][b][1]);
        }
      }
    }
  }

  // 3. add the RG_KS partial sums of each (row, column) in a fixed order,
  //    PASS rows at a time; the order is the same for every NB, so a
  //    row's result does not depend on how many rows run beside it
  const int part = tid % PARTS;
  const int col = (tid / PARTS) % RG_TILE;
  const int pr = tid / (PARTS * RG_TILE);
  float y[NA][NPASS];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int p = 0; p < NPASS; ++p) {
      __syncthreads();
#pragma unroll
      for (int r = 0; r < PASS; ++r)
#pragma unroll
        for (int v = 0; v < RG_VEC; ++v)
          red[(ks * PASS + r) * RG_TILE + ct * RG_VEC + v] =
              p * PASS + r < NB ? acc[a][p * PASS + r][v] : 0.f;
      __syncthreads();
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) s += red[((part * PER + i) * PASS + pr) * RG_TILE + col];
#pragma unroll
      for (int off = PARTS / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      y[a][p] = s;
    }
  }

  // 4. epilogue
  const int n = blockIdx.x * RG_TILE + col;
  if (part != 0 || n >= N) return;
#pragma unroll
  for (int p = 0; p < NPASS; ++p) {
    const int b = p * PASS + pr;
    if (b >= nb) continue;
    const size_t o = (size_t)b * N + n;
    const float y0 = stack_product<W>(y[0][p], scale, n);
    if (MODE == kQkv) {
      out[o] = __float2bfloat16(y0);
    } else if (MODE == kResidual) {
      out[o] = __float2bfloat16(__fadd_rn(bf(out[o]), round_bf16(y0)));
    } else if (MODE == kSwiglu) {
      const float gate = round_bf16(__fdiv_rn(y0, __fadd_rn(1.f, expf(-y0))));
      const float up = round_bf16(stack_product<W>(y[NA - 1][p], scale_b, n));
      out[o] = __float2bfloat16(__fmul_rn(gate, up));
    } else {
      out_f32[o] = y0;
    }
  }
}

template <int MODE, typename W>
cudaError_t launch_rows_gemm(int nb, const bf16* in, const bf16* norm_w, const W* w,
                             const W* w_b, const bf16* scale, const bf16* scale_b, int K,
                             int N, int ldw, float eps, bf16* out, float* out_f32,
                             cudaStream_t st) {
  if (N % RG_VEC || ldw % RG_VEC) return cudaErrorInvalidValue;
  const int grid = (N + RG_TILE - 1) / RG_TILE;
  if (nb <= 4)
    rows_gemm_kernel<MODE, W, 4><<<grid, THREADS, 0, st>>>(in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out, out_f32);
  else if (nb <= 8)
    rows_gemm_kernel<MODE, W, 8><<<grid, THREADS, 0, st>>>(in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out, out_f32);
  else if (nb <= 16)
    rows_gemm_kernel<MODE, W, 16><<<grid, THREADS, 0, st>>>(in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out, out_f32);
  else if (nb <= MAX_BATCH_ROWS)
    rows_gemm_kernel<MODE, W, 32><<<grid, THREADS, 0, st>>>(in, norm_w, w, w_b, scale, scale_b, nb, K, N, ldw, eps, out, out_f32);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
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
