// Device code shared by the codebook samplers of the batch-1 fast frame
// (fast_frame.cu) and the batched fast frame (fast_frame_batched.cu): one
// block of 1024 threads draws one token from V <= 4096 probabilities.
//
// The order is lax.top_k's: probability descending, ties by the lower
// index. A bitonic sort of (p, index) keys in shared memory gives it, and
// a block scan of the sorted p the exclusive mass before each rank. The
// draw keeps rank r when r < k_eff, p > 0 and (when a mass limit is on)
// the exclusive mass < the limit, and takes the token that maximises
// log p + gumbel[r]: the Gumbel draws are indexed by rank. Ties in the
// score go to the lower token index.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SAMPLER_THREADS = 1024;
constexpr int SAMPLER_WARPS = SAMPLER_THREADS / 32;
constexpr int MAX_WINDOW = 64;  // rep-pen window entries a sampler takes
constexpr unsigned SAMPLER_FULL = 0xffffffffu;

// (value, index) as one integer that orders like "larger value, then
// smaller index": the float's bits mapped to an order-preserving uint32,
// then the inverted index.
__device__ __forceinline__ unsigned long long rank_key(float v, int i) {
  unsigned u = __float_as_uint(v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (0xffffffffu - (unsigned)i);
}

// The index of the block's largest key.
__device__ __forceinline__ int block_best(unsigned long long key,
                                          unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(SAMPLER_FULL, key, off);
    key = o > key ? o : key;
  }
  __syncthreads();
  if (lane == 0) red[warp] = key;
  __syncthreads();
  unsigned long long best = red[0];
  for (int w = 1; w < SAMPLER_WARPS; ++w) best = red[w] > best ? red[w] : best;
  return (int)(0xffffffffu - (unsigned)(best & 0xffffffffu));
}

__device__ __forceinline__ float sampler_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(SAMPLER_FULL, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < SAMPLER_WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// lg[it] holds the logit of token tid + it * 1024 (-inf past V). Tokens
// in the window (entries of -1 match none) are divided by `penalty`.
template <int ITEMS>
__device__ __forceinline__ void apply_penalty(float (&lg)[ITEMS], int V, const int* win_s,
                                              int window_len, float penalty) {
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * SAMPLER_THREADS;
    if (i < V) {
      bool member = false;
      for (int w = 0; w < window_len; ++w) member |= win_s[w] == i;
      if (member) lg[it] = __fdiv_rn(lg[it], penalty);
    }
  }
}

// lg becomes exp(lg / temp - max) (0 past V); returns the block's sum.
template <int ITEMS>
__device__ __forceinline__ float softmax_exp(float (&lg)[ITEMS], int V, float temp,
                                             float* red) {
  float lmax = -INFINITY;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    lg[it] = __fdiv_rn(lg[it], temp);
    lmax = fmaxf(lmax, lg[it]);
  }
  const float m = sampler_reduce(lmax, red, true);
  float lsum = 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = threadIdx.x + it * SAMPLER_THREADS;
    lg[it] = i < V ? expf(__fsub_rn(lg[it], m)) : 0.f;
    lsum += lg[it];
  }
  return sampler_reduce(lsum, red, false);
}

// The draw over p = e / sum (e as softmax_exp leaves it). keys holds
// SAMPLER_THREADS * ITEMS entries of shared memory. Keeps rank r when
// r < k_eff, p > 0 and, if use_limit, the exclusive mass < p_limit; the
// Gumbel draws are gumbel[r]. Returns the drawn token; *top gets the
// rank-0 token (the whole block sees both).
template <int ITEMS>
__device__ __forceinline__ int sorted_draw(const float (&e)[ITEMS], float sum, int V,
                                           int k_eff, bool use_limit, float p_limit,
                                           const float* __restrict__ gumbel,
                                           unsigned long long* keys, float* red,
                                           unsigned long long* best_red, int* top) {
  constexpr int NP = SAMPLER_THREADS * ITEMS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. ascending sort of (~bits(p), index): p descending, ties by index
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int i = tid + it * SAMPLER_THREADS;
    unsigned long long key = ~0ull;
    if (i < V) {
      const float p = __fdiv_rn(e[it], sum);
      key = ((unsigned long long)(~__float_as_uint(p)) << 32) | (unsigned)i;
    }
    keys[i] = key;
  }
  __syncthreads();
  for (int k = 2; k <= NP; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < NP; i += SAMPLER_THREADS) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  if (tid == 0) *top = (int)(keys[0] & 0xffffffffu);

  // 2. inclusive scan of the sorted p; this thread owns ranks
  //    tid*ITEMS .. tid*ITEMS+ITEMS-1
  float ps[ITEMS], incl[ITEMS];
  int idx[ITEMS];
  float run = 0.f;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int r = tid * ITEMS + it;
    const unsigned long long key = keys[r];
    idx[it] = (int)(key & 0xffffffffu);
    ps[it] = r < V ? __uint_as_float(~(unsigned)(key >> 32)) : 0.f;
    run = __fadd_rn(run, ps[it]);
    incl[it] = run;
  }
  float scan = run;  // inclusive scan of the thread totals
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(SAMPLER_FULL, scan, off);
    if (lane >= off) scan += o;
  }
  __syncthreads();
  if (lane == 31) red[warp] = scan;
  __syncthreads();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base += red[w];
  base += scan - run;  // everything before this thread's first rank

  // 3. keep masks and the Gumbel draw
  unsigned long long best = 0;
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int r = tid * ITEMS + it;
    const float excl = __fsub_rn(__fadd_rn(base, incl[it]), ps[it]);
    const bool keep = r < V && r < k_eff && ps[it] > 0.f && (!use_limit || excl < p_limit);
    if (keep) best = max(best, rank_key(__fadd_rn(logf(ps[it]), gumbel[r]), idx[it]));
  }
  const int tok = block_best(best, best_red);
  __syncthreads();  // *top is read by the caller after the draw
  return tok;
}

}  // namespace
