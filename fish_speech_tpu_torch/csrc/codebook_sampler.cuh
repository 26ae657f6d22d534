// Device code of the codebook samplers: the batch-1 fast frame's
// (fast_frame.cu, through decode_stack.cuh), one block of 1024 threads
// drawing one token from V <= 4096 probabilities; and, at the end, the
// batched fast frame's draw inside its persistent kernel
// (fast_frame_batched.cu), on a block's 256 consumer threads.
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

// ---------------------------------------------------------------------------
// The batched frame's draw, inside its persistent kernel
// ---------------------------------------------------------------------------
//
// fast_frame_batched.cu draws row b's token on block b's RD_THREADS = 256
// consumer threads (named barrier 1: the block's producer warp never
// joins), while the other blocks wait and every block's producer streams
// the next step's weights. A bitonic sort of all V keys, as sorted_draw
// makes it, takes 55 barrier steps at V = 1024 with 1024 threads and four
// times the compare steps on 256; yet only the k_eff <= k_dyn largest keys
// are ever kept. So the draw selects them first: a radix select over
// rank_key's 64-bit order (probability, then the lower index), 8-bit
// digits from the top, one shared histogram a pass with warp-aggregated
// adds, stopping as soon as the digits so far take exactly k_eff keys
// (four passes where the probabilities differ); then a bitonic sort of
// those keys only (the next power of two >= k_eff, warp shuffles for the
// strides below 32), a block scan of their probabilities and the Gumbel
// draw by rank. The order is lax.top_k's, so the tokens are the full
// sort's. The draw is a chain of barriers, so each step takes as few as it
// can: a thread keeps its own four adjacent logits from the gather to the
// compaction (no barrier between), a reduction or a radix pass is one
// barrier (rotating buffers; every warp reads the whole histogram and
// finds the digit itself), and the row's knobs, window and first Gumbel
// draws are loaded ahead, beside the head's partial sums.

// (DS_MARK is decode_stack.cuh's, which includes this file.)
constexpr int RD_THREADS = 256;
constexpr int RD_WARPS = RD_THREADS / 32;
constexpr int RD_ITEMS = 4;  // adjacent logits a thread owns in a round of 4 * RD_THREADS

__device__ __forceinline__ void rd_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(RD_THREADS) : "memory");
}

// Keys the draw sorts for a top-k of k: a power of two, at least 32.
__host__ __device__ inline int rd_sort_width(int k) {
  int n = 32;
  while (n < k) n *= 2;
  return n;
}

// Bytes of the draw's shared memory at V logits and a top-k cap k_dyn.
__host__ __device__ inline int rd_smem_bytes(int V, int k_dyn) {
  return 8 * rd_sort_width(k_dyn) + 4 * V + 3 * 256 * 4 + 3 * 4 * RD_WARPS + 8 * RD_WARPS + 16;
}

// The draw's shared memory (16-byte aligned base): the selected keys; the
// row's logits, then its probabilities; three 256-bin histograms (a radix
// pass's, the next's, and one being cleared); the reductions (the max,
// the sum, the scan); the best key; the compaction's slot count.
struct RdSmem {
  unsigned long long* keys;  // [rd_sort_width(k_dyn)]
  float* p;                  // [V]
  unsigned* hist;            // [3][256]
  float* fred;               // [3][RD_WARPS]
  unsigned long long* kred;  // [RD_WARPS]
  int* slots;

  __device__ __forceinline__ static RdSmem at(unsigned char* base, int V, int k_dyn) {
    RdSmem s;
    s.keys = reinterpret_cast<unsigned long long*>(base);
    s.p = reinterpret_cast<float*>(s.keys + rd_sort_width(k_dyn));
    s.hist = reinterpret_cast<unsigned*>(s.p + V);
    s.fred = reinterpret_cast<float*>(s.hist + 3 * 256);
    s.kred = reinterpret_cast<unsigned long long*>(s.fred + 3 * RD_WARPS);
    s.slots = reinterpret_cast<int*>(s.kred + RD_WARPS);
    return s;
  }
};

// The block's max or sum of v (each thread's, a butterfly in the warp, the
// warps in order): one barrier, red used by no other reduction of the call.
__device__ __forceinline__ float rd_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(SAMPLER_FULL, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  rd_sync();
  float r = red[0];
  for (int w = 1; w < RD_WARPS; ++w) r = is_max ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// The index of the block's largest rank_key: one barrier.
__device__ __forceinline__ int rd_best(unsigned long long key, unsigned long long* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(SAMPLER_FULL, key, off);
    key = o > key ? o : key;
  }
  if (lane == 0) red[warp] = key;
  rd_sync();
  unsigned long long best = red[0];
  for (int w = 1; w < RD_WARPS; ++w) best = red[w] > best ? red[w] : best;
  return (int)(0xffffffffu - (unsigned)(best & 0xffffffffu));
}

// A bitonic compare of v (key i = 32 s + lane of a 32-key segment) with
// key i ^ j: the larger goes to the lower index in a descending run.
__device__ __forceinline__ unsigned long long rd_cmp(unsigned long long v, int j, bool desc,
                                                     int lane) {
  const unsigned long long o = __shfl_xor_sync(SAMPLER_FULL, v, j);
  return (((lane & j) == 0) == desc) ? (o > v ? o : v) : (o < v ? o : v);
}

// keys[0..n) (n a power of two >= 32) sorted descending.
__device__ __forceinline__ void rd_sort(unsigned long long* keys, int n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // runs of up to 32 keys: a warp a segment, in registers
  for (int seg = warp; seg < n / 32; seg += RD_WARPS) {
    const int i = seg * 32 + lane;
    unsigned long long v = keys[i];
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) v = rd_cmp(v, j, (i & k) == 0, lane);
    keys[i] = v;
  }
  rd_sync();
  for (int k = 64; k <= n; k <<= 1) {
    // strides of 32 and more through shared memory, a pair a thread
    for (int j = k >> 1; j >= 32; j >>= 1) {
      for (int q = tid; q < n / 2; q += RD_THREADS) {
        const int i = 2 * q - (q & (j - 1));
        const unsigned long long a = keys[i], b = keys[i + j];
        if ((a < b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[i + j] = a;
        }
      }
      rd_sync();
    }
    for (int seg = warp; seg < n / 32; seg += RD_WARPS) {
      const int i = seg * 32 + lane;
      unsigned long long v = keys[i];
#pragma unroll
      for (int j = 16; j > 0; j >>= 1) v = rd_cmp(v, j, (i & k) == 0, lane);
      keys[i] = v;
    }
    rd_sync();
  }
}

// The token of one row, on the block's RD_THREADS consumer threads, with
// the semantics of ops/sampling.py::sample_top_k_top_p_dynamic: x =
// logits / max(temp, 1e-6) after the row's repetition penalty, in s.p,
// each thread's RD_ITEMS adjacent entries n = r * 4 * RD_THREADS + 4 tid +
// e written by that thread (mx: the largest of them); p = softmax(x);
// temp <= 1e-7 takes the rank-0 token; else k_eff = top_k if 0 < top_k
// <= k_dyn, else k_dyn; p_eff = top_p if 0 < top_p < 1, else 1; rank r is
// kept when r < k_eff, p > 0 and its exclusive mass < p_eff, and the token
// maximises log p + gumbel[r] (ties to the lower token); g0 = gumbel[tid]
// (for tid < k_dyn), loaded ahead. The first two histograms are zero.
// Every thread returns the token. Trace marks (pass `pass`): 11 max, 12
// sum, 4 probabilities, 13 the first radix pass, 14 the last, 5 selection,
// 6 sort.
__device__ __noinline__ int rd_sample(const RdSmem& s, int V, float mx, float temp, float top_p,
                                      int top_k, int k_dyn, const float* __restrict__ gumbel,
                                      float g0, int pass) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int step = RD_ITEMS * RD_THREADS;

  // 1. softmax
  const float m = rd_reduce(mx, true, s.fred);
  DS_MARK(pass, 11);
  float sum = 0.f;
  for (int n = RD_ITEMS * tid; n < V; n += step)
#pragma unroll
    for (int e = 0; e < RD_ITEMS; ++e) {
      const float x = expf(__fsub_rn(s.p[n + e], m));
      s.p[n + e] = x;
      sum += x;
    }
  sum = rd_reduce(sum, false, s.fred + RD_WARPS);
  DS_MARK(pass, 12);
  unsigned long long top = 0;
  for (int n = RD_ITEMS * tid; n < V; n += step)
#pragma unroll
    for (int e = 0; e < RD_ITEMS; ++e) {
      const float pn = __fdiv_rn(s.p[n + e], sum);
      s.p[n + e] = pn;
      const unsigned long long key = rank_key(pn, n + e);
      top = key > top ? key : top;
    }
  DS_MARK(pass, 4);
  if (temp <= 1e-7f) return rd_best(top, s.kred);
  const int k_eff = (top_k <= 0 || top_k > k_dyn) ? k_dyn : top_k;
  const float p_eff = (top_p <= 0.f || top_p >= 1.f) ? 1.f : top_p;

  // 2. the k_eff largest keys: (key >> shift) >= (prefix >> shift). Pass i
  //    counts into histogram i % 3 and clears histogram (i + 2) % 3, whose
  //    last readers passed this pass's barrier and whose next writers come
  //    after the next pass's.
  unsigned long long prefix = 0;
  int shift = 56;
  if (k_eff < V) {
    int krem = k_eff;  // keys still to take from the candidates
    for (int i = 0;; ++i) {
      unsigned* h = s.hist + (i % 3) * 256;
      const unsigned long long above = shift == 56 ? 0ull : ~0ull << (shift + 8);
      for (int base = 0; base < V; base += step)
#pragma unroll
        for (int e = 0; e < RD_ITEMS; ++e) {
          const int n = base + RD_ITEMS * tid + e;
          int dig = -1;
          if (n < V) {
            const unsigned long long key = rank_key(s.p[n], n);
            if (((key ^ prefix) & above) == 0) dig = (int)(key >> shift) & 255;
          }
          const unsigned peers = __match_any_sync(SAMPLER_FULL, dig);
          if (dig >= 0 && lane == __ffs(peers) - 1) atomicAdd(h + dig, (unsigned)__popc(peers));
        }
      rd_sync();
      // every warp: lane l takes bins 255 - 8 l - j (j < 8), the candidates
      // in the bins above them (a lane scan), then the bin in which the
      // k_eff-th key falls
      unsigned c8[8];
      unsigned tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c8[j] = h[255 - 8 * lane - j];
        tot += c8[j];
      }
      unsigned run = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(SAMPLER_FULL, run, off);
        if (lane >= off) run += o;
      }
      run -= tot;
      int found = -1, take = 0, in_bin = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (found < 0 && run + c8[j] >= (unsigned)krem && run < (unsigned)krem) {
          found = 255 - 8 * lane - j;
          take = krem - (int)run;
          in_bin = (int)c8[j];
        }
        run += c8[j];
      }
      const int src = __ffs(__ballot_sync(SAMPLER_FULL, found >= 0)) - 1;
      const int d = __shfl_sync(SAMPLER_FULL, found, src);
      krem = __shfl_sync(SAMPLER_FULL, take, src);
      in_bin = __shfl_sync(SAMPLER_FULL, in_bin, src);
      s.hist[((i + 2) % 3) * 256 + tid] = 0u;
      DS_MARK(pass, i == 0 ? 13 : 14);
      prefix |= (unsigned long long)d << shift;
      if (in_bin == krem || shift == 0) break;  // the bin's candidates are all taken
      shift -= 8;
    }
  }
  // the selected keys, in any order, then zeros up to the sort's width
  for (int base = 0; base < V; base += step)
#pragma unroll
    for (int e = 0; e < RD_ITEMS; ++e) {
      const int n = base + RD_ITEMS * tid + e;
      unsigned long long key = 0;
      bool sel = false;
      if (n < V) {
        key = rank_key(s.p[n], n);
        sel = k_eff >= V || (key >> shift) >= (prefix >> shift);
      }
      const unsigned ball = __ballot_sync(SAMPLER_FULL, sel);
      int slot = 0;
      if (lane == 0 && ball != 0u) slot = atomicAdd(s.slots, __popc(ball));
      slot = __shfl_sync(SAMPLER_FULL, slot, 0);
      if (sel) s.keys[slot + __popc(ball & ((1u << lane) - 1u))] = key;
    }
  const int width = rd_sort_width(k_eff);
  for (int i = k_eff + tid; i < width; i += RD_THREADS) s.keys[i] = 0ull;
  rd_sync();
  DS_MARK(pass, 5);

  // 3. the order of lax.top_k
  rd_sort(s.keys, width);
  DS_MARK(pass, 6);

  // 4. the exclusive mass of each rank (a block scan a round of 256
  //    ranks), the keep mask and the Gumbel draw
  unsigned long long best = 0;
  float carry = 0.f;
  float* red = s.fred + 2 * RD_WARPS;
  for (int base = 0; base < k_eff; base += RD_THREADS) {
    const int r = base + tid;
    const unsigned long long key = r < k_eff ? s.keys[r] : 0ull;
    const float pr = r < k_eff ? __uint_as_float((unsigned)(key >> 32) & 0x7fffffffu) : 0.f;
    float c = pr;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(SAMPLER_FULL, c, off);
      if (lane >= off) c += o;
    }
    if (lane == 31) red[warp] = c;
    rd_sync();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += red[w];
    float total = carry;
    for (int w = 0; w < RD_WARPS; ++w) total += red[w];
    const float excl = __fsub_rn(__fadd_rn(before, c), pr);
    if (r < k_eff && pr > 0.f && excl < p_eff) {
      const float g = base == 0 ? g0 : gumbel[r];
      const unsigned long long sk =
          rank_key(__fadd_rn(logf(pr), g), (int)(0xffffffffu - (unsigned)key));
      best = sk > best ? sk : best;
    }
    carry = total;
    if (base + RD_THREADS < k_eff) rd_sync();  // red is free for the next round
  }
  return rd_best(best, s.kred);
}

}  // namespace
