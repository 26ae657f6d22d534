// Decode attention with an in-place KV-cache write, for Hopper (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/attention_pallas.py::
// fused_decode_attention. For one cache layer and each batch row b it
// writes the new key/value at position pos[b] of the (L, B, KV, S, hd)
// bf16 caches, then runs grouped-query softmax attention of the row's
// H query heads over positions 0..pos[b]: scores in float32, the global
// max m and sum l, the normalised weights exp(s - m) / l rounded to bf16
// (attention_pallas.py:66-75), the PV product in float32, bf16 output.
//
// What bounds it on this card: bytes, and below a few thousand keys the
// latency of the few dependent steps. Every key and value row 0..pos is
// read once (2 * KV * (pos+1) * hd * 2 bytes per batch row) at ~2 flops
// per byte, far below the ~295 flop/byte at which the tensor cores
// become the limit; at the serving positions that is tens of KB, so what
// counts is how many memory round trips and barriers lie on the path.
//
// Design: one cluster of P blocks per (batch row, KV head), the P blocks
// split over the keys (launched with cudaLaunchKernelEx and a cluster
// dimension). P is a power of two <= 8 chosen from the cache length S
// alone (ops/decode_attention.py::decode_plan), never from B or pos: the
// launch is fixed for a graph capture, and a row's sums are taken in one
// order whatever its co-tenants.
//   * Keys come in tiles of 32, dealt round-robin to the ranks (tile t to
//     rank t % P), so the work is even at any pos. Within a tile each warp
//     takes 4 keys, 8 lanes to a key, each lane 16 bytes (8 dims) of the
//     K and V rows. A rank keeps the scores of its keys in registers, one
//     per lane and step (MAX_STEPS steps), so no buffer grows with S; the
//     cap is S <= P * 32 * MAX_STEPS (4096 at P = 8).
//   * The dot of each (key, head) is 8 sequential FMAs per lane, then a
//     reduce-scatter over the key's 8 lanes (7 shuffles for the G = 8
//     heads of a KV head), which leaves each lane with one head's score.
//     mma.sync would need the 8 heads padded to 16 rows and a K tile in
//     shared memory for 8 FMAs of work per loaded element; the FMA path
//     keeps the rows in registers straight from the 16-byte loads.
//   * K and V rows are loaded DEPTH steps ahead; the first V steps are in
//     flight before the first score is formed, so at the serving positions
//     (one or two steps a rank) the kernel waits on memory once. q stays
//     packed in bf16 and is unpacked where used, so a thread fits in 128
//     registers and two blocks share an SM: the 128 blocks of the serving
//     shape are then resident at once.
//   * The per-head max m and sum l come from one exchange through
//     distributed shared memory: each rank pushes its block's max m_r and
//     its sum l_r of exp(s - m_r) into its slot of every rank's buffer
//     (remote stores), cluster.sync(), and each lane combines the P slots
//     of its head from its own shared memory: m = max m_r, l = sum of
//     l_r exp(m_r - m) in fixed rank order. This is l to f32 rounding
//     (each term's exp is taken in two steps), and saves the barrier that
//     a max exchange followed by a sum exchange would take; the weights
//     are still exp(s - m) / l with the global m and l, rounded to bf16.
//   * Each rank forms the rounded normalised weights of its own keys
//     (broadcast to the key's 8 lanes by shuffles) and its partial PV
//     (G x 64 f32); each rank owns a slice of the G x 64 outputs, receives
//     the others' partials of it by the same pushes, and adds them in
//     fixed rank order. No rank reads another's shared memory, so no
//     barrier is needed on the way out: two cluster.sync() in all.
//   * The rank whose tile holds pos writes the new K/V row into the cache;
//     every rank takes key pos from k_new/v_new, never from the cache, so
//     no block reads a row that another block is writing. Only rows
//     0..pos are read: the TPU kernel's masked read-modify-write of the
//     whole window is a Mosaic workaround, and keys past pos take weight 0.
// Sums run in another order than XLA's, so attn agrees to bf16 rounding;
// the cache write is a plain copy and agrees bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int LANES_PER_KEY = 8;                      // 8 x 16 bytes = one row
constexpr int KEYS_PER_WARP = 32 / LANES_PER_KEY;     // 4
constexpr int TILE = NWARPS * KEYS_PER_WARP;          // 32 keys a block step
constexpr int MAX_STEPS = 16;                         // tiles a rank takes
constexpr int DEPTH = 4;                              // steps loaded ahead
constexpr int MAX_CLUSTER = 8;                        // portable cluster size
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void unpack8(const uint4& raw, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 v = __bfloat1622float2(h[e]);
    f[2 * e] = v.x;
    f[2 * e + 1] = v.y;
  }
}

// One stage of the reduce-scatter over a key's 8 lanes: with C >= 2
// values left, lanes whose bit O is set keep the upper half of them, the
// others the lower half, each adding its partner's copy; with one value
// left, both partners add (and so hold the same bits).
template <int C, int O, int G>
__device__ __forceinline__ void scatter_stage(float (&a)[G], int sub) {
  if constexpr (O > 0) {
    if constexpr (C >= 2) {
      const bool up = (sub & O) != 0;
#pragma unroll
      for (int i = 0; i < C / 2; ++i) {
        const float keep = up ? a[i + C / 2] : a[i];
        const float send = up ? a[i] : a[i + C / 2];
        a[i] = keep + __shfl_xor_sync(FULL, send, O);
      }
      scatter_stage<C / 2, O / 2, G>(a, sub);
    } else {
      a[0] += __shfl_xor_sync(FULL, a[0], O);
      scatter_stage<1, O / 2, G>(a, sub);
    }
  }
}

// The two halves of cluster.sync(): a block arrives as it starts and
// waits before its first store into another block's shared memory, which
// is legal only once every block of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Publish v as this rank's slot of buf ([MAX_CLUSTER][n] floats) in
// every block of the cluster (distributed shared memory stores); read
// after the next cluster.sync(), from the reader's own shared memory.
__device__ __forceinline__ void publish(float* buf, int n, int i, float v, int rank, int P) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int q = 0; q < P; ++q) cluster.map_shared_rank(buf, q)[rank * n + i] = v;
}

// grid: B * KV * P blocks in clusters of P (rank = blockIdx.x % P).
template <int G>
__global__ void __launch_bounds__(THREADS, 2)
    decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_new,
                            const bf16* __restrict__ v_new, const int* __restrict__ pos_arr,
                            bf16* ck, bf16* cv, bf16* __restrict__ out, int B, int KV, int S,
                            int layer, float scale) {
  constexpr int DUP = LANES_PER_KEY / G;  // lanes of a key that hold one head
  __shared__ float wred[NWARPS][G];  // the warps' max of each head
  __shared__ float wsum[NWARPS][G];  // and their sums of exp(s - block max)
  __shared__ float all_max[MAX_CLUSTER * G];  // [rank][head], pushed by every rank
  __shared__ float all_sum[MAX_CLUSTER * G];
  __shared__ __align__(16) float partial[NWARPS][G * HD];
  __shared__ float all_pv[G * HD];  // [rank][this rank's G * HD / P outputs]

  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 3;                     // key of the lane within its warp
  const int sub = lane & 7;                      // dims [8 sub, 8 sub + 8)
  const int own = sub / DUP;                     // head whose score the lane keeps
  const int key0 = warp * KEYS_PER_WARP + grp;   // the lane's key within a tile
  const int bg = blockIdx.x / P;                 // b * KV + g
  const int b = bg / KV;
  const int g = bg % KV;
  const int H = KV * G;
  const int p = pos_arr[b];
  if (p < 0 || p >= S) __trap();  // a position outside the cache

  const size_t row = ((size_t)layer * B * KV + bg) * (size_t)S * HD;
  bf16* kc = ck + row;
  bf16* vc = cv + row;
  const bf16* kn = k_new + (size_t)bg * HD + sub * 8;
  const bf16* vn = v_new + (size_t)bg * HD + sub * 8;

  // this lane's 16 bytes of key t * TILE + key0 (zero past pos; key pos
  // from k_new / v_new)
  auto load_at = [&](const bf16* cache, const bf16* fresh, int t) {
    const int j = t * TILE + key0;
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (j < p)
      r = *reinterpret_cast<const uint4*>(cache + (size_t)j * HD + sub * 8);
    else if (j == p)
      r = *reinterpret_cast<const uint4*>(fresh);
    return r;
  };

  uint4 kbuf[DEPTH], vbuf[DEPTH];
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) {
    kbuf[i] = load_at(kc, kn, rank + P * i);
    vbuf[i] = load_at(vc, vn, rank + P * i);
  }
  uint4 qraw[G];  // this lane's 8 dims of each head, unpacked where used
#pragma unroll
  for (int h = 0; h < G; ++h)
    qraw[h] = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + g * G + h) * HD + sub * 8);

  // in-place cache write of this step's key and value, by the lanes that
  // hold key pos
  if ((p / TILE) % P == rank && p % TILE == key0) {
    *reinterpret_cast<uint4*>(kc + (size_t)p * HD + sub * 8) = *reinterpret_cast<const uint4*>(kn);
    *reinterpret_cast<uint4*>(vc + (size_t)p * HD + sub * 8) = *reinterpret_cast<const uint4*>(vn);
  }

  // 1. scores of the rank's keys, one (key, head) per lane and step
  float sc[MAX_STEPS];
  float lmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < MAX_STEPS; ++i) {
    sc[i] = -INFINITY;
    const int t = rank + P * i;
    if (t * TILE <= p) {  // the same for the whole block
      const uint4 cur = kbuf[i % DEPTH];
      if (i + DEPTH < MAX_STEPS) kbuf[i % DEPTH] = load_at(kc, kn, t + P * DEPTH);
      float kf[8];
      unpack8(cur, kf);
      float d[G];
#pragma unroll
      for (int h = 0; h < G; ++h) d[h] = 0.f;
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float qf[8];
        unpack8(qraw[h], qf);
#pragma unroll
        for (int e = 0; e < 8; ++e) d[h] = fmaf(qf[e], kf[e], d[h]);
      }
      scatter_stage<G, LANES_PER_KEY / 2, G>(d, sub);
      if (t * TILE + key0 <= p) {
        sc[i] = d[0] * scale;
        lmax = fmaxf(lmax, sc[i]);
      }
    }
  }

  // 2. each rank's max of each head (warp, then block) and its sum of
  //    exp(s - that max); one exchange gives every rank all P pairs, from
  //    which the global max m and the global sum l = sum_r l_r exp(m_r - m)
  //    follow, the ranks added in rank order
  lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, 8));
  lmax = fmaxf(lmax, __shfl_xor_sync(FULL, lmax, 16));
  if (grp == 0 && sub % DUP == 0) wred[warp][own] = lmax;
  __syncthreads();
  float m_blk = wred[0][own];
  for (int w = 1; w < NWARPS; ++w) m_blk = fmaxf(m_blk, wred[w][own]);
  float lsum = 0.f;
  if (m_blk != -INFINITY) {  // a rank with no key yet adds nothing
#pragma unroll
    for (int i = 0; i < MAX_STEPS; ++i)
      if ((rank + P * i) * TILE <= p) lsum += expf(sc[i] - m_blk);  // exp(-inf) = 0 past pos
  }
  lsum += __shfl_xor_sync(FULL, lsum, 8);
  lsum += __shfl_xor_sync(FULL, lsum, 16);
  if (grp == 0 && sub % DUP == 0) wsum[warp][own] = lsum;
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  if (tid < G) {
    float mb = wred[0][tid];
    float sb = wsum[0][tid];
    for (int w = 1; w < NWARPS; ++w) {
      mb = fmaxf(mb, wred[w][tid]);
      sb += wsum[w][tid];
    }
    publish(all_max, G, tid, mb, rank, P);
    publish(all_sum, G, tid, sb, rank, P);
  }
  cluster.sync();
  float m = all_max[own];
  for (int r = 1; r < P; ++r) m = fmaxf(m, all_max[r * G + own]);
  float l = 0.f;
  for (int r = 0; r < P; ++r) {
    const float lr = all_sum[r * G + own];
    if (lr > 0.f) l += lr * expf(all_max[r * G + own] - m);
  }

  // 4. PV with bf16-rounded normalised weights, float32 accumulation
  float acc[G][8];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[h][e] = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_STEPS; ++i) {
    const int t = rank + P * i;
    if (t * TILE <= p) {
      const uint4 cur = vbuf[i % DEPTH];
      if (i + DEPTH < MAX_STEPS) vbuf[i % DEPTH] = load_at(vc, vn, t + P * DEPTH);
      const float w = __bfloat162float(__float2bfloat16(__fdiv_rn(expf(sc[i] - m), l)));
      float vf[8];
      unpack8(cur, vf);
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float wh = __shfl_sync(FULL, w, (lane & ~(LANES_PER_KEY - 1)) + h * DUP);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[h][e] = fmaf(wh, vf[e], acc[h][e]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[h][e] += __shfl_xor_sync(FULL, acc[h][e], 8);
      acc[h][e] += __shfl_xor_sync(FULL, acc[h][e], 16);
    }
  if (grp == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float4* dst = reinterpret_cast<float4*>(&partial[warp][h * HD + sub * 8]);
      dst[0] = make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
      dst[1] = make_float4(acc[h][4], acc[h][5], acc[h][6], acc[h][7]);
    }
  }
  __syncthreads();
  // the block's PV, pushed to the rank that writes each output (outputs
  // [q * per, q * per + per) to rank q, into slot [rank] of its all_pv)
  const int per = G * HD / P;
  for (int i = tid; i < G * HD; i += THREADS) {
    float s = partial[0][i];
    for (int w = 1; w < NWARPS; ++w) s += partial[w][i];
    const int q = i / per;
    cluster.map_shared_rank(&all_pv[0], q)[rank * per + (i - q * per)] = s;
  }
  // every rank's pushes have landed; after this no block touches another's
  // shared memory, so each may finish and leave on its own
  cluster.sync();
  bf16* o = out + ((size_t)b * H + g * G) * HD + rank * per;
  for (int i = tid; i < per; i += THREADS) {
    float s = all_pv[i];
    for (int r = 1; r < P; ++r) s += all_pv[r * per + i];
    o[i] = __float2bfloat16(s);
  }
}

template <int G>
int launch(const void* q, const void* k_new, const void* v_new, const void* pos, void* ck,
           void* cv, void* out, int B, int KV, int S, int layer, int P, float scale,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * KV * P);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<G>, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<const int*>(pos), static_cast<bf16*>(ck), static_cast<bf16*>(cv),
      static_cast<bf16*>(out), B, KV, S, layer, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, 64), k_new/v_new (B, KV, 64), pos (B,) int32, ck/cv
// (L, B, KV, S, 64), out (B, H, 64); all bf16 except pos, contiguous.
// cluster: P, the blocks a (row, KV head) is split over, from
// ops/decode_attention.py::decode_plan (a power of two <= 8 with
// S <= P * 32 * 16). H / KV must be 1, 2, 4 or 8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fs_decode_attention(const void* q, const void* k_new, const void* v_new,
                                   const void* pos, void* ck, void* cv, void* out, int B,
                                   int H, int KV, int S, int L, int layer, int cluster,
                                   float scale, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || layer < 0 || layer >= L || S <= 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) != 0 ||
      S > cluster * TILE * MAX_STEPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / KV) {
    case 1: return launch<1>(q, k_new, v_new, pos, ck, cv, out, B, KV, S, layer, cluster, scale, st);
    case 2: return launch<2>(q, k_new, v_new, pos, ck, cv, out, B, KV, S, layer, cluster, scale, st);
    case 4: return launch<4>(q, k_new, v_new, pos, ck, cv, out, B, KV, S, layer, cluster, scale, st);
    case 8: return launch<8>(q, k_new, v_new, pos, ck, cv, out, B, KV, S, layer, cluster, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
