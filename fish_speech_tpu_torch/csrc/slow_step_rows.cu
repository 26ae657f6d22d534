// The whole slow-stack decode step for 5 and more rows, for Hopper
// (sm_90a): one cooperative persistent launch for each group of up to 32
// rows, on the tensor cores.
//
// Replaces the TPU kernel fish_speech_tpu/ops/slow_step_pallas.py::
// fused_slow_step in its batched domain (B >= 5 with B * S <= 16384 and
// cache windows within 48 MiB, slow_step_pallas.py:447, 469-497), bf16
// body and int8 body (_make_kernel(quantized=True), l.152); 1-4 rows run
// the batch-1 persistent kernel (slow_step.cu). For every row b: all slow
// layers on x0[b] with interleaved RoPE at pos[b], the in-place K/V write
// at row pos[b] of the row's cache and attention over rows 0..pos[b];
// then the final norm and the gathered head, a float32 unrounded product.
// Rounding points, int8 rescale and silu on the unrounded f32 w1 product
// are dual_ar_layer.cuh's (the TPU kernel's, slow_step_pallas.py:152-174,
// 198-207, 229-334).
//
// What bounds it on this card: bytes. A 16-row step at cache 512 reads
// 737.7 MB (bf16) or 379.7 MB (int8) at Fish-1.5 width, the slow stack
// once for all rows plus each row's keys and values; at 16-32 rows a
// weight element feeds 16-32 multiply-adds, far below the ~295 operations
// a byte at which the tensor cores become the limit.
//
// The sequence this replaces (5 launches a layer and 1 for the head, 121
// a step) paid three costs: each launch's fixed cost to its first copy and
// its cluster barrier; no launch fetching its weights before the previous
// one ended, though the weights never depend on the activations; and no
// weight byte moving while attention ran. The design removes all three
// with decode_stack.cuh's machinery (its grid syncs, sync state, head
// exchange and cooperative launch):
//
// * The layer pass, the plan, the weight ring and the sync state are
//   rows_stack.cuh's, shared with the batched fast frame
//   (fast_frame_batched.cu), which runs the same pass on the fast stack.
//   After the last layer: the head's partials, one more sync, and each
//   block adds the splits of its (tile, row) pairs into f32 logits.
// Not ported: the TPU kernel's flat-lane 0/1 matrices E/R/P/Sel, its
// masked full-window KV read-modify-write and its row-block grid, which
// are Mosaic workarounds (slow_step_pallas.py:19-35).

#include "rows_stack.cuh"

namespace {

// One group of nb <= 32 rows: one block per SM, cooperative launch.
template <typename W>
__global__ void __launch_bounds__(DS_BLOCK, 1)
    slow_step_rows_kernel(const __grid_constant__ SrArgs<W> a) {
  extern __shared__ __align__(128) unsigned char sr_smem[];
  const SrPlan& P = a.plan;
  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  const int G = gridDim.x;
  const int D = a.D, H = a.H, KV = a.KV, L = a.L, nb = a.nb;
  const int Q = P.q_blocks;
  const int group = H / KV;
  const SrMem m = SrMem::of(sr_smem, a.scratch, P);

  // 1. the tables, the ring's mbarriers, the positions
  sr_setup(a, m, sr_smem, 0);
  if (tid < nb) {
    m.pos_s[tid] = a.pos[tid];
    if (m.pos_s[tid] < 0 || m.pos_s[tid] >= a.S) __trap();  // a position outside the cache
  }
  __syncthreads();  // the whole block, producer warp included: the last time
  const uint32_t full = ds_smem_addr(sr_smem + P.sm_bar);
  const uint32_t empty = full + 8 * P.stages;
  if (tid >= DS_THREADS) {
    sr_produce<W>(m.segs, m.mats, L, 1, sr_smem + P.sm_ring, full, empty, P.stages,
                  P.stage_bytes);
    return;
  }
  SrRing rg{sr_smem + P.sm_ring, full, empty, P.stages, P.stage_bytes, 0, 0u};

  // the cache rows 0..pos-1 of layer l that the block's attention units
  // read, into L2; the units of a KV head's query heads take a share each
  auto prefetch_kv = [&](int l) {
    for (int u = blk; u < P.attn_units; u += G) {
      const int h = u / Q;
      for (int b = u % Q; b < nb; b += Q) {
        const int p = m.pos_s[b];
        const size_t co = (((size_t)l * a.cache_b + b) * KV + h / group) * a.S * HDIM;
        for (int j = h % group + tid * group; j < p; j += DS_THREADS * group) {
          ds_prefetch_l2(a.ck + co + (size_t)j * HDIM);
          ds_prefetch_l2(a.cv + co + (size_t)j * HDIM);
        }
      }
    }
  };
  prefetch_kv(0);
  sr_norm(a.x0, nb, D, a.stack.attn_norm, m.h_s, P.h_pitch, a.eps);
  ds_sync();

  // 2. the layers (the last one's x is the hidden output)
  SrFlow fl{0u, 0u, 0, a.x0};
  for (int l = 0; l < L; ++l)
    sr_layer<W>(a, m, rg, fl, l, l, l + 1 == L ? a.hidden : nullptr, [&]() {
      if (l + 1 < L) prefetch_kv(l + 1);  // a layer ahead
    });

  // 3. the head's partials; one more sync; each block adds the splits of
  //    its (tile, row) pairs in order: f32 logits, unrounded
  sr_head_partials<W>(a, m, rg);
  DS_MARK(L - 1, 20);
  sr_grid_sync(a.state, fl.si);
  DS_MARK(L - 1, 21);
  for (int i = blk * 2 + tid / SR_TILE; i < P.head_tiles * nb; i += 2 * G) {
    const int t = i / nb, b = i % nb;
    const int n = t * SR_TILE + tid % SR_TILE;
    if (n < a.head_n)
      a.logits[(size_t)b * a.head_n + n] = ds_sum_strided<16>(
          m.part_head + ((size_t)t * P.head_splits * SR_ROWS + b) * SR_TILE + tid % SR_TILE,
          (size_t)SR_ROWS * SR_TILE, P.head_splits);
  }
  DS_MARK(L - 1, 22);

  // 4. the last block to finish counts the launch and resets the counters
  sr_finish(a, SR_LAUNCHES_WORD);
}

template <typename W>
cudaError_t sr_launch(const SrArgs<W>& a, cudaStream_t st) {
  static int smem_set = 0;
  static int smem_checked = 0;
  return ds_coop_launch(slow_step_rows_kernel<W>, a, a.plan.grid, DS_BLOCK, a.plan.smem, st,
                        smem_set, smem_checked);
}

}  // namespace

// x0 (B, D) bf16, the embedded rows; pos (B,) int32; the slow stack as in
// fs_slow_step (attn_norm, ffn_norm (L, D) bf16; wqkv, wo, w1, w3, w2
// (L, in, out), bf16 or int8 with five (L, 1, out) bf16 scales, else five
// nulls); norm (D,) bf16; head (D, head_ld) bf16, whose first W columns
// are the gathered head (head_ld a multiple of 8, >= W); cos_t, sin_t
// (positions, 32) f32; ck, cv (L, B, KV, S, 64) bf16, written in place at
// row pos[b]. Out: logits (B, W) f32, hidden (B, D) bf16. scratch:
// scratch_bytes of device memory (at least the plan's); state:
// DS_STATE_WORDS words, its counters zero, left zero (the last two words:
// the last launch's grid syncs and head 0's exchanges; word
// DS_STATE_WORDS - 5 counts this kernel's launches). One launch a group of
// 32 rows, in order on the stream; *launched: the launches made. Returns
// the first CUDA error (0 on success).
extern "C" int fs_slow_step_rows(
    const void* x0, const void* pos, const void* attn_norm, const void* ffn_norm,
    const void* wqkv, const void* wo, const void* w1, const void* w3, const void* w2,
    const void* s_qkv, const void* s_o, const void* s_1, const void* s_3, const void* s_2,
    const void* norm, const void* head, const void* cos_t, const void* sin_t, void* ck,
    void* cv, void* logits, void* hidden, void* scratch, void* state, int B, int L, int D, int H,
    int KV, int F, int W, int head_ld, int S, int scratch_bytes, float eps, void* stream,
    int* launched) {
  if (launched == nullptr) return (int)cudaErrorInvalidValue;
  *launched = 0;
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  bool int8 = false;
  if (B < 1 || L < 1 || !ds_int8(scales, int8) || head_ld < W || head_ld % 8 != 0)
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  SrPlan plan;
  if (!sr_make_plan(D, H, KV, F, W, S, int8, grid, plan) || scratch_bytes < plan.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto stack) -> int {
    using Wt = typename std::remove_cv<
        typename std::remove_pointer<decltype(stack.wqkv)>::type>::type;
    for (int b0 = 0; b0 < B; b0 += SR_ROWS) {
      const size_t rows_b = (size_t)KV * S * HDIM;  // cache elements of a row of a layer
      SrArgs<Wt> a = {};
      a.stack = stack;
      a.final_norm = static_cast<const bf16*>(norm);
      a.head = static_cast<const bf16*>(head);
      a.head_ld = head_ld;
      a.head_n = W;
      a.cos_t = static_cast<const float*>(cos_t);
      a.sin_t = static_cast<const float*>(sin_t);
      a.ck = static_cast<bf16*>(ck) + b0 * rows_b;
      a.cv = static_cast<bf16*>(cv) + b0 * rows_b;
      a.cache_b = B;
      a.S = S;
      a.pos = static_cast<const int*>(pos) + b0;
      a.x0 = static_cast<const bf16*>(x0) + (size_t)b0 * D;
      a.logits = static_cast<float*>(logits) + (size_t)b0 * W;
      a.hidden = static_cast<bf16*>(hidden) + (size_t)b0 * D;
      a.nb = B - b0 < SR_ROWS ? B - b0 : SR_ROWS;
      a.L = L;
      a.D = D;
      a.H = H;
      a.KV = KV;
      a.F = F;
      a.eps = eps;
      a.scratch = static_cast<unsigned char*>(scratch);
      a.state = static_cast<unsigned*>(state);
      a.plan = plan;
      const cudaError_t e = sr_launch<Wt>(a, st);
      if (e != cudaSuccess) return (int)e;
      ++*launched;
    }
    return 0;
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}

// The plan slow_step_rows_kernel runs for these shapes on the current
// device (W the head's columns, S the cache length), as SR_PLAN_INTS ints
// in SrPlan's order into out. Returns cudaErrorInvalidValue for shapes the
// kernel does not take.
extern "C" int fs_slow_step_rows_plan(int D, int H, int KV, int F, int W, int S, int int8,
                                      void* out) {
  int grid = 0;
  const cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  SrPlan plan;
  if (!sr_make_plan(D, H, KV, F, W, S, int8 != 0, grid, plan)) return (int)cudaErrorInvalidValue;
  sr_plan_ints(plan, static_cast<int*>(out));
  return 0;
}

#ifdef DS_TRACE
// The instrumented copy's phase trace (this file's kernel): n words of
// ds_trace_buf into out.
extern "C" int fs_slow_step_rows_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ds_trace_buf, (size_t)n * sizeof(unsigned long long));
}
#endif
