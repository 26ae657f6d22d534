// The whole slow-stack decode step, for Hopper (sm_90a).
//
// Replaces the TPU kernel fish_speech_tpu/ops/slow_step_pallas.py::
// fused_slow_step. For B <= 4 rows at per-row positions pos[b]: every
// layer runs RMSNorm -> wqkv -> interleaved RoPE at pos[b] -> in-place K/V
// write at row pos[b] -> GQA over rows 0..pos[b] -> wo + residual ->
// RMSNorm -> SwiGLU + residual; then the final RMSNorm and the gathered
// head give f32 logits, unrounded as in the TPU kernel. The stack may be
// int8 with bf16 per-column scales (ops/quant.py): the TPU kernel's
// quantized body (slow_step_pallas.py:152-174, 198-207, 313-323), the same
// kernel reading int8 pieces at half the bytes.
//
// What bounds it on this card: bytes and the chain of dependent phases. A
// step reads ~717 MiB of bf16 layer weights (half of it in int8, plus
// ~0.6 MB of scales) and the 2.1 MB head once, ~0.215 ms at 3.35 TB/s;
// the flops are ~1000x below the tensor cores' rate. Each layer also has
// three cross-block reductions (QKV, wo, w2) that must finish in order.
//
// Design: the TPU kernel is one kernel whose grid walks the layers, so
// Pallas fetches layer l+1's weights while layer l computes. Here too the
// step is one cooperative launch, decode_stack.cuh's persistent kernel:
// one block per SM walks all layers with three grid syncs a layer, and
// each block's weight ring streams its share of the coming phases and
// layers ahead of those syncs. The TPU kernel's flat-lane 0/1 matrices
// (E/R/P/Sel) and its masked full-window cache rewrite are Mosaic
// workarounds and are not ported.

#include "decode_stack.cuh"

// x0 (B, D) bf16; the stack's norms attn_norm/ffn_norm (L, D) bf16, its
// weights wqkv (L, D, QKV), wo (L, D, D), w1/w3 (L, D, F), w2 (L, F, D),
// all bf16, or all int8 with scales (L, 1, out) bf16 (null for bf16); norm
// (D,) and head (D, W) bf16; all contiguous; pos (B,) int32; cos_t/sin_t
// (P, 32) f32 RoPE tables; ck/cv (L, B, KV, S, 64) bf16, updated in
// place. Out: logits (B, W) f32, hidden (B, D) bf16 (the residual after
// the last layer). scratch: scratch_bytes of device memory (at least the
// plan's); state: DS_STATE_WORDS zeroed words, its counters left zeroed
// (the last two words: the call's counts). Returns the launch's CUDA error
// (0 on success).
extern "C" int fs_slow_step(const void* x0, const void* pos, const void* attn_norm,
                            const void* ffn_norm, const void* wqkv, const void* wo,
                            const void* w1, const void* w3, const void* w2,
                            const void* s_qkv, const void* s_o, const void* s_1,
                            const void* s_3, const void* s_2, const void* norm,
                            const void* head, const void* cos_t, const void* sin_t, void* ck,
                            void* cv, void* logits, void* hidden, void* scratch, void* state,
                            int B, int L, int D, int H, int KV, int F, int W, int S,
                            int scratch_bytes, float eps, void* stream) {
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  bool int8 = false;
  if (B < 1 || B > DS_MAX_ROWS || L < 1 || !ds_int8(scales, int8))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  DsPlan plan;
  if (!ds_make_plan(0, D, H, KV, F, W, S, int8, grid, plan) || scratch_bytes < plan.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto stack) -> int {
    using Wt = typename std::remove_cv<
        typename std::remove_pointer<decltype(stack.wqkv)>::type>::type;
    DsArgs<Wt> a = {};
    a.stack = stack;
    a.final_norm = static_cast<const bf16*>(norm);
    a.head = static_cast<const bf16*>(head);
    a.head_ld = W;
    a.head_n = W;
    a.cos_t = static_cast<const float*>(cos_t);
    a.sin_t = static_cast<const float*>(sin_t);
    a.ck = static_cast<bf16*>(ck);
    a.cv = static_cast<bf16*>(cv);
    a.S = S;
    a.pos = static_cast<const int*>(pos);
    a.x0 = static_cast<const bf16*>(x0);
    a.logits = static_cast<float*>(logits);
    a.hidden = static_cast<bf16*>(hidden);
    a.C = 1;
    a.L = L;
    a.D = D;
    a.H = H;
    a.KV = KV;
    a.F = F;
    a.eps = eps;
    a.scratch = static_cast<unsigned char*>(scratch);
    a.state = static_cast<unsigned*>(state);
    a.plan = plan;
    switch (B) {
      case 1: return (int)ds_launch<Wt, 1, false>(a, st);
      case 2: return (int)ds_launch<Wt, 2, false>(a, st);
      case 3: return (int)ds_launch<Wt, 3, false>(a, st);
      default: return (int)ds_launch<Wt, 4, false>(a, st);
    }
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}

// The plan decode_stack_kernel runs for these shapes on the current
// device (fast 0: the slow step, head_n = W, S the cache length; fast 1:
// the fast frame, head_n = V, S = C), as DS_PLAN_INTS ints in DsPlan's
// order into out. Returns cudaErrorInvalidValue for shapes the kernel does
// not take.
extern "C" int fs_decode_stack_plan(int fast, int D, int H, int KV, int F, int head_n, int S,
                                    int int8, void* out) {
  int grid = 0;
  const cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  DsPlan plan;
  if (!ds_make_plan(fast, D, H, KV, F, head_n, S, int8 != 0, grid, plan))
    return (int)cudaErrorInvalidValue;
  ds_plan_ints(plan, static_cast<int*>(out));
  return 0;
}

#ifdef DS_TRACE
// The instrumented copy's phase trace (this file's kernels): n words of
// ds_trace_buf into out.
extern "C" int fs_slow_step_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ds_trace_buf, (size_t)n * sizeof(unsigned long long));
}
#endif
