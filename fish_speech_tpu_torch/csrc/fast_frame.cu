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
// next step's x. The whole frame stays on the card, in 2C launches. The
// stack may be int8 with bf16 per-column scales (ops/quant.py): the TPU
// kernel's quantized body (fast_frame_pallas.py:127-151, 174-186,
// 284-294), the same kernel reading int8 pieces at half the bytes.
//
// What bounds it on this card: bytes and the chain of dependent phases.
// The fast stack is ~120 MB at Fish-1.5 width (4 layers x ~29.9 MB), more
// than the 50 MB L2 and the SMs' shared memory together, so the TPU
// kernel's "weights fetched once per frame" (it keeps them in 128 MiB of
// VMEM) cannot be had: each codebook step streams the weights again,
// ~0.97 GB a frame (~0.29 ms at 3.35 TB/s). Each step also has three
// cross-block reductions a layer and the draw, which waits for the head.
//
// Design: each codebook step is one cooperative launch of
// decode_stack.cuh's persistent kernel (one block per SM: the step's
// layers with three grid syncs a layer, then the head's partials),
// followed by one launch of its sampler, ds_sampler_kernel: 16 launches a
// frame. The sampler is codebook_sampler.cuh's code on one block of 1024
// threads, as the batched frame's: the head's splits added in order into
// the f32 logits, the penalty, a bitonic sort of (p, index) pairs in
// shared memory for the order of lax.top_k (probability descending, ties
// by lower index), a block scan for the exclusive mass, the draw; it
// writes the token's embedding row, which the next step's launch reads as
// its x. (The draw inside the persistent kernel, on the last block's 256
// consumer threads while the other blocks' rings fetched the next step,
// made the whole frame one launch but took ~26 us a step; PERF.md
// section 6 has both times.) The TPU kernel's j-tiled rank matrices,
// one-hot embedding matmul and flat-lane 0/1 matrices are Mosaic
// workarounds and are not ported.

#include "decode_stack.cuh"

// hidden (1, D) bf16, the slow hidden. The fast-layer stack as in
// fs_slow_step (norms, five weights bf16 or int8, five scales or nulls);
// fast_norm (D,); head: the fast output (D, head_ld), whose columns
// [cb*V, cb*V + V) serve step cb when depthwise_output, else columns
// [0, V); emb: the fast embeddings, rows [cb*V, cb*V + V) for step cb's
// token when depthwise_wte, else rows [0, V). window (C, window_len) int32
// rep-pen windows; gumbel (C, k_eff) f32, null in argmax mode; is_eos (1,)
// bool. Out: tokens (C,) int32; logits, (C, V) f32, holds each step's
// penalty-free head logits. k_hist and v_hist (L, 1, KV, C, 64) bf16
// scratch; scratch: scratch_bytes of device memory (at least the plan's);
// state: DS_STATE_WORDS zeroed words, its counters left zeroed (the last
// two words: the last launch's counts). Returns the first failing launch's CUDA
// error (0 on success).
extern "C" int fs_fast_frame(
    const void* hidden, const void* attn_norm, const void* ffn_norm, const void* wqkv,
    const void* wo, const void* w1, const void* w3, const void* w2, const void* s_qkv,
    const void* s_o, const void* s_1, const void* s_3, const void* s_2,
    const void* fast_norm, const void* head, const void* emb,
    const void* cos_t, const void* sin_t, const void* window,
    const void* gumbel, const void* is_eos, void* tokens, void* logits,
    void* k_hist, void* v_hist, void* scratch, void* state, int L, int D, int H, int KV, int F,
    int C, int V, int head_ld, int depthwise_output, int depthwise_wte,
    int window_len, int k_eff, int rep_enabled, int scratch_bytes, float temp, float top_p,
    float penalty, float eps, void* stream) {
  const void* wts[5] = {wqkv, wo, w1, w3, w2};
  const void* scales[5] = {s_qkv, s_o, s_1, s_3, s_2};
  bool int8 = false;
  if (L < 1 || C < 1 || V < 1 || V > 4 * SAMPLER_THREADS || window_len > MAX_WINDOW ||
      (rep_enabled && window_len < 1) || (temp > 1e-7f && (gumbel == nullptr || k_eff < 1)) ||
      !ds_int8(scales, int8))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  cudaError_t err = ds_grid(grid);
  if (err != cudaSuccess) return (int)err;
  DsPlan plan;
  if (!ds_make_plan(1, D, H, KV, F, V, C, int8, grid, plan) || scratch_bytes < plan.scratch_bytes)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto stack) -> int {
    using Wt = typename std::remove_cv<
        typename std::remove_pointer<decltype(stack.wqkv)>::type>::type;
    DsArgs<Wt> a = {};
    a.stack = stack;
    a.final_norm = static_cast<const bf16*>(fast_norm);
    a.head = static_cast<const bf16*>(head);
    a.head_ld = head_ld;
    a.head_n = V;
    a.cos_t = static_cast<const float*>(cos_t);
    a.sin_t = static_cast<const float*>(sin_t);
    a.ck = static_cast<bf16*>(k_hist);
    a.cv = static_cast<bf16*>(v_hist);
    a.S = C;
    a.logits = static_cast<float*>(logits);
    a.emb = static_cast<const bf16*>(emb);
    a.window = static_cast<const int*>(window);
    a.gumbel = static_cast<const float*>(gumbel);
    a.is_eos = static_cast<const unsigned char*>(is_eos);
    a.tokens = static_cast<int*>(tokens);
    a.C = C;
    a.depthwise_output = depthwise_output;
    a.depthwise_wte = depthwise_wte;
    a.window_len = window_len;
    a.k_eff = k_eff;
    a.rep_enabled = rep_enabled;
    a.temp = temp;
    a.top_p = top_p;
    a.penalty = penalty;
    a.L = L;
    a.D = D;
    a.H = H;
    a.KV = KV;
    a.F = F;
    a.eps = eps;
    a.scratch = static_cast<unsigned char*>(scratch);
    a.state = static_cast<unsigned*>(state);
    a.plan = plan;
    // each codebook step: the persistent launch (from x0: the slow hidden,
    // then the previous step's embedding row), then the draw
    const bf16* x_next = reinterpret_cast<const bf16*>(a.scratch + plan.sc_xn);
    for (int cb = 0; cb < C; ++cb) {
      a.step = cb;
      a.x0 = cb == 0 ? static_cast<const bf16*>(hidden) : x_next;
      cudaError_t e = ds_launch<Wt, 1, true>(a, st);
      if (e == cudaSuccess)
        e = V <= SAMPLER_THREADS ? ds_sampler_launch<Wt, 1>(a, st)
                                 : ds_sampler_launch<Wt, 4>(a, st);
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  };
  if (int8) return run(make_stack<int8_t>(attn_norm, ffn_norm, wts, scales));
  return run(make_stack<bf16>(attn_norm, ffn_norm, wts, scales));
}

#ifdef DS_TRACE
// The instrumented copy's phase trace (this file's kernels): n words of
// ds_trace_buf into out.
extern "C" int fs_fast_frame_trace(void* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, ds_trace_buf, (size_t)n * sizeof(unsigned long long));
}
#endif
