// C entries that one source's launch sequence calls in another source of
// the same library (slow_step_rows.cu runs fast_frame_batched.cu's
// rows_gemm and decode_attention.cu's packed attention). Each defining
// source includes this header, so the compiler holds its definition to
// the declaration the caller sees. Arguments: at the definitions.

#pragma once

extern "C" {

int fs_rows_gemm(int mode, const void* in, const void* norm_w, const void* w, const void* w_b,
                 const void* scale, const void* scale_b, int nb, int K, int N, int ldw,
                 float eps, void* out, void* out_f32, void* stream);

int fs_rope_decode_attention(const void* qkv, const void* cos_t, const void* sin_t,
                             const void* pos, void* ck, void* cv, void* out, int B, int H,
                             int KV, int S, int cache_b, int L, int layer, int cluster,
                             float scale, void* stream);

}  // extern "C"
