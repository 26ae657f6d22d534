// Tensor-core fragments shared by the batched frame's rows_gemm
// (fast_frame_batched.cu) and the slow step's row kernel
// (slow_step_rows.cu), for Hopper (sm_90a): mma.sync.m16n8k16 bf16 with
// f32 accumulation in the "swap-AB" form, a weight tile as the A operand
// (M = 16 output columns, K = 16 weight rows) and the batch rows as N.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes 0 and 2 (lo_hi = 0) or 1 and 3 (lo_hi = 1) of w, four int8 weights
// offset by 128 (w ^ 0x80808080), as a bf16 pair (exact for -128..127):
// each byte becomes the low mantissa bits of 2^23, from which 2^23 + 128
// is subtracted, without an int-to-float conversion.
__device__ __forceinline__ unsigned int8_pair(unsigned w, int lo_hi) {
  const float lo = __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 + lo_hi)),
                             8388736.f);
  const float hi = __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7542 + lo_hi)),
                             8388736.f);
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The A fragment (16 columns x 16 k) of int8 weights from the two bytes
// each lane reads at columns c0 + 2g, c0 + 2g + 1 of k-rows 2c, 2c + 1,
// 2c + 8 and 2c + 9 (r0, r1, r8, r9: those bytes' addresses; g = lane / 4,
// c = lane % 4): columns c0 + 2g and c0 + 2g + 1 become fragment rows g
// and g + 8 (int8_a_column), converted to bf16 as the fragment is formed.
// The A fragment from w01 and w89, each lane's bytes [g@r, g+8@r, g@r+1,
// g+8@r+1] of k-rows r = 2c (w01) and r = 2c + 8 (w89): what
// ldmatrix.trans of the int8 rows as b16 pairs gives a lane.
__device__ __forceinline__ void int8_a_frag_words(unsigned (&a)[4], unsigned w01, unsigned w89) {
  w01 ^= 0x80808080u;
  w89 ^= 0x80808080u;
  a[0] = int8_pair(w01, 0);
  a[1] = int8_pair(w01, 1);
  a[2] = int8_pair(w89, 0);
  a[3] = int8_pair(w89, 1);
}

__device__ __forceinline__ void int8_a_frag_rows(unsigned (&a)[4], const unsigned char* r0,
                                                 const unsigned char* r1, const unsigned char* r8,
                                                 const unsigned char* r9) {
  auto pair_rows = [](const unsigned char* lo_p, const unsigned char* hi_p) {
    // [g@r, g+8@r, g@r+1, g+8@r+1]
    const unsigned lo = *reinterpret_cast<const unsigned short*>(lo_p);
    const unsigned hi = *reinterpret_cast<const unsigned short*>(hi_p);
    return __byte_perm(lo, hi, 0x5410);
  };
  int8_a_frag_words(a, pair_rows(r0, r1), pair_rows(r8, r9));
}

// The A fragment of int8 weight rows k..k+15 (PITCH bytes apart in shared
// memory) at columns c0..c0+15.
template <int PITCH>
__device__ __forceinline__ void int8_a_frag(unsigned (&a)[4], const unsigned char* tile, int k,
                                            int c0, int lane) {
  const unsigned char* base = tile + (k + 2 * (lane & 3)) * PITCH + c0 + 2 * (lane >> 2);
  int8_a_frag_rows(a, base, base + PITCH, base + 8 * PITCH, base + 9 * PITCH);
}

// The weight column of fragment row m of an int8_a_frag at columns c0..
__device__ __forceinline__ int int8_a_column(int c0, int m) {
  return c0 + (m < 8 ? 2 * m : 2 * (m - 8) + 1);
}

}  // namespace
