// Warp-level tensor-core products (sm_80 and later).  bf16: ldmatrix loads
// of 8x8 b16 tiles from shared memory and mma.sync with float32
// accumulators, shared by K3 bf16 / K4 bf16 (update_bf16.cu) and K7 bf16
// (attn.cu).  tf32: the split of a float into two tf32 values and the
// m16n8k8 tf32 mma that K5 (mlp.cu) runs three times a k-step, so its
// products stay float32-accurate (3xTF32).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ppoc {

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and register i of lane l holds row l / 4, columns 2 (l % 4) and + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// The same, each matrix transposed: register i of lane l holds column l / 4,
// rows 2 (l % 4) and + 1.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4],
                                          const __nv_bfloat16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

// d += a (16x16, row) x b (16x8, col): bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) x b (8x8, col): the k8 shape, bf16 since sm_80
__device__ __forceinline__ void mma_bf16_k8(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Two float32 values as the bf16 pair of an mma operand register, each
// rounded to nearest even (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x as big + small, each a tf32 value (10 mantissa bits, rounded to nearest,
// ties away from zero, as cvt.rna.tf32.f32 rounds a finite x): big = rna(x),
// small = rna(x - big); x - big is exact, so big + small carries 22 of x's
// 24 significant bits.  In bits: add half of the 13 dropped bits, clear
// them (small's are left set: the mma reads a tf32 operand's top 19 bits
// only), the bits cvt.rna.tf32.f32 gives a finite x in four operations,
// where cvt.rna compiles to seven with its Inf and NaN checks.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d = c + a (16x8, row) x b (8x8, col), tf32 operands, float32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a {(g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4)}, b {(t, g), (t + 4, g)}, d {(g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// One k-step of a float32-accurate product (3xTF32): the step's sum
// a_small b_big + a_big b_small, then + a_big b_big, formed from zero (the
// tensor cores truncate each mma's sum, so a step's truncation is one ulp
// of its own 8-term partial, not of the running sum), then added into acc
// with a float32 add (round to nearest).
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float t[4], u[4];
  mma_tf32(t, as, bb, zero);
  mma_tf32(u, ab, bs, t);
  mma_tf32(t, ab, bb, u);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

}  // namespace ppoc
