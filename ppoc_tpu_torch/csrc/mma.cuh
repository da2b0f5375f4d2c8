// Warp-level bf16 tensor-core products (sm_80 and later): ldmatrix loads of
// 8x8 b16 tiles from shared memory and mma.sync with float32 accumulators.
// Shared by K3 bf16 / K4 bf16 (update_bf16.cu) and K7 bf16 (attn.cu).
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

}  // namespace ppoc
