// Hopper's warpgroup products, mbarriers and bulk copies (sm_90a), for
// K3 bf16 / K4 bf16 (update_bf16.cu) and whoever reuses them.  Inline PTX
// only (no CuTe: the build stays seconds long).
//
// Shared-memory images.  Every matrix a product reads is kept in the one
// image that `wgmma` reads with the 128-byte swizzle: the matrix's columns
// in blocks of 64 (128 bytes of bf16), each block `rows` x 128 bytes, row r
// at r * 128, its 16-byte chunk c at (c ^ (r % 8)) * 16 (`sw128`).  The
// same image serves as a K-major operand (rows = M or N, columns = K) and,
// through the descriptor's transpose bit, as an MN-major one (rows = K,
// columns = M or N): an activation [rows][width] is the forward's A
// (K-major) and dW's A^T or B (MN-major); W [in][out] is the forward's B
// (MN-major: K = in, N = out) and dX's B^T (K-major: N = in, K = out).
// Images start on 1024-byte boundaries (the swizzle's period), so the
// descriptors' base offset is 0.  A matrix 16 columns wide (the policy or
// value head's outputs, padded) takes the 32-byte swizzle instead: rows of
// 32 bytes, 8-row groups of 256 (the period), as a K-major operand of one
// k-step or an MN-major one of N = 16.
//
// Descriptors (`desc`): start address >> 4 in bits 0-13, the leading byte
// offset >> 4 in 16-29, the stride byte offset >> 4 in 32-45, the swizzle
// (1: 128 bytes) in 62-63.  K-major: SBO = 1024 (the next 8 rows), LBO
// unused; a k-step of 16 adds 32 bytes to the start (within a 64-column
// block) or moves to the next block.  MN-major: SBO = 1024 (the next 8 rows
// of K), LBO = the stride between 64-column blocks along M or N; a k-step
// of 16 adds 16 rows, 2048 bytes.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ppoc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of element (row, col) in a 64-column block of an image
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// byte offset of element (row, col) of an image of 16 columns (32-byte
// rows) in the 32-byte swizzle: 16-byte chunk c at (c ^ (row / 4 % 2)) * 16
__device__ __forceinline__ int sw32(int row, int col) {
  return row * 32 + ((((col >> 3) ^ (row >> 2)) & 1) << 4) + (col & 7) * 2;
}

// a descriptor of the image at shared address `addr` in the 128-byte
// swizzle (`swizzle` 1) or the 32-byte one (3: rows of 16 bf16, SBO = 256)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swizzle = 1) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int NA>
__device__ __forceinline__ void fence_acc(float (&d)[NA]) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// this thread's generic-proxy shared-memory writes, before products or
// bulk copies (the async proxy) read them
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// every state space: global writes of other threads, acquired by a
// barrier, before this thread's bulk copies read them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// a barrier of `count` threads (a multiple of 32) on hardware barrier `id`
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// --- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// spins until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra.uni WAIT;\n}\n" ::"r"(a), "r"(parity) : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, completed
// on `bar`'s transaction count
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// --- thread-block clusters ------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_size() {
  int n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// arrive on the barrier at `addr`, a shared::cluster address (mapa) that
// may lie in another block of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(addr) : "memory");
}
// bulk_g2s into the same offset of every block of the cluster in `mask`,
// each completing on its own barrier at `bar`'s offset
__device__ __forceinline__ void bulk_g2s_multicast(void* dst, const void* src,
                                                   uint32_t bytes,
                                                   uint64_t* bar,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask) : "memory");
}

// --- wgmma.mma_async m64nNk16, bf16 operands, float32 accumulators ---------
// d[O .. O + N/2) += A (64 x 16) B (16 x N); TA / TB: the operand is
// MN-major (read through the transpose bit).  scale_d 0 ignores d's input.
// Fragment of thread t of the warpgroup (w = t / 32, l = t % 32): d[O + 4j
// + e] is row 16 w + l / 4 + 8 (e / 2), column 8 j + 2 (l % 4) + e % 2.

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  template <int TA, int TB, int O, int NA>
  static __device__ __forceinline__ void run(float (&d)[NA], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(O + 8 <= NA, "accumulators out of range");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7"
        "}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  template <int TA, int TB, int O, int NA>
  static __device__ __forceinline__ void run(float (&d)[NA], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(O + 32 <= NA, "accumulators out of range");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
          "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
          "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
          "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TA, int TB, int O, int NA>
  static __device__ __forceinline__ void run(float (&d)[NA], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(O + 64 <= NA, "accumulators out of range");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
          "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
          "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
          "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
          "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]), "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
          "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
          "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
          "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]), "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  template <int TA, int TB, int O, int NA>
  static __device__ __forceinline__ void run(float (&d)[NA], uint64_t a,
                                             uint64_t b, int scale_d) {
    static_assert(O + 128 <= NA, "accumulators out of range");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,"
        "%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,"
        "%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[O + 0]), "+f"(d[O + 1]), "+f"(d[O + 2]), "+f"(d[O + 3]), "+f"(d[O + 4]), "+f"(d[O + 5]), "+f"(d[O + 6]), "+f"(d[O + 7]),
          "+f"(d[O + 8]), "+f"(d[O + 9]), "+f"(d[O + 10]), "+f"(d[O + 11]), "+f"(d[O + 12]), "+f"(d[O + 13]), "+f"(d[O + 14]), "+f"(d[O + 15]),
          "+f"(d[O + 16]), "+f"(d[O + 17]), "+f"(d[O + 18]), "+f"(d[O + 19]), "+f"(d[O + 20]), "+f"(d[O + 21]), "+f"(d[O + 22]), "+f"(d[O + 23]),
          "+f"(d[O + 24]), "+f"(d[O + 25]), "+f"(d[O + 26]), "+f"(d[O + 27]), "+f"(d[O + 28]), "+f"(d[O + 29]), "+f"(d[O + 30]), "+f"(d[O + 31]),
          "+f"(d[O + 32]), "+f"(d[O + 33]), "+f"(d[O + 34]), "+f"(d[O + 35]), "+f"(d[O + 36]), "+f"(d[O + 37]), "+f"(d[O + 38]), "+f"(d[O + 39]),
          "+f"(d[O + 40]), "+f"(d[O + 41]), "+f"(d[O + 42]), "+f"(d[O + 43]), "+f"(d[O + 44]), "+f"(d[O + 45]), "+f"(d[O + 46]), "+f"(d[O + 47]),
          "+f"(d[O + 48]), "+f"(d[O + 49]), "+f"(d[O + 50]), "+f"(d[O + 51]), "+f"(d[O + 52]), "+f"(d[O + 53]), "+f"(d[O + 54]), "+f"(d[O + 55]),
          "+f"(d[O + 56]), "+f"(d[O + 57]), "+f"(d[O + 58]), "+f"(d[O + 59]), "+f"(d[O + 60]), "+f"(d[O + 61]), "+f"(d[O + 62]), "+f"(d[O + 63]),
          "+f"(d[O + 64]), "+f"(d[O + 65]), "+f"(d[O + 66]), "+f"(d[O + 67]), "+f"(d[O + 68]), "+f"(d[O + 69]), "+f"(d[O + 70]), "+f"(d[O + 71]),
          "+f"(d[O + 72]), "+f"(d[O + 73]), "+f"(d[O + 74]), "+f"(d[O + 75]), "+f"(d[O + 76]), "+f"(d[O + 77]), "+f"(d[O + 78]), "+f"(d[O + 79]),
          "+f"(d[O + 80]), "+f"(d[O + 81]), "+f"(d[O + 82]), "+f"(d[O + 83]), "+f"(d[O + 84]), "+f"(d[O + 85]), "+f"(d[O + 86]), "+f"(d[O + 87]),
          "+f"(d[O + 88]), "+f"(d[O + 89]), "+f"(d[O + 90]), "+f"(d[O + 91]), "+f"(d[O + 92]), "+f"(d[O + 93]), "+f"(d[O + 94]), "+f"(d[O + 95]),
          "+f"(d[O + 96]), "+f"(d[O + 97]), "+f"(d[O + 98]), "+f"(d[O + 99]), "+f"(d[O + 100]), "+f"(d[O + 101]), "+f"(d[O + 102]), "+f"(d[O + 103]),
          "+f"(d[O + 104]), "+f"(d[O + 105]), "+f"(d[O + 106]), "+f"(d[O + 107]), "+f"(d[O + 108]), "+f"(d[O + 109]), "+f"(d[O + 110]), "+f"(d[O + 111]),
          "+f"(d[O + 112]), "+f"(d[O + 113]), "+f"(d[O + 114]), "+f"(d[O + 115]), "+f"(d[O + 116]), "+f"(d[O + 117]), "+f"(d[O + 118]), "+f"(d[O + 119]),
          "+f"(d[O + 120]), "+f"(d[O + 121]), "+f"(d[O + 122]), "+f"(d[O + 123]), "+f"(d[O + 124]), "+f"(d[O + 125]), "+f"(d[O + 126]), "+f"(d[O + 127])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
};

// One k-step over NC (64, 128, 192 or 256) output columns: one chain, or
// n128 then n64 for 192 (B's descriptor moved on two 64-column blocks,
// `b_step2` in descriptor units).
template <int NC, int TA, int TB, int NA>
__device__ __forceinline__ void wgmma_nc(float (&d)[NA], uint64_t a,
                                         uint64_t b, uint64_t b_step2,
                                         int scale_d) {
  if constexpr (NC == 192) {
    Wgmma<128>::run<TA, TB, 0>(d, a, b, scale_d);
    Wgmma<64>::run<TA, TB, 64>(d, a, b + b_step2, scale_d);
  } else {
    Wgmma<NC>::template run<TA, TB, 0>(d, a, b, scale_d);
  }
}

}  // namespace ppoc
