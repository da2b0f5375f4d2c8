// K7: causal episode-masked flash attention, forward and backward.
//
// Replaces ppoc_tpu/ops/pallas_attn.py: `_fwd` -> `_fwd_kernel` (the
// forward), and `_bwd` -> `_bwd_dq_kernel` and `_bwd_dkv_kernel` (the two
// backward kernels).  On q, k, v folded to [BH, T, hd] (row-major), query t
// of a (batch, head) row attends key s iff
//
//   (rel < 0 || s <= t) && rel <= 0 && ep_k[s] == ep_q[t] && s, t < T
//
// with ep_q, ep_k the [B, T] episode ids of the query and key sides (the
// head's batch row is bh / H).  `rel` is the key block's time relation of
// ring attention: -1 every key precedes every query, 0 one window (the
// causal test), +1 nothing is valid.  The forward writes the softmax
// output and the row logsumexp (lse); a row with no valid key gets out 0
// and lse NEG.  The backward recomputes each weight from lse,
// w = exp(s * scale - lse), and takes dsum = rowsum(dout * out) - g_lse
// from the caller: ds = w (dout . v - dsum) scale, dq = sum_s ds k,
// dk = sum_t ds q, dv = sum_t w dout.
//
// What bounds it on the card: at the recall_xl shapes (hd 8, T 1024) the
// inputs are a few MB, so the bound is the FP32 operations over the valid
// pairs of the causal triangle (about 4 hd flops a pair forward, 6 hd for
// dq, 8 hd for dk/dv).  This first kernel runs them as scalar FP32 in
// registers, not on the tensor cores.
//
// What the design does about it: each thread owns one row (or, for hd 32
// and 64, a group of 2 or 4 neighbouring lanes owns one row, each lane
// holding every TPR-th dimension, and the dot products are summed with
// warp shuffles), so the row's q, accumulators and statistics live in
// registers and nothing of the [T, T] score plane is ever stored.  One
// block takes 64 rows: the forward and dq one query tile, looping over the
// key tiles up to the tile's causal bound; dk/dv one key tile, looping
// over the query tiles from the first that can see it.  The other side's
// tile is staged in shared memory, where every row reads the same address
// (a broadcast).  The forward's online softmax rescales once per 16 keys.
// Every launch writes each output element from one thread, in a fixed
// order, so results are the same bit for bit from call to call.
//
// The bf16 variant (`ppoc_flash_*_bf16`, pallas_attn.flash_mha with
// compute_dtype=bfloat16) is the same three bodies on another element type
// E of q, k, v and dout: they are read, and staged in shared memory, as
// bf16, half the f32 staging.  Every score and sum stays f32 (a bf16 x bf16
// product is exact in f32).  The roundings sit where the Pallas kernel's
// casts do: p to bf16 for the P.V sum only, l summing the unrounded p
// (pallas_attn.py:151); ds to bf16 for dq = ds.k (:245); dst and wt to bf16
// for dk = ds.q and dv = w.dout (:296-299); dq, dk and dv written as bf16
// (:253, :312-313).  dsum comes from the f32 cotangent before it is rounded
// (:326-330), computed by the caller.  Rounding is to nearest even
// (__float2bfloat16_rn).  With E = float every rounding is the identity, so
// the f32 variant's arithmetic is unchanged.  Its bound is the bf16
// tensor-core peak or the bf16 bytes; this first variant still runs scalar
// FP32 arithmetic on the loaded values (hd 8 is half of one mma.sync k16
// step), so it is no faster than the f32 one.
#include <climits>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float NEG = -1e9f;   // pallas_attn.NEG
constexpr int ROWS = 64;       // query (or key) rows per block
constexpr int TILE = 64;       // rows of the other side per shared tile
constexpr int CHUNK = 16;      // keys per online-softmax rescale

using bf16 = __nv_bfloat16;

// loads of the element type, as f32
__device__ __forceinline__ float ld(float x) { return x; }
__device__ __forceinline__ float ld(bf16 x) { return __bfloat162float(x); }

// an f32 value as the element type, rounded to nearest even
template <typename E>
__device__ __forceinline__ E to_e(float x);
template <>
__device__ __forceinline__ float to_e<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 to_e<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// an operand of a P.V or dS.K/Q product: rounded to E, carried in f32
template <typename E>
__device__ __forceinline__ float rnd(float x) { return ld(to_e<E>(x)); }

template <int HD>
struct Shape {
  static constexpr int TPR = HD <= 16 ? 1 : HD / 16;   // lanes per row
  static constexpr int DPT = HD / TPR;                  // dims per lane
  static constexpr int THREADS = ROWS * TPR;
};

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copies rows [r0, r0 + TILE) of a [T, HD] matrix into `dst`, zeros past T.
template <int HD, typename E>
__device__ __forceinline__ void load_tile(E (*dst)[HD],
                                          const E* __restrict__ src,
                                          int r0, int T) {
  for (int i = threadIdx.x; i < TILE * HD; i += blockDim.x) {
    const int r = i / HD, d = i % HD;
    dst[r][d] = r0 + r < T ? src[(size_t)(r0 + r) * HD + d] : to_e<E>(0.0f);
  }
}

template <int HD, typename E>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
flash_fwd(const E* __restrict__ q, const E* __restrict__ k,
          const E* __restrict__ v, const int* __restrict__ ep_q,
          const int* __restrict__ ep_k, float* __restrict__ out,
          float* __restrict__ lse, int H, int T, int rel, float scale) {
  constexpr int TPR = Shape<HD>::TPR, DPT = Shape<HD>::DPT;
  __shared__ E ks[TILE][HD];
  __shared__ E vs[TILE][HD];
  __shared__ int eks[TILE];
  const int bh = blockIdx.y, b = bh / H;
  const int row = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int t = blockIdx.x * ROWS + row;
  const bool live = t < T;
  const E* qb = q + (size_t)bh * T * HD;
  const E* kb = k + (size_t)bh * T * HD;
  const E* vb = v + (size_t)bh * T * HD;
  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = live ? ld(qb[(size_t)t * HD + i * TPR + g]) : 0.0f;
    acc[i] = 0.0f;
  }
  const int eq = live ? ep_q[(size_t)b * T + t] : 0;
  float m = NEG, l = 0.0f;
  const int n_keys = rel < 0 ? T : rel == 0 ? min(T, (blockIdx.x + 1) * ROWS)
                                            : 0;
  for (int k0 = 0; k0 < n_keys; k0 += TILE) {
    __syncthreads();   // the previous tile is no longer read
    load_tile<HD>(ks, kb, k0, T);
    load_tile<HD>(vs, vb, k0, T);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x)
      eks[i] = k0 + i < T ? ep_k[(size_t)b * T + k0 + i] : INT_MIN;
    __syncthreads();
    for (int c0 = 0; c0 < TILE; c0 += CHUNK) {
      float sc[CHUNK];
      unsigned ok = 0u;
      float cmax = NEG;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int kk = c0 + j, s = k0 + kk;
        float dot = 0.0f;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          dot = fmaf(qr[i], ld(ks[kk][i * TPR + g]), dot);
        dot = group_sum<TPR>(dot);
        const bool valid = live && s < T && (rel < 0 || s <= t) &&
                           eks[kk] == eq;
        sc[j] = valid ? dot * scale : NEG;
        ok |= (valid ? 1u : 0u) << j;
        cmax = fmaxf(cmax, sc[j]);
      }
      const float m2 = fmaxf(m, cmax);
      const float alpha = expf(m - m2);
      float psum = 0.0f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        // invalid lanes add exactly 0: a row with no valid key would
        // otherwise get exp(NEG - NEG) = 1 (pallas_attn.py:143-147)
        const float p = (ok >> j) & 1u ? expf(sc[j] - m2) : 0.0f;
        const float pv = rnd<E>(p);   // the P.V operand; l takes p itself
        psum += p;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc[i] = fmaf(pv, ld(vs[c0 + j][i * TPR + g]), acc[i]);
      }
      l = l * alpha + psum;
      m = m2;
    }
  }
  if (!live) return;
  const float l_safe = l == 0.0f ? 1.0f : l;
  float* ob = out + ((size_t)bh * T + t) * HD;
#pragma unroll
  for (int i = 0; i < DPT; ++i) ob[i * TPR + g] = acc[i] / l_safe;
  if (g == 0) lse[(size_t)bh * T + t] = m + logf(l_safe);
}

template <int HD, typename E>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
flash_bwd_dq(const E* __restrict__ q, const E* __restrict__ k,
             const E* __restrict__ v, const int* __restrict__ ep_q,
             const int* __restrict__ ep_k, const E* __restrict__ dout,
             const float* __restrict__ dsum, const float* __restrict__ lse,
             E* __restrict__ dq, int H, int T, int rel, float scale) {
  constexpr int TPR = Shape<HD>::TPR, DPT = Shape<HD>::DPT;
  __shared__ E ks[TILE][HD];
  __shared__ E vs[TILE][HD];
  __shared__ int eks[TILE];
  const int bh = blockIdx.y, b = bh / H;
  const int row = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int t = blockIdx.x * ROWS + row;
  const bool live = t < T;
  const size_t rows = (size_t)bh * T;
  const E* kb = k + rows * HD;
  const E* vb = v + rows * HD;
  float qr[DPT], dor[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = live ? ld(q[(rows + t) * HD + i * TPR + g]) : 0.0f;
    dor[i] = live ? ld(dout[(rows + t) * HD + i * TPR + g]) : 0.0f;
    acc[i] = 0.0f;
  }
  const int eq = live ? ep_q[(size_t)b * T + t] : 0;
  const float lse_t = live ? lse[rows + t] : 0.0f;
  const float dsum_t = live ? dsum[rows + t] : 0.0f;
  const int n_keys = rel < 0 ? T : rel == 0 ? min(T, (blockIdx.x + 1) * ROWS)
                                            : 0;
  for (int k0 = 0; k0 < n_keys; k0 += TILE) {
    __syncthreads();
    load_tile<HD>(ks, kb, k0, T);
    load_tile<HD>(vs, vb, k0, T);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x)
      eks[i] = k0 + i < T ? ep_k[(size_t)b * T + k0 + i] : INT_MIN;
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TILE; ++kk) {
      const int s = k0 + kk;
      float dot = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dot = fmaf(qr[i], ld(ks[kk][i * TPR + g]), dot);
        dp = fmaf(dor[i], ld(vs[kk][i * TPR + g]), dp);
      }
      dot = group_sum<TPR>(dot);
      dp = group_sum<TPR>(dp);
      const bool valid = live && s < T && (rel < 0 || s <= t) &&
                         eks[kk] == eq;
      const float w = valid ? expf(dot * scale - lse_t) : 0.0f;
      const float ds = rnd<E>(w * (dp - dsum_t) * scale);
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = fmaf(ds, ld(ks[kk][i * TPR + g]), acc[i]);
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < DPT; ++i)
    dq[(rows + t) * HD + i * TPR + g] = to_e<E>(acc[i]);
}

template <int HD, typename E>
__global__ void __launch_bounds__(Shape<HD>::THREADS)
flash_bwd_dkv(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, const int* __restrict__ ep_q,
              const int* __restrict__ ep_k, const E* __restrict__ dout,
              const float* __restrict__ dsum, const float* __restrict__ lse,
              E* __restrict__ dk, E* __restrict__ dv, int H, int T,
              int rel, float scale) {
  constexpr int TPR = Shape<HD>::TPR, DPT = Shape<HD>::DPT;
  __shared__ E qs[TILE][HD];
  __shared__ E dos[TILE][HD];
  __shared__ float lses[TILE];
  __shared__ float dsums[TILE];
  __shared__ int eqs[TILE];
  const int bh = blockIdx.y, b = bh / H;
  const int row = threadIdx.x / TPR, g = threadIdx.x % TPR;
  const int s = blockIdx.x * ROWS + row;       // this thread's key
  const bool live = s < T;
  const size_t rows = (size_t)bh * T;
  const E* qb = q + rows * HD;
  const E* dob = dout + rows * HD;
  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    kr[i] = live ? ld(k[(rows + s) * HD + i * TPR + g]) : 0.0f;
    vr[i] = live ? ld(v[(rows + s) * HD + i * TPR + g]) : 0.0f;
    dka[i] = 0.0f;
    dva[i] = 0.0f;
  }
  const int ek = live ? ep_k[(size_t)b * T + s] : 0;
  // the first query that can see a key of this tile: every query before
  // the block, the tile's first key itself on the diagonal, none after
  const int q_start = rel < 0 ? 0 : rel == 0 ? blockIdx.x * ROWS : T;
  for (int q0 = q_start; q0 < T; q0 += TILE) {
    __syncthreads();
    load_tile<HD>(qs, qb, q0, T);
    load_tile<HD>(dos, dob, q0, T);
    for (int i = threadIdx.x; i < TILE; i += blockDim.x) {
      const bool in = q0 + i < T;
      lses[i] = in ? lse[rows + q0 + i] : 0.0f;
      dsums[i] = in ? dsum[rows + q0 + i] : 0.0f;
      eqs[i] = in ? ep_q[(size_t)b * T + q0 + i] : INT_MIN;
    }
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < TILE; ++qq) {
      const int t = q0 + qq;
      float dot = 0.0f, dp = 0.0f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dot = fmaf(kr[i], ld(qs[qq][i * TPR + g]), dot);
        dp = fmaf(vr[i], ld(dos[qq][i * TPR + g]), dp);
      }
      dot = group_sum<TPR>(dot);
      dp = group_sum<TPR>(dp);
      const bool valid = live && t < T && (rel < 0 || s <= t) &&
                         eqs[qq] == ek;
      const float w = valid ? expf(dot * scale - lses[qq]) : 0.0f;
      const float ds = rnd<E>(w * (dp - dsums[qq]) * scale);
      const float wr = rnd<E>(w);
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dka[i] = fmaf(ds, ld(qs[qq][i * TPR + g]), dka[i]);
        dva[i] = fmaf(wr, ld(dos[qq][i * TPR + g]), dva[i]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    dk[(rows + s) * HD + i * TPR + g] = to_e<E>(dka[i]);
    dv[(rows + s) * HD + i * TPR + g] = to_e<E>(dva[i]);
  }
}

template <int HD, typename E>
int launch_fwd(const E* q, const E* k, const E* v, const int* ep_q,
               const int* ep_k, float* out, float* lse, int BH, int H, int T,
               int rel, float scale, cudaStream_t stream) {
  const dim3 grid((T + ROWS - 1) / ROWS, BH);
  flash_fwd<HD, E><<<grid, Shape<HD>::THREADS, 0, stream>>>(
      q, k, v, ep_q, ep_k, out, lse, H, T, rel, scale);
  return (int)cudaGetLastError();
}

template <int HD, typename E>
int launch_dq(const E* q, const E* k, const E* v, const int* ep_q,
              const int* ep_k, const E* dout, const float* dsum,
              const float* lse, E* dq, int BH, int H, int T, int rel,
              float scale, cudaStream_t stream) {
  const dim3 grid((T + ROWS - 1) / ROWS, BH);
  flash_bwd_dq<HD, E><<<grid, Shape<HD>::THREADS, 0, stream>>>(
      q, k, v, ep_q, ep_k, dout, dsum, lse, dq, H, T, rel, scale);
  return (int)cudaGetLastError();
}

template <int HD, typename E>
int launch_dkv(const E* q, const E* k, const E* v, const int* ep_q,
               const int* ep_k, const E* dout, const float* dsum,
               const float* lse, E* dk, E* dv, int BH, int H, int T, int rel,
               float scale, cudaStream_t stream) {
  const dim3 grid((T + ROWS - 1) / ROWS, BH);
  flash_bwd_dkv<HD, E><<<grid, Shape<HD>::THREADS, 0, stream>>>(
      q, k, v, ep_q, ep_k, dout, dsum, lse, dk, dv, H, T, rel, scale);
  return (int)cudaGetLastError();
}

#define PPOC_HD_SWITCH(hd, CALL)          \
  switch (hd) {                           \
    case 8: return CALL(8);               \
    case 16: return CALL(16);             \
    case 32: return CALL(32);             \
    case 64: return CALL(64);             \
    default: return (int)cudaErrorInvalidValue; \
  }

template <typename E>
int flash_fwd_entry(const E* q, const E* k, const E* v, const int* ep_q,
                    const int* ep_k, float* out, float* lse, int BH, int H,
                    int T, int hd, int rel, float scale, void* stream) {
  if (BH < 1 || H < 1 || T < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
#define CALL(HD) launch_fwd<HD, E>(q, k, v, ep_q, ep_k, out, lse, BH, H, T, \
                                   rel, scale, (cudaStream_t)stream)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

template <typename E>
int flash_dq_entry(const E* q, const E* k, const E* v, const int* ep_q,
                   const int* ep_k, const E* dout, const float* dsum,
                   const float* lse, E* dq, int BH, int H, int T, int hd,
                   int rel, float scale, void* stream) {
  if (BH < 1 || H < 1 || T < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
#define CALL(HD) launch_dq<HD, E>(q, k, v, ep_q, ep_k, dout, dsum, lse, dq, \
                                  BH, H, T, rel, scale, (cudaStream_t)stream)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

template <typename E>
int flash_dkv_entry(const E* q, const E* k, const E* v, const int* ep_q,
                    const int* ep_k, const E* dout, const float* dsum,
                    const float* lse, E* dk, E* dv, int BH, int H, int T,
                    int hd, int rel, float scale, void* stream) {
  if (BH < 1 || H < 1 || T < 1 || BH > 65535) return (int)cudaErrorInvalidValue;
#define CALL(HD) launch_dkv<HD, E>(q, k, v, ep_q, ep_k, dout, dsum, lse, dk, \
                                   dv, BH, H, T, rel, scale,                 \
                                   (cudaStream_t)stream)
  PPOC_HD_SWITCH(hd, CALL)
#undef CALL
}

}  // namespace

// f32 q, k, v, dout and gradients
extern "C" int ppoc_flash_fwd(const float* q, const float* k, const float* v,
                              const int* ep_q, const int* ep_k, float* out,
                              float* lse, int BH, int H, int T, int hd,
                              int rel, float scale, void* stream) {
  return flash_fwd_entry(q, k, v, ep_q, ep_k, out, lse, BH, H, T, hd, rel,
                         scale, stream);
}

extern "C" int ppoc_flash_bwd_dq(const float* q, const float* k,
                                 const float* v, const int* ep_q,
                                 const int* ep_k, const float* dout,
                                 const float* dsum, const float* lse,
                                 float* dq, int BH, int H, int T, int hd,
                                 int rel, float scale, void* stream) {
  return flash_dq_entry(q, k, v, ep_q, ep_k, dout, dsum, lse, dq, BH, H, T,
                        hd, rel, scale, stream);
}

extern "C" int ppoc_flash_bwd_dkv(const float* q, const float* k,
                                  const float* v, const int* ep_q,
                                  const int* ep_k, const float* dout,
                                  const float* dsum, const float* lse,
                                  float* dk, float* dv, int BH, int H, int T,
                                  int hd, int rel, float scale,
                                  void* stream) {
  return flash_dkv_entry(q, k, v, ep_q, ep_k, dout, dsum, lse, dk, dv, BH, H,
                         T, hd, rel, scale, stream);
}

// bf16 q, k, v, dout and gradients (out, lse, dsum stay f32)
extern "C" int ppoc_flash_fwd_bf16(const bf16* q, const bf16* k,
                                   const bf16* v, const int* ep_q,
                                   const int* ep_k, float* out, float* lse,
                                   int BH, int H, int T, int hd, int rel,
                                   float scale, void* stream) {
  return flash_fwd_entry(q, k, v, ep_q, ep_k, out, lse, BH, H, T, hd, rel,
                         scale, stream);
}

extern "C" int ppoc_flash_bwd_dq_bf16(const bf16* q, const bf16* k,
                                      const bf16* v, const int* ep_q,
                                      const int* ep_k, const bf16* dout,
                                      const float* dsum, const float* lse,
                                      bf16* dq, int BH, int H, int T, int hd,
                                      int rel, float scale, void* stream) {
  return flash_dq_entry(q, k, v, ep_q, ep_k, dout, dsum, lse, dq, BH, H, T,
                        hd, rel, scale, stream);
}

extern "C" int ppoc_flash_bwd_dkv_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, const int* ep_q,
                                       const int* ep_k, const bf16* dout,
                                       const float* dsum, const float* lse,
                                       bf16* dk, bf16* dv, int BH, int H,
                                       int T, int hd, int rel, float scale,
                                       void* stream) {
  return flash_dkv_entry(q, k, v, ep_q, ep_k, dout, dsum, lse, dk, dv, BH, H,
                         T, hd, rel, scale, stream);
}
