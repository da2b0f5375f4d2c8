// K3 bf16 and K4 bf16: the large-minibatch (throughput) value and Gaussian
// policy phases, every epoch x minibatch step in one cooperative launch.
//
// Replaces ppoc_tpu/ops/pallas_update.py `value_phase_fused(..., bf16=True)`
// -> `_run_value_phase` -> `_value_kernel(..., bf16=True)` (K3 bf16) and
// `policy_phase_fused(..., bf16=True)` -> `_policy_kernel(..., bf16=True)`
// (K4 bf16).  What they compute per step: every product on bf16 operands
// with float32 accumulation (each layer's input and W rounded to bf16); the
// hidden post-activations stored rounded to bf16, the last layer's output
// float32; the loss gradient in float32 as K3/K4 take it; backward with the
// cotangent rounded to bf16 before both dW = a_in^T g and dX = g W^T, the
// activation derivative from the bf16-stored post-activation, db summed from
// the float32 cotangent; float32 gradient sums, then Adam on float32 master
// weights and moments (K4: and log_std's own Adam).
//
// What bounds it on the card: operations.  A step of the reacher regime's
// value phase is 6 x 16384 rows x 68,352 multiply-adds, 6.7 GFLOP, and the
// phase 370 of them (2.49 TFLOP); one SM at the one-block kernels' rate
// (update.cu) would take tens of seconds.  The steps are serial through
// Adam, so the work of each step has to be spread over the card.
//
// What the design does about it: one persistent cooperative grid over all
// SMs (its size from the occupancy query; a grid that does not fit at once
// is refused, never shrunk).  Each block owns R rows of the minibatch (R =
// 128 where shared memory allows; it loops if the minibatch has more tiles
// than the grid has blocks) and per step runs, on its rows and out of
// shared memory, the forward, the loss gradient and the backward, with
// warp-level mma.sync.m16n8k16 (bf16 operands, float32 accumulators) fed by
// ldmatrix; it writes its partial dW/db to a global scratch.  A grid-wide
// barrier; then each block sums a fixed slice of the parameters over the
// blocks' partials in block order and runs Adam on it, writing the float32
// master weight and a bf16 shadow of W; a second barrier; the next step.
// No launch happens between steps, and every sum is taken in a fixed order,
// so two launches on the same inputs give the same bits, and so does a
// phase split over two launches (t0 carried).
//
// Layouts.  Shared memory holds the block's bf16 activations per layer,
// [R][wp + 8] (wp = the width rounded up to 16; the 8-element pad puts the
// 8 rows of an ldmatrix on distinct banks), the output and its float32
// cotangent, and a staging slice of W: the forward stages KS rows of W
// ([KS][wp_out + 8], read with ldmatrix.trans), dX stages KS columns
// ([wp_in][KS + 8], read with ldmatrix).  dW reads both operands from the
// activations with ldmatrix.trans.  The cotangent of a hidden layer is
// written in place over that layer's post-activations once dW has read
// them.  The weights come from the bf16 shadow in the padded layout
// [wp_in][wp_out] (zeros in the padding), which Adam rewrites every step:
// everything that another block wrote during the launch is read with
// ld.global.cg (__ldcg, at L2), never through L1 or the read-only cache.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "mlp_step.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;
using namespace ppoc;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MT = 8;               // m-tiles (16 rows each) of a warp's unit
constexpr int MAX_ROWS = MT * 16;   // rows per block, at most
constexpr int MAX_WIDTH = 512;      // widest layer taken
constexpr int KS = 64;              // K rows per staged slice of W
constexpr int PAD = 8;              // bf16 pad of every shared-memory row
constexpr int STAT = 16;            // floats of one block's step statistics
constexpr int STATIC_SMEM = 1024;   // the kernel's static shared memory, rounded up

__host__ __device__ inline int pad16(int n) { return (n + 15) & ~15; }

struct Layout {
  Net net;
  int wp[MAX_LAYERS + 1];        // widths rounded up to 16
  int sh_off[MAX_LAYERS + 1];    // W_l in the bf16 shadow, [wp_l][wp_l+1]
  int act_off[MAX_LAYERS];       // bytes: layer l's input [R][wp_l + PAD] bf16
  int gl_off, out_off, stage_off;   // bytes: g_L bf16, out / g_L float32, W slice
  int smem;                      // dynamic shared memory, bytes
  int rows;                      // R
};

// The layout for R rows; false if the net is out of range.
inline bool make_layout(Layout* L, int n_layers, const int* dims, int rows) {
  if (!make_net(&L->net, n_layers, dims)) return false;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] > MAX_WIDTH) return false;
    L->wp[l] = pad16(dims[l]);
  }
  int sh = 0, off = 0, stage = 0;
  for (int l = 0; l < n_layers; ++l) {
    L->sh_off[l] = sh;
    sh += L->wp[l] * L->wp[l + 1];
    L->act_off[l] = off;
    off += rows * (L->wp[l] + PAD) * 2;
    const int kf = L->wp[l] < KS ? L->wp[l] : KS;
    const int fwd = kf * (L->wp[l + 1] + PAD);
    const int kb = L->wp[l + 1] < KS ? L->wp[l + 1] : KS;
    const int bwd = l > 0 ? L->wp[l] * (kb + PAD) : 0;
    stage = fwd > stage ? fwd : stage;
    stage = bwd > stage ? bwd : stage;
  }
  L->sh_off[n_layers] = sh;
  const int wl = L->wp[n_layers];
  L->gl_off = off;
  off += rows * (wl + PAD) * 2;
  L->out_off = off;
  off += rows * wl * 4;
  L->stage_off = off;
  off += stage * 2;
  L->smem = off;
  L->rows = rows;
  return true;
}

struct Bf16Dev {
  Layout lay;
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p, *m, *v;
  const float *ls_in, *mls_in, *vls_in;
  float *ls, *mls, *vls;
  float *partial, *bstats, *stats;
  bf16* shadow;
  int activation, n_steps, mb, t0, t0_ls, k_act;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

// --- warp-level products (ldmatrix, mma.sync: mma.cuh) ----------------

typedef float Acc[MT][2][4];   // a warp's unit: up to 8 m-tiles x 2 n-tiles

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
}

// One k-step of 16 over `mtiles` m-tiles and two n-tiles.  `a` is this
// lane's ldmatrix address of m-tile 0 (m-tile i at a + i * a_step), `b`
// its address of the B operand, which one ldmatrix.x4 gives as (b0, b1) of
// n-tile 0 and of n-tile 1.  A_T / B_T: read through ldmatrix.trans.
template <bool A_T, bool B_T>
__device__ __forceinline__ void kstep(Acc& acc, int mtiles, const bf16* a,
                                      int a_step, const bf16* b) {
  uint32_t bf[4];
  if (B_T) ldsm_x4_t(bf, b); else ldsm_x4(bf, b);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    if (i < mtiles) {
      uint32_t af[4];
      if (A_T) ldsm_x4_t(af, a + i * a_step); else ldsm_x4(af, a + i * a_step);
      mma_bf16(acc[i][0], af, bf[0], bf[1]);
      mma_bf16(acc[i][1], af, bf[2], bf[3]);
    }
  }
}

// This lane's ldmatrix addresses.  Row-major A [m][k] read as is: rows
// lane % 16, k half lane / 16.  A stored [k][m] read transposed (dW's
// a_in^T): k rows lane % 8 (+8 for lanes 16-31), m half (lane / 8) % 2.
// B stored [k][n] read transposed (the forward's W, dW's g): k rows lane % 8
// (+8 for lanes 8-15, 24-31), n half lane / 16.  B stored [n][k] read as is
// (dX's W): n rows lane % 8 (+8 for lanes 16-31), k half (lane / 8) % 2.
__device__ __forceinline__ const bf16* lane_a(const bf16* A, int ld, int m0,
                                              int k0, int lane) {
  return A + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* lane_at(const bf16* A, int ld, int m0,
                                               int k0, int lane) {
  return A + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * ld + m0 +
         ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ const bf16* lane_bt(const bf16* B, int ld, int n0,
                                               int k0, int lane) {
  return B + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* lane_b(const bf16* B, int ld, int n0,
                                              int k0, int lane) {
  return B + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}

// --- the block's view of shared memory -----------------------------------

struct Smem {
  unsigned char* base;
  const Layout* L;
  __device__ bf16* act(int l) const { return (bf16*)(base + L->act_off[l]); }
  __device__ int ld_act(int l) const { return L->wp[l] + PAD; }
  __device__ bf16* gl() const { return (bf16*)(base + L->gl_off); }
  __device__ float* out() const { return (float*)(base + L->out_off); }
  __device__ bf16* stage() const { return (bf16*)(base + L->stage_off); }
  // layer l's cotangent (bf16): g_L for the last layer, else written over
  // the post-activations of layer l, which are layer l+1's input
  __device__ bf16* cot(int l) const {
    return l == L->net.n_layers - 1 ? gl() : act(l + 1);
  }
  __device__ int ld_cot(int l) const {
    return l == L->net.n_layers - 1 ? L->wp[l + 1] + PAD : ld_act(l + 1);
  }
};

// partial[idx] of this block: written on its first row tile, added after
__device__ __forceinline__ void put(float* part, int idx, float v, bool first) {
  part[idx] = first ? v : part[idx] + v;
}

// Forward of layer l on the block's R rows: out = act(in W + b) rounded to
// bf16 into the next layer's input, or (last layer) in float32 into out.
// W's rows are staged KS at a time.  Ends with __syncthreads.
__device__ void forward_layer(const Bf16Dev& a, const Smem& sm, int l) {
  const Layout& L = a.lay;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int K = L.wp[l], N = L.wp[l + 1], dout = L.net.dim[l + 1];
  const bool last = l == L.net.n_layers - 1;
  const bf16* A = sm.act(l);
  const int lda = sm.ld_act(l);
  bf16* Ws = sm.stage();
  const int ldw = N + PAD;
  const bf16* Wg = a.shadow + L.sh_off[l];
  const float* bias = a.p + L.net.b_off[l];
  const int mt_all = L.rows / 16, n_units = N / 16;
  // a narrow layer splits its rows over the idle warps
  int m_chunks = WARPS / n_units;
  m_chunks = m_chunks < 1 ? 1 : (m_chunks > mt_all ? mt_all : m_chunks);
  const int mt_per = (mt_all + m_chunks - 1) / m_chunks;
  const int units = n_units * m_chunks;
  for (int base = 0; base < units; base += WARPS) {
    const int u = base + warp;
    const bool own = u < units;
    const int n0 = (u % n_units) * 16, m0 = (u / n_units) * mt_per * 16;
    const int mtiles = own ? min(mt_per, mt_all - m0 / 16) : 0;
    Acc acc;
    zero(acc);
    for (int k0 = 0; k0 < K; k0 += KS) {
      const int kn = min(KS, K - k0), vec = N / 8;
      __syncthreads();   // the previous slice's reads are done
      for (int e = threadIdx.x; e < kn * vec; e += THREADS) {
        const int kk = e / vec, c = (e - kk * vec) * 8;
        *reinterpret_cast<uint4*>(Ws + kk * ldw + c) = __ldcg(
            reinterpret_cast<const uint4*>(Wg + (size_t)(k0 + kk) * N + c));
      }
      __syncthreads();
      if (mtiles > 0)
        for (int kk = 0; kk < kn; kk += 16)
          kstep<false, true>(acc, mtiles, lane_a(A, lda, m0, k0 + kk, lane),
                             16 * lda, lane_bt(Ws, ldw, n0, kk, lane));
    }
    if (mtiles > 0) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = n0 + nt * 8 + 2 * t4;
        const float b0 = c < dout ? __ldcg(bias + c) : 0.0f;
        const float b1 = c + 1 < dout ? __ldcg(bias + c + 1) : 0.0f;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i >= mtiles) continue;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + i * 16 + g + 8 * h;
            const float v0 = acc[i][nt][2 * h] + b0;
            const float v1 = acc[i][nt][2 * h + 1] + b1;
            if (last) {
              float* o = sm.out() + r * N + c;
              o[0] = c < dout ? v0 : 0.0f;
              o[1] = c + 1 < dout ? v1 : 0.0f;
            } else {
              *reinterpret_cast<__nv_bfloat162*>(sm.act(l + 1) +
                                                 r * sm.ld_act(l + 1) + c) =
                  __floats2bfloat162_rn(
                      c < dout ? act_fwd(v0, a.activation) : 0.0f,
                      c + 1 < dout ? act_fwd(v1, a.activation) : 0.0f);
            }
          }
        }
      }
    }
  }
  __syncthreads();
}

// dW_l = a_in^T g over the block's first `kr` rows (a multiple of 16; the
// rows past the tile's hold g = 0) into the block's partials.
__device__ void dw_layer(const Bf16Dev& a, const Smem& sm, int l, int kr,
                         float* part, bool first) {
  const Layout& L = a.lay;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int M = L.wp[l], N = L.wp[l + 1];
  const int din = L.net.dim[l], dout = L.net.dim[l + 1];
  const bf16* A = sm.act(l);
  const bf16* C = sm.cot(l);
  const int lda = sm.ld_act(l), ldc = sm.ld_cot(l);
  const int n_units = N / 16, m_chunks = (M + MAX_ROWS - 1) / MAX_ROWS;
  for (int u = warp; u < n_units * m_chunks; u += WARPS) {
    const int n0 = (u % n_units) * 16, i0 = (u / n_units) * MAX_ROWS;
    const int mtiles = min(MT, (M - i0) / 16);
    Acc acc;
    zero(acc);
    for (int r0 = 0; r0 < kr; r0 += 16)
      kstep<true, true>(acc, mtiles, lane_at(A, lda, i0, r0, lane), 16,
                        lane_bt(C, ldc, n0, r0, lane));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i >= mtiles) continue;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = i0 + i * 16 + g + 8 * h;
          const int c = n0 + nt * 8 + 2 * t4;
          if (row >= din) continue;
          const int idx = L.net.w_off[l] + row * dout + c;
          if (c < dout) put(part, idx, acc[i][nt][2 * h], first);
          if (c + 1 < dout) put(part, idx + 1, acc[i][nt][2 * h + 1], first);
        }
    }
  }
}

// g_{l-1} = (g_l W_l^T) * act'(h_{l-1}) written in place over h_{l-1} (bf16),
// and db_{l-1}, the column sums of the float32 g_{l-1}, into the partials.
// W_l's columns are staged KS at a time.  Each warp owns all R rows of its
// 16 columns, so a column's sum is the warp's own, in a fixed order.
__device__ void dx_layer(const Bf16Dev& a, const Smem& sm, int l, float* part,
                         bool first) {
  const Layout& L = a.lay;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int K = L.wp[l + 1], N = L.wp[l], din = L.net.dim[l];
  const bf16* C = sm.cot(l);
  const int ldc = sm.ld_cot(l);
  bf16* H = sm.act(l);
  const int ldh = sm.ld_act(l);
  bf16* Ws = sm.stage();
  const int kb = K < KS ? K : KS;
  const int ldw = kb + PAD;
  const bf16* Wg = a.shadow + L.sh_off[l];   // [N][K]
  const int mtiles = L.rows / 16, units = N / 16;
  for (int base = 0; base < units; base += WARPS) {
    const int u = base + warp;
    const bool own = u < units;
    const int n0 = u * 16;
    Acc acc;
    zero(acc);
    for (int j0 = 0; j0 < K; j0 += KS) {
      const int kn = min(KS, K - j0), vec = kn / 8;
      __syncthreads();
      for (int e = threadIdx.x; e < N * vec; e += THREADS) {
        const int i = e / vec, c = (e - i * vec) * 8;
        *reinterpret_cast<uint4*>(Ws + i * ldw + c) = __ldcg(
            reinterpret_cast<const uint4*>(Wg + (size_t)i * K + j0 + c));
      }
      __syncthreads();
      if (own)
        for (int kk = 0; kk < kn; kk += 16)
          kstep<false, false>(acc, mtiles, lane_a(C, ldc, 0, j0 + kk, lane),
                              16 * ldc, lane_b(Ws, ldw, n0, kk, lane));
    }
    if (own) {
      float cs[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mtiles) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = i * 16 + g + 8 * h, c = n0 + nt * 8 + 2 * t4;
            __nv_bfloat162* hp =
                reinterpret_cast<__nv_bfloat162*>(H + r * ldh + c);
            const __nv_bfloat162 hv = *hp;
            const float g0 =
                acc[i][nt][2 * h] * act_grad(__low2float(hv), a.activation);
            const float g1 = acc[i][nt][2 * h + 1] *
                             act_grad(__high2float(hv), a.activation);
            cs[nt][0] += g0;
            cs[nt][1] += g1;
            *hp = __floats2bfloat162_rn(g0, g1);
          }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cs[nt][e] += __shfl_xor_sync(0xffffffffu, cs[nt][e], o);
      if (g == 0)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = n0 + nt * 8 + 2 * t4 + e;
            if (c < din) put(part, L.net.b_off[l - 1] + c, cs[nt][e], first);
          }
    }
  }
  __syncthreads();
}

// The bf16 shadow's element e: W_l[i][j] rounded to bf16, 0 in the padding.
__device__ bf16 shadow_value(const Layout& L, const float* p, int e) {
  int l = 0;
  while (l + 1 < L.net.n_layers && e >= L.sh_off[l + 1]) ++l;
  const int r = e - L.sh_off[l], wpo = L.wp[l + 1];
  const int i = r / wpo, j = r - i * wpo;
  const int dout = L.net.dim[l + 1];
  return __float2bfloat16_rn(i < L.net.dim[l] && j < dout
                                 ? p[L.net.w_off[l] + i * dout + j]
                                 : 0.0f);
}

// The shadow index of flat parameter i, or -1 for a bias.
__device__ int shadow_index(const Layout& L, int i) {
  for (int l = 0; l < L.net.n_layers; ++l) {
    if (i < L.net.b_off[l]) {
      const int r = i - L.net.w_off[l], dout = L.net.dim[l + 1];
      const int row = r / dout;
      return L.sh_off[l] + row * L.wp[l + 1] + (r - row * dout);
    }
    if (i < L.net.b_off[l] + L.net.dim[l + 1]) return -1;
  }
  return -1;
}

template <bool POLICY>
__global__ void __launch_bounds__(THREADS, 1) phase_bf16_kernel(
    const __grid_constant__ Bf16Dev a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[33];
  __shared__ float ls_s[MAX_ACT], inv_sigma_s[MAX_ACT];
  cg::grid_group grid = cg::this_grid();
  const Layout& L = a.lay;
  const Smem sm{smem, &L};
  const int G = gridDim.x, b = blockIdx.x, tid = threadIdx.x;
  const int P = L.net.n_params, n_layers = L.net.n_layers;
  const int d0 = L.net.dim[0], wp0 = L.wp[0], R = L.rows;
  const int wl = L.wp[n_layers], dl = L.net.dim[n_layers], k = a.k_act;
  const int n_tiles = (a.mb + R - 1) / R;
  float* part = a.partial + (size_t)b * P;
  // this block's slice of the parameters for Adam
  const int s0 = (int)((long)P * b / G), s1 = (int)((long)P * (b + 1) / G);

  for (int i = s0 + tid; i < s1; i += THREADS) {
    a.p[i] = a.p_in[i];
    a.m[i] = a.m_in[i];
    a.v[i] = a.v_in[i];
  }
  for (int e = b * THREADS + tid; e < L.sh_off[n_layers]; e += G * THREADS)
    a.shadow[e] = shadow_value(L, a.p_in, e);
  if (POLICY && b == 0 && tid < k) {
    a.ls[tid] = a.ls_in[tid];
    a.mls[tid] = a.mls_in[tid];
    a.vls[tid] = a.vls_in[tid];
  }
  __threadfence();
  grid.sync();

  const float mbf = (float)a.mb;
  float run_loss = 0.0f, run_ent = 0.0f;   // block 0, thread 0
  for (int s = 0; s < a.n_steps; ++s) {
    const size_t step_row = (size_t)s * a.mb;
    float sum_ls = 0.0f;
    if (POLICY) {
      if (tid < k) {
        const float l = __ldcg(a.ls + tid);
        ls_s[tid] = l;
        inv_sigma_s[tid] = expf(-l);
      }
      __syncthreads();
      for (int j = 0; j < k; ++j) sum_ls += ls_s[j];
    }
    float bst[STAT];   // thread 0: this block's statistics over its tiles
    for (int q = 0; q < STAT; ++q) bst[q] = 0.0f;
    bool first = true;
    for (int t = b; t < n_tiles; t += G, first = false) {
      const int r0 = t * R, nrows = min(R, a.mb - r0);
      const size_t row0 = step_row + r0;
      bf16* X = sm.act(0);
      const int ldx = sm.ld_act(0);
      for (int e = tid; e < R * wp0; e += THREADS) {
        const int r = e / wp0, c = e - r * wp0;
        X[r * ldx + c] = __float2bfloat16_rn(
            r < nrows && c < d0 ? __ldg(a.x + (row0 + r) * d0 + c) : 0.0f);
      }
      __syncthreads();
      for (int l = 0; l < n_layers; ++l) forward_layer(a, sm, l);

      // the loss gradient per row, float32 over `out`, bf16 into g_L
      float* out = sm.out();
      bf16* gL = sm.gl();
      const int ldg = wl + PAD;
      float part0 = 0.0f, gls_part[MAX_ACT];
      for (int j = 0; j < MAX_ACT; ++j) gls_part[j] = 0.0f;
      for (int r = tid; r < R; r += THREADS) {
        float gr[MAX_ACT];
        for (int j = 0; j < MAX_ACT; ++j) gr[j] = 0.0f;
        if (r < nrows) {
          const size_t row = row0 + r;
          if (POLICY) {
            float z[MAX_ACT], sumz2 = 0.0f;
            for (int j = 0; j < k; ++j) {
              z[j] = (__ldg(a.act + row * k + j) - out[r * wl + j]) *
                     inv_sigma_s[j];
              sumz2 += z[j] * z[j];
            }
            const float logp = a.lp0 - sum_ls - 0.5f * sumz2;
            const float adv = __ldg(a.adv + row);
            const float ratio = expf(logp - __ldg(a.lp_old + row));
            const float clipped = fminf(fmaxf(ratio, a.clip_lo), a.clip_hi);
            const float ra = ratio * adv, ca = clipped * adv;
            part0 += fminf(ra, ca);
            // only the unclipped branch carries gradient
            const float dlogp = ra <= ca ? -(adv * ratio / mbf) : 0.0f;
            for (int j = 0; j < k; ++j) {
              gls_part[j] += dlogp * (z[j] * z[j] - 1.0f);
              gr[j] = dlogp * z[j] * inv_sigma_s[j];
            }
          } else {
            const float diff = out[r * wl] - __ldg(a.tgt + row);
            part0 += diff * diff;
            gr[0] = a.two_over_mb * diff;
          }
        }
        for (int j = 0; j < wl; ++j) {
          const float v = j < MAX_ACT ? gr[j] : 0.0f;
          out[r * wl + j] = v;
          gL[r * ldg + j] = __float2bfloat16_rn(v);
        }
      }
      const float tot0 = block_sum(part0, red);
      if (tid == 0) bst[0] += tot0;
      if (POLICY)
        for (int j = 0; j < k; ++j) {
          const float tj = block_sum(gls_part[j], red);
          if (tid == 0) bst[1 + j] += tj;
        }
      __syncthreads();
      // db of the last layer from the float32 g_L, rows in order
      if (tid < dl) {
        float sum = 0.0f;
        for (int r = 0; r < R; ++r) sum += out[r * wl + tid];
        put(part, L.net.b_off[n_layers - 1] + tid, sum, first);
      }
      const int kr = (nrows + 15) & ~15;
      for (int l = n_layers - 1; l >= 0; --l) {
        dw_layer(a, sm, l, kr, part, first);
        __syncthreads();   // dW has read h_{l-1}, which dX overwrites
        if (l > 0) dx_layer(a, sm, l, part, first);
      }
    }
    if (tid == 0)
      for (int q = 0; q < STAT; ++q) a.bstats[(size_t)b * STAT + q] = bst[q];
    __threadfence();
    grid.sync();

    // Adam on this block's slice, each gradient summed over the blocks in
    // block order
    const AdamHyper& h = a.hyper;
    {
      const float tf = (float)(a.t0 + s + 1);
      const float bc1 = 1.0f - expf(tf * h.logb1);
      const float bc2 = 1.0f - expf(tf * h.logb2);
      const float step = h.lr / bc1;
      for (int i = s0 + tid; i < s1; i += THREADS) {
        float gsum = 0.0f;
#pragma unroll 16
        for (int q = 0; q < G; ++q) gsum += __ldcg(a.partial + (size_t)q * P + i);
        const float m2 = h.b1 * __ldcg(a.m + i) + h.omb1 * gsum;
        const float v2 = h.b2 * __ldcg(a.v + i) + h.omb2 * (gsum * gsum);
        a.m[i] = m2;
        a.v[i] = v2;
        const float p2 =
            __ldcg(a.p + i) - step * m2 / (sqrtf(v2 / bc2) + h.eps);
        a.p[i] = p2;
        const int si = shadow_index(L, i);
        if (si >= 0) a.shadow[si] = __float2bfloat16_rn(p2);
      }
    }
    if (b == 0 && tid == 0) {
      float tot[STAT];
      for (int q = 0; q < STAT; ++q) tot[q] = 0.0f;
      for (int q = 0; q < G; ++q)
        for (int j = 0; j < STAT; ++j)
          tot[j] += __ldcg(a.bstats + (size_t)q * STAT + j);
      if (POLICY) {
        // closed-form Gaussian entropy of the step's log_std
        const float ent = a.ent0 + sum_ls;
        run_ent += ent;
        run_loss += -a.ent_coeff * ent;
        run_loss += -tot[0] / mbf;
        // log_std Adam (its own timestep); the entropy bonus adds -ent_coeff
        const float tl = (float)(a.t0_ls + s + 1);
        const float bc1 = 1.0f - expf(tl * h.logb1);
        const float bc2 = 1.0f - expf(tl * h.logb2);
        for (int j = 0; j < k; ++j) {
          const float gj = tot[1 + j] - a.ent_coeff;
          const float m2 = h.b1 * a.mls[j] + h.omb1 * gj;
          const float v2 = h.b2 * a.vls[j] + h.omb2 * (gj * gj);
          a.mls[j] = m2;
          a.vls[j] = v2;
          a.ls[j] = ls_s[j] - (h.lr / bc1) * m2 / (sqrtf(v2 / bc2) + h.eps);
        }
      } else {
        run_loss += tot[0];
      }
    }
    __threadfence();
    grid.sync();
  }
  if (b == 0 && tid == 0) {
    a.stats[0] = run_loss;
    if (POLICY) a.stats[1] = run_ent;
  }
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_update.py mirrors it
// field for field.  The value phase leaves the policy fields null, the
// policy phase `tgt`.  `scratch` (scratch_bytes, from ppoc_phase_bf16_plan)
// holds the blocks' partial gradients, their step statistics and the bf16
// shadow of W.
struct Bf16PhaseArgs {
  const float *x, *tgt, *act, *lp_old, *adv;
  const float *p_in, *m_in, *v_in;
  float *p_out, *m_out, *v_out;
  const float *ls_in, *mls_in, *vls_in;
  float *ls_out, *mls_out, *vls_out;
  void* scratch;
  float* stats;
  const int* dims;   // host array of n_layers + 1 widths
  long scratch_bytes;
  int n_layers, activation, n_steps, mb, t0, t0_ls, k_act;
  float two_over_mb, lp0, ent0, clip_lo, clip_hi, ent_coeff;
  AdamHyper hyper;
};

extern "C" int ppoc_phase_bf16_args_size() { return (int)sizeof(Bf16PhaseArgs); }

static void (*bf16_kernel(int policy))(const Bf16Dev) {
  return policy ? phase_bf16_kernel<true> : phase_bf16_kernel<false>;
}

static long align256(long n) { return (n + 255) & ~255L; }

struct Plan {
  Layout lay;
  int grid, occupancy, sms;
  long partial_off, bstats_off, shadow_off, scratch_bytes;
};

// R: the most rows (128, 64, 32 or 16, and no more than the minibatch
// needs) whose shared memory fits one block; the grid: one block per row
// tile, at most as many as fit on the card at once.
static int make_plan(const Bf16PhaseArgs* a, int policy, Plan* pl) {
  if (a->mb < 1 || a->n_steps < 0) return cudaErrorInvalidValue;
  int dev, optin, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int rows = MAX_ROWS;
  while (rows > 16 && rows >= 2 * pad16(a->mb)) rows /= 2;
  for (;; rows /= 2) {
    if (!make_layout(&pl->lay, a->n_layers, a->dims, rows))
      return cudaErrorInvalidValue;
    if (pl->lay.smem + STATIC_SMEM <= optin) break;
    if (rows == 16) return cudaErrorInvalidValue;
  }
  auto kernel = bf16_kernel(policy);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl->lay.smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                      pl->lay.smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_tiles = (a->mb + rows - 1) / rows;
  pl->grid = n_tiles < occ * sms ? n_tiles : occ * sms;
  pl->occupancy = occ;
  pl->sms = sms;
  const long P = pl->lay.net.n_params;
  pl->partial_off = 0;
  pl->bstats_off = align256(pl->partial_off + 4L * pl->grid * P);
  pl->shadow_off = align256(pl->bstats_off + 4L * pl->grid * STAT);
  pl->scratch_bytes = align256(pl->shadow_off + 2L * pl->lay.sh_off[a->n_layers]);
  return cudaSuccess;
}

// out: rows per block, grid, threads, dynamic shared memory (bytes),
// scratch bytes, blocks per SM, SMs.  Returns a CUDA error code (0 = ok;
// cudaErrorInvalidValue for a net or minibatch it does not take).
extern "C" int ppoc_phase_bf16_plan(const Bf16PhaseArgs* a, int policy,
                                    long* out) {
  Plan pl;
  const int err = make_plan(a, policy, &pl);
  if (err != cudaSuccess) return err;
  out[0] = pl.lay.rows;
  out[1] = pl.grid;
  out[2] = THREADS;
  out[3] = pl.lay.smem;
  out[4] = pl.scratch_bytes;
  out[5] = pl.occupancy;
  out[6] = pl.sms;
  return 0;
}

static int launch_bf16(const Bf16PhaseArgs* a, cudaStream_t stream,
                       int policy) {
  Plan pl;
  int err = make_plan(a, policy, &pl);
  if (err != cudaSuccess) return err;
  if (a->scratch_bytes < pl.scratch_bytes) return cudaErrorInvalidValue;
  if (policy ? (a->k_act < 1 || a->k_act > MAX_ACT ||
                pl.lay.net.dim[a->n_layers] != a->k_act)
             : pl.lay.net.dim[a->n_layers] != 1)
    return cudaErrorInvalidValue;
  Bf16Dev d{};
  d.lay = pl.lay;
  d.x = a->x; d.tgt = a->tgt; d.act = a->act; d.lp_old = a->lp_old; d.adv = a->adv;
  d.p_in = a->p_in; d.m_in = a->m_in; d.v_in = a->v_in;
  d.p = a->p_out; d.m = a->m_out; d.v = a->v_out;
  d.ls_in = a->ls_in; d.mls_in = a->mls_in; d.vls_in = a->vls_in;
  d.ls = a->ls_out; d.mls = a->mls_out; d.vls = a->vls_out;
  unsigned char* scratch = (unsigned char*)a->scratch;
  d.partial = (float*)(scratch + pl.partial_off);
  d.bstats = (float*)(scratch + pl.bstats_off);
  d.shadow = (bf16*)(scratch + pl.shadow_off);
  d.stats = a->stats;
  d.activation = a->activation; d.n_steps = a->n_steps; d.mb = a->mb;
  d.t0 = a->t0; d.t0_ls = a->t0_ls; d.k_act = a->k_act;
  d.two_over_mb = a->two_over_mb; d.lp0 = a->lp0; d.ent0 = a->ent0;
  d.clip_lo = a->clip_lo; d.clip_hi = a->clip_hi; d.ent_coeff = a->ent_coeff;
  d.hyper = a->hyper;
  void* params[] = {&d};
  err = cudaLaunchCooperativeKernel((const void*)bf16_kernel(policy),
                                    dim3(pl.grid), dim3(THREADS), params,
                                    (size_t)pl.lay.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" int ppoc_value_phase_bf16(const Bf16PhaseArgs* a,
                                     cudaStream_t stream) {
  return launch_bf16(a, stream, 0);
}

extern "C" int ppoc_policy_phase_bf16(const Bf16PhaseArgs* a,
                                      cudaStream_t stream) {
  return launch_bf16(a, stream, 1);
}
