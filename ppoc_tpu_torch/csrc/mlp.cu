// K5: the whole MLP, forward and backward, one kernel per direction.
//
// Replaces ppoc_tpu/ops/pallas_mlp.py `mlp_forward` (custom VJP):
// `_forward_padded` -> `_fwd_kernel` and `_backward_padded` -> `_bwd_kernel`.
// Forward: per batch tile, every layer's x @ W + b with the activation fused
// (the last layer linear), saving each hidden post-activation for the
// backward.  Backward: dW/db of every layer and optionally dX, with the
// activation derivative taken from the saved post-activation (relu: h > 0,
// tanh: 1 - h^2).
//
// What bounds it on the card: at the throughput shape (8192 rows through
// [3,128,128,1]) the forward is 0.28 GFLOP against ~8.5 MB of saved
// activations, so FP32 operations bound it (about 4 us at 67 TFLOP/s); the
// backward does twice the operations.  Tensor cores are off the table: the
// parity tests hold it to float32.
//
// What the design does about it: a grid of blocks over 64-row tiles.  Each
// block copies the weights into dynamic shared memory once (rows padded to
// d+1 floats, 69.6 KB at that shape, opted in above 48 KB) and keeps its
// tile's activations in shared memory between layers; the products are the
// register-tiled block loops of mlp_step.cuh in plain FP32 FMAs.  On the TPU
// the backward's grid is sequential and dW/db accumulate in a resident
// block; here the blocks run in parallel, so each block adds its tiles'
// dW/db into its own row of a [blocks, n_params] scratch, in tile order,
// and a second kernel sums the rows in block order.  No float atomics: the
// result is the same bit for bit from run to run.  Measured on an H100
// 80GB HBM3 (PERF.md): ~50 us a forward at 256 and at 8192 rows alike, so
// one block's serial work on its tile, not the card's rates, sets the time
// of this first design.
//
// Nets larger than one block's shared memory (the reacher regime's
// [10,256,256,1]: 69.6 K padded floats, 278 KB, and the backward's three
// 64x256 tiles add 196 KB) take a second variant, picked by size at the
// launch: the weights stay in global memory (L2-resident) and each product
// stages its weight operand SLICE = 32 rows at a time (`sliced_gemm`,
// mlp_step.cuh): the forward W[k0:k0+32, :], the dX product
// W[:, j0:j0+32] transposed.  The
// tile is TILE_L = 32 rows, so three tiles and a slice fit; each warp keeps
// its 4x4 sums per lane in registers across the slices.  dW/db reads no
// weights.  Each output is summed in the same order as in the first
// variant, so forward and dX are the same bits; dW/db group their rows by
// 32-row tiles instead of 64.  At 16384 x [10,256,256,1] the forward is
// ~2.25 GFLOP (FP32 bound ~0.034 ms), the backward twice that.
#include "mlp_step.cuh"

using namespace ppoc;

namespace {

constexpr int TILE = 64;          // rows per tile
constexpr int THREADS = 512;
constexpr int MAX_BLOCKS = 128;   // grid cap: bounds the backward's scratch
constexpr int TILE_L = 32;        // rows per tile, weights in global memory

struct MlpDev {
  PaddedNet pn;        // the padded shared-memory layout of the weights
  const float* params; // flat W0, b0, W1, b1, ...
  const float* x;      // [B, d0]
  float* out;          // [B, dL]
  float* hidden[MAX_LAYERS];   // [B, d_{l+1}] post-activation of layer l < L-1
  const float* g;      // [B, dL] cotangent of out
  float* dx;           // [B, d0], or null: not wanted
  float* partial;      // [gridDim.x, n_params]
  float* grads;        // [n_params]
  int B, act, dmax;
  int variant;         // 0: weights in shared memory, 1: in global memory
};

__device__ void load_weights(const MlpDev& a, float* W) {
  for (int i = threadIdx.x; i < a.pn.net.n_params; i += blockDim.x)
    W[padded_index(a.pn, i)] = a.params[i];
}

// Copy `rows` rows of `cols` floats starting at row r0 into shared memory.
__device__ void stage(float* dst, const float* src, int r0, int rows,
                      int cols) {
  const float* s = src + (size_t)r0 * cols;
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) dst[i] = s[i];
}

__global__ void __launch_bounds__(THREADS) mlp_fwd_kernel(const MlpDev a) {
  extern __shared__ float smem[];
  float* W = smem;
  float* buf[2] = {smem + a.pn.n_padded, smem + a.pn.n_padded + TILE * a.dmax};
  load_weights(a, W);
  const Net& net = a.pn.net;
  const int L = net.n_layers;
  const int n_tiles = (a.B + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TILE;
    const int rows = min(TILE, a.B - r0);
    stage(buf[0], a.x, r0, rows, net.dim[0]);
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      const float* in = buf[l & 1];
      float* o = buf[(l + 1) & 1];
      const float* Wl = W + a.pn.pw_off[l];
      const float* bl = W + a.pn.pb_off[l];
      const bool hidden = l < L - 1;
      float* gout = (hidden ? a.hidden[l] : a.out) + (size_t)r0 * dout;
      const int act = a.act;
      block_gemm(
          rows, dout, din,
          [=](int r, int k) { return in[r * din + k]; },
          [=](int k, int j) { return Wl[k * (dout + 1) + j]; },
          [=](int r, int j, float s) {
            float h = s + bl[j];
            if (hidden) h = act_fwd(h, act);
            o[r * dout + j] = h;
            gout[r * dout + j] = h;
          });
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(THREADS) mlp_bwd_kernel(const MlpDev a) {
  extern __shared__ float smem[];
  float* W = smem;
  float* gbuf[2] = {smem + a.pn.n_padded,
                    smem + a.pn.n_padded + TILE * a.dmax};
  float* A = smem + a.pn.n_padded + 2 * TILE * a.dmax;   // layer input tile
  load_weights(a, W);
  const Net& net = a.pn.net;
  const int L = net.n_layers, d0 = net.dim[0];
  float* part = a.partial + (size_t)blockIdx.x * net.n_params;
  const int n_tiles = (a.B + TILE - 1) / TILE;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TILE;
    const int rows = min(TILE, a.B - r0);
    stage(gbuf[0], a.g, r0, rows, net.dim[L]);
    int cur = 0;
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      stage(A, l == 0 ? a.x : a.hidden[l - 1], r0, rows, din);
      __syncthreads();
      const float* g = gbuf[cur];
      float* dW = part + net.w_off[l];
      float* db = part + net.b_off[l];
      const bool acc = !first;
      // dW[k][j] = sum_r A[r][k] g[r][j]; row k = din is db[j] = sum_r g[r][j]
      block_gemm(
          din + 1, dout, rows,
          [=](int k, int r) { return k < din ? A[r * din + k] : 1.0f; },
          [=](int r, int j) { return g[r * dout + j]; },
          [=](int k, int j, float s) {
            float* p = k < din ? dW + k * dout + j : db + j;
            *p = acc ? *p + s : s;
          });
      if (l > 0 || a.dx != nullptr) {
        // g'[r][k] = (sum_j g[r][j] W[k][j]) * act'(A[r][k]); at l = 0, dX
        const float* Wl = W + a.pn.pw_off[l];
        float* gn = gbuf[1 - cur];
        const bool gate = l > 0;
        float* dx = gate ? nullptr : a.dx + (size_t)r0 * d0;
        const int act = a.act;
        block_gemm(
            rows, din, dout,
            [=](int r, int j) { return g[r * dout + j]; },
            [=](int j, int k) { return Wl[k * (dout + 1) + j]; },
            [=](int r, int k, float s) {
              if (gate)
                gn[r * din + k] = s * act_grad(A[r * din + k], act);
              else
                dx[r * din + k] = s;
            });
      }
      __syncthreads();
      cur = 1 - cur;
    }
    first = false;
  }
}

// The forward with the weights in global memory: per layer, W's rows are
// staged SLICE at a time into `Ws` [SLICE][dout].
__global__ void __launch_bounds__(THREADS) mlp_fwd_global_kernel(
    const MlpDev a) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + TILE_L * a.dmax};
  float* Ws = smem + 2 * TILE_L * a.dmax;
  const Net& net = a.pn.net;
  const int L = net.n_layers;
  const int n_tiles = (a.B + TILE_L - 1) / TILE_L;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TILE_L;
    const int rows = min(TILE_L, a.B - r0);
    stage(buf[0], a.x, r0, rows, net.dim[0]);
    for (int l = 0; l < L; ++l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      const float* in = buf[l & 1];
      float* o = buf[(l + 1) & 1];
      const float* Wl = a.params + net.w_off[l];
      const float* bl = a.params + net.b_off[l];
      const bool hidden = l < L - 1;
      float* gout = (hidden ? a.hidden[l] : a.out) + (size_t)r0 * dout;
      const int act = a.act;
      sliced_gemm(
          rows, dout, din,
          [=](int r, int k) { return in[r * din + k]; },
          [=](int k, int j) { return Ws[k * dout + j]; },
          [=](int k0, int kn) {
            for (int i = threadIdx.x; i < kn * dout; i += blockDim.x)
              Ws[i] = __ldg(Wl + (size_t)k0 * dout + i);
          },
          [=](int r, int j, float s) {
            float h = s + __ldg(bl + j);
            if (hidden) h = act_fwd(h, act);
            o[r * dout + j] = h;
            gout[r * dout + j] = h;
          });
    }
    __syncthreads();
  }
}

// The backward with the weights in global memory: dW/db as in
// mlp_bwd_kernel; the dX product with W's columns staged SLICE at a time,
// transposed, into `Ws` [SLICE][din + 1] (rows padded so the stores of a
// warp hit distinct banks).
__global__ void __launch_bounds__(THREADS) mlp_bwd_global_kernel(
    const MlpDev a) {
  extern __shared__ float smem[];
  float* gbuf[2] = {smem, smem + TILE_L * a.dmax};
  float* A = smem + 2 * TILE_L * a.dmax;   // layer input tile
  float* Ws = smem + 3 * TILE_L * a.dmax;
  const Net& net = a.pn.net;
  const int L = net.n_layers, d0 = net.dim[0];
  float* part = a.partial + (size_t)blockIdx.x * net.n_params;
  const int n_tiles = (a.B + TILE_L - 1) / TILE_L;
  bool first = true;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * TILE_L;
    const int rows = min(TILE_L, a.B - r0);
    stage(gbuf[0], a.g, r0, rows, net.dim[L]);
    int cur = 0;
    for (int l = L - 1; l >= 0; --l) {
      const int din = net.dim[l], dout = net.dim[l + 1];
      stage(A, l == 0 ? a.x : a.hidden[l - 1], r0, rows, din);
      __syncthreads();
      const float* g = gbuf[cur];
      float* dW = part + net.w_off[l];
      float* db = part + net.b_off[l];
      const bool acc = !first;
      // dW[k][j] = sum_r A[r][k] g[r][j]; row k = din is db[j] = sum_r g[r][j]
      block_gemm(
          din + 1, dout, rows,
          [=](int k, int r) { return k < din ? A[r * din + k] : 1.0f; },
          [=](int r, int j) { return g[r * dout + j]; },
          [=](int k, int j, float s) {
            float* p = k < din ? dW + k * dout + j : db + j;
            *p = acc ? *p + s : s;
          });
      if (l > 0 || a.dx != nullptr) {
        // g'[r][k] = (sum_j g[r][j] W[k][j]) * act'(A[r][k]); at l = 0, dX
        const float* Wl = a.params + net.w_off[l];
        float* gn = gbuf[1 - cur];
        const bool gate = l > 0;
        float* dx = gate ? nullptr : a.dx + (size_t)r0 * d0;
        const int act = a.act;
        const int ld = din + 1;
        sliced_gemm(
            rows, din, dout,
            [=](int r, int j) { return g[r * dout + j]; },
            [=](int j, int k) { return Ws[j * ld + k]; },
            [=](int j0, int jn) {
              for (int i = threadIdx.x; i < din * jn; i += blockDim.x) {
                const int k = i / jn, jj = i - k * jn;
                Ws[jj * ld + k] = __ldg(Wl + (size_t)k * dout + j0 + jj);
              }
            },
            [=](int r, int k, float s) {
              if (gate)
                gn[r * din + k] = s * act_grad(A[r * din + k], act);
              else
                dx[r * din + k] = s;
            });
      }
      __syncthreads();
      cur = 1 - cur;
    }
    first = false;
  }
}

// grads[i] = sum over blocks b, in order, of partial[b][i].
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ grads, int n_blocks,
                                    int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * n + i];
  grads[i] = s;
}

}  // namespace

// Host-side argument block; ppoc_tpu_torch/ops/cuda_mlp.py mirrors it field
// for field as a ctypes.Structure.  The forward leaves g, dx, partial and
// grads null; the backward reads params, x and hidden and writes partial,
// grads and (when not null) dx.
struct MlpArgs {
  const float* params;
  const float* x;
  float* out;
  float* hidden[MAX_LAYERS];
  const float* g;
  float* dx;
  float* partial;
  float* grads;
  const int* dims;   // host array of n_layers + 1 widths
  int n_layers, activation, B;
  int variant;       // 0: weights in shared memory, 1: in global memory
};

extern "C" int ppoc_mlp_args_size() { return (int)sizeof(MlpArgs); }

static bool make_dev(const MlpArgs* a, MlpDev* d, int variant) {
  if (a->B < 1 || variant < 0 || variant > 1 ||
      !make_padded(&d->pn, a->n_layers, a->dims))
    return false;
  d->variant = variant;
  d->params = a->params;
  d->x = a->x;
  d->out = a->out;
  for (int l = 0; l < MAX_LAYERS; ++l) d->hidden[l] = a->hidden[l];
  d->g = a->g;
  d->dx = a->dx;
  d->partial = a->partial;
  d->grads = a->grads;
  d->B = a->B;
  d->act = a->activation;
  d->dmax = 1;
  for (int l = 0; l <= a->n_layers; ++l)
    d->dmax = a->dims[l] > d->dmax ? a->dims[l] : d->dmax;
  return true;
}

static int n_blocks(const MlpDev& d) {
  const int rows = d.variant == 0 ? TILE : TILE_L;
  const int n_tiles = (d.B + rows - 1) / rows;
  return n_tiles < MAX_BLOCKS ? n_tiles : MAX_BLOCKS;
}

static long smem_bytes(const MlpDev& d, bool backward) {
  const long tiles = backward ? 3 : 2;
  if (d.variant == 0)
    return ((long)d.pn.n_padded + tiles * TILE * d.dmax) * (long)sizeof(float);
  return (tiles * TILE_L * d.dmax + (long)SLICE * (d.dmax + 1)) *
         (long)sizeof(float);   // the tiles and one slice of W
}

// For `variant`: sizes[0], [1]: dynamic shared-memory bytes of the forward
// and backward; sizes[2]: rows of the backward's partial scratch (its
// grid); sizes[3]: n_params.  Returns false (0) for a shape the kernels
// refuse.
extern "C" int ppoc_mlp_sizes(const MlpArgs* a, int variant, long* sizes) {
  MlpDev d{};
  if (!make_dev(a, &d, variant)) return 0;
  sizes[0] = smem_bytes(d, false);
  sizes[1] = smem_bytes(d, true);
  sizes[2] = n_blocks(d);
  sizes[3] = d.pn.net.n_params;
  return 1;
}

// Launches `kernel` on the grid of `d`'s variant with `smem` bytes.
static cudaError_t launch(void (*kernel)(const MlpDev), const MlpDev& d,
                          long smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks(d), THREADS, smem, stream>>>(d);
  return cudaGetLastError();
}

extern "C" int ppoc_mlp_forward(const MlpArgs* a, cudaStream_t stream) {
  MlpDev d{};
  if (!make_dev(a, &d, a->variant)) return cudaErrorInvalidValue;
  return launch(d.variant == 0 ? mlp_fwd_kernel : mlp_fwd_global_kernel, d,
                smem_bytes(d, false), stream);
}

extern "C" int ppoc_mlp_backward(const MlpArgs* a, cudaStream_t stream) {
  MlpDev d{};
  if (!make_dev(a, &d, a->variant)) return cudaErrorInvalidValue;
  cudaError_t err =
      launch(d.variant == 0 ? mlp_bwd_kernel : mlp_bwd_global_kernel, d,
             smem_bytes(d, true), stream);
  if (err != cudaSuccess) return err;
  const int n = d.pn.net.n_params;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      d.partial, d.grads, n_blocks(d), n);
  return cudaGetLastError();
}
