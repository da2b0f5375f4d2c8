"""What bounds K5's products on the card: the tf32 mma and K5's loop alone.

    python3 tools/k5_probe.py

Writes a small CUDA program under build/k5_probe/ that includes
ppoc_tpu_torch/csrc/mlp.cu, builds it with nvcc (sm_90a) and runs it on
one CUDA device.  It prints, in SM clocks (clock64): the latency of one
mma.sync m16n8k8 tf32 (a chain of dependent ones, one warp) and its
throughput a warp with 8 independent chains at 1, 2 and 4 warps an SMSP
(132 blocks); then K5's product loop alone (mlp.cu ``product``, the
forward's operands: a warp's 32 x 32 output tile, eight warps a block,
each on its own tile of a 64 x 128 output, K 16 and 128, operands already
in shared memory) as clocks per warp-tile k-step (8 deep), and the float32
work that rate makes on the card (2 x 32 x 32 x 8 operations a warp-tile
k-step, at the SM clock the card reports).  Needs nvcc and one CUDA device.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k5_probe"

SOURCE = r"""
#include "%(mlp)s"
#include <cstdio>

template <int CHAINS>
__global__ void mma_chains(float* out, long long* cyc, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  float acc[CHAINS][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma_tf32(acc[c], a, b, acc[c]);
  }
  float s = 0.0f;
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0];
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0 + (s > 1e30f);
}

__global__ void product_loop(float* out, long long* cyc, int K, int reps,
                             int ld, int ldb) {
  extern __shared__ __align__(16) float sm[];
  float* A = sm;
  float* B = sm + 64 * ld;
  for (int i = threadIdx.x; i < 64 * ld; i += blockDim.x)
    A[i] = 0.001f * (i %% 97) - 0.05f;
  for (int i = threadIdx.x; i < K * ldb; i += blockDim.x)
    B[i] = 0.002f * (i %% 89) - 0.07f;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  float acc[2][4][4];
  zero_acc(acc);
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r)
    product<P_FWD>(acc, A, ld, B, ldb, (warp / 4) * 32, (warp %% 4) * 32, 64,
                   128, 0, K, 0);
  float s = 0.0f;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j)
      for (int q = 0; q < 4; ++q) s += acc[i][j][q];
  const long long t1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0 + (s > 1e30f);
}

int main() {
  float* out;
  long long* cyc;
  long long h[1];
  int dev = 0, khz = 0, sms = 0;
  cudaMalloc(&out, 1 << 22);
  cudaMalloc(&cyc, 4096);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int iters = 4096;
  mma_chains<1><<<1, 32>>>(out, cyc, iters);
  mma_chains<1><<<1, 32>>>(out, cyc, iters);
  cudaMemcpy(h, cyc, 8, cudaMemcpyDeviceToHost);
  printf("mma.sync m16n8k8 tf32: latency %%.1f clocks (a dependent chain, one warp)\n",
         h[0] / (double)iters);
  for (int warps : {4, 8, 16}) {
    mma_chains<8><<<sms, 32 * warps>>>(out, cyc, iters / 8);
    mma_chains<8><<<sms, 32 * warps>>>(out, cyc, iters / 8);
    cudaMemcpy(h, cyc, 8, cudaMemcpyDeviceToHost);
    printf("mma.sync m16n8k8 tf32: %%d warps an SMSP, 8 chains a warp: %%.2f clocks an mma an SMSP\n",
           warps / 4, h[0] / (double)(iters / 8 * 8) / (warps / 4));
  }
  const int ld = 136, ldb = 132;
  for (int K : {16, 128}) {
    const int reps = 4096 / K;
    const size_t smem = (64 * ld + K * ldb) * sizeof(float);
    cudaFuncSetAttribute(product_loop, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    product_loop<<<sms, 256, smem>>>(out, cyc, K, reps, ld, ldb);
    product_loop<<<sms, 256, smem>>>(out, cyc, K, reps, ld, ldb);
    cudaMemcpy(h, cyc, 8, cudaMemcpyDeviceToHost);
    const double clk = h[0] / (double)(reps * K / 8);
    printf("K5 product loop (mlp.cu product, P_FWD), K %%d, 8 warps a block on %%d SMs: %%.1f clocks a warp-tile k-step, %%.1f TFLOP/s of float32 work at %%d MHz\n",
           K, sms, clk, 2.0 * 32 * 32 * 8 * 8 * sms / clk * khz * 1e3 / 1e12, khz / 1000);
  }
  printf("%%s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT))
    from ppoc_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "k5_probe.cu"
    src.write_text(SOURCE % {"mlp": _build.CSRC / "mlp.cu"})
    exe = OUT / "k5_probe"
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-o", str(exe), str(src)], check=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
