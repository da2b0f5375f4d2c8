"""Where a step of K3's cluster kernels goes: clock64 probes, phase by phase.

    python3 tools/cluster_probe.py [--kernel cluster|shard]
                                   [--mb 64 256 2048] [--cluster 16 8]
                                   [--steps 50]

Copies ppoc_tpu_torch/csrc to build/probe_csrc with timing probes added
to the kernel's source (thread 0 of the cluster's block 0 adds the
clock64 cycles between consecutive points of each step to a device
array), builds that copy into build/probe_build (the checkout's own
library is untouched), runs K3 for ``--steps`` steps at each minibatch
size and cluster size, and prints the cycles a step in each part.
``cluster`` (csrc/update_cluster.cu, the nets in shared memory; on the
bench's value net [3,128,128,1]): the loop, the wait for the rows and its
__syncthreads, the next rows' prefetch, the forward, the loss gradient
and its __syncthreads, the fold of the block's stats, the backward, the
first cluster barrier, Adam over distributed shared memory, the stats'
reduction (and K4's log_std Adam), the second cluster barrier.  ``shard``
(csrc/update_shard.cuh, the weights sharded over the cluster; on
REACHER_REF's value net [10,256,256,1]): the loop, the wait and its
__syncthreads, the prefetch, the forward's products up to the head's
partial, the head's exchange barrier, its sum over the cluster and the
forward's end, the loss gradient and its __syncthreads, the fold, the
backward, the first cluster barrier, the replicated layer's Adam over
distributed shared memory, the shards' Adam, the ROW biases' and
log_std's Adam, the second cluster barrier.  Block 0's thread 0 stands
for the cluster: a barrier's part includes its wait for the slowest
block.  Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
PARTS = ("loop", "wait+sync", "prefetch", "forward", "loss+sync", "fold",
         "backward", "cluster sync 1", "adam", "stats", "cluster sync 2")
# (lines of the kernel's step loop, the probe placed right after them; the
# last closes the loop, so its probe goes before the brace)
POINTS = (
    ("  for (int s = 0; s < a.n_steps; ++s) {\n", 0),
    ("      cp_async_wait_all();\n      __syncthreads();\n", 1),
    ("                         Eb + ((tile + 1) & 1) * SUB * ES);\n", 2),
    ("      forward(cn, R, X, W, H, act);\n", 3),
    ("      __syncthreads();\n      if (tid < n_stat) {", 4),
    ("        sacc += t;\n      }\n", 5),
    ("      backward(cn, R, X, W, H, P, u == 0, act);\n", 6),
    ("    if (tid < n_stat) STAT[tid] = sacc;\n    cluster_sync();\n", 7),
    ("          if (c < C) st_cluster4(cluster_addr(W + pi, c), w);\n"
     "      }\n    }\n", 8),
    ("        LS[j] = LS[j] - (h.lr / bc1) * m2 / "
     "(sqrtf(v2 / bc2) + h.eps);\n      }\n    }\n", 9),
    ("    cluster_sync();\n  }\n", 10),
)
CLOSING = "  }\n"
SHARD_PARTS = ("loop", "wait+sync", "prefetch", "head's partial",
               "exchange sync", "(forward)", "loss+sync", "fold",
               "(backward)", "cluster sync 1", "REP adam", "shard adam",
               "bias adam", "cluster sync 2", "forward 0", "forward 1",
               "forward 2 (sum)", "dW 0", "dW 1", "dW 2", "-", "dX 1",
               "dX 2")
# update_shard.cu: (text, the same with {} where probe i goes)
SHARD_POINTS = (
    ("  for (int s = 0; s < a.n_steps; ++s) {\n",
     "  for (int s = 0; s < a.n_steps; ++s) {\n{0}"),
    ("      cp_async_wait_all();\n      __syncthreads();\n",
     "      cp_async_wait_all();\n      __syncthreads();\n{1}"),
    ("                         Eb + ((tile + 1) & 1) * S * ES);\n",
     "                         Eb + ((tile + 1) & 1) * S * ES);\n{2}"),
    ("                 false, act);\n      cluster_sync();\n",
     "                 false, act);\n{3}      cluster_sync();\n{4}"),
    ("      forward(sn, rank, R, X, ps, H, XCH, ZERO, act, xc);\n",
     "      forward(sn, rank, R, X, ps, H, XCH, ZERO, act, xc);\n{5}"),
    ("      __syncthreads();\n      if (KIND == CATEGORICAL && tid == 0) {",
     "      __syncthreads();\n{6}      if (KIND == CATEGORICAL && tid == 0) {"),
    ("        sacc += t;\n      }\n      backward(",
     "        sacc += t;\n      }\n{7}      backward("),
    ("      backward(sn, rank, R, X, ps, H, XCH, u == 0, act, xc);\n",
     "      backward(sn, rank, R, X, ps, H, XCH, u == 0, act, xc);\n{8}"),
    ("    cluster_sync();\n\n    // Adam:",
     "    cluster_sync();\n{9}\n    // Adam:"),
    ("        if (q < C) st_cluster4(cluster_addr(W + pi, q), w4);\n    }\n",
     "        if (q < C) st_cluster4(cluster_addr(W + pi, q), w4);\n    }\n"
     "{10}"),
    ("    });\n    for (int l = 0; l < L; ++l)\n      if (sn.mode[l] == ROW)",
     "    });\n{11}    for (int l = 0; l < L; ++l)\n"
     "      if (sn.mode[l] == ROW)"),
    ("    cluster_sync();\n  }\n",
     "{12}    cluster_sync();\n{13}  }\n"),
    # by layer l of the probed 3-layer net: the forward's end, the
    # backward's dW and dX
    ("      ++xc;\n    }\n    __syncthreads();\n  }\n}\n\n// Backward",
     "      ++xc;\n    }\n    __syncthreads();\n    PROBE(14 + l);\n  }\n}"
     "\n\n// Backward"),
    ("    __syncthreads();\n    if (l == 0) break;\n",
     "    __syncthreads();\n    PROBE(17 + l);\n    if (l == 0) break;\n"),
    ("      ++xc;\n    }\n    __syncthreads();\n  }\n}\n\n// Start copying",
     "      ++xc;\n    }\n    __syncthreads();\n    PROBE(20 + l);\n  }\n}"
     "\n\n// Start copying"),
)
PROBE_DEF = """__device__ unsigned long long g_probe[32];
__device__ long long g_probe_last;
#define PROBE(i)                                           \\
  do {                                                     \\
    if (rank == 0 && threadIdx.x == 0) {                   \\
      const long long t_ = clock64();                      \\
      g_probe[i] += t_ - g_probe_last;                     \\
      g_probe_last = t_;                                   \\
    }                                                      \\
  } while (0)
"""
PROBE_READ = """
extern "C" int ppoc_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  const unsigned long long zero[32] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return e;
}
"""


def probed_shard(dst: Path) -> None:
    """csrc with the probes in update_shard.cuh (the sharded kernel, each
    kind's source a copy of its own: the value kind's, update_shard.cu,
    reads them), into ``dst``."""
    path = dst / "update_shard.cuh"
    s = path.read_text()
    s = s.replace("namespace {\n", "namespace {\n" + PROBE_DEF, 1)
    s = s.replace("  int tile = 0, xc = 0;\n  __syncthreads();\n",
                  "  int tile = 0, xc = 0;\n  __syncthreads();\n"
                  "  if (rank == 0 && tid == 0) g_probe_last = clock64();\n",
                  1)
    for i, (old, new) in enumerate(SHARD_POINTS):
        if s.count(old) != 1:
            raise SystemExit(f"probe point {i} not found once in "
                             f"update_shard.cuh: {old!r}")
        for j in range(14):
            new = new.replace(f"{{{j}}}", f"    PROBE({j});\n")
        s = s.replace(old, new)
    path.write_text(s)
    value = dst / "update_shard.cu"
    value.write_text(value.read_text() + PROBE_READ)


def probed_sources(dst: Path, kernel: str = "cluster") -> None:
    """csrc with the probes in the ``kernel``'s source, into ``dst``."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(HERE / "ppoc_tpu_torch" / "csrc", dst)
    if kernel == "shard":
        probed_shard(dst)
        return
    path = dst / "update_cluster.cu"
    s = path.read_text()
    s = s.replace("namespace {\n", """__device__ unsigned long long g_probe[16];
#define PROBE(i)                                           \\
  do {                                                     \\
    if (rank == 0 && tid == 0) {                           \\
      const long long t_ = clock64();                      \\
      g_probe[i] += t_ - t_last;                           \\
      t_last = t_;                                         \\
    }                                                      \\
  } while (0)
namespace {
""", 1)
    s = s.replace("  int tile = 0;\n  __syncthreads();\n",
                  "  int tile = 0;\n  __syncthreads();\n"
                  "  long long t_last = clock64();\n", 1)
    for line, i in POINTS:
        if line.endswith("if (tid < n_stat) {"):
            head = line[:-len("      if (tid < n_stat) {")]
            new = f"{head}      PROBE({i});\n      if (tid < n_stat) {{"
        elif i == len(PARTS) - 1:
            head = line[:-len(CLOSING)]
            new = f"{head}    PROBE({i});\n{CLOSING}"
        else:
            new = f"{line}    PROBE({i});\n"
        if s.count(line) != 1:
            raise SystemExit(f"probe point {i} not found once in "
                             f"update_cluster.cu: {line!r}")
        s = s.replace(line, new)
    s += """
extern "C" int ppoc_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  const unsigned long long zero[16] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return e;
}
"""
    path.write_text(s)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("cluster", "shard"),
                    default="cluster")
    ap.add_argument("--mb", type=int, nargs="+", default=[64, 256, 2048])
    ap.add_argument("--cluster", type=int, nargs="+", default=[16, 8])
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ppoc_tpu_torch.ops import _build

    _build.CSRC = HERE / "build" / "probe_csrc"
    _build.BUILD_DIR = HERE / "build" / "probe_build"
    probed_sources(_build.CSRC, args.kernel)
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import AdamState

    lib = _build.load()
    lib.ppoc_probe_read.argtypes = [ctypes.c_void_p]
    lib.ppoc_probe_read.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(1)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    widths = (3, 128, 128, 1) if args.kernel == "cluster" else (10, 256,
                                                                 256, 1)
    parts = PARTS if args.kernel == "cluster" else SHARD_PARTS
    variant = "smem" if args.kernel == "cluster" else "global"
    params = mlp.init(widths, g, dev)
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    opt = AdamState(zeros, zeros, 0)
    n = args.steps
    cycles = (ctypes.c_ulonglong * 32)()
    for mb in args.mb:
        x = torch.randn(n * mb, widths[0], generator=g).to(dev)
        tgt = (10 * torch.randn(n * mb, generator=g)).to(dev)
        for c in args.cluster:
            for _ in range(2):          # the second launch is read
                lib.ppoc_probe_read(cycles)
                cu.value_phase_kernel(x, tgt, params, opt, n, mb, "relu", h,
                                      variant=variant, cluster=c)
                torch.cuda.synchronize()
            lib.ppoc_probe_read(cycles)
            total = sum(cycles[i] for i in range(len(parts)))
            print(f"K3 {list(widths)} ({args.kernel}), minibatch {mb}, "
                  f"cluster {c}: {total / n:.0f} cycles a step; " + ", ".join(
                      f"{p} {cycles[i] / n:.0f}"
                      for i, p in enumerate(parts)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
