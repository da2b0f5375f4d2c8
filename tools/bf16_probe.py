"""Where a step of K3 bf16 (csrc/update_bf16.cu) goes, part by part.

    python3 tools/bf16_probe.py [--root OTHER] [--mb 16384] [--steps 20]

Copies the kernel's source from ``OTHER`` (default: this checkout) into
build/bf16_probe/<variant>/, adds clock64 stamps (block 0, thread 0 adds
the cycles between consecutive points of each step in shared memory, then
to a device array) and
switches that remove one part of the work, builds every variant with its
own nvcc (all started together; only update_bf16.cu and its headers, so
the checkout's library is untouched) and runs K3 bf16 on the reacher
value net [10,256,256,1] for ``--steps`` steps at each minibatch size
(16384: 128 blocks of 128 rows, one tile each).  For each variant it
prints a step's device microseconds (a launch of the steps less one of
none, queued behind a spin kernel and timed with CUDA events) and, for the
full kernel, the stamps' cycles a step by part and every block's cycles
in Adam (the slowest block holds the barrier after it).  The variants:

  as built     the kernel as it is, without the stamps
  full         the kernel with the stamps
  no products  every tensor-core product skipped (its operands still
               staged, its accumulators zero)
  no staging   W's slices never copied to shared memory (the products run
               on whatever the stage holds)
  no partials  the blocks' gradient partials never written to global
               memory (their products still run)
  no sum       Adam reads one partial an element instead of the grid's
  skeleton     all four removed: the barriers, the loss, Adam's update

A part's cost is the full step less the step without it (each with the
stamps, ~1% of a step).  Two designs are known by their text: the
mma.sync design (m16n8k16 from ldmatrix fragments, W staged by all
threads; run it with --root on a checkout that has it) and the wgmma
design (a producer warp's bulk copies into an mbarrier ring; its stamps
also read the consumers' waits for a stage and the parts of the
backward).  Needs nvcc and one CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "bf16_probe"
# (name, products, staging, partials, the grid's sum); "as built" has no
# stamps either
VARIANTS = (("as built", 1, 1, 1, 1), ("full", 1, 1, 1, 1),
            ("no products", 0, 1, 1, 1),
            ("no staging", 1, 0, 1, 1), ("no partials", 1, 1, 0, 1),
            ("no sum", 1, 1, 1, 0), ("skeleton", 0, 0, 0, 0))

# block 0's thread 0 adds the cycles in shared memory, flushed once
PROBE_DEF = """
__device__ unsigned long long g_probe[32];
__shared__ unsigned long long s_probe[32];
__shared__ long long s_probe_last;
#define PROBE(i)                                            \\
  do {                                                      \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {              \\
      const long long t_ = clock64();                       \\
      s_probe[i] += t_ - s_probe_last;                      \\
      s_probe_last = t_;                                    \\
    }                                                       \\
  } while (0)
#define PROBE_FROM(i, t0)                                   \\
  do {                                                      \\
    if (blockIdx.x == 0 && threadIdx.x == 0)                \\
      s_probe[i] += clock64() - (t0);                       \\
  } while (0)
#define PROBE_START()                                       \\
  do {                                                      \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {              \\
      for (int i_ = 0; i_ < 32; ++i_) s_probe[i_] = 0;      \\
      s_probe_last = clock64();                             \\
    }                                                       \\
  } while (0)
// every block's thread 0: the largest of its cycles since t0 over blocks
// and steps, and each block's sum over the steps
__device__ unsigned long long g_probe_block[1024];
#define PROBE_MAX(i, t0)                                    \\
  do {                                                      \\
    if (threadIdx.x == 0) {                                 \\
      const unsigned long long d_ = clock64() - (t0);       \\
      atomicMax(&g_probe[i], d_);                           \\
      if (blockIdx.x < 1024) g_probe_block[blockIdx.x] += d_; \\
    }                                                       \\
  } while (0)
#define PROBE_FLUSH()                                       \\
  do {                                                      \\
    if (blockIdx.x == 0 && threadIdx.x == 0)                \\
      for (int i_ = 0; i_ < 32; ++i_) g_probe[i_] += s_probe[i_]; \\
  } while (0)
"""
# both designs end alike: the flush goes before block 0's last write
FLUSH_POINT = ("  if (b == 0 && tid == 0) {\n    a.stats[0] = run_loss;",
               "  PROBE_FLUSH();\n"
               "  if (b == 0 && tid == 0) {\n    a.stats[0] = run_loss;")
PROBE_READ = """
extern "C" int ppoc_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));
  const unsigned long long zero[32] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_probe, zero, sizeof(zero));
  return e;
}
extern "C" int ppoc_probe_read_blocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_probe_block,
                                       sizeof(g_probe_block));
  static const unsigned long long zero[1024] = {};
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_probe_block, zero, sizeof(zero));
  return e;
}
extern "C" const char* ppoc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""

# the mma.sync design: (text found once, its replacement)
MMA_PARTS = ("x load", "forward", "loss", "backward", "grid sync 1", "adam",
             "stats", "grid sync 2", "(staging, within forward and dX)")
MMA_POINTS = (
    ("  const float mbf = (float)a.mb;\n",
     "  const float mbf = (float)a.mb;\n  PROBE_START();\n"),
    ("      for (int l = 0; l < n_layers; ++l) forward_layer(a, sm, l);\n",
     "      PROBE(0);\n"
     "      for (int l = 0; l < n_layers; ++l) forward_layer(a, sm, l);\n"
     "      PROBE(1);\n"),
    ("      const int kr = (nrows + 15) & ~15;\n",
     "      PROBE(2);\n      const int kr = (nrows + 15) & ~15;\n"),
    ("        if (l > 0) dx_layer(a, sm, l, part, first);\n      }\n",
     "        if (l > 0) dx_layer(a, sm, l, part, first);\n      }\n"
     "      PROBE(3);\n"),
    ("    grid.sync();\n\n    // Adam on this block's slice",
     "    grid.sync();\n    PROBE(4);\n\n    // Adam on this block's slice"),
    ("    if (b == 0 && tid == 0) {\n      float tot[STAT];",
     "    PROBE(5);\n    if (b == 0 && tid == 0) {\n      float tot[STAT];"),
    ("    __threadfence();\n    grid.sync();\n  }\n  if (b == 0 && tid == 0) {",
     "    PROBE(6);\n    __threadfence();\n    grid.sync();\n    PROBE(7);\n"
     "  }\n  if (b == 0 && tid == 0) {"),
    # staging: thread 0 from the slice's first barrier to after its second
    ("      __syncthreads();   // the previous slice's reads are done\n",
     "      const long long ps_ = clock64();\n"
     "      __syncthreads();   // the previous slice's reads are done\n"),
    ("      __syncthreads();\n      if (mtiles > 0)\n",
     "      __syncthreads();\n      PROBE_FROM(8, ps_);\n"
     "      if (mtiles > 0)\n"),
    ("      __syncthreads();\n      for (int e = threadIdx.x; e < N * vec;",
     "      const long long ps_ = clock64();\n"
     "      __syncthreads();\n      for (int e = threadIdx.x; e < N * vec;"),
    ("      __syncthreads();\n      if (own)\n",
     "      __syncthreads();\n      PROBE_FROM(8, ps_);\n      if (own)\n"),
    # the switches
    ("  uint32_t bf[4];\n  if (B_T) ldsm_x4_t(bf, b); else ldsm_x4(bf, b);\n",
     "  if (!PROBE_MMA) return;\n  uint32_t bf[4];\n"
     "  if (B_T) ldsm_x4_t(bf, b); else ldsm_x4(bf, b);\n"),
    ("for (int e = threadIdx.x; e < kn * vec; e += THREADS) {",
     "for (int e = threadIdx.x; PROBE_STAGE && e < kn * vec; "
     "e += THREADS) {"),
    ("for (int e = threadIdx.x; e < N * vec; e += THREADS) {",
     "for (int e = threadIdx.x; PROBE_STAGE && e < N * vec; "
     "e += THREADS) {"),
    ("  part[idx] = first ? v : part[idx] + v;\n",
     "  if (PROBE_PARTIAL || v == 1.25e-38f)\n"
     "    part[idx] = first ? v : part[idx] + v;\n"),
    ("for (int q = 0; q < G; ++q) gsum += __ldcg(",
     "for (int q = 0; q < (PROBE_SUM ? G : 1); ++q) gsum += __ldcg("),
)

# the wgmma design: the same parts, the products split from the consumers'
# waits for a stage of the ring
WGMMA_PARTS = ("x load", "forward", "head and loss", "backward",
               "grid sync 1", "adam", "stats", "grid sync 2",
               "(waits for a stage, within forward and dX)",
               "(forward epilogues)", "(head backward)", "(dW)", "(dX)",
               "(max: Adam in the slowest block and step)")
WGMMA_POINTS = (
    ("  float run_loss = 0.0f, run_ent = 0.0f;   // block 0, thread 0\n",
     "  float run_loss = 0.0f, run_ent = 0.0f;   // block 0, thread 0\n"
     "  PROBE_START();\n"),
    ("      consumers_sync();\n      if (w < row_wgs)\n",
     "      consumers_sync();\n      PROBE(0);\n      if (w < row_wgs)\n"),
    ("      consumers_sync();\n      if (w < row_wgs) head_forward(a, sm, w);\n",
     "      consumers_sync();\n      PROBE(1);\n"
     "      if (w < row_wgs) head_forward(a, sm, w);\n"),
    ("      const int kr = pad16(nrows);\n",
     "      PROBE(2);\n      const int kr = pad16(nrows);\n"),
    ("          consumers_sync();\n        }\n      }\n    }\n",
     "          consumers_sync();\n        }\n      }\n      PROBE(3);\n"
     "    }\n"),
    ("    grid_sync(a.barrier, G, barriers);\n\n    // Adam",
     "    grid_sync(a.barrier, G, barriers);\n    PROBE(4);\n"
     "    const long long pa_ = clock64();\n\n    // Adam"),
    ("    float tot[1 + MAX_ACT];",
     "    PROBE(5);\n    PROBE_MAX(13, pa_);\n    float tot[1 + MAX_ACT];"),
    ("    __threadfence();\n    grid_sync(a.barrier, G, barriers);\n  }\n",
     "    PROBE(6);\n    __threadfence();\n    grid_sync(a.barrier, G, barriers);"
     "\n    PROBE(7);\n  }\n"),
    # the consumers' waits for a stage (thread 0: warpgroup 0)
    ("    mbar_wait(&ring.full[ring.slot()], ring.parity());\n"
     "    fence_acc(acc);\n    wgmma_fence();\n    mma_forward",
     "    const long long ps_ = clock64();\n"
     "    mbar_wait(&ring.full[ring.slot()], ring.parity());\n"
     "    PROBE_FROM(8, ps_);\n"
     "    fence_acc(acc);\n    wgmma_fence();\n    mma_forward"),
    ("        mbar_wait(&ring.full[ring.slot()], ring.parity());\n"
     "        fence_acc(acc);\n        wgmma_fence();\n        mma_dx",
     "        const long long ps_ = clock64();\n"
     "        mbar_wait(&ring.full[ring.slot()], ring.parity());\n"
     "        PROBE_FROM(8, ps_);\n"
     "        fence_acc(acc);\n        wgmma_fence();\n        mma_dx"),
    # the forward's epilogues, the head's backward, dW and dX
    ("  WITH_ACT(a.activation, forward_epilogue, acc, sm, sm.act(l + 1),\n"
     "           sm.bias() + L.hb[l], jc, w, L.rows);\n",
     "  const long long pe_ = clock64();\n"
     "  WITH_ACT(a.activation, forward_epilogue, acc, sm, sm.act(l + 1),\n"
     "           sm.bias() + L.hb[l], jc, w, L.rows);\n"
     "  PROBE_FROM(9, pe_);\n"),
    ("      head_backward(a, sm, part, kr, row_wgs, first);\n",
     "      const long long ph_ = clock64();\n"
     "      head_backward(a, sm, part, kr, row_wgs, first);\n"
     "      PROBE_FROM(10, ph_);\n"),
    ("        dw_layer(a, sm, l, kr, part, first);\n",
     "        const long long pw_ = clock64();\n"
     "        dw_layer(a, sm, l, kr, part, first);\n"
     "        PROBE_FROM(11, pw_);\n"),
    ("          dx_layer(a, sm, ring, l, row_wgs, part, first);\n",
     "          const long long px_ = clock64();\n"
     "          dx_layer(a, sm, ring, l, row_wgs, part, first);\n"
     "          PROBE_FROM(12, px_);\n"),
    # the switches
    ("  const uint32_t lbo = rs * 128;\n",
     "  if (!PROBE_MMA) return;\n  const uint32_t lbo = rs * 128;\n"),
    ("#pragma unroll 1\n  for (int kk = 0; kk < nc; kk += 16)\n",
     "  if (!PROBE_MMA) return;\n"
     "#pragma unroll 1\n  for (int kk = 0; kk < nc; kk += 16)\n"),
    ("#pragma unroll 1\n  for (int r0 = 0; r0 < kr; r0 += 16)\n",
     "  if (!PROBE_MMA) return;\n"
     "#pragma unroll 1\n  for (int r0 = 0; r0 < kr; r0 += 16)\n"),
    ("    mbar_expect_tx(full, bytes);\n",
     "    if (!PROBE_STAGE) {\n      mbar_arrive(full);\n      ++ring.q;\n"
     "      return;\n    }\n    mbar_expect_tx(full, bytes);\n"),
    ("  if (two && !(idx & 1)) {\n",
     "  if (!PROBE_PARTIAL && v0 != 1.25e-38f) return;\n"
     "  if (two && !(idx & 1)) {\n"),
    ("        if (c < dout && i < din)\n"
     "          *reinterpret_cast<float2*>(dw + (long)i * dout + c) =\n",
     "        if ((PROBE_PARTIAL || acc[4 * j + 2 * h] == 1.25e-38f) &&\n"
     "            c < dout && i < din)\n"
     "          *reinterpret_cast<float2*>(dw + (long)i * dout + c) =\n"),
    ("          for (int q = q0; q < q1; ++q) {\n",
     "          for (int q = q0; q < (PROBE_SUM ? q1 : min(q1, q0 + 1)); "
     "++q) {\n"),
)


def design_of(src: str):
    if '#include "wgmma.cuh"' in src:
        return "wgmma", WGMMA_PARTS, WGMMA_POINTS
    return "mma", MMA_PARTS, MMA_POINTS


def probed(src: str, variant) -> str:
    """``src`` with the stamps and ``variant``'s switches."""
    _, mma, stage, partial, gsum = variant
    _, _, points = design_of(src)
    head = (f"#define PROBE_MMA {mma}\n#define PROBE_STAGE {stage}\n"
            f"#define PROBE_PARTIAL {partial}\n#define PROBE_SUM {gsum}\n")
    s = src.replace("namespace {\n", "namespace {\n" + PROBE_DEF, 1)
    if variant[0] == "as built":
        points = ()
    for old, new in points + (FLUSH_POINT,):
        if s.count(old) != 1:
            raise SystemExit(f"probe point not found once in update_bf16.cu:"
                             f" {old!r} ({s.count(old)} times)")
        s = s.replace(old, new)
    if "ppoc_wgmma_test" not in s:   # a design before wgmma.cuh
        s += ('extern "C" int ppoc_wgmma_test(int, const float*, const float*,'
              ' float*, int, int, cudaStream_t) { return 1; }\n')
    return head + s + PROBE_READ


def build_all(csrc: Path) -> dict:
    """Each variant's library path; every nvcc started together."""
    sys.path.insert(0, str(HERE))
    from ppoc_tpu_torch.ops import _build

    src = (csrc / "update_bf16.cu").read_text()
    nvcc = _build.find_nvcc()
    shutil.rmtree(OUT, ignore_errors=True)
    jobs = {}
    for v in VARIANTS:
        d = OUT / v[0].replace(" ", "_")
        d.mkdir(parents=True)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "update_bf16.cu").write_text(probed(src, v))
        lib = d / "libprobe.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(d / "update_bf16.cu")]
        log = open(d / "nvcc.log", "w")
        jobs[v[0]] = (lib, subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT), d)
    libs = {}
    for name, (lib, proc, d) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"nvcc failed for '{name}':\n"
                             + (d / "nvcc.log").read_text()[-4000:])
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="the checkout whose update_bf16.cu is probed")
    ap.add_argument("--mb", type=int, nargs="+", default=[16384])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from ppoc_tpu_torch.models import mlp
    from ppoc_tpu_torch.ops import _build
    from ppoc_tpu_torch.ops import cuda_update as cu
    from ppoc_tpu_torch.ops.adam import AdamState

    csrc = args.root / "ppoc_tpu_torch" / "csrc"
    design, parts, _ = design_of((csrc / "update_bf16.cu").read_text())
    libs = build_all(csrc)
    dev = torch.device("cuda", 0)
    print(f"K3 bf16 probe, {design} design from {args.root}; "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    widths = (10, 256, 256, 1)
    g = torch.Generator().manual_seed(1)
    h = cu.Hyper.of(3e-4, 0.9, 0.999, 1e-8)
    params = mlp.init(widths, g, dev)
    zeros = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in params]
    opt = AdamState(zeros, zeros, 0)
    n = args.steps
    cycles = (ctypes.c_ulonglong * 32)()
    for mb in args.mb:
        x = torch.randn(n * mb, widths[0], generator=g).to(dev)
        tgt = torch.randn(n * mb, generator=g).to(dev)
        full = None
        for name, lib_path in libs.items():
            lib = ctypes.CDLL(str(lib_path))
            lib.ppoc_error_string.argtypes = [ctypes.c_int]
            lib.ppoc_error_string.restype = ctypes.c_char_p
            lib.ppoc_probe_read.argtypes = [ctypes.c_void_p]
            lib.ppoc_probe_read.restype = ctypes.c_int
            _build.load = lambda lib=lib: lib
            plan = cu.phase_bf16_plan("value", widths, mb, dev)

            def run(k):
                return cu.value_phase_bf16_kernel(
                    x[:k * mb], tgt[:k * mb], params, opt, k, mb, "relu", h)

            ms = [queued_ms(lambda k=k: run(k), 3) for k in (0, n)]
            us = 1e3 * (ms[1] - ms[0]) / n
            blocks = (ctypes.c_ulonglong * 1024)()
            lib.ppoc_probe_read(cycles)
            lib.ppoc_probe_read_blocks(blocks)
            run(n)
            torch.cuda.synchronize()
            lib.ppoc_probe_read(cycles)
            lib.ppoc_probe_read_blocks(blocks)
            if name == "full":
                full = us
            against = "" if full is None or name == "full" else \
                f" ({full - us:+.2f} us against full)"
            print(f"  mb {mb} ({plan['grid']} blocks of {plan['rows']} rows,"
                  f" {plan['threads']} threads, {plan['smem']} B): {name}: "
                  f"{us:.2f} us a step{against}", flush=True)
            if name == "full":
                total = sum(cycles[i] for i, p in enumerate(parts)
                            if not p.startswith("("))
                print(f"    stamps, cycles a step: {total / n:.0f} in all; "
                      + ", ".join(f"{p} {cycles[i] / (1 if p.startswith('(max') else n):.0f}"
                                  for i, p in enumerate(parts)), flush=True)
                print(f"    ({total / n / us:.0f} stamped cycles a "
                      f"microsecond of the step)", flush=True)
                per = sorted((blocks[b] / n, b) for b in range(plan["grid"]))
                if per[-1][0] > 0:
                    print("    Adam's cycles a step by block: least "
                          f"{per[0][0]:.0f} (block {per[0][1]}), median "
                          f"{per[len(per) // 2][0]:.0f}, most "
                          + ", ".join(f"{c:.0f} (block {b})"
                                      for c, b in per[-5:]), flush=True)
    return 0


def queued_ms(fn, reps: int) -> float:
    """Device ms per call: ``reps`` calls queued behind a spin kernel, timed
    with CUDA events (chip_smoke.queued_ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000 + 1_000_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


if __name__ == "__main__":
    sys.exit(main())
