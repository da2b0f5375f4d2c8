// The fused update phases' host interface: the size of `struct PhaseArgs`
// (phase_args.cuh), which ops/cuda_update.py checks its ctypes mirror
// against before any launch.
//
// The phases themselves (K3, K4 and K6, each a kind of two thread-block
// cluster kernels) live in update_cluster.cu, with the weights replicated
// in every block's shared memory, and in update_shard.cu, with them
// sharded by column over the cluster for nets past one block; their
// shared code is in cluster.cuh.  The bf16 big-tile phases (K3 bf16, K4
// bf16) are update_bf16.cu's.
#include "phase_args.cuh"

extern "C" int ppoc_phase_args_size() { return (int)sizeof(PhaseArgs); }
