// K4 past one block's shared memory: update_shard.cuh's sharded cluster
// kernel of the Gaussian policy kind (compiled apart from the value kind
// in update_shard.cu, which plans every kind's launch).
#include "update_shard.cuh"

cudaError_t shard_clusters_policy(int spill, int C, long smem, int* n) {
  return shard_clusters<POLICY>(spill, C, smem, n);
}

extern "C" int ppoc_policy_phase_shard(const PhaseArgs* a,
                                       cudaStream_t stream) {
  return launch_shard<POLICY>(a, stream);
}
