// K6 past one block's shared memory: update_shard.cuh's sharded cluster
// kernel of the categorical policy kind (compiled apart from the value
// kind in update_shard.cu, which plans every kind's launch).
#include "update_shard.cuh"

cudaError_t shard_clusters_categorical(int spill, int C, long smem, int* n) {
  return shard_clusters<CATEGORICAL>(spill, C, smem, n);
}

extern "C" int ppoc_policy_phase_categorical_shard(const PhaseArgs* a,
                                                   cudaStream_t stream) {
  return launch_shard<CATEGORICAL>(a, stream);
}
