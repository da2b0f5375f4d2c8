// K3 past one block's shared memory: update_shard.cuh's sharded cluster
// kernel of the value kind, and the entries that size and plan every
// kind's launch.  K4 and K6 are the same kernel's other kinds, compiled
// apart (update_shard_policy.cu, update_shard_categorical.cu) so that the
// three build in parallel.
#include "update_shard.cuh"

cudaError_t shard_clusters_value(int spill, int C, long smem, int* n) {
  return shard_clusters<VALUE>(spill, C, smem, n);
}

// Dynamic shared-memory bytes of a block of the sharded kernels for the net
// `dims` in a cluster of `cluster` blocks (0: SHARDS; the minibatch size
// does not enter), or -1 for a shape they refuse.  Past BUDGET at a 1-row
// sub-tile: those bytes, which the launch then refuses.
extern "C" long ppoc_phase_shard_smem(const PhaseArgs* a) {
  ShardNet sn;
  return shard_of(a, &sn) ? 4L * sn.total : -1;
}

// How the sharded kernel of `kind` (0 value, 1 policy, 2 categorical)
// launches for `a`:
// out = {blocks in the cluster, rows of a sub-tile, sub-tiles a minibatch,
// threads a block, dynamic shared-memory bytes, clusters of that shape the
// card can hold at once (cudaOccupancyMaxActiveClusters), floats of global
// scratch the caller allocates (0 unless the weights spill)}.
extern "C" int ppoc_phase_shard_plan(const PhaseArgs* a, int kind,
                                     long* out) {
  ShardNet sn;
  const int C = shard_of(a, &sn);
  if (C == 0 || a->mb < 1 || kind < VALUE || kind > CATEGORICAL)
    return cudaErrorInvalidValue;
  const long smem = 4L * sn.total;
  out[0] = C;
  out[1] = sn.S;
  out[2] = (a->mb + sn.S - 1) / sn.S;
  out[3] = ST;
  out[4] = smem;
  out[5] = 0;
  out[6] = 2L * C * sn.n_gpar;
  if (smem > BUDGET) return cudaSuccess;   // the caller refuses it by size
  int n = 0;
  const cudaError_t err =
      (kind == VALUE    ? shard_clusters_value
       : kind == POLICY ? shard_clusters_policy
                        : shard_clusters_categorical)(sn.spill, C, smem, &n);
  out[5] = n;
  return err;
}

extern "C" int ppoc_value_phase_shard(const PhaseArgs* a,
                                      cudaStream_t stream) {
  return launch_shard<VALUE>(a, stream);
}
