// The Adam hyperparameters every fused update phase takes (phase_args.cuh,
// update_bf16.cu).  K5's products, which lived here, are mma.cuh's 3xTF32
// steps inside mlp.cu.
#pragma once

#include "common.cuh"

namespace ppoc {

struct AdamHyper {
  float lr, b1, b2, omb1, omb2, logb1, logb2, eps;   // omb = 1 - b, logb = log b
};

}  // namespace ppoc
