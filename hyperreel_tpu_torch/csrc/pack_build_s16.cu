// K1's kernels at S = 16 (csrc/pack_build.cuh), compiled apart from the
// other sample counts so that they build in parallel.

#include "pack_build.cuh"

K1_DEFINE(16)
