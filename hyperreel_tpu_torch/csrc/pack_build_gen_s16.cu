// K1's generic instantiations at S = 16 (csrc/pack_build.cuh): any layer
// and field activation, bf16 and f32 kernels, compiled apart from the
// default one so that the two build in parallel.

#include "pack_build.cuh"

K1_DEFINE_GEN(16)
