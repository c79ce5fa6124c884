// K1's default instantiation at S = 32 (csrc/pack_build.cuh), compiled apart
// from the other sample counts and the generic ones, to build in parallel.

#include "pack_build.cuh"

K1_DEFINE(32)
