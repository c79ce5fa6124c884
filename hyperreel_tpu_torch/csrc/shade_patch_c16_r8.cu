// K3 (csrc/shade_patch.cuh) at C = 16, R = 8, compiled apart from the
// other instantiations so that they build in parallel.

#include "shade_patch.cuh"

K3_DEFINE(16, 8)
