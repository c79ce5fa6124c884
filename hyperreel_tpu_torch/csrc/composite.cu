// Ray-major composite kernel (K7): per-sample density, sorted distance and
// colour -> per-ray colour and accumulated opacity.
//
// Replaces hyperreel_tpu/ops/pallas/composite.py:_composite_kernel (the
// public entry point composite_pallas). The math: deltas of the sorted
// distances with a last delta of 1e10, x = clip(sigma * delta * scale,
// +-70), weight = (1 - exp(-x)) * exp(exclusive sum of max(-x, log 1e-10)),
// rgb_map = sum of weight * rgb, acc = sum of weight.
//
// Bound on the H100 by device-memory bytes: 20 bytes read per sample
// (sigma, dist, rgb) and 16 written per ray, about 1 flop per byte.
// Design: one S-lane segment of a warp per ray, a lane per sample, with
// coalesced 4-byte loads; the weight is K2's warp-shuffle composite and
// the sums its segment butterfly (shade_core.cuh), so nothing but the
// four sums per ray is written. S is a power of two up to 32.

#include "shade_core.cuh"

namespace {

using namespace shade_core;

constexpr int kThreads = 128;

__global__ void composite_kernel(const float* __restrict__ sigma,
                                 const float* __restrict__ dist,
                                 const float* __restrict__ rgb,
                                 float* __restrict__ out, int B, int S,
                                 float scale) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < (int64_t)B * S;
  const int s = (int)(g % S);
  const float sg = live ? __ldg(sigma + g) : 0.0f;
  const float d = live ? __ldg(dist + g) : 0.0f;
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = __ldg(rgb + g * 3 + c);
  }
  const float w = composite_weight(sg, d, scale, s, S);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] *= w;
  v[3] = w;
  segment_sum<4>(v, S);
  if (live && s == 0) {
    float* o = out + (g / S) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = v[i];
  }
}

}  // namespace

extern "C" int composite_launch(const float* sigma, const float* dist,
                                const float* rgb, float* out, int B, int S,
                                float scale, void* stream) {
  if (S < 1 || S > 32 || (S & (S - 1))) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * S;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  composite_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      sigma, dist, rgb, out, B, S, scale);
  return (int)cudaGetLastError();
}
