// Fused patch-blend + shade kernel (K3): the coherent patch-gather route of
// the flagship eval render in one kernel, from the per-sample pack and the
// patch table to the per-ray colour.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_fused_patch
// (the blend of ops/pallas/patch_blend.py inside the shade kernel, R phases
// per patch row, with _shade_core and _shade_tail) together with the XLA
// patch-row gather and patch_anchor_idx that fed it.
//
// Bound on the H100 by device-memory bytes once the SH basis is folded per
// ray: per sample its ten pack rows, px*py*C*2 / R bytes of patch row (40
// bytes at R = 8, (5, 2), C = 16) and the time taps; per valid sample the
// blend of at most four texels, the time features, the density and a [3,
// C] colour product. Design (PR 7's K5 ray-run form with the patch
// prologue of patch_core.cuh):
// - A thread per ray walks the ray's samples in order; a warp is 32
//   consecutive rays of the caller, 32/R whole coherent blocks, each ray
//   read and written at its position (phase-major or scanline). At each
//   sample slot the R lanes of a coherent block are neighbours, so the
//   slot's anchor, its coverage test and the witness are shuffle
//   butterflies over them (span, anchor_of), with no block barrier; the taps
//   are read from the slot's patch row through L1 (the R lanes read one row
//   in the same instruction).
// - Each warp stages its 32 rays' pack rows, 8 samples at a time (32 bytes
//   per ray and row, a whole sector: staging 4 at a time, as K5 does, read
//   each sector twice and measured 23 % slower), in shared memory with a
//   stride of 9 floats per ray, which its threads then read without bank
//   conflicts.
// - The SH basis is folded with the ray's view direction once per ray
//   (shade_core.cuh sh_fold: 3 nb x C / 2 FMAs over the C / 2 appearance
//   channels), so that a sample's colour is a [3, C / 2] product
//   (sh_folded_colour); RGB colour has nothing to fold.
// - The composite is a running sum per thread (composite_add).
// - Blocks of 4 warps, registers capped for 4 blocks per SM.
// Built for C in {8, 16}, R in {4, 8}, S a power of two in 4 .. 32 and SH
// of degree 0-4 with C / 2 density channels (every preset's) or RGB colour
// (a template argument); a pack with the weights row is refused (not
// built: ROADMAP.md 2a).
//
// The kernel and its launch live here; shade_patch_c<C>_r<R>.cu instantiate
// them per (C, R) so that they build in parallel, and shade_patch.cu holds
// the C entry point.

#pragma once

#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace patch_core;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// registers for 4 blocks per SM (at most 128): 0.434 against 0.480 ms
// with the 134-168 ptxas takes unbounded, 3 blocks (scripts/
// patch_variants.py)
constexpr int kBlocksPerSm = 4;
// the pack tiles: samples per stage (32 bytes of a row per ray: a whole
// sector) and floats per ray
constexpr int kStageS = 8;
constexpr int kTileStride = kStageS + 1;

// A sample's colour: RGB, or SH from the ray's folded basis M [3, C / 2]
// over its appearance channels (feat[C / 2 ..]; the density channels'
// basis columns are zero).
template <int C, bool kRgb>
__device__ __forceinline__ void patch_colour(const float* feat,
                                             const float* M, const float* wb,
                                             const float* pk, float* rgb) {
  if constexpr (kRgb) {
    rgb_colour<C>(feat, wb, pk, rgb);
  } else {
    sh_folded_colour<C / 2>(feat + C / 2, M, pk, rgb);
  }
}

template <int C, int R, bool kRgb, bool kAnyDeg>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    shade_patch_kernel(const uint4* __restrict__ ptab,
                       const float* __restrict__ pack,
                       const float* __restrict__ rays,
                       const float* __restrict__ ttab,
                       float* __restrict__ out, int* __restrict__ viol,
                       const __grid_constant__ ShadeParams p,
                       const __grid_constant__ PatchParams q) {
  __shared__ float tiles[kWarps][kPackRows * 32 * kTileStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = q.S;
  const int64_t N = (int64_t)q.B * S;
  const int64_t J = q.B / R;
  // the caller's ray R*j + r (r = lane % R), at its position
  const int64_t ray_i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray_i < q.B;
  const int64_t pos = !live ? 0
                      : q.phase_major ? (ray_i % R) * J + ray_i / R
                                      : ray_i;
  const float* ray = rays + pos * 8;
  const int vecs = q.px * q.py * C / 8;
  float* tile = tiles[warp];
  const float* mine = tile + lane * kTileStride;

  // the ray's folded basis [3, C / 2]
  float M[kRgb ? 1 : 3 * C / 2];
  if constexpr (!kRgb) {
    sh_fold<C / 2, C, kAnyDeg>(p.wb + C / 2, p.nb, __ldg(ray + 3),
                               __ldg(ray + 4), __ldg(ray + 5), M);
  }
  RayComposite acc;
  float prev_sigma = 0.0f, prev_rgb[3] = {0.0f, 0.0f, 0.0f}, prev_dist = 0.0f;
  int n_viol = 0;
  for (int s0 = 0; s0 < S; s0 += kStageS) {
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kPackRows; ++r) {
#pragma unroll
      for (int h = 0; h < kStageS; h += 4) {
        const float4 v =
            live && s0 + h < S
                ? __ldg(reinterpret_cast<const float4*>(pack + r * N +
                                                        pos * S + s0 + h))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float* t = tile + (r * 32 + lane) * kTileStride + h;
        t[0] = v.x;
        t[1] = v.y;
        t[2] = v.z;
        t[3] = v.w;
      }
    }
    __syncwarp();
    const int stage = S - s0 < kStageS ? S - s0 : kStageS;
    for (int j = 0; j < stage; ++j) {
      float pk[kPackRows];
#pragma unroll
      for (int i = 0; i < kPackRows; ++i) pk[i] = mine[i * 32 * kTileStride + j];
      const bool valid = live && sample_valid(pk);
      const bool all_valid = __all_sync(0xffffffffu, valid || !live);
      const float x = pick3(pk, q.m0), y = pick3(pk, q.m1);
      const SlotAnchor a =
          anchor_of(span<R>(x, valid, all_valid),
                    span<R>(y, valid, all_valid), q.W, q.H, q.px, q.py);
      n_viol += (live && a.viol && lane % R == 0) ? 1 : 0;
      float sigma = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
      if (valid) {
        float feat[C];
        patch_taps<C>(ptab + (int64_t)a.idx * vecs,
                            patch_offset(x, q.W, a.x0),
                            patch_offset(y, q.H, a.y0), q.px, q.py, feat);
        sigma = sample_density<C, false>(feat, pk, ray, ttab, p, 1.0f);
        patch_colour<C, kRgb>(feat, M, p.wb, pk, rgb);
      }
      if (s0 + j > 0) {
        composite_add(acc, prev_sigma, prev_rgb, prev_dist, pk[3] - prev_dist,
                      p.distance_scale);
      }
      prev_sigma = sigma;
      prev_rgb[0] = rgb[0];
      prev_rgb[1] = rgb[1];
      prev_rgb[2] = rgb[2];
      prev_dist = pk[3];
    }
  }
  composite_add(acc, prev_sigma, prev_rgb, prev_dist, 1e10f,
                p.distance_scale);
  if (live) {
    float* o = out + pos * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = acc.v[i];
  }
  n_viol = __reduce_add_sync(0xffffffffu, n_viol);
  if (lane == 0 && n_viol) atomicAdd(viol, n_viol);
}

template <int C, int R>
cudaError_t launch(const uint4* ptab, const float* pack, const float* rays,
                   const float* ttab, float* out, int* viol,
                   const ShadeParams& p, const PatchParams& q,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)((q.B + kThreads - 1) / kThreads);
  if (p.rgb) {
    shade_patch_kernel<C, R, true, false><<<blocks, kThreads, 0, st>>>(
        ptab, pack, rays, ttab, out, viol, p, q);
  } else if (any_degree(p.rgb, p.nb)) {
    shade_patch_kernel<C, R, false, true><<<blocks, kThreads, 0, st>>>(
        ptab, pack, rays, ttab, out, viol, p, q);
  } else {
    shade_patch_kernel<C, R, false, false><<<blocks, kThreads, 0, st>>>(
        ptab, pack, rays, ttab, out, viol, p, q);
  }
  return cudaGetLastError();
}

}  // namespace

#define K3_DEFINE(C, R)                                                   \
  cudaError_t k3_launch_c##C##_r##R(                                      \
      const uint4* ptab, const float* pack, const float* rays,            \
      const float* ttab, float* out, int* viol, const ShadeParams& p,     \
      const PatchParams& q, cudaStream_t st) {                            \
    return launch<C, R>(ptab, pack, rays, ttab, out, viol, p, q, st);     \
  }

#define K3_DECLARE(C, R)                                                  \
  cudaError_t k3_launch_c##C##_r##R(                                      \
      const uint4* ptab, const float* pack, const float* rays,            \
      const float* ttab, float* out, int* viol, const ShadeParams& p,     \
      const PatchParams& q, cudaStream_t st);

K3_DECLARE(8, 4)
K3_DECLARE(8, 8)
K3_DECLARE(16, 4)
K3_DECLARE(16, 8)
