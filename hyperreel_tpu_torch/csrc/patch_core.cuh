// Device code shared by the kernels of the coherent patch-gather routes:
// K3 (shade_patch.cuh, the blend inside the flagship's shade kernel), K4
// (patch_blend.cu, the blend alone, over every plane of a chunk) and K6
// (shade_multi_patch.cu, the blend of the three plane axes inside the
// multi-axis shade kernel). Port of hyperreel_tpu/ops/patch_gather.py and
// the blend of ops/pallas/patch_blend.py:_patch_blend_kernel with
// patch_anchor_idx.
//
// A coherent block j is R rays of one chunk; at every sample slot s the R
// rays' samples share one patch row per plane axis: px*py texels of C bf16
// channels, texel t = ty*px + tx channel-major, anchored at (x0, y0) =
// clip(floor(min over the R rays of the unnormalised coordinate), -1, W-1 /
// H-1), the coordinates being the plane's two point components (pack rows
// m0 and m1: 0 and 1 for the flagship's space plane, MAT_MODE of the static
// net's axis otherwise). Ray p of block j is the caller's ray R*j + p,
// found at position R*j + p, or at p*(B/R) + j when the caller delivers the
// rays phase-major; the kernels read and write each ray at its position, so
// there is no permutation and no index array. A sample's feature is
//   sum over ty < py, tx < px of max(0, 1-|u-tx|) * max(0, 1-|v-ty|) *
//   patch[t],  u = (x+1)*0.5*(W-1) - x0, v likewise,
// which is the bilinear lookup when the sample's 2x2 footprint lies in the
// patch and zero-degrades where it leaves it. Only the taps floor(u),
// floor(u)+1 (and those of v) can have a non-zero hat weight, so a thread
// blends at most four texels (the same non-zero terms in the same order as
// the full sum). The kernels also count the coverage violations: the
// slots whose valid samples' footprint exits the patch on some axis,
// floor(max) - floor(min) > p - 2 (hyperreel_tpu/models/fused_eval.py
// patch_coverage_viol, the OR over every plane's two coordinates).
//
// The anchors and the witness: the kernels hold the R rays of a coherent
// block in R neighbouring lanes of a warp at each sample slot, so a slot's
// min, its coverage test and its OR are __shfl_xor_sync butterflies over
// those lanes (span, anchor_of), with no barrier; the taps are read from
// the patch table through L1 (patch_taps).

#pragma once

#include "shade_core.cuh"

// global scope: see the note on PackParams in pack_build.cu. K3 reads every
// field; K6 reads B, S, R, px, py and phase_major (its planes' shapes are in
// its MultiParams). K4 takes its own (patch_blend.cu BlendParams).
struct PatchParams {
  int B, S, W, H, C, R, px, py, phase_major, m0, m1;
};

constexpr int kMaxPatchAxes = 3;

namespace patch_core {

// xyz[m] by selects (m is a kernel parameter: no local-memory indexing)
__device__ __forceinline__ float pick3(const float* xyz, int m) {
  return m == 0 ? xyz[0] : m == 1 ? xyz[1] : xyz[2];
}

// the unnormalised texel coordinate (align_corners=True)
__device__ __forceinline__ float texel(float coord, int size) {
  return (coord + 1.0f) * 0.5f * (float)(size - 1);
}

// The warp prologue of K3, K4 and K6. At one sample slot the R rays of a
// coherent block sit in R neighbouring lanes of a warp (lane bits below R;
// every lane of the warp takes part, the lanes of a dead coherent block
// too). One coordinate's span over them: the min over every sample (the
// anchor counts every sample, as the JAX anchors do) and the min and max
// over the valid samples (the coverage test counts those); `all_valid`
// (warp-uniform) says that every live lane's sample is valid, so that the
// min over the valid samples is the min over all.
struct Span {
  float mn, lo, hi;
};

template <int R>
__device__ __forceinline__ Span span(float x, bool valid, bool all_valid) {
  const int kLanes = R;
  const unsigned full = 0xffffffffu;
  const float inf = __int_as_float(0x7f800000);
  Span s{x, valid ? x : inf, valid ? x : -inf};
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    s.mn = fminf(s.mn, __shfl_xor_sync(full, s.mn, o));
    s.hi = fmaxf(s.hi, __shfl_xor_sync(full, s.hi, o));
    if (!all_valid) s.lo = fminf(s.lo, __shfl_xor_sync(full, s.lo, o));
  }
  if (all_valid) s.lo = s.mn;
  return s;
}

// The anchor (x0, y0), the patch-table row and the witness of one plane
// at one slot from its two coordinates' spans. floor(texel(.)) is
// monotone, so the floors' min and max are the floors of the coordinates'
// min and max; with no valid sample hi = -inf < lo and nothing violates.
struct SlotAnchor {
  float x0, y0;
  int idx;
  bool viol;
};

__device__ __forceinline__ SlotAnchor anchor_of(const Span& x, const Span& y,
                                                int W, int H, int px,
                                                int py) {
  SlotAnchor a;
  a.viol = x.hi >= x.lo &&
           (floorf(texel(x.hi, W)) - floorf(texel(x.lo, W)) >
                (float)(px - 2) ||
            floorf(texel(y.hi, H)) - floorf(texel(y.lo, H)) >
                (float)(py - 2));
  a.x0 = fminf(fmaxf(floorf(texel(x.mn, W)), -1.0f), (float)(W - 1));
  a.y0 = fminf(fmaxf(floorf(texel(y.mn, H)), -1.0f), (float)(H - 1));
  a.idx = ((int)a.y0 + 1) * (W + 1) + ((int)a.x0 + 1);
  return a;
}

// The hat blend of one sample from its slot's row in the patch table, read
// through L1 (K3, K4, K6): the four taps around (u, v) in the order of the
// full sum, with the taps' indices clamped into the row and the weight of a
// tap outside the patch 0 (an added 0 changes no sum). Skipping those taps
// by branches, as K6's earlier shared-memory blend did, measured slower in
// both kernels (scripts/patch_variants.py `skip_taps`: K3 0.437 against
// 0.416 ms, K4 over n3d's three planes 1.24 against 0.82).
template <int C>
__device__ __forceinline__ void patch_taps(const uint4* __restrict__ row,
                                           float u, float v, int px, int py,
                                           float* feat) {
  const float fx0 = floorf(u), fy0 = floorf(v);
  float wx[2], wy[2];
  int ix[2], iy[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float tx = fx0 + (float)d, ty = fy0 + (float)d;
    const bool inx = tx >= 0.0f && tx <= (float)(px - 1);
    const bool iny = ty >= 0.0f && ty <= (float)(py - 1);
    wx[d] = inx ? fmaxf(0.0f, 1.0f - fabsf(u - tx)) : 0.0f;
    wy[d] = iny ? fmaxf(0.0f, 1.0f - fabsf(v - ty)) : 0.0f;
    ix[d] = inx ? (int)tx : 0;
    iy[d] = iny ? (int)ty : 0;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float w = wx[dx] * wy[dy];
      const uint4* tex = row + (iy[dy] * px + ix[dx]) * (C / 8);
#pragma unroll
      for (int k = 0; k < C / 8; ++k) {
        shade_core::axpy_bf16x8(feat + 8 * k, w, __ldg(tex + k));
      }
    }
  }
}

// A sample's offsets inside its slot's patch, in the JAX kernels' op order:
// ((x + 1) * 0.5) * (W - 1) - x0, with no fused multiply-add.
__device__ __forceinline__ float patch_offset(float coord, int size,
                                              float anchor) {
  return __fmul_rn((coord + 1.0f) * 0.5f, (float)(size - 1)) - anchor;
}

}  // namespace patch_core
