// Device code shared by the multi-axis shade kernels of the static VM net
// (TensorVMNoSample, the llff_z_plane family): K5 shade_multi.cu (quad
// rows, or the pre-blended features of K4) and K6 shade_multi_patch.cu (the
// patch blend inside). Port of the per-axis body of
// hyperreel_tpu/ops/pallas/shade.py:_multi_core for static nets (time_hs
// all 0: a plane times a line per axis).
//
// Axis i of the VM decomposition spans the point components MAT_MODE[i] =
// (0, 1), (0, 2), (1, 2) with its plane and VEC_MODE[i] = 2, 1, 0 with its
// line. Per valid sample and axis: the plane features (C channels), the
// line's two linear taps at (c + 1) * 0.5 * (L - 1) (zero off the line, as
// the JAX kernel's ring-padded two-hot), their product; the first nd
// channels sum into the density feature (per axis, then across axes, as
// JAX adds each axis's sum), the rest append to one appearance vector in
// axis order; then one SH-2 colour from it (shade_core.cuh sh_colour with
// the [3 * kBasis, A] basis, A the appearance channels) and relu density.
// The kernels are built for the llff_z_plane family's layout, axes 0, 1, 2
// with C = 16, 8, 8 of which 8, 4, 4 density channels (the [8, 4, 4]
// presets and tiny_static with those components). The constants below are
// the layout's one owner: shade_multi.cu exports them (multi_layout), and
// the loader (ops/kernels/build.py) hands them to the wrappers' check.

#pragma once

#include "shade_core.cuh"

// global scope: see the note on PackParams in pack_build.cu
struct MultiAxis {
  // K5: bf16 quad table [(H+1)*(W+1), 4C]; K5 pre-blended: bf16 features
  // [B*S, C] in the pack's order; K6: bf16 patch table [(H+1)*(W+1),
  // px*py*C]
  const void* table;
  const float* line;  // f32 [L, C]
  int W, H, L;
};

struct MultiParams {
  int B, S;
  float distance_scale;
  MultiAxis axis[3];
  float wb[kMaxWb];  // [3 * kBasis, A], rows ch * kBasis + k
};

namespace multi_core {

constexpr int kCh0 = 16, kCh1 = 8, kCh2 = 8;  // channels of axes 0, 1, 2
constexpr int kNd0 = 8, kNd1 = 4, kNd2 = 4;   // of which density channels
constexpr int kApp = kCh0 - kNd0 + kCh1 - kNd1 + kCh2 - kNd2;

// the pack rows of axis A's plane coordinates and of its line coordinate
template <int A>
struct Mode {
  static constexpr int m0 = A == 2 ? 1 : 0;
  static constexpr int m1 = A == 0 ? 1 : 2;
  static constexpr int v = 2 - A;
};

// The plane features of one sample: bilinear from the 4 corners of its
// quad-table row (JAX weight order (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx)
template <int A, int C>
__device__ __forceinline__ void quad_features(const MultiAxis& ax,
                                              const float* pk, float* feat) {
  using namespace shade_core;
  const Taps tx = taps(pk[Mode<A>::m0], ax.W);
  const Taps ty = taps(pk[Mode<A>::m1], ax.H);
  const float w4[4] = {ty.w0 * tx.w0, ty.w0 * tx.w1, ty.w1 * tx.w0,
                       ty.w1 * tx.w1};
  const int64_t qrow = (int64_t)(ty.i0 + 1) * (ax.W + 1) + (tx.i0 + 1);
  const uint4* qr = static_cast<const uint4*>(ax.table) + qrow * (C / 2);
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int q = 0; q < C / 8; ++q) {
      axpy_bf16x8(feat + 8 * q, w4[k], __ldg(qr + k * (C / 8) + q));
    }
  }
}

// The pre-blended plane features of sample g (C bf16, one row per sample)
template <int C>
__device__ __forceinline__ void row_features(const MultiAxis& ax, int64_t g,
                                             float* feat) {
  const uint4* fr = static_cast<const uint4*>(ax.table) + g * (C / 8);
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.0f;
#pragma unroll
  for (int q = 0; q < C / 8; ++q) {
    shade_core::axpy_bf16x8(feat + 8 * q, 1.0f, __ldg(fr + q));
  }
}

// Axis A's line factor times its plane features `feat`: the density
// channels' sum is added to dsum, the rest written to app[0 .. C - ND).
template <int A, int C, int ND>
__device__ __forceinline__ void line_product(const MultiAxis& ax,
                                             const float* pk,
                                             const float* feat, float& dsum,
                                             float* app) {
  using namespace shade_core;
  float lf[C];
  z_blend<C>(lf, ax.line, taps(pk[Mode<A>::v], ax.L));
  float ds = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float pr = feat[c] * lf[c];
    if (c < ND) {
      ds += pr;
    } else {
      app[c - ND] = pr;
    }
  }
  dsum += ds;
}

}  // namespace multi_core
