// Device code shared by the multi-axis shade kernels of the VM nets: the
// static net (TensorVMNoSample, the llff_z_plane family: a plane times a
// line per axis) and the dynamic one (TensorVMKeyframeTime with three
// axes, the neural_3d_z_plane family: a space plane times a keyframe time
// plane per axis). K5 shade_multi.cu (quad rows, or the pre-blended
// features of K4) and K6 shade_multi_patch.cu (the patch blend inside).
// Port of the per-axis body of hyperreel_tpu/ops/pallas/shade.py:
// _multi_core (and of _shade_kernel_multi_fused_patch's second factor).
//
// Axis i of the VM decomposition spans the point components MAT_MODE[i] =
// (0, 1), (0, 2), (1, 2) with its plane and VEC_MODE[i] = 2, 1, 0 with its
// second factor. Per valid sample and axis: the plane features (C
// channels); the second factor: for a static net the line's two linear
// taps at (c + 1) * 0.5 * (L - 1) (zero off the line, as the JAX kernel's
// ring-padded two-hot), for a dynamic net (TH > 0) the same z taps on the
// two keyframe rows of the time plane [TH, L, C] around the ray's time
// coordinate tn, blended by tn's two taps (the JAX kernel's :711-722 with
// its TH + 2 ring padding replaced by zero-weight taps, as
// shade_core.cuh sample_density does for the flagship; a time plane
// premixed for one t is a line, TH = 0); their product; the first nd
// channels sum into the density feature (per axis, then across axes, as
// JAX adds each axis's sum), the rest append to one appearance vector in
// axis order; then one colour from it (shade_core.cuh: SH of degree 0-4
// from the [3 * nb, A] basis folded once per ray with the ray's view
// direction, or RGB with a [3, A] basis, A the appearance channels) and
// relu density (of the density sum times the sample's weight where the
// pack has the weights row).
// The channel layout (C and density channels per axis) is a template
// argument of every kernel here (Layout below). K5's quad kernel is built
// for [8, 4, 4] (axes 0, 1, 2 with C = 16, 8, 8 of which 8, 4, 4 density
// channels: the llff_z_plane, shiny_z_plane, neural_3d_z_plane,
// donerf_sphere and immersive_sphere_new presets) and [8, 8, 8] (C = 16 on
// every axis, 8 density: catacaustics_distance); K5's pre-blended kernel
// and K6 for [8, 4, 4] only, since no route reaches them at [8, 8, 8] (a
// chain that is not a z-plane chain never takes the channels-first
// route). The aliases below (Layout844, Layout888, PatchLayout) are the
// layouts' one owner: the launchers check a launch's layout against them
// and refuse any other, and shade_multi.cu exports them (multi_layouts) to
// the loader (ops/kernels/build.py), which hands them to the wrappers'
// check.

#pragma once

#include <type_traits>

#include "shade_core.cuh"

// global scope: see the note on PackParams in pack_build.cu
struct MultiAxis {
  // K5: bf16 quad table [(H+1)*(W+1), 4C]; K5 pre-blended: bf16 features
  // [B*S, C] in the pack's order; K6: bf16 patch table [(H+1)*(W+1),
  // px*py*C]
  const void* table;
  // f32 second factor: the line [L, C] (TH = 0), or the time plane
  // [TH, L, C] (L its length along VEC_MODE)
  const float* line;
  int W, H, L, TH;
};

struct MultiParams {
  int B, S;
  float distance_scale;
  MultiAxis axis[3];
  // the layout: C and density channels of axes 0, 1, 2 (0 for an axis
  // that is absent); a launcher runs only a layout it is built for
  int ch[3], nd[3];
  float wb[kMaxWb];  // SH: [3 * nb, A], rows ch * nb + k; RGB [3, A]
  // the host's choice of instantiation: 1 = RGB colour (kRgb); 1 = the
  // pack has the weights row (kWeights, the quad kernel only)
  int rgb, weights;
  int nb;            // the SH basis count (deg + 1)^2 (1 for RGB)
};

namespace multi_core {

// A layout: axes 0, 1, 2 with C0, C1, C2 channels, of which N0, N1, N2
// density channels; kApp appearance channels in all.
template <int C0, int N0, int C1, int N1, int C2, int N2>
struct Layout {
  static constexpr int kCh0 = C0, kCh1 = C1, kCh2 = C2;
  static constexpr int kNd0 = N0, kNd1 = N1, kNd2 = N2;
  static constexpr int kApp = C0 - N0 + C1 - N1 + C2 - N2;
  template <int A>
  __host__ __device__ static constexpr int ch() {
    return A == 0 ? C0 : A == 1 ? C1 : C2;
  }
  template <int A>
  __host__ __device__ static constexpr int nd() {
    return A == 0 ? N0 : A == 1 ? N1 : N2;
  }
  // Is this the layout of p?
  static bool of(const MultiParams& p) {
    return p.ch[0] == C0 && p.ch[1] == C1 && p.ch[2] == C2 &&
           p.nd[0] == N0 && p.nd[1] == N1 && p.nd[2] == N2;
  }
  // (C, density channels) of axes 0, 1, 2 into v[0 .. 6)
  static void write(int* v) {
    const int c_nd[6] = {C0, N0, C1, N1, C2, N2};
    for (int i = 0; i < 6; ++i) v[i] = c_nd[i];
  }
};

// K5's quad kernel is built for both; K5's pre-blended kernel and K6 for
// PatchLayout only
using Layout844 = Layout<16, 8, 8, 4, 8, 4>;
using Layout888 = Layout<16, 8, 16, 8, 16, 8>;
using PatchLayout = Layout844;

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

// Axis A's second factor (the line, or the time plane at the ray's time
// coordinate tn) times its plane features `feat`: the density channels'
// sum is added to dsum, the rest written to app[0 .. C - ND). kTime:
// compiled with the time-plane branch (a launch with some TH > 0), so that
// the static nets' kernels keep their registers.
template <int A, int C, int ND, bool kTime>
__device__ __forceinline__ void line_product(const MultiAxis& ax,
                                             const float* pk, float tn,
                                             const float* feat, float& dsum,
                                             float* app) {
  using namespace shade_core;
  float lf[C];
  if (!kTime || ax.TH == 0) {
    z_blend<C>(lf, ax.line, taps(pk[Mode<A>::v], ax.L));
  } else {
    const Taps tz = taps(pk[Mode<A>::v], ax.L);
    const Taps tt = taps(tn, ax.TH);
#pragma unroll
    for (int c = 0; c < C; ++c) lf[c] = 0.0f;
    float zf[C];
    if (tt.w0 != 0.0f) {
      z_blend<C>(zf, ax.line + (int64_t)tt.i0 * ax.L * C, tz);
#pragma unroll
      for (int c = 0; c < C; ++c) lf[c] += zf[c] * tt.w0;
    }
    if (tt.w1 != 0.0f) {
      z_blend<C>(zf, ax.line + (int64_t)(tt.i0 + 1) * ax.L * C, tz);
#pragma unroll
      for (int c = 0; c < C; ++c) lf[c] += zf[c] * tt.w1;
    }
  }
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

// Everything after the three planes' features of one valid sample (the
// per-axis products, relu density of their sum (times the sample's weight
// `wt` with kWeights), the colour) at layout L: `feat(A, f)` writes axis
// A's C_A plane features to f (A a std::integral_constant).
template <class L, bool kTime, bool kRgb, bool kWeights, bool kAnyDeg,
          typename Feat>
__device__ __forceinline__ void shade_axes(const MultiParams& p,
                                           const float* pk, const float* ray,
                                           Feat feat, float wt, float& sigma,
                                           float* rgb) {
  const float tn = kTime ? __ldg(ray + 7) : 0.0f;
  float dsum = 0.0f;
  float app[L::kApp];
  {
    float f[L::kCh0];
    feat(std::integral_constant<int, 0>{}, f);
    line_product<0, L::kCh0, L::kNd0, kTime>(p.axis[0], pk, tn, f, dsum,
                                             app);
  }
  {
    float f[L::kCh1];
    feat(std::integral_constant<int, 1>{}, f);
    line_product<1, L::kCh1, L::kNd1, kTime>(p.axis[1], pk, tn, f, dsum,
                                             app + L::kCh0 - L::kNd0);
  }
  {
    float f[L::kCh2];
    feat(std::integral_constant<int, 2>{}, f);
    line_product<2, L::kCh2, L::kNd2, kTime>(
        p.axis[2], pk, tn, f, dsum,
        app + L::kCh0 - L::kNd0 + L::kCh1 - L::kNd1);
  }
  sigma = fmaxf(kWeights ? dsum * wt : dsum, 0.0f);
  shade_core::colour<L::kApp, kRgb, kAnyDeg>(app, p.wb, p.nb, pk, ray, rgb);
}

// Does any axis of p have a time plane (TH > 0)?
inline bool has_time(const MultiParams& p) {
  return p.axis[0].TH > 0 || p.axis[1].TH > 0 || p.axis[2].TH > 0;
}

// ---- The per-sample body of K5 and K6 (shade_multi.cu,
// shade_multi_patch.cu): the second factors through L1 without branches on
// their taps, and the colour from the ray's folded basis. line_product and
// shade_axes above stay K5-pre's.

// out[c] (+)= w0 * r0[c] + w1 * r1[c] for C contiguous f32 of two 16-byte
// aligned rows in device memory (kAcc: added to out)
template <int C, bool kAcc>
__device__ __forceinline__ void blend_rows(float* out, const float* r0,
                                           const float* r1, float w0,
                                           float w1) {
  const float4* a = reinterpret_cast<const float4*>(r0);
  const float4* b = reinterpret_cast<const float4*>(r1);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 u = __ldg(a + q);
    const float4 v = __ldg(b + q);
    const float s[4] = {u.x * w0 + v.x * w1, u.y * w0 + v.y * w1,
                        u.z * w0 + v.z * w1, u.w * w0 + v.w * w1};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[4 * q + i] = (kAcc ? out[4 * q + i] : 0.0f) + s[i];
    }
  }
}

// Axis A's second factor at one sample: the line's two z taps (!kTime),
// or those taps on the two keyframe rows around the ray's tn (kTime) mixed
// by tn's taps `tt` (the four rows' weights the products of a z and a t
// tap; a line in a kTime launch, TH = 0, has tt = {0, 1, 0}: its row 0
// with weight 1). Each index is clamped onto the table (where a tap is
// clamped its weight is 0), so that a zero-weight tap still reads a valid
// row and no branch depends on a tap's weight.
template <int A, int C, bool kTime>
__device__ __forceinline__ void second_factor(const MultiAxis& ax,
                                              const float* pk,
                                              const shade_core::Taps& tt,
                                              float* lf) {
  using namespace shade_core;
  const Taps tz = taps(pk[Mode<A>::v], ax.L);
  const int z0 = max(tz.i0, 0) * C, z1 = min(tz.i0 + 1, ax.L - 1) * C;
  if constexpr (!kTime) {
    blend_rows<C, false>(lf, ax.line + z0, ax.line + z1, tz.w0, tz.w1);
    return;
  }
  const float* k0 = ax.line + (int64_t)max(tt.i0, 0) * ax.L * C;
  const float* k1 =
      ax.line + (int64_t)max(min(tt.i0 + 1, ax.TH - 1), 0) * ax.L * C;
  blend_rows<C, false>(lf, k0 + z0, k0 + z1, tz.w0 * tt.w0, tz.w1 * tt.w0);
  blend_rows<C, true>(lf, k1 + z0, k1 + z1, tz.w0 * tt.w1, tz.w1 * tt.w1);
}

// The product of one axis's plane features and second factor: the first ND
// channels' sum added to dsum, the rest written to app[0 .. C - ND).
template <int C, int ND>
__device__ __forceinline__ void axis_product(const float* feat,
                                             const float* lf, float& dsum,
                                             float* app) {
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

// One valid sample of K5 or K6 after its pack rows, at layout L: each
// axis's plane features (`feat(A, f)`, A a std::integral_constant) times
// its second factor (tt[A] the ray's time taps), relu density of the
// density sum (times the sample's weight `wt` with kWeights), and the
// colour: RGB from the [3, A] basis in the parameters, or SH from the
// ray's folded basis M (sh_fold).
template <class L, bool kTime, bool kRgb, bool kWeights, typename Feat>
__device__ __forceinline__ void shade_k5_sample(
    const MultiParams& p, const float* pk, const shade_core::Taps* tt,
    Feat feat, const float* M, float wt, float& sigma, float* rgb) {
  float dsum = 0.0f;
  float app[L::kApp];
  {
    float f[L::kCh0], lf[L::kCh0];
    feat(std::integral_constant<int, 0>{}, f);
    second_factor<0, L::kCh0, kTime>(p.axis[0], pk, tt[0], lf);
    axis_product<L::kCh0, L::kNd0>(f, lf, dsum, app);
  }
  {
    float f[L::kCh1], lf[L::kCh1];
    feat(std::integral_constant<int, 1>{}, f);
    second_factor<1, L::kCh1, kTime>(p.axis[1], pk, tt[1], lf);
    axis_product<L::kCh1, L::kNd1>(f, lf, dsum, app + L::kCh0 - L::kNd0);
  }
  {
    float f[L::kCh2], lf[L::kCh2];
    feat(std::integral_constant<int, 2>{}, f);
    second_factor<2, L::kCh2, kTime>(p.axis[2], pk, tt[2], lf);
    axis_product<L::kCh2, L::kNd2>(
        f, lf, dsum, app + L::kCh0 - L::kNd0 + L::kCh1 - L::kNd1);
  }
  sigma = fmaxf(kWeights ? dsum * wt : dsum, 0.0f);
  if constexpr (kRgb) {
    shade_core::rgb_colour<L::kApp>(app, p.wb, pk, rgb);
  } else {
    shade_core::sh_folded_colour<L::kApp>(app, M, pk, rgb);
  }
}

}  // namespace multi_core
