// Device code shared by the shade kernels (K2 shade.cu, K3 shade_patch.cuh,
// K5 shade_multi.cu, K6 shade_multi_patch.cu): the per-sample shading that
// follows the space features (time-plane taps and density for K2/K3; for
// all of them the colour, SH of degree 0-4 or RGB (a template argument,
// kRgb), with its colour scale/shift, the SH basis folded once per ray
// for K2, K3, K5 and K6), the staging of a warp's pack tiles for the
// thread-per-ray kernels K2 and K6, and the per-ray log-space composite:
// over an S-lane segment of a warp (S <= 32; K7 and K5-pre), over a whole
// warp with two samples per lane (S = 64, K5-pre), or a running sum per
// thread over its ray's samples (K2, K3, K5, K6).
//
// The SH degree: every SH kernel is built twice, for degree 2 (the
// presets') with its body alone, the code it ran before, and for any
// other degree (a template flag, kAnyDeg, the launchers' choice from
// ShadeParams::nb / MultiParams::nb, the basis count (deg + 1)^2), which
// switches once on nb to a body for that count, unrolled, but the fold of
// degree 3-4 rolled over the bases (sh_fold_rolled). The fold runs once
// per ray and gives the same [3, A] matrix at every degree, so a sample's
// colour does not depend on it. One kernel with the switch ran degree 2
// up to 20 % slower (K5; K5-pre 15 %) with the same registers, and up to
// 47 % with the degree-3-4 bodies rolled (PERF.md), so degree 2 keeps its
// own instantiation; a template axis per degree would build each SH
// kernel five times. (K5-pre's per-sample colour rolled over the bases
// reads its weights at run-time offsets and ran 4-25x slower than
// unrolled.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kMaxBasis = 25;                // SH degree 4
// the largest basis of a kernel's parameters: [3 * kMaxBasis, 24] floats,
// the SH basis of degree 4 over the 24 appearance channels of K5's [8, 8,
// 8] layout (K2's [3 * nb, C] takes C <= 16); 7,200 bytes, past the 4 KB
// that kernel parameters held before CUDA 12.1, inside the 32,764 bytes
// that it allows on sm_70 and later (the structs below are the kernels'
// __grid_constant__ parameters)
constexpr int kMaxWb = 3 * kMaxBasis * 24;

// global scope: see the note on PackParams in pack_build.cu
struct ShadeParams {
  int B, S, W, H, TW, TH, C, nd;
  float distance_scale;
  // SH: [3 * nb, C], rows ch * nb + k (colour ch); RGB: [3, C]
  float wb[kMaxWb];
  // the host's choice of instantiation: 1 = RGB colour (kRgb); 1 = the
  // pack has the weights row (kWeights, quad kernels only)
  int rgb, weights;
  // the SH basis count (deg + 1)^2 in 1, 4, 9, 16, 25 (1 for RGB); last,
  // so that the fields before it sit where degree 2's kernels read them
  int nb;
};

namespace shade_core {

constexpr int kPackRows = 10;
// the predicted per-sample weight, in a pack with the weights row (the
// static net's own fused route); it scales the density feature before
// the relu
constexpr int kWeightsRow = 10;
constexpr float kLogEps = -23.025850929940457f;  // log(1e-10)
constexpr float kExpClamp = 70.0f;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f;
constexpr float kC21 = -1.0925484305920792f;
constexpr float kC22 = 0.31539156525252005f;
constexpr float kC23 = -1.0925484305920792f;
constexpr float kC24 = 0.5462742152960396f;

// Whether a kernel takes this colour: RGB, or SH with nb (deg + 1)^2
// basis rows per colour channel, degree 0-4.
inline bool basis_built(int rgb, int nb) {
  return rgb || nb == 1 || nb == 4 || nb == 9 || nb == 16 || nb == 25;
}

// Whether an SH launch takes the instantiation for any degree (kAnyDeg):
// every degree but 2.
inline bool any_degree(int rgb, int nb) { return !rgb && nb != 9; }

// The first NB real SH bases (NB = (deg + 1)^2, degree 0-4) of the view
// direction (x, y, z), in the order and with the constants of the JAX
// kernel's _sh_basis_rows (hyperreel_tpu/ops/pallas/shade.py:67-101) and
// ops/sh.py eval_sh_bases.
template <int NB>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* Y) {
  if constexpr (NB <= 4) {
    Y[0] = kC0;
    if constexpr (NB > 1) {
      Y[1] = -kC1 * y;
      Y[2] = kC1 * z;
      Y[3] = -kC1 * x;
    }
  } else {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    Y[0] = kC0;
    Y[1] = -kC1 * y;
    Y[2] = kC1 * z;
    Y[3] = -kC1 * x;
    Y[4] = kC20 * xy;
    Y[5] = kC21 * yz;
    Y[6] = kC22 * (2.0f * zz - xx - yy);
    Y[7] = kC23 * xz;
    Y[8] = kC24 * (xx - yy);
    if constexpr (NB > 9) {
      Y[9] = -0.5900435899266435f * y * (3.0f * xx - yy);
      Y[10] = 2.890611442640554f * xy * z;
      Y[11] = -0.4570457994644658f * y * (4.0f * zz - xx - yy);
      Y[12] = 0.3731763325901154f * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      Y[13] = -0.4570457994644658f * x * (4.0f * zz - xx - yy);
      Y[14] = 1.445305721320277f * z * (xx - yy);
      Y[15] = -0.5900435899266435f * x * (xx - 3.0f * yy);
    }
    if constexpr (NB > 16) {
      Y[16] = 2.5033429417967046f * xy * (xx - yy);
      Y[17] = -1.7701307697799304f * yz * (3.0f * xx - yy);
      Y[18] = 0.9461746957575601f * xy * (7.0f * zz - 1.0f);
      Y[19] = -0.6690465435572892f * yz * (7.0f * zz - 3.0f);
      Y[20] = 0.10578554691520431f * (zz * (35.0f * zz - 30.0f) + 3.0f);
      Y[21] = -0.6690465435572892f * xz * (7.0f * zz - 3.0f);
      Y[22] = 0.47308734787878004f * (xx - yy) * (7.0f * zz - 1.0f);
      Y[23] = -1.7701307697799304f * xz * (xx - 3.0f * yy);
      Y[24] = 0.6258357354491761f *
              (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// Linear-interpolation taps along one grid axis (align_corners=True, zero
// padding): base index, the two weights, zeroed where a tap is off-grid.
struct Taps {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float coord, int size) {
  const float pc = (coord + 1.0f) * 0.5f * (float)(size - 1);
  const float p0 = floorf(pc);
  const float f = pc - p0;
  Taps t;
  t.i0 = (int)fminf(fmaxf(p0, -1.0f), size - 1.0f);
  t.w0 = (p0 >= 0.0f && p0 <= size - 1.0f) ? 1.0f - f : 0.0f;
  t.w1 = (p0 + 1.0f >= 0.0f && p0 + 1.0f <= size - 1.0f) ? f : 0.0f;
  return t;
}

// a bf16 is the upper 16 bits of the f32 with the same value; a 32-bit
// word holds two, the lower half first
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// acc[8q .. 8q+7] += w * the 8 bf16 of one 16-byte vector
__device__ __forceinline__ void axpy_bf16x8(float* acc, float w,
                                            const uint4& u) {
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    acc[2 * h + 0] += bf16_lo(words[h]) * w;
    acc[2 * h + 1] += bf16_hi(words[h]) * w;
  }
}

// acc[c] += w * row[c] for C contiguous f32 values (16-byte aligned)
template <int C>
__device__ __forceinline__ void axpy_row(float* acc, float w,
                                         const float* row) {
  const float4* v = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < C / 4; ++q) {
    const float4 t = __ldg(v + q);
    acc[4 * q + 0] += w * t.x;
    acc[4 * q + 1] += w * t.y;
    acc[4 * q + 2] += w * t.z;
    acc[4 * q + 3] += w * t.w;
  }
}

template <int C>
__device__ __forceinline__ void z_blend(float* out, const float* line,
                                        const Taps& tz) {
#pragma unroll
  for (int c = 0; c < C; ++c) out[c] = 0.0f;
  if (tz.w0 != 0.0f) axpy_row<C>(out, tz.w0, line + (int64_t)tz.i0 * C);
  if (tz.w1 != 0.0f) {
    axpy_row<C>(out, tz.w1, line + (int64_t)(tz.i0 + 1) * C);
  }
}

// Is this sample inside the aabb with a positive distance (pack rows
// xn, yn, zn, dist)?
__device__ __forceinline__ bool sample_valid(const float* pk) {
  return fabsf(pk[0]) <= 1.0f && fabsf(pk[1]) <= 1.0f &&
         fabsf(pk[2]) <= 1.0f && pk[3] > 0.0f;
}

// Stage samples [s0, s0 + kStage) of the 10 pack rows of ray b (zeros
// where !live) into this thread's column `mine` of its warp's tile
// [kPackRows][32][kStage + 1] (the thread-per-ray kernels K2 and K6:
// kStage = 8, 32 bytes of a row per ray, a whole sector; the odd
// stride lets the warp's threads read their columns without bank
// conflicts): 16-byte loads where `vec` (the pack 16-byte aligned and S >=
// 4, so that each ray's samples of a row are), else scalars.
template <int kStage>
__device__ __forceinline__ void stage_ray_pack(float* mine, const float* pack,
                                               int64_t N, int S, int64_t b,
                                               bool live, int s0, bool vec) {
  constexpr int kStride = kStage + 1;
  const float* src = pack + b * S + s0;
  if (vec) {
#pragma unroll
    for (int r = 0; r < kPackRows; ++r) {
#pragma unroll
      for (int h = 0; h < kStage; h += 4) {
        const float4 v =
            live && s0 + h < S
                ? __ldg(reinterpret_cast<const float4*>(src + r * N + h))
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float* t = mine + r * 32 * kStride + h;
        t[0] = v.x;
        t[1] = v.y;
        t[2] = v.z;
        t[3] = v.w;
      }
    }
  } else {
    const int n = S - s0 < kStage ? S - s0 : kStage;
#pragma unroll
    for (int r = 0; r < kPackRows; ++r) {
      for (int h = 0; h < n; ++h) {
        mine[r * 32 * kStride + h] = live ? __ldg(src + r * N + h) : 0.0f;
      }
    }
  }
}

// The SH colour of one valid sample from its C features:
// rgb = max(sum_k (wb @ feat)_k Y_k + 0.5, 0) * (scale + 1) + shift, with
// wb [3 * nb, C] (rows ch * nb + k, colour channel ch; zero on the
// density channels where feat holds them), Y the nb bases of the ray's
// view direction (ray pack row o xyz, d xyz, dt, tn) and the scale and
// shift in pack rows 4..9.
template <int C, int K>
__device__ __forceinline__ void sh_colour_nb(const float* feat,
                                             const float* wb, const float* pk,
                                             const float* ray, float* rgb) {
  float Y[K];
  sh_basis<K>(__ldg(ray + 3), __ldg(ray + 4), __ldg(ray + 5), Y);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float e = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float app = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) app += wb[(ch * K + k) * C + c] * feat[c];
      e += app * Y[k];
    }
    rgb[ch] = fmaxf(e + 0.5f, 0.0f) * (pk[4 + ch] + 1.0f) + pk[7 + ch];
  }
}

// The SH colour with nb bases: degree 2 alone, or (kAnyDeg) the body for
// the run-time basis count nb (1, 4, 16 or 25; the launchers refuse any
// other)
template <int C, bool kAnyDeg>
__device__ __forceinline__ void sh_colour(const float* feat, const float* wb,
                                          int nb, const float* pk,
                                          const float* ray, float* rgb) {
  if constexpr (!kAnyDeg) {
    sh_colour_nb<C, 9>(feat, wb, pk, ray, rgb);
  } else {
    switch (nb) {
      case 1: sh_colour_nb<C, 1>(feat, wb, pk, ray, rgb); break;
      case 4: sh_colour_nb<C, 4>(feat, wb, pk, ray, rgb); break;
      case 16: sh_colour_nb<C, 16>(feat, wb, pk, ray, rgb); break;
      default: sh_colour_nb<C, 25>(feat, wb, pk, ray, rgb); break;
    }
  }
}

// The RGB colour of one valid sample from its C features:
// rgb = sigmoid(wb @ feat) * (scale + 1) + shift, with wb [3, C] (zero on
// the density channels where feat holds them) and sigmoid(x) = 1 / (1 +
// exp(-x)), as the JAX kernel computes it (shade.py:369); the scale and
// shift in pack rows 4..9.
template <int C>
__device__ __forceinline__ void rgb_colour(const float* feat, const float* wb,
                                           const float* pk, float* rgb) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float app = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) app += wb[ch * C + c] * feat[c];
    rgb[ch] = (1.0f / (1.0f + expf(-app))) * (pk[4 + ch] + 1.0f) +
              pk[7 + ch];
  }
}

// The SH basis weights folded with one ray's view direction (x, y, z):
// M[ch * A + a] = sum_k Y_k wb[(ch * nb + k) * kRow + a], 3 nb x A FMAs
// once per ray, so that each sample's colour takes the [3, A] product
// M @ feat (sh_folded_colour) instead of sh_colour's [3 * nb, A] one.
// The same function as sh_colour up to the order of the sums. wb's rows
// hold kRow channels, of which the fold takes the first A (K3 passes wb
// from its first appearance channel: the density channels' columns are
// zero).
template <int A, int kRow, int K>
__device__ __forceinline__ void sh_fold_nb(const float* wb, float x, float y,
                                           float z, float* M) {
  float Y[K];
  sh_basis<K>(x, y, z, Y);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float m = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        m += wb[(ch * K + k) * kRow + a] * Y[k];
      }
      M[ch * A + a] = m;
    }
  }
}

// sh_fold_nb for degree 3 or 4 (K = 16, 25) with the loop over the bases
// rolled: the bases in a local array, each taken once into the 3A
// accumulators of M, so that this body holds M and one basis in
// registers (unrolled, all 25 bases and M: K5 at degree 4 ran 0.87 ms a
// chunk, rolled 0.61, PERF.md); the sum over k runs in the same order.
template <int A, int kRow, int K>
__device__ __forceinline__ void sh_fold_rolled(const float* wb, float x,
                                               float y, float z, float* M) {
  float Y[K];
  sh_basis<K>(x, y, z, Y);
#pragma unroll
  for (int i = 0; i < 3 * A; ++i) M[i] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < K; ++k) {
    const float yk = Y[k];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        M[ch * A + a] += wb[(ch * K + k) * kRow + a] * yk;
      }
    }
  }
}

// The fold with nb bases: degree 2 alone, or (kAnyDeg) the body for the
// run-time basis count nb (1, 4, 16 or 25; the launchers refuse any
// other), one uniform branch per ray
template <int A, int kRow, bool kAnyDeg>
__device__ __forceinline__ void sh_fold(const float* wb, int nb, float x,
                                        float y, float z, float* M) {
  if constexpr (!kAnyDeg) {
    sh_fold_nb<A, kRow, 9>(wb, x, y, z, M);
  } else {
    switch (nb) {
      case 1: sh_fold_nb<A, kRow, 1>(wb, x, y, z, M); break;
      case 4: sh_fold_nb<A, kRow, 4>(wb, x, y, z, M); break;
      case 16: sh_fold_rolled<A, kRow, 16>(wb, x, y, z, M); break;
      default: sh_fold_rolled<A, kRow, 25>(wb, x, y, z, M); break;
    }
  }
}

// The SH colour of one valid sample from its A features and its ray's
// folded basis M [3, A] (sh_fold): rgb = max(M @ feat + 0.5, 0) * (scale +
// 1) + shift, the scale and shift in pack rows 4..9.
template <int A>
__device__ __forceinline__ void sh_folded_colour(const float* feat,
                                                 const float* M,
                                                 const float* pk, float* rgb) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float e = 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a) e += M[ch * A + a] * feat[a];
    rgb[ch] = fmaxf(e + 0.5f, 0.0f) * (pk[4 + ch] + 1.0f) + pk[7 + ch];
  }
}

// The per-ray composite taken by one thread over its ray's samples in
// order (the sequential form of composite_weight and segment_sum): the
// log-transmittance so far and the sums r, g, b, acc, depth.
struct RayComposite {
  float log_t = 0.0f;
  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
};

// Add one sample (delta: the next sample's dist minus its own, 1e10 for
// the last) to the ray's composite.
__device__ __forceinline__ void composite_add(RayComposite& c, float sigma,
                                              const float* rgb, float dist,
                                              float delta, float scale) {
  const float x = fminf(fmaxf(sigma * (delta * scale), -kExpClamp),
                        kExpClamp);
  const float w = (1.0f - expf(-x)) * expf(c.log_t);
  c.log_t += fmaxf(-x, kLogEps);
  c.v[0] += w * rgb[0];
  c.v[1] += w * rgb[1];
  c.v[2] += w * rgb[2];
  c.v[3] += w;
  c.v[4] += w * dist;
}

// The colour of one valid sample: RGB (kRgb) or SH with nb bases (degree
// 2 unless kAnyDeg).
template <int C, bool kRgb, bool kAnyDeg>
__device__ __forceinline__ void colour(const float* feat, const float* wb,
                                       int nb, const float* pk,
                                       const float* ray, float* rgb) {
  if constexpr (kRgb) {
    rgb_colour<C>(feat, wb, pk, rgb);
  } else {
    sh_colour<C, kAnyDeg>(feat, wb, nb, pk, ray, rgb);
  }
}

// The time features and density of one valid sample: the z taps, then the
// t taps, or the z taps on a table premixed for one t, or on a static net's
// z line, when p.TH == 0; feat <- the space features times the time
// features; returns density = relu of the summed density channels (times
// the sample's weight `wt` with kWeights).
// `feat` holds the C space features and is overwritten; `pk` the sample's
// 10 pack rows, `ray` its ray pack row (o xyz, d xyz, dt, tn).
template <int C, bool kWeights>
__device__ __forceinline__ float sample_density(float* feat, const float* pk,
                                                const float* ray,
                                                const float* ttab,
                                                const ShadeParams& p,
                                                float wt) {
  const Taps tz = taps(pk[2], p.TW);
  float ft[C];
  if (p.TH == 0) {
    z_blend<C>(ft, ttab, tz);
  } else {
    const Taps tt = taps(__ldg(ray + 7), p.TH);
#pragma unroll
    for (int c = 0; c < C; ++c) ft[c] = 0.0f;
    float zf[C];
    if (tt.w0 != 0.0f) {
      z_blend<C>(zf, ttab + (int64_t)tt.i0 * p.TW * C, tz);
#pragma unroll
      for (int c = 0; c < C; ++c) ft[c] += zf[c] * tt.w0;
    }
    if (tt.w1 != 0.0f) {
      z_blend<C>(zf, ttab + (int64_t)(tt.i0 + 1) * p.TW * C, tz);
#pragma unroll
      for (int c = 0; c < C; ++c) ft[c] += zf[c] * tt.w1;
    }
  }

  float dsum = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    feat[c] *= ft[c];
    if (c < p.nd) dsum += feat[c];
  }
  return fmaxf(kWeights ? dsum * wt : dsum, 0.0f);
}

// The composite weight of this lane's sample in its ray, over the S-lane
// segment that holds the ray's samples in order (lane s of the segment is
// sample s): delta = next dist - dist (1e10 for the last sample), x =
// clip(sigma * delta * scale, +-70), alpha = 1 - exp(-x), times the
// exclusive transmittance exp(sum of max(-x, log 1e-10) over the samples
// before). An inclusive __shfl_up_sync scan; every lane of the warp must
// call it.
__device__ __forceinline__ float composite_weight(float sigma, float dist,
                                                  float scale, int s,
                                                  int S) {
  const unsigned full = 0xffffffffu;
  const float nxt = __shfl_down_sync(full, dist, 1, S);
  const float delta = (s == S - 1) ? 1e10f : nxt - dist;
  const float x = fminf(fmaxf(sigma * (delta * scale), -kExpClamp),
                        kExpClamp);
  const float alpha = 1.0f - expf(-x);
  float acc = fmaxf(-x, kLogEps);
  for (int off = 1; off < S; off <<= 1) {
    const float y = __shfl_up_sync(full, acc, off, S);
    if (s >= off) acc += y;
  }
  const float prev = __shfl_up_sync(full, acc, 1, S);
  return alpha * expf(s == 0 ? 0.0f : prev);
}

// v[i] <- the sum of v[i] over the S-lane segment (a __shfl_xor_sync
// butterfly); every lane of the warp must call it.
template <int NV>
__device__ __forceinline__ void segment_sum(float* v, int S) {
  const unsigned full = 0xffffffffu;
  for (int off = S >> 1; off >= 1; off >>= 1) {
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] += __shfl_xor_sync(full, v[i], off, S);
  }
}

// The per-ray tail every shade kernel ends with: this lane's composite
// weight, the segment's sums r, g, b, acc, depth, and lane 0 of the
// segment writes them to `out` (f32 [5]) when `store`. Every lane of the
// warp must call it.
__device__ __forceinline__ void composite_store(float sigma, const float* rgb,
                                                float dist, float scale, int s,
                                                int S, bool store,
                                                float* out) {
  const float w = composite_weight(sigma, dist, scale, s, S);
  float v[5] = {w * rgb[0], w * rgb[1], w * rgb[2], w, w * dist};
  segment_sum<5>(v, S);
  if (store && s == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) out[i] = v[i];
  }
}

// composite_store for a ray of 64 samples over a whole warp, two samples
// per lane: lane l holds samples 2l and 2l + 1 (sigma[i], rgb[3i .. 3i + 2]
// and dist[i] of sample 2l + i). The lane first combines its own pair (the delta of sample 2l is
// in the lane, that of 2l + 1 reaches to lane l + 1's first sample; the
// log-transmittance of the pair sums before the scan), then runs the warp
// scan and butterfly of composite_weight and segment_sum over 32 lanes.
// Every lane of the warp must call it.
__device__ __forceinline__ void composite_store_pair(
    const float* sigma, const float* rgb, const float* dist,
    float scale, int l, bool store, float* out) {
  const unsigned full = 0xffffffffu;
  const float nxt = __shfl_down_sync(full, dist[0], 1);
  const float delta[2] = {dist[1] - dist[0],
                          l == 31 ? 1e10f : nxt - dist[1]};
  float alpha[2], a[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float x = fminf(fmaxf(sigma[j] * (delta[j] * scale), -kExpClamp),
                          kExpClamp);
    alpha[j] = 1.0f - expf(-x);
    a[j] = fmaxf(-x, kLogEps);
  }
  float acc = a[0] + a[1];
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(full, acc, off);
    if (l >= off) acc += y;
  }
  const float prev = __shfl_up_sync(full, acc, 1);
  const float before = l == 0 ? 0.0f : prev;
  const float w[2] = {alpha[0] * expf(before), alpha[1] * expf(before + a[0])};
  float v[5] = {w[0] * rgb[0] + w[1] * rgb[3], w[0] * rgb[1] + w[1] * rgb[4],
                w[0] * rgb[2] + w[1] * rgb[5], w[0] + w[1],
                w[0] * dist[0] + w[1] * dist[1]};
  segment_sum<5>(v, 32);
  if (store && l == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) out[i] = v[i];
  }
}

}  // namespace shade_core
