// Device code shared by the shade kernels (K2 shade.cu, K3 shade_patch.cuh,
// K5 shade_multi.cu, K6 shade_multi_patch.cu): the per-sample shading that
// follows the space features (time-plane taps and density for K2/K3; for
// all of them the colour, SH of degree 2 or RGB (a template argument,
// kRgb), with its colour scale/shift, the SH basis folded once per ray
// for K2, K3, K5 and K6), the staging of a warp's pack tiles for the
// thread-per-ray kernels K2 and K6, and the per-ray log-space composite:
// over an S-lane segment of a warp (S <= 32; K7 and K5-pre), over a whole
// warp with two samples per lane (S = 64, K5-pre), or a running sum per
// thread over its ray's samples (K2, K3, K5, K6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kBasis = 9;                    // SH degree 2
// the largest basis of a kernel's parameters: [3 * kBasis, 24] floats, the
// SH basis over the 24 appearance channels of K5's [8, 8, 8] layout (K2's
// [3 * kBasis, C] takes C <= 16); 2592 bytes, well inside the 4 KB of a
// kernel's parameters
constexpr int kMaxWb = 3 * kBasis * 24;

// global scope: see the note on PackParams in pack_build.cu
struct ShadeParams {
  int B, S, W, H, TW, TH, C, nd;
  float distance_scale;
  // SH: [3 * kBasis, C], rows ch * kBasis + k (colour ch); RGB: [3, C]
  float wb[kMaxWb];
  // the host's choice of instantiation: 1 = RGB colour (kRgb); 1 = the
  // pack has the weights row (kWeights, quad kernels only)
  int rgb, weights;
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

// the 9 real SH bases of degree <= 2 (the flagship's and tiny_dynamic's)
__device__ __forceinline__ void sh_basis2(float x, float y, float z,
                                          float* Y) {
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

// The SH-2 colour of one valid sample from its C features:
// rgb = max(sum_k (wb @ feat)_k Y_k + 0.5, 0) * (scale + 1) + shift, with
// wb [3 * kBasis, C] (rows ch * kBasis + k, colour channel ch; zero on the
// density channels where feat holds them), Y the bases of the ray's view
// direction (ray pack row o xyz, d xyz, dt, tn) and the scale and shift
// in pack rows 4..9.
template <int C>
__device__ __forceinline__ void sh_colour(const float* feat, const float* wb,
                                          const float* pk, const float* ray,
                                          float* rgb) {
  constexpr int K = kBasis;
  float Y[K];
  sh_basis2(__ldg(ray + 3), __ldg(ray + 4), __ldg(ray + 5), Y);
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

// The SH-2 basis weights folded with one ray's view direction (x, y, z):
// M[ch * A + a] = sum_k Y_k wb[(ch * kBasis + k) * kRow + a], 27 x A FMAs
// once per ray, so that each sample's colour takes the [3, A] product
// M @ feat (sh_folded_colour) instead of sh_colour's [3 * kBasis, A] one.
// The same function as sh_colour up to the order of the sums. wb's rows
// hold kRow channels, of which the fold takes the first A (K3 passes wb
// from its first appearance channel: the density channels' columns are
// zero).
template <int A, int kRow = A>
__device__ __forceinline__ void sh_fold(const float* wb, float x, float y,
                                        float z, float* M) {
  float Y[kBasis];
  sh_basis2(x, y, z, Y);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float m = 0.0f;
#pragma unroll
      for (int k = 0; k < kBasis; ++k) {
        m += wb[(ch * kBasis + k) * kRow + a] * Y[k];
      }
      M[ch * A + a] = m;
    }
  }
}

// The SH-2 colour of one valid sample from its A features and its ray's
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

// The colour of one valid sample: RGB (kRgb) or SH of degree 2.
template <int C, bool kRgb>
__device__ __forceinline__ void colour(const float* feat, const float* wb,
                                       const float* pk, const float* ray,
                                       float* rgb) {
  if constexpr (kRgb) {
    rgb_colour<C>(feat, wb, pk, rgb);
  } else {
    sh_colour<C>(feat, wb, pk, ray, rgb);
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
