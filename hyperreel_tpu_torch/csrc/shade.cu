// Shade + composite kernel (K2): from the per-sample pack to the per-ray
// colour, one S-lane segment of a warp per ray, one lane per sample.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel (the quad
// route: _shade_core, _corner_weights, _twohot_matmul, _shade_tail,
// _compact_rows) together with the XLA quad-row gather that fed it
// (models/fused_eval.py `tabs[a][0][idx8[a]]`).
//
// Bound on the H100: device-memory bytes and load latency. Per valid
// sample a lane reads its 40-byte pack column and one 8*C-byte quad row
// (the four bilinear corners of its space-plane texel, bf16), plus four
// C-float taps of the time plane, which is small enough (TH*TW*C f32,
// 20 KB for the flagship) to stay in L1/L2; the view direction and the
// time coordinate are per ray and come from the 32-byte ray pack row,
// one L1 line shared by the segment. Design: the lane computes its own
// texel row from xn/yn and loads it with 16-byte vector loads (no gather
// kernel, no index array in HBM); samples outside the aabb skip every
// table load. The basis matrix rides in the kernel parameters (constant
// bank), so the 27 x C product compiles to FMAs with constant operands.
// The per-ray composite is a log-space inclusive scan over __shfl_up_sync
// inside the segment, and the per-ray sums a butterfly of __shfl_xor_sync:
// nothing per-sample is written to memory. Built for SH degree 2 and
// C in {8, 16}, the (C, degree) pairs of the ported configurations.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kBasis = 9;                    // SH degree 2
constexpr int kMaxWb = 3 * kBasis * 16;      // [3 * kBasis, C] floats

// global scope: see the note on PackParams in pack_build.cu
struct ShadeParams {
  int B, S, W, H, TW, TH, C, nd;
  float distance_scale;
  float wb[kMaxWb];  // [3 * kBasis, C], rows ch * kBasis + k (colour ch)
};

namespace {

constexpr int kPackRows = 10;
constexpr int kThreads = 128;
constexpr float kLogEps = -23.025850929940457f;  // log(1e-10)
constexpr float kExpClamp = 70.0f;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
__constant__ float kC2[5] = {1.0925484305920792f, -1.0925484305920792f,
                          0.31539156525252005f, -1.0925484305920792f,
                          0.5462742152960396f};

// the 9 real SH bases of degree <= 2 (the flagship's and tiny_dynamic's)
__device__ __forceinline__ void sh_basis2(float x, float y, float z,
                                          float* Y) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  Y[0] = kC0;
  Y[1] = -kC1 * y;
  Y[2] = kC1 * z;
  Y[3] = -kC1 * x;
  Y[4] = kC2[0] * xy;
  Y[5] = kC2[1] * yz;
  Y[6] = kC2[2] * (2.0f * zz - xx - yy);
  Y[7] = kC2[3] * xz;
  Y[8] = kC2[4] * (xx - yy);
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

template <int C>
__global__ void shade_kernel(const uint4* __restrict__ quad,
                             const float* __restrict__ pack,
                             const float* __restrict__ rays,
                             const float* __restrict__ ttab,
                             float* __restrict__ out, const ShadeParams p) {
  constexpr int K = kBasis;
  constexpr int kRowVecs = C / 2;  // 4*C bf16 = C/2 uint4 per quad row
  const int S = p.S;
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t N = (int64_t)p.B * S;
  const bool live = g < N;
  const int s = (int)(g % S);

  float pk[kPackRows];
#pragma unroll
  for (int i = 0; i < kPackRows; ++i) {
    pk[i] = live ? __ldg(pack + (int64_t)i * N + g) : 0.0f;
  }
  const float xn = pk[0], yn = pk[1], zn = pk[2];
  const float dist = pk[3];
  // the ray pack row: o xyz, d xyz (the view direction), dt, tn
  const float* ray = rays + (live ? g / S : 0) * 8;
  const bool valid = live && fabsf(xn) <= 1.0f && fabsf(yn) <= 1.0f &&
                     fabsf(zn) <= 1.0f && dist > 0.0f;

  float sigma = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    // ---- space plane: the 4 bilinear corners in one quad-table row
    const Taps tx = taps(xn, p.W);
    const Taps ty = taps(yn, p.H);
    const float w4[4] = {ty.w0 * tx.w0, ty.w0 * tx.w1, ty.w1 * tx.w0,
                         ty.w1 * tx.w1};
    // JAX weight order: (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
    const int64_t qrow = (int64_t)(ty.i0 + 1) * (p.W + 1) + (tx.i0 + 1);
    const uint4* qr = quad + qrow * kRowVecs;
    float feat[C];
#pragma unroll
    for (int c = 0; c < C; ++c) feat[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {
        const uint4 u = __ldg(qr + k * (C / 8) + q);
        const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          // two bf16 per word, the lower half first; a bf16 is the upper
          // 16 bits of the f32 with the same value
          feat[8 * q + 2 * h + 0] += __uint_as_float(words[h] << 16) * w4[k];
          feat[8 * q + 2 * h + 1] +=
              __uint_as_float(words[h] & 0xffff0000u) * w4[k];
        }
      }
    }

    // ---- time plane: z taps, then t taps (TH == 0: premixed [TW, C])
    const Taps tz = taps(zn, p.TW);
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

    // ---- density (relu of the summed density channels) and colour
    float dsum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      feat[c] *= ft[c];
      if (c < p.nd) dsum += feat[c];
    }
    sigma = fmaxf(dsum, 0.0f);
    float Y[K];
    sh_basis2(__ldg(ray + 3), __ldg(ray + 4), __ldg(ray + 5), Y);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float e = 0.0f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        float app = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          app += p.wb[(ch * K + k) * C + c] * feat[c];
        }
        e += app * Y[k];
      }
      rgb[ch] = fmaxf(e + 0.5f, 0.0f) * (pk[4 + ch] + 1.0f) + pk[7 + ch];
    }
  }

  // ---- per-ray composite over the S-lane segment
  const unsigned full = 0xffffffffu;
  const float nxt = __shfl_down_sync(full, dist, 1, S);
  const float delta = (s == S - 1) ? 1e10f : nxt - dist;
  const float x =
      fminf(fmaxf(sigma * (delta * p.distance_scale), -kExpClamp), kExpClamp);
  const float alpha = 1.0f - expf(-x);
  float acc = fmaxf(-x, kLogEps);
  for (int off = 1; off < S; off <<= 1) {
    const float y = __shfl_up_sync(full, acc, off, S);
    if (s >= off) acc += y;
  }
  const float prev = __shfl_up_sync(full, acc, 1, S);
  const float w = alpha * expf(s == 0 ? 0.0f : prev);
  float v[5] = {w * rgb[0], w * rgb[1], w * rgb[2], w, w * dist};
  for (int off = S >> 1; off >= 1; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 5; ++i) v[i] += __shfl_xor_sync(full, v[i], off, S);
  }
  if (live && s == 0) {
    float* o = out + (g / S) * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = v[i];
  }
}

template <int C>
cudaError_t launch_c(const uint4* quad, const float* pack, const float* rays,
                     const float* ttab, float* out, const ShadeParams& p,
                     unsigned blocks, cudaStream_t st) {
  shade_kernel<C><<<blocks, kThreads, 0, st>>>(quad, pack, rays, ttab, out,
                                               p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shade_launch(const void* quad, const float* pack,
                            const float* rays, const float* ttab, float* out,
                            const ShadeParams* p, void* stream) {
  const int S = p->S;
  if (S < 1 || S > 32 || (S & (S - 1))) return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)p->B * S;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const uint4* q = static_cast<const uint4*>(quad);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->C) {
    case 8: return (int)launch_c<8>(q, pack, rays, ttab, out, *p, blocks, st);
    case 16: return (int)launch_c<16>(q, pack, rays, ttab, out, *p, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int shade_params_size() { return (int)sizeof(ShadeParams); }
