// Shade + composite kernel (K2): from the per-sample pack to the per-ray
// colour, one S-lane segment of a warp per ray, one lane per sample.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel (the quad
// route: _shade_core, _corner_weights, _twohot_matmul, _shade_tail,
// _compact_rows) together with the XLA quad-row gather that fed it
// (models/fused_eval.py `tabs[a][0][idx8[a]]`); and, as the pre-blended
// variant, the same kernel with `preblended="phase_major"` (shade.py
// :259-262, :626-632), which reads the space features that the
// patch-blend kernel (K4, patch_blend.cu) wrote.
//
// Bound on the H100: device-memory bytes and load latency. Per valid
// sample a lane reads its 40-byte pack column and either one 8*C-byte quad
// row (the four bilinear corners of its space-plane texel, bf16) or, pre-
// blended, its 2*C-byte bf16 feature row, plus four C-float taps of the
// time plane, which is small enough (TH*TW*C f32, 20 KB for the flagship)
// to stay in L1/L2; the view direction and the time coordinate are per ray
// and come from the 32-byte ray pack row, one L1 line shared by the
// segment. Design: the lane computes its own texel row from xn/yn and
// loads it with 16-byte vector loads (no gather kernel, no index array in
// HBM); samples outside the aabb skip every table load. The basis matrix
// rides in the kernel parameters (constant bank), so the 27 x C product
// compiles to FMAs with constant operands. The per-ray composite is a
// log-space inclusive scan over __shfl_up_sync inside the segment, and the
// per-ray sums a butterfly of __shfl_xor_sync: nothing per-sample is
// written to memory. Built for C in {8, 16} with SH of degree 2 or RGB
// colour (a template argument), those of the ported configurations; the
// quad kernel with the weights row (kWeights) scales the density feature
// by the sample's predicted weight before the relu, as the static net's
// own fused route asks (shade.py:223-224; there the z line of
// stanford_llff_z_plane is the premixed table, TH = 0). Both are template
// arguments, so that the SH routes' kernels are the ones they were.

#include "shade_core.cuh"

namespace {

using namespace shade_core;

constexpr int kThreads = 128;

// kPre: `space` is the bf16 feature array [B*S, C] (one row per sample)
// instead of the quad table [(H+1)*(W+1), 4C]; kRgb: RGB colour, else SH;
// kWeights: the pack has the weights row
template <int C, bool kPre, bool kRgb, bool kWeights>
__global__ void shade_kernel(const uint4* __restrict__ space,
                             const float* __restrict__ pack,
                             const float* __restrict__ rays,
                             const float* __restrict__ ttab,
                             float* __restrict__ out,
                             const __grid_constant__ ShadeParams p) {
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
  const float* ray = rays + (live ? g / S : 0) * 8;
  const bool valid = live && sample_valid(pk);

  float sigma = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    float feat[C];
#pragma unroll
    for (int c = 0; c < C; ++c) feat[c] = 0.0f;
    if (kPre) {
      // C bf16 = C/8 16-byte vectors per sample
      const uint4* fr = space + g * (C / 8);
#pragma unroll
      for (int q = 0; q < C / 8; ++q) {
        axpy_bf16x8(feat + 8 * q, 1.0f, __ldg(fr + q));
      }
    } else {
      // the 4 bilinear corners in one quad-table row (4C bf16 = C/2
      // vectors); JAX weight order: (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx
      const Taps tx = taps(pk[0], p.W);
      const Taps ty = taps(pk[1], p.H);
      const float w4[4] = {ty.w0 * tx.w0, ty.w0 * tx.w1, ty.w1 * tx.w0,
                           ty.w1 * tx.w1};
      const int64_t qrow = (int64_t)(ty.i0 + 1) * (p.W + 1) + (tx.i0 + 1);
      const uint4* qr = space + qrow * (C / 2);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int q = 0; q < C / 8; ++q) {
          axpy_bf16x8(feat + 8 * q, w4[k], __ldg(qr + k * (C / 8) + q));
        }
      }
    }
    const float wt =
        kWeights ? __ldg(pack + (int64_t)kWeightsRow * N + g) : 1.0f;
    shade_sample<C, kRgb, kWeights>(feat, pk, ray, ttab, p, wt, sigma, rgb);
  }

  composite_store(sigma, rgb, pk[3], p.distance_scale, s, S, live,
                  out + (live ? g / S : 0) * 5);
}

template <int C, bool kPre, bool kRgb, bool kWeights>
void run(unsigned blocks, const uint4* sp, const float* pack,
         const float* rays, const float* ttab, float* out,
         const ShadeParams* p, cudaStream_t st) {
  shade_kernel<C, kPre, kRgb, kWeights><<<blocks, kThreads, 0, st>>>(
      sp, pack, rays, ttab, out, *p);
}

// the instantiation for p's colour and weights row (the pre-blended
// kernel has none)
template <int C, bool kPre>
void run_c(unsigned blocks, const uint4* sp, const float* pack,
           const float* rays, const float* ttab, float* out,
           const ShadeParams* p, cudaStream_t st) {
  if (!kPre && p->weights) {
    p->rgb ? run<C, false, true, true>(blocks, sp, pack, rays, ttab, out, p,
                                       st)
           : run<C, false, false, true>(blocks, sp, pack, rays, ttab, out, p,
                                        st);
  } else {
    p->rgb ? run<C, kPre, true, false>(blocks, sp, pack, rays, ttab, out, p,
                                       st)
           : run<C, kPre, false, false>(blocks, sp, pack, rays, ttab, out, p,
                                        st);
  }
}

template <bool kPre>
int launch(const void* space, const float* pack, const float* rays,
           const float* ttab, float* out, const ShadeParams* p,
           void* stream) {
  const int S = p->S;
  if (S < 1 || S > 32 || (S & (S - 1)) || (kPre && p->weights)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = (int64_t)p->B * S;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  const uint4* sp = static_cast<const uint4*>(space);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->C) {
    case 8:
      run_c<8, kPre>(blocks, sp, pack, rays, ttab, out, p, st);
      break;
    case 16:
      run_c<16, kPre>(blocks, sp, pack, rays, ttab, out, p, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shade_launch(const void* quad, const float* pack,
                            const float* rays, const float* ttab, float* out,
                            const ShadeParams* p, void* stream) {
  return launch<false>(quad, pack, rays, ttab, out, p, stream);
}

extern "C" int shade_preblended_launch(const void* feats, const float* pack,
                                       const float* rays, const float* ttab,
                                       float* out, const ShadeParams* p,
                                       void* stream) {
  return launch<true>(feats, pack, rays, ttab, out, p, stream);
}

extern "C" int shade_params_size() { return (int)sizeof(ShadeParams); }
