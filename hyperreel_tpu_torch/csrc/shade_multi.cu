// Multi-axis shade + composite kernel (K5): the static VM net's eval render
// from the per-sample pack to the per-ray colour (the llff_z_plane family),
// one S-lane segment of a warp per ray, one lane per sample.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi (with
// _multi_core for time_hs all 0, _corner_weights, _twohot_matmul,
// _shade_tail and _compact_rows) together with the XLA quad-row gathers
// that fed it (models/fused_eval.py `tabs[a][0][idx8[a]]`, one per axis);
// and, as the pre-blended variant, the same kernel with
// `preblended="phase_major"` (shade.py :759-763, :1000-1008), which reads
// the three planes' features that the patch-blend kernel (K4,
// patch_blend.cu) wrote.
//
// Bound on the H100: by its f32 operations at the llff layout (~1,000 per
// valid sample, the 27 x 16 basis product the largest part) when the quad
// tables stay in L2; at a trained checkpoint's grid the three bf16 quad
// tables come to ~116 MB, more than the 50 MB L2, so the 256 bytes of quad
// rows a valid sample reads may come from device memory. Design: per valid
// sample a lane computes each plane's texel row from its two pack
// coordinates and loads it with 16-byte vector loads (no gather kernel, no
// index array), takes the line's two taps through the read-only cache (the
// lines are a few dozen KB), multiplies, and keeps the density sum and the
// 16 appearance channels in registers; samples outside the aabb load
// nothing. The basis rides in the kernel parameters (constant bank). The
// composite and per-ray sums are K2's warp scan and butterfly
// (shade_core.cuh). Built for the layout of multi_core.cuh.

#include "multi_core.cuh"

namespace {

using namespace shade_core;
using namespace multi_core;

constexpr int kThreads = 128;

// kPre: each axis's `table` is its pre-blended bf16 features [B*S, C]
template <bool kPre>
__global__ void __launch_bounds__(kThreads)
    shade_multi_kernel(const float* __restrict__ pack,
                       const float* __restrict__ rays,
                       float* __restrict__ out,
                       const __grid_constant__ MultiParams p) {
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
    float dsum = 0.0f;
    float app[kApp];
    {
      float feat[kCh0];
      if (kPre) {
        row_features<kCh0>(p.axis[0], g, feat);
      } else {
        quad_features<0, kCh0>(p.axis[0], pk, feat);
      }
      line_product<0, kCh0, kNd0>(p.axis[0], pk, feat, dsum, app);
    }
    {
      float feat[kCh1];
      if (kPre) {
        row_features<kCh1>(p.axis[1], g, feat);
      } else {
        quad_features<1, kCh1>(p.axis[1], pk, feat);
      }
      line_product<1, kCh1, kNd1>(p.axis[1], pk, feat, dsum,
                                  app + kCh0 - kNd0);
    }
    {
      float feat[kCh2];
      if (kPre) {
        row_features<kCh2>(p.axis[2], g, feat);
      } else {
        quad_features<2, kCh2>(p.axis[2], pk, feat);
      }
      line_product<2, kCh2, kNd2>(p.axis[2], pk, feat, dsum,
                                  app + kCh0 - kNd0 + kCh1 - kNd1);
    }
    sigma = fmaxf(dsum, 0.0f);
    sh_colour<kApp>(app, p.wb, pk, ray, rgb);
  }
  composite_store(sigma, rgb, pk[3], p.distance_scale, s, S, live,
                  out + (live ? g / S : 0) * 5);
}

template <bool kPre>
int launch(const float* pack, const float* rays, float* out,
           const MultiParams* p, void* stream) {
  const int S = p->S;
  if (S < 1 || S > 32 || (S & (S - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n = (int64_t)p->B * S;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  shade_multi_kernel<kPre><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      pack, rays, out, *p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shade_multi_launch(const float* pack, const float* rays,
                                  float* out, const MultiParams* p,
                                  void* stream) {
  return launch<false>(pack, rays, out, p, stream);
}

extern "C" int shade_multi_preblended_launch(const float* pack,
                                             const float* rays, float* out,
                                             const MultiParams* p,
                                             void* stream) {
  return launch<true>(pack, rays, out, p, stream);
}

extern "C" int multi_params_size() { return (int)sizeof(MultiParams); }

// The layout the multi-axis kernels are built for: (C, density channels)
// of axes 0, 1, 2 into c_nd[6]; returns the number of axes.
extern "C" int multi_layout(int* c_nd) {
  const int v[6] = {kCh0, kNd0, kCh1, kNd1, kCh2, kNd2};
  for (int i = 0; i < 6; ++i) c_nd[i] = v[i];
  return 3;
}
