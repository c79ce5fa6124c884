// Multi-axis shade + composite kernel (K5): the VM nets' eval render from
// the per-sample pack to the per-ray colour (the static llff_z_plane
// family, and the dynamic neural_3d_z_plane family whose second factors
// are time planes), one warp segment per ray: one lane per sample for S
// <= 32, a whole warp with two samples per lane for S = 64.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi (with
// _multi_core, its time-plane branch for time_hs > 0 included,
// _corner_weights, _twohot_matmul, _shade_tail and _compact_rows) together
// with the XLA quad-row gathers that fed it (models/fused_eval.py
// `tabs[a][0][idx8[a]]`, one per axis); and, as the pre-blended variant,
// the same kernel with `preblended="phase_major"` (shade.py :759-763,
// :1000-1008), which reads the three planes' features that the
// patch-blend kernel (K4, patch_blend.cu) wrote.
//
// Bound on the H100: by its f32 operations at the [8, 4, 4] layout
// (~1,000 per valid sample, the 27 x 16 basis product the largest part;
// a time plane adds a second z blend and the t blend per axis) when the
// quad rows a chunk reads stay in L2; at a trained checkpoint's grid the
// three bf16 quad tables come to ~113-116 MB, more than the 50 MB L2, so
// the 256 bytes of quad rows a valid sample reads may come from device
// memory. Design: per valid sample a lane computes each plane's texel row
// from its two pack coordinates and loads it with 16-byte vector loads
// (no gather kernel, no index array), takes the second factor's taps
// through the read-only cache (a line is a few dozen KB, a time plane 12
// times that), multiplies, and keeps the density sum and the 16
// appearance channels in registers; samples outside the aabb load
// nothing. The time coordinate is per ray (ray pack row 7); the
// time-plane branch is compiled only into the launches whose net has time
// planes (kTime), so that the static nets' kernels keep their registers
// (64/72, against 80 with the branch, which cost llff's K5 8 % and its
// pre-blended variant 17 % on the H100). The basis rides in the kernel
// parameters (constant bank). The composite and per-ray sums are K2's
// warp scan and butterfly (shade_core.cuh; at S = 64 each lane first
// combines its pair). Built for the layout of multi_core.cuh, with SH of
// degree 2 or RGB colour (a template argument, like kTime); the quad
// kernel with the weights row (kWeights: the static net's own fused route,
// shade.py:728-729) scales the density sum by the sample's predicted
// weight before the relu. Template arguments all, so that the SH routes'
// kernels are the ones they were.

#include "multi_core.cuh"

namespace {

using namespace shade_core;
using namespace multi_core;

constexpr int kThreads = 128;

// kPre: each axis's `table` is its pre-blended bf16 features [B*S, C].
// SPL samples per lane: lane l of ray r's segment of S / SPL lanes holds
// samples SPL*l + j. kTime: some axis has a time plane (TH > 0). kRgb:
// RGB colour, else SH. kWeights: the pack has the weights row.
template <bool kPre, int SPL, bool kTime, bool kRgb, bool kWeights>
__global__ void __launch_bounds__(kThreads)
    shade_multi_kernel(const float* __restrict__ pack,
                       const float* __restrict__ rays,
                       float* __restrict__ out,
                       const __grid_constant__ MultiParams p) {
  const int S = p.S, lanes = S / SPL;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t N = (int64_t)p.B * S;
  const int64_t ray_i = t / lanes;
  const bool live = ray_i < p.B;
  const int l = (int)(t % lanes);
  const float* ray = rays + (live ? ray_i : 0) * 8;

  float sigma[SPL], rgb[SPL][3], dist[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int64_t g = ray_i * S + SPL * l + j;
    float pk[kPackRows];
#pragma unroll
    for (int i = 0; i < kPackRows; ++i) {
      pk[i] = live ? __ldg(pack + (int64_t)i * N + g) : 0.0f;
    }
    sigma[j] = 0.0f;
    rgb[j][0] = rgb[j][1] = rgb[j][2] = 0.0f;
    dist[j] = pk[3];
    if (live && sample_valid(pk)) {
      auto feat = [&](auto A, float* f) {
        constexpr int a = decltype(A)::value;
        if (kPre) {
          row_features<kChOf<a>>(p.axis[a], g, f);
        } else {
          quad_features<a, kChOf<a>>(p.axis[a], pk, f);
        }
      };
      const float wt =
          kWeights ? __ldg(pack + (int64_t)kWeightsRow * N + g) : 1.0f;
      shade_axes<kTime, kRgb, kWeights>(p, pk, ray, feat, wt, sigma[j],
                                        rgb[j]);
    }
  }
  float* o = out + (live ? ray_i : 0) * 5;
  if constexpr (SPL == 1) {
    composite_store(sigma[0], rgb[0], dist[0], p.distance_scale, l, S, live,
                    o);
  } else {
    composite_store_pair(sigma, &rgb[0][0], dist, p.distance_scale, l, live,
                         o);
  }
}

template <bool kPre, int SPL, bool kTime, bool kRgb, bool kWeights>
void run(unsigned blocks, const float* pack, const float* rays, float* out,
         const MultiParams* p, cudaStream_t st) {
  shade_multi_kernel<kPre, SPL, kTime, kRgb, kWeights>
      <<<blocks, kThreads, 0, st>>>(pack, rays, out, *p);
}

// the instantiation for p's colour and weights row (the pre-blended
// kernel has none)
template <bool kPre, int SPL, bool kTime>
void run_c(unsigned blocks, const float* pack, const float* rays, float* out,
           const MultiParams* p, cudaStream_t st) {
  if (!kPre && p->weights) {
    p->rgb ? run<false, SPL, kTime, true, true>(blocks, pack, rays, out, p,
                                                st)
           : run<false, SPL, kTime, false, true>(blocks, pack, rays, out, p,
                                                 st);
  } else {
    p->rgb ? run<kPre, SPL, kTime, true, false>(blocks, pack, rays, out, p,
                                                st)
           : run<kPre, SPL, kTime, false, false>(blocks, pack, rays, out, p,
                                                 st);
  }
}

// the instantiation for p's time planes
template <bool kPre, int SPL>
void run_s(unsigned blocks, const float* pack, const float* rays, float* out,
           const MultiParams* p, cudaStream_t st) {
  has_time(*p) ? run_c<kPre, SPL, true>(blocks, pack, rays, out, p, st)
               : run_c<kPre, SPL, false>(blocks, pack, rays, out, p, st);
}

template <bool kPre>
int launch(const float* pack, const float* rays, float* out,
           const MultiParams* p, void* stream) {
  const int S = p->S;
  if (S < 1 || S > 64 || (S & (S - 1)) || (kPre && p->weights)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < 3; ++a) {
    if (p->axis[a].TH < 0) return (int)cudaErrorInvalidValue;
  }
  const int64_t n = (int64_t)p->B * (S < 32 ? S : 32);
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= 32) {
    run_s<kPre, 1>(blocks, pack, rays, out, p, st);
  } else {
    run_s<kPre, 2>(blocks, pack, rays, out, p, st);
  }
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
