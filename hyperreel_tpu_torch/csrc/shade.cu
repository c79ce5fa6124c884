// Shade + composite kernel (K2): from the per-sample pack to the per-ray
// colour, a thread per ray over its samples.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel (the quad
// route: _shade_core, _corner_weights, _twohot_matmul, _shade_tail,
// _compact_rows) together with the XLA quad-row gather that fed it
// (models/fused_eval.py `tabs[a][0][idx8[a]]`); and, as the pre-blended
// variant, the same kernel with `preblended="phase_major"` (shade.py
// :259-262, :626-632), which reads the space features that the
// patch-blend kernel (K4, patch_blend.cu) wrote.
//
// Bound on the H100 by device-memory bytes once the SH basis is folded per
// ray: per sample its 40-byte pack column and, where valid, either one
// 8*C-byte quad row (the four bilinear corners of its space-plane texel,
// bf16) or, pre-blended, its 2*C-byte bf16 feature row, plus four C-float
// taps of the time plane, which is small enough (TH*TW*C f32, 20 KB for
// the flagship) to stay in L1/L2; the view direction and the time
// coordinate are per ray (the 32-byte ray pack row). Design (K3's ray-run
// form, shade_patch.cuh, without its patch prologue):
// - A thread per ray walks the ray's samples in order; a warp is 32
//   consecutive rays of the caller, each read and written at its own
//   position. At one sample index the warp's rays are neighbouring pixels
//   at one depth, so their texels share L1 lines.
// - Each warp stages its 32 rays' 10 pack rows, 8 samples at a time (32
//   bytes per ray and row, a whole sector), in shared memory with a
//   stride of 9 floats per ray, which its threads then read without bank
//   conflicts (shade_core.cuh stage_ray_pack); a stage shorter than 4
//   samples (S = 1, 2) is loaded by scalars. The weights row is not
//   staged: a valid sample's thread loads its weight (staging it took the
//   tiles past 48 KB per block and ran 31 % slower, PERF.md).
// - The space features: the thread computes its texel's quad row from xn,
//   yn and loads its 4 corners with 16-byte vector loads (no gather kernel,
//   no index array in HBM), or loads the sample's pre-blended feature row;
//   samples outside the aabb load nothing. Then the time taps and the
//   density of shade_core.cuh sample_density.
// - The SH basis is folded with the ray's view direction once per ray
//   (shade_core.cuh sh_fold: 3 nb x A FMAs, nb = (deg + 1)^2, over the A
//   channels whose basis
//   columns can be non-zero: the C / 2 appearance channels of every
//   preset, else all C), so that a sample's colour is a [3, A] product
//   (sh_folded_colour); RGB colour has nothing to fold.
// - The composite is a running sum per thread (composite_add), the last
//   delta 1e10: no shuffles, no scan.
// - Blocks of 4 warps, registers capped for 4 blocks per SM.
// Built for C in {8, 16}, S a power of two up to 32, SH of degree 0-4 (the
// basis count a run-time value, shade_core.cuh) or RGB colour (a template
// argument), those of the ported configurations; the
// quad kernel with the weights row (kWeights) scales the density feature
// by the sample's predicted weight before the relu, as the static net's
// own fused route asks (shade.py:223-224; there the z line of
// stanford_llff_z_plane is the premixed table, TH = 0). A pre-blended
// launch with the weights row is refused (no JAX route reaches it:
// ROADMAP.md 2a).

#include "shade_core.cuh"

namespace {

using namespace shade_core;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
// the pack tiles: samples per stage (32 bytes of a row per ray: a whole
// sector) and floats per ray
constexpr int kStageS = 8;
constexpr int kTileStride = kStageS + 1;

// The C space features of one valid sample g: kPre, its row of the bf16
// feature array [B*S, C]; else bilinear from the 4 corners of its
// quad-table row (4C bf16 = C/2 vectors), JAX weight order (1-fy)(1-fx),
// (1-fy)fx, fy(1-fx), fy fx.
template <int C, bool kPre>
__device__ __forceinline__ void space_features(const uint4* __restrict__ space,
                                               const float* pk,
                                               const ShadeParams& p,
                                               int64_t g, float* feat) {
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.0f;
  if constexpr (kPre) {
    const uint4* fr = space + g * (C / 8);
#pragma unroll
    for (int q = 0; q < C / 8; ++q) {
      axpy_bf16x8(feat + 8 * q, 1.0f, __ldg(fr + q));
    }
  } else {
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
}

// kPre: `space` is the bf16 feature array [B*S, C] (one row per sample)
// instead of the quad table [(H+1)*(W+1), 4C]; kRgb: RGB colour, else SH
// folded over the basis columns [F, C) (the columns before F are zero);
// kWeights: the pack has the weights row
template <int C, bool kPre, bool kRgb, bool kWeights, int F, bool kAnyDeg>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    shade_kernel(const uint4* __restrict__ space,
                 const float* __restrict__ pack,
                 const float* __restrict__ rays,
                 const float* __restrict__ ttab, float* __restrict__ out,
                 const __grid_constant__ ShadeParams p) {
  constexpr int A = C - F;
  __shared__ float tiles[kWarps][kPackRows * 32 * kTileStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = p.S;
  const int64_t N = (int64_t)p.B * S;
  const int64_t ray_i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray_i < p.B;
  const int64_t b = live ? ray_i : 0;
  const float* ray = rays + b * 8;
  float* mine = tiles[warp] + lane * kTileStride;
  const bool vec = S >= 4 && (reinterpret_cast<uintptr_t>(pack) & 15) == 0;

  // the ray's folded basis [3, A]
  float M[kRgb ? 1 : 3 * A];
  if constexpr (!kRgb) {
    sh_fold<A, C, kAnyDeg>(p.wb + F, p.nb, __ldg(ray + 3), __ldg(ray + 4),
                           __ldg(ray + 5), M);
  }
  RayComposite acc;
  float prev_sigma = 0.0f, prev_rgb[3] = {0.0f, 0.0f, 0.0f}, prev_dist = 0.0f;
  for (int s0 = 0; s0 < S; s0 += kStageS) {
    __syncwarp();
    stage_ray_pack<kStageS>(mine, pack, N, S, b, live, s0, vec);
    __syncwarp();
    const int stage = S - s0 < kStageS ? S - s0 : kStageS;
    for (int j = 0; j < stage; ++j) {
      float pk[kPackRows];
#pragma unroll
      for (int i = 0; i < kPackRows; ++i) {
        pk[i] = mine[i * 32 * kTileStride + j];
      }
      float sigma = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
      if (live && sample_valid(pk)) {
        float feat[C];
        space_features<C, kPre>(space, pk, p, b * S + s0 + j, feat);
        const float wt =
            kWeights ? __ldg(pack + kWeightsRow * N + b * S + s0 + j) : 1.0f;
        sigma = sample_density<C, kWeights>(feat, pk, ray, ttab, p, wt);
        if constexpr (kRgb) {
          rgb_colour<C>(feat, p.wb, pk, rgb);
        } else {
          sh_folded_colour<A>(feat + F, M, pk, rgb);
        }
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
    float* o = out + ray_i * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = acc.v[i];
  }
}

template <int C, bool kPre, bool kRgb, bool kWeights, int F>
int run(unsigned blocks, const uint4* sp, const float* pack,
        const float* rays, const float* ttab, float* out,
        const ShadeParams* p, cudaStream_t st) {
  if (any_degree(p->rgb, p->nb)) {
    if constexpr (!kRgb) {
      shade_kernel<C, kPre, kRgb, kWeights, F, true>
          <<<blocks, kThreads, 0, st>>>(sp, pack, rays, ttab, out, *p);
    }
  } else {
    shade_kernel<C, kPre, kRgb, kWeights, F, false>
        <<<blocks, kThreads, 0, st>>>(sp, pack, rays, ttab, out, *p);
  }
  return (int)cudaGetLastError();
}

// Whether the SH basis columns [0, F) of p's [3 * nb, C] wb are all zero
// (the density channels'), so that the fold may start at F.
bool zero_columns(const ShadeParams* p, int C, int F) {
  for (int r = 0; r < 3 * p->nb; ++r) {
    for (int c = 0; c < F; ++c) {
      if (p->wb[r * C + c] != 0.0f) return false;
    }
  }
  return true;
}

// the instantiation for p's colour, its weights row (the pre-blended
// kernel has none) and, for SH, the first basis column that can be
// non-zero
template <int C, bool kPre>
int run_c(unsigned blocks, const uint4* sp, const float* pack,
          const float* rays, const float* ttab, float* out,
          const ShadeParams* p, cudaStream_t st) {
  const bool w = !kPre && p->weights;
  if (p->rgb) {
    return w ? run<C, false, true, true, 0>(blocks, sp, pack, rays, ttab,
                                            out, p, st)
             : run<C, kPre, true, false, 0>(blocks, sp, pack, rays, ttab,
                                            out, p, st);
  }
  if (zero_columns(p, C, C / 2)) {
    return w ? run<C, false, false, true, C / 2>(blocks, sp, pack, rays,
                                                 ttab, out, p, st)
             : run<C, kPre, false, false, C / 2>(blocks, sp, pack, rays,
                                                 ttab, out, p, st);
  }
  return w ? run<C, false, false, true, 0>(blocks, sp, pack, rays, ttab, out,
                                           p, st)
           : run<C, kPre, false, false, 0>(blocks, sp, pack, rays, ttab, out,
                                           p, st);
}

template <bool kPre>
int launch(const void* space, const float* pack, const float* rays,
           const float* ttab, float* out, const ShadeParams* p,
           void* stream) {
  const int S = p->S;
  if (S < 1 || S > 32 || (S & (S - 1)) || (kPre && p->weights) ||
      !basis_built(p->rgb, p->nb)) {
    return (int)cudaErrorInvalidValue;
  }
  if (p->B == 0) return 0;
  const unsigned blocks = (unsigned)((p->B + kThreads - 1) / kThreads);
  const uint4* sp = static_cast<const uint4*>(space);
  cudaStream_t st = (cudaStream_t)stream;
  switch (p->C) {
    case 8:
      return run_c<8, kPre>(blocks, sp, pack, rays, ttab, out, p, st);
    case 16:
      return run_c<16, kPre>(blocks, sp, pack, rays, ttab, out, p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
