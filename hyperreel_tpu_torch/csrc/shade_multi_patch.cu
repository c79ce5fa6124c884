// Fused multi-axis patch-blend + shade kernel (K6): the coherent patch-gather
// route of the VM nets' eval render (the static llff_z_plane family, and the
// dynamic neural_3d_z_plane family with its time planes) in one kernel,
// from the per-sample pack and the three planes' patch tables to the
// per-ray colour.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi_fused_patch
// (per axis the blend of ops/pallas/patch_blend.py, the second factor: a
// line, or a time plane for time_hs > 0 (:861-873), the density and
// appearance sums, then _shade_tail) together with the XLA patch-row
// gathers and patch_anchor_idx (one per axis) that fed it. The JAX kernel
// walks the axes outside and its R phases inside so that one axis's patch
// transpose fits the TPU's VMEM; here a thread walks its ray's samples and
// blends each sample's three planes from their patch rows in L1.
//
// Bound on the H100 by its f32 operations: per valid sample K5's
// arithmetic with the SH basis folded per ray, plus the hat blend of at
// most four texels per plane; the bytes are the pack and ray-pack reads
// and px*py*(16+8+8)*2 / R bytes of patch rows per sample (80 at R = 8,
// (5, 2)). Design (K3's ray run, shade_patch.cuh, over three planes, with
// K5's per-sample body, multi_core.cuh):
// - A thread per ray walks the ray's S samples in order; a warp is 32
//   consecutive rays of the caller, 32/R whole coherent blocks, each ray
//   read and written at its position (phase-major or scanline). The pack
//   is staged per warp, 8 samples at a time, in shared memory
//   (shade_core.cuh stage_ray_pack; nothing else is).
// - At each sample slot the R lanes of a coherent block are neighbours, so
//   each plane's anchor (the min over the R rays of its two coordinates,
//   Mode<a>::m0 / m1) and coverage test are shuffle butterflies over them
//   (patch_core.cuh span, anchor_of), with no block barrier; the slot's
//   witness is the OR over the three planes, counted once per slot (by the
//   lane with lane % R == 0) and reduced per warp before one atomicAdd.
// - Each plane's features are the hat blend of the slot's patch row read
//   through L1 (patch_taps; the R lanes read one row in the same
//   instruction), then K5's second factors (the time taps of the ray's tn
//   once per ray), products and colour from the SH basis folded once per
//   ray (multi_core.cuh shade_k5_sample), and a running composite
//   (composite_add).
// - Blocks of 4 warps, registers capped for 4 blocks per SM.
// Built for multi_core.cuh PatchLayout ([8, 4, 4]; the layout a template
// argument), R in {4, 8}, S a power of two <= 64, lines, time planes or a
// mix, and SH of degree 0-4 (p.nb) or RGB colour (a template argument). A pack with
// the weights row is refused (not built: ROADMAP.md 2a).

#include "multi_core.cuh"
#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace multi_core;
using namespace patch_core;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// registers for 4 blocks per SM (at most 128; 160 bytes of spills on the
// time planes): 1.55 ms per n3d chunk against 1.61-1.64 with the 255
// ptxas takes at 2 blocks (scripts/k5_variants.py `pr_regs2`)
constexpr int kBlocksPerSm = 4;
// the pack tiles: samples per stage (32 bytes of a row per ray: a whole
// sector) and floats per ray
constexpr int kStageS = 8;
constexpr int kTileStride = kStageS + 1;

// Axis A's anchor and witness at this sample slot, over the R lanes of the
// coherent block (every lane of the warp calls it).
template <int A, int R>
__device__ __forceinline__ SlotAnchor plane_anchor(const MultiAxis& ax,
                                                   const float* pk,
                                                   bool valid, bool all_valid,
                                                   int px, int py) {
  return anchor_of(span<R>(pk[Mode<A>::m0], valid, all_valid),
                   span<R>(pk[Mode<A>::m1], valid, all_valid), ax.W, ax.H,
                   px, py);
}

template <class L, int R, bool kTime, bool kRgb, bool kAnyDeg>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    shade_multi_patch_kernel(const float* __restrict__ pack,
                             const float* __restrict__ rays,
                             float* __restrict__ out, int* __restrict__ viol,
                             const __grid_constant__ MultiParams p,
                             const __grid_constant__ PatchParams q) {
  __shared__ float tiles[kWarps][kPackRows * 32 * kTileStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = q.S;
  const int64_t N = (int64_t)q.B * S;
  const int64_t J = q.B / R;
  // the caller's ray R*j + r (r = lane % R), at its position
  const int64_t ray_i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const bool live = ray_i < q.B;
  const int64_t pos = !live ? 0
                      : q.phase_major ? (ray_i % R) * J + ray_i / R
                                      : ray_i;
  const float* ray = rays + pos * 8;
  const bool vec = S >= 4 && (reinterpret_cast<uintptr_t>(pack) & 15) == 0;
  float* mine = tiles[warp] + lane * kTileStride;

  // the ray's time taps on each axis (a line's: {0, 1, 0}, second_factor)
  Taps tt[3] = {};
  if constexpr (kTime) {
    const float tn = __ldg(ray + 7);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      tt[a] = p.axis[a].TH > 0 ? taps(tn, p.axis[a].TH) : Taps{0, 1.0f, 0.0f};
    }
  }
  // the ray's folded basis [3, A]
  float M[kRgb ? 1 : 3 * L::kApp];
  if constexpr (!kRgb) {
    sh_fold<L::kApp, L::kApp, kAnyDeg>(p.wb, p.nb, __ldg(ray + 3),
                                       __ldg(ray + 4), __ldg(ray + 5), M);
  }
  RayComposite acc;
  float prev_sigma = 0.0f, prev_rgb[3] = {0.0f, 0.0f, 0.0f}, prev_dist = 0.0f;
  int n_viol = 0;
  for (int s0 = 0; s0 < S; s0 += kStageS) {
    __syncwarp();
    stage_ray_pack<kStageS>(mine, pack, N, S, pos, live, s0, vec);
    __syncwarp();
    const int stage = S - s0 < kStageS ? S - s0 : kStageS;
    for (int j = 0; j < stage; ++j) {
      float pk[kPackRows];
#pragma unroll
      for (int i = 0; i < kPackRows; ++i) pk[i] = mine[i * 32 * kTileStride + j];
      const bool valid = live && sample_valid(pk);
      const bool all_valid = __all_sync(0xffffffffu, valid || !live);
      const SlotAnchor an[3] = {
          plane_anchor<0, R>(p.axis[0], pk, valid, all_valid, q.px, q.py),
          plane_anchor<1, R>(p.axis[1], pk, valid, all_valid, q.px, q.py),
          plane_anchor<2, R>(p.axis[2], pk, valid, all_valid, q.px, q.py)};
      n_viol += (live && lane % R == 0 &&
                 (an[0].viol || an[1].viol || an[2].viol))
                    ? 1
                    : 0;
      float sigma = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
      if (valid) {
        auto feat = [&](auto A, float* f) {
          constexpr int a = decltype(A)::value;
          constexpr int C = L::template ch<a>();
          const MultiAxis& ax = p.axis[a];
          const uint4* row = static_cast<const uint4*>(ax.table) +
                             (int64_t)an[a].idx * (q.px * q.py * C / 8);
          patch_taps<C>(row, patch_offset(pk[Mode<a>::m0], ax.W, an[a].x0),
                        patch_offset(pk[Mode<a>::m1], ax.H, an[a].y0), q.px,
                        q.py, f);
        };
        shade_k5_sample<L, kTime, kRgb, false>(p, pk, tt, feat, M, 1.0f,
                                               sigma, rgb);
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
    float* o = out + pos * 5;
#pragma unroll
    for (int i = 0; i < 5; ++i) o[i] = acc.v[i];
  }
  n_viol = __reduce_add_sync(0xffffffffu, n_viol);
  if (lane == 0 && n_viol) atomicAdd(viol, n_viol);
}

template <class L, int R, bool kTime, bool kRgb>
cudaError_t launch(const float* pack, const float* rays, float* out,
                   int* viol, const MultiParams& p, const PatchParams& q,
                   cudaStream_t st) {
  const unsigned blocks = (unsigned)((q.B + kThreads - 1) / kThreads);
  if (any_degree(p.rgb, p.nb)) {
    if constexpr (!kRgb) {
      shade_multi_patch_kernel<L, R, kTime, kRgb, true>
          <<<blocks, kThreads, 0, st>>>(pack, rays, out, viol, p, q);
    }
  } else {
    shade_multi_patch_kernel<L, R, kTime, kRgb, false>
        <<<blocks, kThreads, 0, st>>>(pack, rays, out, viol, p, q);
  }
  return cudaGetLastError();
}

// the instantiation for p's second factors and colour
template <class L, int R>
cudaError_t launch_c(const float* pack, const float* rays, float* out,
                     int* viol, const MultiParams& p, const PatchParams& q,
                     cudaStream_t st) {
  if (has_time(p)) {
    return p.rgb
               ? launch<L, R, true, true>(pack, rays, out, viol, p, q, st)
               : launch<L, R, true, false>(pack, rays, out, viol, p, q, st);
  }
  return p.rgb ? launch<L, R, false, true>(pack, rays, out, viol, p, q, st)
               : launch<L, R, false, false>(pack, rays, out, viol, p, q, st);
}

}  // namespace

extern "C" int shade_multi_patch_launch(const float* pack, const float* rays,
                                        float* out, int* viol,
                                        const MultiParams* p,
                                        const PatchParams* q, void* stream) {
  const int S = q->S;
  if (S < 1 || S > 64 || (S & (S - 1)) || p->S != S || p->B != q->B ||
      p->weights || (q->R != 4 && q->R != 8) || q->B % q->R ||
      !basis_built(p->rgb, p->nb) ||
      !PatchLayout::of(*p)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < 3; ++a) {
    if (p->axis[a].TH < 0) return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  using L = PatchLayout;
  return q->R == 8 ? (int)launch_c<L, 8>(pack, rays, out, viol, *p, *q, st)
                   : (int)launch_c<L, 4>(pack, rays, out, viol, *p, *q, st);
}
