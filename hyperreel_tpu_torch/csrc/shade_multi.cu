// Multi-axis shade + composite kernel (K5): the VM nets' eval render from
// the per-sample pack to the per-ray colour (the static llff_z_plane
// family, and the dynamic neural_3d_z_plane family whose second factors
// are time planes).
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi (with
// _multi_core, its time-plane branch for time_hs > 0 included,
// _corner_weights, _twohot_matmul, _shade_tail and _compact_rows) together
// with the XLA quad-row gathers that fed it (models/fused_eval.py
// `tabs[a][0][idx8[a]]`, one per axis); and, as the pre-blended kernel,
// the same function with `preblended="phase_major"` (shade.py :759-763,
// :1000-1008), which reads the three planes' features that the
// patch-blend kernel (K4, patch_blend.cu) wrote.
//
// What bounds it on the H100. Its counted work (~620 f32 operations per
// valid sample at the [8, 4, 4] layout with the SH basis folded per ray,
// 256 bytes of quad rows) would take a fifth of its time. What held the
// quad kernel when it ran a warp per ray (a lane per sample) was the L1
// traffic of loads whose rows differ from lane to lane: a ray's samples
// lie on as many z-planes, so each 16-byte load of axis 0's z line and of
// the xz and yz planes' quad rows touched up to 32 cache lines
// (scripts/k5_variants.py: reading those at one row per ray took 32-37 %
// of its time, the [27, 16] basis product per sample 12-20 %).
//
// The quad kernel (shade_multi_kernel). The TPU kernel kept its lines and
// time planes in VMEM and read them by a two-hot matmul; here:
// - A thread per ray walks the ray's samples in order: a warp is 32
//   neighbouring rays at one sample index, and on a z-plane model sample
//   s of every ray lies on one z-plane, so the z line and the yz plane
//   are read at (nearly) one row by the whole warp, the xy and xz planes
//   at neighbouring rows. The composite is a running sum per thread
//   (shade_core.cuh composite_add). Each warp stages its 32 rays' pack
//   rows, 4 samples at a time (16 bytes per ray and row), into shared
//   memory with a stride of 5 floats per ray, which its threads then read
//   without bank conflicts (S >= 4).
// - The SH basis is folded with the ray's view direction once per ray
//   (shade_core.cuh sh_fold): 3 nb x 16 FMAs per ray (432 at degree 2,
//   1,200 at degree 4), then a [3, 16] product per sample instead of
//   [3 nb, 16]; the fold stays in the thread's registers.
//   N = 3 is too thin for mma.
// - The second factors are read through L1 with branch-free taps (both
//   rows of a tap pair always read, indices clamped, weight 0 off the
//   line): a warp reads one row of a line at a time. Staging lines in
//   shared memory measured slower (the 78 KB they take leave L1 less room
//   for the quad rows). Staging a time plane's keyframe pair for the
//   blocks whose rays all share it held 158 KB of shared memory per block
//   on every time-plane launch; with that room left to L1 the L1 path ran
//   faster both with one t for every ray (1.43 against 1.65 ms per n3d
//   chunk) and with a t per ray (PERF.md).
// - Persistent blocks of 256 threads, as many as fit (the occupancy API:
//   one per SM, since ptxas takes up to 255 registers so as to issue a
//   sample's loads together; registers for two blocks per SM spilled and
//   ran 8-35 % slower, and fewer registers for RGB colour ran 25 % slower
//   at three blocks), each on a contiguous run of rays (neighbouring
//   pixels in the chunk's order), so that neighbouring rays find their
//   quad rows in the SM's own L1; the L1/shared carve-out is the least
//   that holds those blocks, chosen once per instantiation and card, and
//   the launch reports it with the grid (launch_config).
// Template arguments: L (the channel layout, multi_core.cuh Layout844 or
// Layout888: [8, 4, 4] or [8, 8, 8]; at [8, 8, 8] the folded basis is 72
// floats, the appearance vector 24), kTime (every axis a time plane, else
// every axis a line: a mix is not built), kRgb (RGB colour, else SH of
// degree 0-4, the basis count p.nb a run-time value),
// kWeights (the pack has the weights row: the static net's own fused
// route, shade.py:728-729, scales the density sum by the sample's
// predicted weight before the relu).
//
// The pre-blended kernel (shade_multi_pre_kernel, built for multi_core.cuh
// PatchLayout: [8, 4, 4]) runs a warp segment per ray, a lane per sample
// (two at S = 64), as before: its feature rows
// [B*S, C] lie in pack order, so that mapping reads them coalesced, and
// its composite is K2's warp scan. The fold, staged lines and persistent
// blocks each measured slower there (PERF.md): they raised its registers
// from 64-96 to 126-219 and its occupancy fell from 28-32 warps per SM to
// 8-16, which its latency-bound loads need.

#include <mutex>

#include "multi_core.cuh"

namespace {

using namespace shade_core;
using namespace multi_core;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPreThreads = 128;
// the quad kernel's pack tiles: samples per stage and floats per ray
constexpr int kStageS = 4;
constexpr int kTileStride = kStageS + 1;
// the largest dynamic shared memory of a block on the H100
constexpr int kMaxSmem = 232448;
// the cards whose launch configurations are kept (launch_config)
constexpr int kMaxDevices = 64;

// floats of the quad kernel's per-warp pack tiles [rows][32][kTileStride]
__host__ __device__ inline int tile_floats(int rows) {
  return kWarps * rows * 32 * kTileStride;
}

// ------------------------------------------------------- the quad kernel

// Stage samples [s0, s0 + kStageS) of the R pack rows of the warp's 32
// rays (from ray0; rays at or past `end` read as 0) into its tile
// [R][32][kTileStride]: each ray's kStageS floats of a row are contiguous
// in the pack (S a multiple of kStageS).
template <int R>
__device__ __forceinline__ void stage_pack(float* tile, const float* pack,
                                           int64_t N, int S, int64_t ray0,
                                           int64_t end, int s0, int lane) {
  constexpr int per = kStageS / 4;
  for (int c = lane; c < 32 * per; c += 32) {
    const int r = c / per, q = c % per;
    const bool live = ray0 + r < end;
    const int64_t g = (ray0 + r) * S + s0 + 4 * q;
    float4 v[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      v[i] = live ? __ldg(reinterpret_cast<const float4*>(pack + i * N + g))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float* t = tile + (i * 32 + r) * kTileStride + 4 * q;
      t[0] = v[i].x;
      t[1] = v[i].y;
      t[2] = v[i].z;
      t[3] = v[i].w;
    }
  }
}

// A thread per ray: each warp takes 32 neighbouring rays of the block's
// run [lo, hi) at a time and walks their samples in order. Block b of the
// grid G takes rays [b B / G, (b+1) B / G). L: the channel layout.
template <class L, bool kTime, bool kRgb, bool kWeights, bool kAnyDeg>
__global__ void __launch_bounds__(kThreads, 1)
    shade_multi_kernel(const float* __restrict__ pack,
                       const float* __restrict__ rays,
                       float* __restrict__ out,
                       const __grid_constant__ MultiParams p) {
  extern __shared__ float4 smem_v[];
  constexpr int R = kWeights ? kWeightsRow + 1 : kPackRows;
  const int S = p.S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t N = (int64_t)p.B * S;
  const int64_t lo = (int64_t)blockIdx.x * p.B / gridDim.x;
  const int64_t hi = (int64_t)(blockIdx.x + 1) * p.B / gridDim.x;
  float* tile =
      reinterpret_cast<float*>(smem_v) + warp * R * 32 * kTileStride;
  const float* mine = tile + lane * kTileStride;
  for (int64_t base = lo + warp * 32; base < hi; base += kThreads) {
    const int64_t ray_i = base + lane;
    const bool live = ray_i < hi;
    const float* ray = rays + (live ? ray_i : lo) * 8;
    Taps tt[3] = {};
    if constexpr (kTime) {
      const float tn = __ldg(ray + 7);
#pragma unroll
      for (int a = 0; a < 3; ++a) tt[a] = taps(tn, p.axis[a].TH);
    }
    // the ray's folded basis [3, A]
    float M[kRgb ? 1 : 3 * L::kApp];
    if constexpr (!kRgb) {
      sh_fold<L::kApp, L::kApp, kAnyDeg>(p.wb, p.nb, __ldg(ray + 3),
                                         __ldg(ray + 4), __ldg(ray + 5), M);
    }
    RayComposite acc;
    float prev_sigma = 0.0f, prev_rgb[3] = {0.0f, 0.0f, 0.0f},
          prev_dist = 0.0f;
    for (int s0 = 0; s0 < S; s0 += kStageS) {
      __syncwarp();
      stage_pack<R>(tile, pack, N, S, base, hi, s0, lane);
      __syncwarp();
      for (int j = 0; j < kStageS; ++j) {
        float pk[kPackRows];
#pragma unroll
        for (int i = 0; i < kPackRows; ++i) {
          pk[i] = mine[i * 32 * kTileStride + j];
        }
        float sigma = 0.0f, rgb[3] = {0.0f, 0.0f, 0.0f};
        if (live && sample_valid(pk)) {
          auto feat = [&](auto A, float* f) {
            constexpr int a = decltype(A)::value;
            quad_features<a, L::template ch<a>()>(p.axis[a], pk, f);
          };
          const float wt =
              kWeights ? mine[kWeightsRow * 32 * kTileStride + j] : 1.0f;
          shade_k5_sample<L, kTime, kRgb, kWeights>(p, pk, tt, feat, M, wt,
                                                    sigma, rgb);
        }
        if (s0 + j > 0) {
          composite_add(acc, prev_sigma, prev_rgb, prev_dist,
                        pk[3] - prev_dist, p.distance_scale);
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
}

// --------------------------------------------------- the pre-blended kernel

// Each axis's `table` is its pre-blended bf16 features [B*S, C]. SPL
// samples per lane: lane l of ray r's segment of S / SPL lanes holds
// samples SPL*l + j. L: the channel layout.
template <class L, int SPL, bool kTime, bool kRgb, bool kAnyDeg>
__global__ void __launch_bounds__(kPreThreads)
    shade_multi_pre_kernel(const float* __restrict__ pack,
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
        row_features<L::template ch<a>()>(p.axis[a], g, f);
      };
      shade_axes<L, kTime, kRgb, false, kAnyDeg>(p, pk, ray, feat, 1.0f,
                                                 sigma[j], rgb[j]);
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

// ------------------------------------------------------- launches

// What a launch of the quad kernel is given, fixed per instantiation and
// card: its blocks per SM, the SMs, the L1/shared carve-out (percent) and
// the dynamic shared memory per block (the pack tiles).
struct LaunchConfig {
  int blocks_per_sm, sms, carveout, smem_bytes;
};

// The instantiation's config on the current card, set up at its first
// launch there: as many blocks per SM as the occupancy API allows with all
// of shared memory, then the least carve-out that holds them (the rest
// stays L1 for the quad rows).
template <class L, bool kTime, bool kRgb, bool kWeights, bool kAnyDeg>
cudaError_t launch_config(LaunchConfig* c) {
  static LaunchConfig kept[kMaxDevices];
  static bool ready[kMaxDevices];
  static std::mutex mu;
  auto kern = shade_multi_kernel<L, kTime, kRgb, kWeights, kAnyDeg>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (ready[dev]) {
    *c = kept[dev];
    return cudaSuccess;
  }
  const int smem = 4 * tile_floats(kWeights ? kWeightsRow + 1 : kPackRows);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           100);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // 1 KB of shared memory per block is the system's
  const int64_t cap = kMaxSmem + 1024;
  int carve = (int)((100 * per_sm * (smem + 1024LL) + cap - 1) / cap);
  carve = carve < 1 ? 1 : carve > 100 ? 100 : carve;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           carve);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  kept[dev] = {per_sm, sms, carve, smem};
  ready[dev] = true;
  *c = kept[dev];
  return cudaSuccess;
}

// The quad kernel on persistent blocks; chosen[4] gets the grid, blocks per
// SM, carve-out and shared memory per block.
template <class L, bool kTime, bool kRgb, bool kWeights, bool kAnyDeg>
int run_deg(const float* pack, const float* rays, float* out,
            const MultiParams* p, int* chosen, cudaStream_t st) {
  LaunchConfig c;
  const cudaError_t e = launch_config<L, kTime, kRgb, kWeights, kAnyDeg>(&c);
  if (e != cudaSuccess) return (int)e;
  const int64_t want = ((int64_t)p->B + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)c.blocks_per_sm * c.sms;
  const int grid = (int)(want < most ? want : most);
  chosen[0] = grid;
  chosen[1] = c.blocks_per_sm;
  chosen[2] = c.carveout;
  chosen[3] = c.smem_bytes;
  shade_multi_kernel<L, kTime, kRgb, kWeights, kAnyDeg>
      <<<(unsigned)grid, kThreads, c.smem_bytes, st>>>(pack, rays, out, *p);
  return (int)cudaGetLastError();
}

// run_deg for p's SH degree: the degree-2 instantiation or the any-degree
// one
template <class L, bool kTime, bool kRgb, bool kWeights>
int run(const float* pack, const float* rays, float* out,
        const MultiParams* p, int* chosen, cudaStream_t st) {
  if constexpr (!kRgb) {
    if (any_degree(p->rgb, p->nb)) {
      return run_deg<L, kTime, kRgb, kWeights, true>(pack, rays, out, p,
                                                     chosen, st);
    }
  }
  return run_deg<L, kTime, kRgb, kWeights, false>(pack, rays, out, p, chosen,
                                                  st);
}

// the instantiation for p's layout (Layout844 or Layout888), time planes,
// colour and weights row
template <class L>
int run_layout(const float* pack, const float* rays, float* out,
               const MultiParams* p, int* chosen, cudaStream_t st) {
  const bool w = p->weights != 0;
  if (has_time(*p)) {
    return p->rgb
               ? (w ? run<L, true, true, true> : run<L, true, true, false>)(
                     pack, rays, out, p, chosen, st)
               : (w ? run<L, true, false, true> : run<L, true, false, false>)(
                     pack, rays, out, p, chosen, st);
  }
  return p->rgb
             ? (w ? run<L, false, true, true> : run<L, false, true, false>)(
                   pack, rays, out, p, chosen, st)
             : (w ? run<L, false, false, true> : run<L, false, false, false>)(
                   pack, rays, out, p, chosen, st);
}

bool quad_layout(const MultiParams& p) {
  return Layout844::of(p) || Layout888::of(p);
}

int run_quad(const float* pack, const float* rays, float* out,
             const MultiParams* p, int* chosen, cudaStream_t st) {
  return Layout888::of(*p)
             ? run_layout<Layout888>(pack, rays, out, p, chosen, st)
             : run_layout<Layout844>(pack, rays, out, p, chosen, st);
}

template <class L, int SPL, bool kTime>
int run_pre(unsigned blocks, const float* pack, const float* rays,
            float* out, const MultiParams* p, cudaStream_t st) {
  if (p->rgb) {
    shade_multi_pre_kernel<L, SPL, kTime, true, false>
        <<<blocks, kPreThreads, 0, st>>>(pack, rays, out, *p);
  } else if (any_degree(p->rgb, p->nb)) {
    shade_multi_pre_kernel<L, SPL, kTime, false, true>
        <<<blocks, kPreThreads, 0, st>>>(pack, rays, out, *p);
  } else {
    shade_multi_pre_kernel<L, SPL, kTime, false, false>
        <<<blocks, kPreThreads, 0, st>>>(pack, rays, out, *p);
  }
  return (int)cudaGetLastError();
}

// Refuse what is not built: S a power of two <= 64; every axis a line or
// every axis a time plane.
bool built(const MultiParams* p) {
  const int S = p->S;
  if (S < 1 || S > 64 || (S & (S - 1)) || !basis_built(p->rgb, p->nb)) {
    return false;
  }
  for (int a = 0; a < 3; ++a) {
    if (p->axis[a].TH < 0 || (p->axis[a].TH > 0) != has_time(*p)) {
      return false;
    }
  }
  return true;
}

}  // namespace

extern "C" int shade_multi_launch(const float* pack, const float* rays,
                                  float* out, const MultiParams* p,
                                  int* chosen, void* stream) {
  // the pack tiles take kStageS samples at a time
  if (!built(p) || !quad_layout(*p) || p->S < kStageS) {
    return (int)cudaErrorInvalidValue;
  }
  if (p->B == 0) return 0;
  return run_quad(pack, rays, out, p, chosen, (cudaStream_t)stream);
}

extern "C" int shade_multi_preblended_launch(const float* pack,
                                             const float* rays, float* out,
                                             const MultiParams* p,
                                             void* stream) {
  if (!built(p) || !PatchLayout::of(*p) || p->weights) {
    return (int)cudaErrorInvalidValue;
  }
  const int S = p->S;
  const int64_t n = (int64_t)p->B * (S < 32 ? S : 32);
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kPreThreads - 1) / kPreThreads);
  cudaStream_t st = (cudaStream_t)stream;
  using L = PatchLayout;
  if (S <= 32) {
    return has_time(*p) ? run_pre<L, 1, true>(blocks, pack, rays, out, p, st)
                        : run_pre<L, 1, false>(blocks, pack, rays, out, p, st);
  }
  return has_time(*p) ? run_pre<L, 2, true>(blocks, pack, rays, out, p, st)
                      : run_pre<L, 2, false>(blocks, pack, rays, out, p, st);
}

extern "C" int multi_params_size() { return (int)sizeof(MultiParams); }

// The layouts a multi-axis kernel is built for (kernel 0: K5's quad
// kernel, 1: K5's pre-blended kernel, 2: K6): (C, density channels) of
// axes 0, 1, 2 per layout into c_nd[6 * n] unless c_nd is null; returns n,
// the number of layouts, or -1 for another kernel.
extern "C" int multi_layouts(int kernel, int* c_nd) {
  if (kernel == 0) {
    if (c_nd) {
      Layout844::write(c_nd);
      Layout888::write(c_nd + 6);
    }
    return 2;
  }
  if (kernel == 1 || kernel == 2) {
    if (c_nd) PatchLayout::write(c_nd);
    return 1;
  }
  return -1;
}
