// Fused multi-axis patch-blend + shade kernel (K6): the coherent
// patch-gather route of the VM nets' eval render (the static llff_z_plane
// family, and the dynamic neural_3d_z_plane family with its time planes)
// in one kernel, from the per-sample pack and the three planes' patch
// tables to the per-ray colour.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi_fused_patch
// (per axis the blend of ops/pallas/patch_blend.py, the second factor: a
// line, or a time plane for time_hs > 0 (:861-873), the density and
// appearance sums, then _shade_tail) together with
// the XLA patch-row gathers and patch_anchor_idx (one per axis) that fed
// it. The JAX kernel walks the axes outside and its R phases inside so that
// one axis's patch transpose fits the TPU's VMEM; here every thread shades
// its own sample, so a thread walks the three axes for its one sample.
//
// Bound on the H100 by its f32 operations: per valid sample K5's arithmetic
// plus the hat blend of at most four texels per plane; the bytes are the
// pack and ray-pack reads and px*py*(16+8+8)*2 / R bytes of patch rows per
// sample (80 at R = 8, (5, 2)) where K5 reads 256 bytes of quad rows.
// Design (patch_core.cuh): one CUDA block of 256 threads holds 256 /
// (R*lanes) coherent blocks, a warp segment per ray and a lane per sample
// slot (two slots per lane at S = 64, so that a ray is one warp and R = 8
// still fits); each slot's anchors are a min over its R rays per plane,
// and its three patch rows (320 + 160 + 160 bytes at (5, 2)) are staged
// once in shared memory with coalesced 16-byte loads behind one set of
// barriers; the R rays blend from them. Everything after the plane
// features is K5's (multi_core.cuh, the time-plane branch compiled only
// into launches with a time plane) and K2's composite (shade_core.cuh).
// The kernel also counts the coverage violations (slots whose footprint
// exits the patch on any plane). Built for multi_core.cuh PatchLayout
// ([8, 4, 4]; the layout a template argument), R
// in {4, 8}, S a power of two <= 64 and SH of degree 2 or RGB colour (a
// template argument); at S = 64 and R = 4 (4, 3) the block's 128 slots
// take 117 KB of shared memory, one block per SM. A pack with the weights
// row is refused (not built: ROADMAP.md 2a).

#include "multi_core.cuh"
#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace multi_core;
using namespace patch_core;

template <class L, int R, int SPL, bool kTime, bool kRgb>
__global__ void __launch_bounds__(kPatchThreads)
    shade_multi_patch_kernel(const float* __restrict__ pack,
                             const float* __restrict__ rays,
                             float* __restrict__ out, int* __restrict__ viol,
                             const __grid_constant__ MultiParams p,
                             const __grid_constant__ PatchParams q) {
  extern __shared__ uint4 smem[];
  const Slot t = thread_slot<R, SPL>(q);
  const int S = q.S;
  const int64_t N = (int64_t)q.B * S;

  float pk[SPL][kPackRows];
  bool valid[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int64_t g = t.pos * S + SPL * t.s + i;
#pragma unroll
    for (int r = 0; r < kPackRows; ++r) {
      pk[i][r] = t.live ? __ldg(pack + (int64_t)r * N + g) : 0.0f;
    }
    valid[i] = t.live && sample_valid(pk[i]);
  }
  const int pp = q.px * q.py;
  const PatchAxis ax[3] = {
      {static_cast<const uint4*>(p.axis[0].table), p.axis[0].W, p.axis[0].H,
       Mode<0>::m0, Mode<0>::m1, pp * L::kCh0 / 8},
      {static_cast<const uint4*>(p.axis[1].table), p.axis[1].W, p.axis[1].H,
       Mode<1>::m0, Mode<1>::m1, pp * L::kCh1 / 8},
      {static_cast<const uint4*>(p.axis[2].table), p.axis[2].W, p.axis[2].H,
       Mode<2>::m0, Mode<2>::m1, pp * L::kCh2 / 8}};
  const uint4* rows[SPL * 3];
  float u[SPL * 3], v[SPL * 3];
  stage_patches<R, 3, SPL, kPackRows>(ax, q, t, &pk[0][0], valid, smem, viol,
                                      nullptr, rows, u, v);

  const float* ray = rays + t.pos * 8;
  float sigma[SPL], rgb[SPL][3], dist[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    sigma[i] = 0.0f;
    rgb[i][0] = rgb[i][1] = rgb[i][2] = 0.0f;
    dist[i] = pk[i][3];
    if (valid[i]) {
      auto feat = [&](auto A, float* f) {
        constexpr int a = decltype(A)::value;
        patch_features<L::template ch<a>()>(rows[i * 3 + a], u[i * 3 + a],
                                            v[i * 3 + a], q.px, q.py, f);
      };
      shade_axes<L, kTime, kRgb, false>(p, pk[i], ray, feat, 1.0f, sigma[i],
                                        rgb[i]);
    }
  }
  if constexpr (SPL == 1) {
    composite_store(sigma[0], rgb[0], dist[0], p.distance_scale, t.s, S,
                    t.live, out + t.pos * 5);
  } else {
    composite_store_pair(sigma, &rgb[0][0], dist, p.distance_scale, t.s, t.live,
                         out + t.pos * 5);
  }
}

template <class L>
size_t multi_smem_bytes(const PatchParams& q) {
  const int pp = q.px * q.py;
  const int vecs[3] = {pp * L::kCh0 / 8, pp * L::kCh1 / 8, pp * L::kCh2 / 8};
  return smem_bytes(vecs, 3, q.R, samples_per_lane(q.S));
}

template <class L, int R, int SPL, bool kTime, bool kRgb>
cudaError_t launch(const float* pack, const float* rays, float* out,
                   int* viol, const MultiParams& p, const PatchParams& q,
                   cudaStream_t st) {
  const size_t smem = multi_smem_bytes<L>(q);
  // above 48 KB only as dynamic shared memory, after opting in
  cudaError_t e = cudaFuncSetAttribute(
      shade_multi_patch_kernel<L, R, SPL, kTime, kRgb>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t J = q.B / R;
  const int per_block = kPatchThreads / (R * (q.S / SPL));
  const unsigned blocks = (unsigned)((J + per_block - 1) / per_block);
  shade_multi_patch_kernel<L, R, SPL, kTime, kRgb>
      <<<blocks, kPatchThreads, smem, st>>>(pack, rays, out, viol, p, q);
  return cudaGetLastError();
}

// the instantiation for p's second factors and colour
template <class L, int R, int SPL>
cudaError_t launch_c(const float* pack, const float* rays, float* out,
                     int* viol, const MultiParams& p, const PatchParams& q,
                     cudaStream_t st) {
  if (has_time(p)) {
    return p.rgb
               ? launch<L, R, SPL, true, true>(pack, rays, out, viol, p, q,
                                               st)
               : launch<L, R, SPL, true, false>(pack, rays, out, viol, p, q,
                                                st);
  }
  return p.rgb
             ? launch<L, R, SPL, false, true>(pack, rays, out, viol, p, q, st)
             : launch<L, R, SPL, false, false>(pack, rays, out, viol, p, q,
                                               st);
}

// the instantiation for q's samples per lane
template <class L, int R>
cudaError_t launch_s(const float* pack, const float* rays, float* out,
                     int* viol, const MultiParams& p, const PatchParams& q,
                     cudaStream_t st) {
  return q.S <= 32 ? launch_c<L, R, 1>(pack, rays, out, viol, p, q, st)
                   : launch_c<L, R, 2>(pack, rays, out, viol, p, q, st);
}

}  // namespace

extern "C" int shade_multi_patch_launch(const float* pack, const float* rays,
                                        float* out, int* viol,
                                        const MultiParams* p,
                                        const PatchParams* q, void* stream) {
  const int S = q->S;
  if (S < 1 || S > 64 || (S & (S - 1)) || p->S != S || p->B != q->B ||
      p->weights || (q->R != 4 && q->R != 8) || q->B % q->R ||
      !PatchLayout::of(*p)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int a = 0; a < 3; ++a) {
    if (p->axis[a].TH < 0) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  using L = PatchLayout;
  if (multi_smem_bytes<L>(*q) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  return q->R == 8 ? (int)launch_s<L, 8>(pack, rays, out, viol, *p, *q, st)
                   : (int)launch_s<L, 4>(pack, rays, out, viol, *p, *q, st);
}
