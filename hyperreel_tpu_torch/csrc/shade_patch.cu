// Fused patch-blend + shade kernel (K3): the coherent patch-gather route of
// the flagship eval render in one kernel, from the per-sample pack and the
// patch table to the per-ray colour.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_fused_patch
// (the blend of ops/pallas/patch_blend.py inside the shade kernel, R phases
// per patch row, with _shade_core and _shade_tail) together with the XLA
// patch-row gather and patch_anchor_idx that fed it.
//
// Bound on the H100 by its f32 operations: per valid sample the blend of at
// most four C-channel texels, the time taps, the density and the 27 x C
// basis product with the SH colour, about as much arithmetic as K2's; the
// bytes are K2's pack and ray-pack reads but only px*py*C*2 / R bytes of
// patch row per sample (40 bytes at R = 8, (5, 2), C = 16, against K2's
// 128-byte quad row). Design (patch_core.cuh): one CUDA block of 256
// threads holds 256 / (R*S) coherent blocks, a warp segment per ray and a
// lane per sample slot, as K2 maps a ray; each slot's anchor is a min over
// its R rays through shared memory, the slot's patch row is loaded once
// into shared memory with coalesced 16-byte loads, and the R rays blend
// from it; the features never reach device memory. Everything after the
// space features is K2's per-sample shading and warp composite
// (shade_core.cuh). Built for C in {8, 16}, R in {4, 8} and SH of degree 2
// or RGB colour (a template argument); a pack with the weights row is
// refused (not built: ROADMAP.md 2a).

#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace patch_core;

template <int C, int R, bool kRgb>
__global__ void __launch_bounds__(kPatchThreads)
    shade_patch_kernel(const uint4* __restrict__ ptab,
                       const float* __restrict__ pack,
                       const float* __restrict__ rays,
                       const float* __restrict__ ttab,
                       float* __restrict__ out, int* __restrict__ viol,
                       const __grid_constant__ ShadeParams p,
                       const __grid_constant__ PatchParams q) {
  extern __shared__ uint4 smem[];
  const Slot t = thread_slot<R, 1>(q);
  const int S = q.S;
  const int64_t N = (int64_t)q.B * S;
  const int64_t g = t.pos * S + t.s;

  float pk[kPackRows];
#pragma unroll
  for (int i = 0; i < kPackRows; ++i) {
    pk[i] = t.live ? __ldg(pack + (int64_t)i * N + g) : 0.0f;
  }
  const bool valid = t.live && sample_valid(pk);
  const PatchAxis ax = single_axis(ptab, q);
  const uint4* row;
  float u, v;
  stage_patches<R, 1, 1, kPackRows>(&ax, q, t, pk, &valid, smem, viol,
                                    nullptr, &row, &u, &v);

  float sigma = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    float feat[C];
    patch_features<C>(row, u, v, q.px, q.py, feat);
    shade_sample<C, kRgb, false>(feat, pk, rays + t.pos * 8, ttab, p, 1.0f,
                                 sigma, rgb);
  }

  composite_store(sigma, rgb, pk[3], p.distance_scale, t.s, S, t.live,
                  out + t.pos * 5);
}

template <int C, int R>
cudaError_t launch(const uint4* ptab, const float* pack, const float* rays,
                   const float* ttab, float* out, int* viol,
                   const ShadeParams& p, const PatchParams& q,
                   cudaStream_t st) {
  const size_t smem = single_smem_bytes(q);
  const int64_t J = q.B / R;
  const int per_block = kPatchThreads / (R * q.S);
  const unsigned blocks = (unsigned)((J + per_block - 1) / per_block);
  if (p.rgb) {
    shade_patch_kernel<C, R, true><<<blocks, kPatchThreads, smem, st>>>(
        ptab, pack, rays, ttab, out, viol, p, q);
  } else {
    shade_patch_kernel<C, R, false><<<blocks, kPatchThreads, smem, st>>>(
        ptab, pack, rays, ttab, out, viol, p, q);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int shade_patch_launch(const void* ptab, const float* pack,
                                  const float* rays, const float* ttab,
                                  float* out, int* viol,
                                  const ShadeParams* p, const PatchParams* q,
                                  void* stream) {
  const int S = q->S;
  if (S < 1 || S > 32 || (S & (S - 1)) || p->S != S || p->B != q->B ||
      p->C != q->C || p->weights || (q->R != 4 && q->R != 8) ||
      q->B % q->R ||
      single_smem_bytes(*q) > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  const uint4* pt = static_cast<const uint4*>(ptab);
  cudaStream_t st = (cudaStream_t)stream;
  const int key = q->C * 10 + q->R;
  switch (key) {
    case 84: return (int)launch<8, 4>(pt, pack, rays, ttab, out, viol, *p, *q, st);
    case 88: return (int)launch<8, 8>(pt, pack, rays, ttab, out, viol, *p, *q, st);
    case 164: return (int)launch<16, 4>(pt, pack, rays, ttab, out, viol, *p, *q, st);
    case 168: return (int)launch<16, 8>(pt, pack, rays, ttab, out, viol, *p, *q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int patch_params_size() { return (int)sizeof(PatchParams); }
