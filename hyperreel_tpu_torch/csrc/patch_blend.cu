// Patch-blend kernel (K4): the features of one plane of the coherent
// patch-gather route, one bf16 row of C channels per sample, for the
// pre-blended shade kernels that read them (shade.cu
// shade_preblended_launch: the flagship's space plane; shade_multi.cu
// shade_multi_preblended_launch: each of the static net's three planes,
// one K4 launch per plane, its coordinates in pack rows (m0, m1)).
//
// Replaces hyperreel_tpu/ops/pallas/patch_blend.py:_patch_blend_kernel
// together with patch_anchor_idx and the XLA patch-row gather that fed it.
// The JAX route stores the features as bf16 (models/fused_eval.py
// `out_dtype=jnp.bfloat16`); this kernel rounds them at the same point
// (round to nearest even), but writes them ray-major, one row per sample
// at its position in the caller's order (the pack's order), instead of the
// TPU's phase-major [R*C, J] tiles.
//
// Bound on the H100 by device-memory bytes: per sample it reads the four
// pack rows that hold its point and decide validity (xn, yn, zn, dist),
// px*py*C*2 / R bytes of patch row, and writes its 2*C-byte feature row.
// With a flag buffer it also marks each violating slot (flags[j*S + s] =
// 1), so that one count over the buffer after the three launches of the
// multi-axis route gives the OR over the planes. Design: the
// anchors, the shared-memory patch rows and the hat blend of
// patch_core.cuh (see there), then each lane writes its row with 16-byte
// stores. Built for C in {8, 16} and R in {4, 8}.

#include <cuda_bf16.h>

#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace patch_core;

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <int C, int R>
__global__ void __launch_bounds__(kPatchThreads)
    patch_blend_kernel(const uint4* __restrict__ ptab,
                       const float* __restrict__ pack,
                       uint4* __restrict__ feats, int* __restrict__ viol,
                       unsigned char* __restrict__ flags,
                       const __grid_constant__ PatchParams q) {
  extern __shared__ uint4 smem[];
  const Slot t = thread_slot<R>(q);
  const int64_t N = (int64_t)q.B * q.S;
  const int64_t g = t.pos * q.S + t.s;

  float pk[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pk[i] = t.live ? __ldg(pack + (int64_t)i * N + g) : 0.0f;
  }
  const bool valid = t.live && sample_valid(pk);
  const PatchAxis ax = single_axis(ptab, q);
  const uint4* row;
  float u, v;
  stage_patches<R, 1>(&ax, q, t, pk, valid, smem, viol, flags, &row, &u, &v);
  if (!t.live) return;

  float feat[C];
  patch_features<C>(row, u, v, q.px, q.py, feat);
  uint4* dst = feats + g * (C / 8);
#pragma unroll
  for (int k = 0; k < C / 8; ++k) {
    const float* f = feat + 8 * k;
    dst[k] = make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                        bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
}

template <int C, int R>
cudaError_t launch(const uint4* ptab, const float* pack, uint4* feats,
                   int* viol, unsigned char* flags, const PatchParams& q,
                   cudaStream_t st) {
  const int64_t J = q.B / R;
  const int per_block = kPatchThreads / (R * q.S);
  const unsigned blocks = (unsigned)((J + per_block - 1) / per_block);
  patch_blend_kernel<C, R>
      <<<blocks, kPatchThreads, single_smem_bytes(q), st>>>(
          ptab, pack, feats, viol, flags, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int patch_blend_launch(const void* ptab, const float* pack,
                                  void* feats, int* viol, void* flags,
                                  const PatchParams* q, void* stream) {
  const int S = q->S;
  if (S < 1 || S > 32 || (S & (S - 1)) || (q->R != 4 && q->R != 8) ||
      q->B % q->R || single_smem_bytes(*q) > 48 * 1024 || q->m0 < 0 ||
      q->m0 > 2 || q->m1 < 0 || q->m1 > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  const uint4* pt = static_cast<const uint4*>(ptab);
  uint4* f = static_cast<uint4*>(feats);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  cudaStream_t st = (cudaStream_t)stream;
  switch (q->C * 10 + q->R) {
    case 84: return (int)launch<8, 4>(pt, pack, f, viol, fl, *q, st);
    case 88: return (int)launch<8, 8>(pt, pack, f, viol, fl, *q, st);
    case 164: return (int)launch<16, 4>(pt, pack, f, viol, fl, *q, st);
    case 168: return (int)launch<16, 8>(pt, pack, f, viol, fl, *q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
