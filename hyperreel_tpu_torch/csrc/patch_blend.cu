// Patch-blend kernel (K4): the features of one plane of the coherent
// patch-gather route, one bf16 row of C channels per sample, for the
// pre-blended shade kernels that read them (shade.cu
// shade_preblended_launch: the flagship's space plane; shade_multi.cu
// shade_multi_preblended_launch: each of the multi-axis nets' three
// planes, one K4 launch per plane, its coordinates in pack rows (m0, m1)).
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
// patch_core.cuh (see there; at S = 64 a lane holds two sample slots),
// then each lane writes its rows with 16-byte stores. Built for C in {8,
// 16}, R in {4, 8} and S a power of two <= 64; rows over 48 KB of shared
// memory (R = 4 at S = 64) opt in to the larger dynamic size.

#include <cuda_bf16.h>

#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace patch_core;

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <int C, int R, int SPL>
__global__ void __launch_bounds__(kPatchThreads)
    patch_blend_kernel(const uint4* __restrict__ ptab,
                       const float* __restrict__ pack,
                       uint4* __restrict__ feats, int* __restrict__ viol,
                       unsigned char* __restrict__ flags,
                       const __grid_constant__ PatchParams q) {
  extern __shared__ uint4 smem[];
  const Slot t = thread_slot<R, SPL>(q);
  const int64_t N = (int64_t)q.B * q.S;

  float pk[SPL][4];
  bool valid[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int64_t g = t.pos * q.S + SPL * t.s + i;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pk[i][r] = t.live ? __ldg(pack + (int64_t)r * N + g) : 0.0f;
    }
    valid[i] = t.live && sample_valid(pk[i]);
  }
  const PatchAxis ax = single_axis(ptab, q);
  const uint4* row[SPL];
  float u[SPL], v[SPL];
  stage_patches<R, 1, SPL, 4>(&ax, q, t, &pk[0][0], valid, smem, viol, flags,
                              row, u, v);
  if (!t.live) return;

#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    float feat[C];
    patch_features<C>(row[i], u[i], v[i], q.px, q.py, feat);
    uint4* dst = feats + (t.pos * q.S + SPL * t.s + i) * (C / 8);
#pragma unroll
    for (int k = 0; k < C / 8; ++k) {
      const float* f = feat + 8 * k;
      dst[k] = make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                          bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
    }
  }
}

template <int C, int R, int SPL>
cudaError_t launch(const uint4* ptab, const float* pack, uint4* feats,
                   int* viol, unsigned char* flags, const PatchParams& q,
                   cudaStream_t st) {
  const size_t smem = single_smem_bytes(q);
  // above 48 KB only as dynamic shared memory, after opting in
  cudaError_t e = cudaFuncSetAttribute(
      patch_blend_kernel<C, R, SPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t J = q.B / R;
  const int per_block = kPatchThreads / (R * (q.S / SPL));
  const unsigned blocks = (unsigned)((J + per_block - 1) / per_block);
  patch_blend_kernel<C, R, SPL><<<blocks, kPatchThreads, smem, st>>>(
      ptab, pack, feats, viol, flags, q);
  return cudaGetLastError();
}

template <int C, int R>
cudaError_t launch_s(const uint4* ptab, const float* pack, uint4* feats,
                     int* viol, unsigned char* flags, const PatchParams& q,
                     cudaStream_t st) {
  return q.S <= 32 ? launch<C, R, 1>(ptab, pack, feats, viol, flags, q, st)
                   : launch<C, R, 2>(ptab, pack, feats, viol, flags, q, st);
}

}  // namespace

extern "C" int patch_blend_launch(const void* ptab, const float* pack,
                                  void* feats, int* viol, void* flags,
                                  const PatchParams* q, void* stream) {
  const int S = q->S;
  if (S < 1 || S > 64 || (S & (S - 1)) || (q->R != 4 && q->R != 8) ||
      q->B % q->R || single_smem_bytes(*q) > 227 * 1024 || q->m0 < 0 ||
      q->m0 > 2 || q->m1 < 0 || q->m1 > 2) {
    return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  const uint4* pt = static_cast<const uint4*>(ptab);
  uint4* f = static_cast<uint4*>(feats);
  unsigned char* fl = static_cast<unsigned char*>(flags);
  cudaStream_t st = (cudaStream_t)stream;
  switch (q->C * 10 + q->R) {
    case 84: return (int)launch_s<8, 4>(pt, pack, f, viol, fl, *q, st);
    case 88: return (int)launch_s<8, 8>(pt, pack, f, viol, fl, *q, st);
    case 164: return (int)launch_s<16, 4>(pt, pack, f, viol, fl, *q, st);
    case 168: return (int)launch_s<16, 8>(pt, pack, f, viol, fl, *q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
