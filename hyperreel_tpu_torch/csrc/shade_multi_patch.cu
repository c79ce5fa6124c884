// Fused multi-axis patch-blend + shade kernel (K6): the coherent
// patch-gather route of the static VM net's eval render (the llff_z_plane
// family) in one kernel, from the per-sample pack and the three planes'
// patch tables to the per-ray colour.
//
// Replaces hyperreel_tpu/ops/pallas/shade.py:_shade_kernel_multi_fused_patch
// (time_hs all 0: per axis the blend of ops/pallas/patch_blend.py, the line
// factor, the density and appearance sums, then _shade_tail) together with
// the XLA patch-row gathers and patch_anchor_idx (one per axis) that fed
// it. The JAX kernel walks the axes outside and its R phases inside so that
// one axis's patch transpose fits the TPU's VMEM; here every thread shades
// its own sample, so a thread walks the three axes for its one sample.
//
// Bound on the H100 by its f32 operations: per valid sample K5's arithmetic
// plus the hat blend of at most four texels per plane; the bytes are the
// pack and ray-pack reads and px*py*(16+8+8)*2 / R bytes of patch rows per
// sample (80 at R = 8, (5, 2)) where K5 reads 256 bytes of quad rows.
// Design (patch_core.cuh): one CUDA block of 256 threads holds 256 / (R*S)
// coherent blocks, a warp segment per ray and a lane per sample slot; each
// slot's anchors are a min over its R rays per plane, and its three patch
// rows (320 + 160 + 160 bytes at (5, 2)) are staged once in shared memory
// with coalesced 16-byte loads behind one set of barriers; the R rays blend
// from them. Everything after the plane features is K5's (multi_core.cuh)
// and K2's composite (shade_core.cuh). The kernel also counts the coverage
// violations (slots whose footprint exits the patch on any plane). Built
// for the layout of multi_core.cuh and R in {4, 8}.

#include "multi_core.cuh"
#include "patch_core.cuh"

namespace {

using namespace shade_core;
using namespace multi_core;
using namespace patch_core;

template <int R>
__global__ void __launch_bounds__(kPatchThreads)
    shade_multi_patch_kernel(const float* __restrict__ pack,
                             const float* __restrict__ rays,
                             float* __restrict__ out, int* __restrict__ viol,
                             const __grid_constant__ MultiParams p,
                             const __grid_constant__ PatchParams q) {
  extern __shared__ uint4 smem[];
  const Slot t = thread_slot<R>(q);
  const int S = q.S;
  const int64_t N = (int64_t)q.B * S;
  const int64_t g = t.pos * S + t.s;

  float pk[kPackRows];
#pragma unroll
  for (int i = 0; i < kPackRows; ++i) {
    pk[i] = t.live ? __ldg(pack + (int64_t)i * N + g) : 0.0f;
  }
  const bool valid = t.live && sample_valid(pk);
  const int pp = q.px * q.py;
  const PatchAxis ax[3] = {
      {static_cast<const uint4*>(p.axis[0].table), p.axis[0].W, p.axis[0].H,
       Mode<0>::m0, Mode<0>::m1, pp * kCh0 / 8},
      {static_cast<const uint4*>(p.axis[1].table), p.axis[1].W, p.axis[1].H,
       Mode<1>::m0, Mode<1>::m1, pp * kCh1 / 8},
      {static_cast<const uint4*>(p.axis[2].table), p.axis[2].W, p.axis[2].H,
       Mode<2>::m0, Mode<2>::m1, pp * kCh2 / 8}};
  const uint4* rows[3];
  float u[3], v[3];
  stage_patches<R, 3>(ax, q, t, pk, valid, smem, viol, nullptr, rows, u, v);

  float sigma = 0.0f;
  float rgb[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    float dsum = 0.0f;
    float app[kApp];
    {
      float feat[kCh0];
      patch_features<kCh0>(rows[0], u[0], v[0], q.px, q.py, feat);
      line_product<0, kCh0, kNd0>(p.axis[0], pk, feat, dsum, app);
    }
    {
      float feat[kCh1];
      patch_features<kCh1>(rows[1], u[1], v[1], q.px, q.py, feat);
      line_product<1, kCh1, kNd1>(p.axis[1], pk, feat, dsum,
                                  app + kCh0 - kNd0);
    }
    {
      float feat[kCh2];
      patch_features<kCh2>(rows[2], u[2], v[2], q.px, q.py, feat);
      line_product<2, kCh2, kNd2>(p.axis[2], pk, feat, dsum,
                                  app + kCh0 - kNd0 + kCh1 - kNd1);
    }
    sigma = fmaxf(dsum, 0.0f);
    sh_colour<kApp>(app, p.wb, pk, rays + t.pos * 8, rgb);
  }
  composite_store(sigma, rgb, pk[3], p.distance_scale, t.s, S, t.live,
                  out + t.pos * 5);
}

size_t multi_smem_bytes(const PatchParams& q) {
  const int pp = q.px * q.py;
  const int vecs[3] = {pp * kCh0 / 8, pp * kCh1 / 8, pp * kCh2 / 8};
  return smem_bytes(vecs, 3, q.R);
}

template <int R>
cudaError_t launch(const float* pack, const float* rays, float* out,
                   int* viol, const MultiParams& p, const PatchParams& q,
                   cudaStream_t st) {
  const size_t smem = multi_smem_bytes(q);
  // above 48 KB only as dynamic shared memory, after opting in
  cudaError_t e = cudaFuncSetAttribute(
      shade_multi_patch_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int64_t J = q.B / R;
  const int per_block = kPatchThreads / (R * q.S);
  const unsigned blocks = (unsigned)((J + per_block - 1) / per_block);
  shade_multi_patch_kernel<R><<<blocks, kPatchThreads, smem, st>>>(
      pack, rays, out, viol, p, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int shade_multi_patch_launch(const float* pack, const float* rays,
                                        float* out, int* viol,
                                        const MultiParams* p,
                                        const PatchParams* q, void* stream) {
  const int S = q->S;
  if (S < 1 || S > 32 || (S & (S - 1)) || p->S != S || p->B != q->B ||
      (q->R != 4 && q->R != 8) || q->B % q->R ||
      multi_smem_bytes(*q) > 227 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  if (q->B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return q->R == 8 ? (int)launch<8>(pack, rays, out, viol, *p, *q, st)
                   : (int)launch<4>(pack, rays, out, viol, *p, *q, st);
}
