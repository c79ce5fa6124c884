// Device code shared by the two kernels of the coherent patch-gather route:
// K3 (shade_patch.cu, the blend inside the shade kernel) and K4
// (patch_blend.cu, the blend alone). Port of hyperreel_tpu/ops/
// patch_gather.py and the blend of ops/pallas/patch_blend.py:
// _patch_blend_kernel with patch_anchor_idx.
//
// A coherent block j is R rays of one chunk; at every sample slot s the R
// rays' samples share one patch row: px*py texels of C bf16 channels,
// texel t = ty*px + tx channel-major, anchored at (x0, y0) = clip(floor(
// min over the R rays of the unnormalised coordinate), -1, W-1 / H-1).
// Ray p of block j is the caller's ray R*j + p, found at position R*j + p,
// or at p*(B/R) + j when the caller delivers the rays phase-major; the
// kernels read and write each ray at its position, so there is no
// permutation and no index array. A sample's feature is
//   sum over ty < py, tx < px of max(0, 1-|u-tx|) * max(0, 1-|v-ty|) *
//   patch[t],  u = (xn+1)*0.5*(W-1) - x0, v likewise,
// which is the bilinear lookup when the sample's 2x2 footprint lies in the
// patch and zero-degrades where it leaves it. Only the taps floor(u),
// floor(u)+1 (and those of v) can have a non-zero hat weight, so a thread
// blends at most four texels (the same non-zero terms in the same order as
// the full sum). The kernels also count the coverage violations: the
// slots whose valid samples' footprint exits the patch on some axis,
// floor(max) - floor(min) > p - 2 (hyperreel_tpu/models/fused_eval.py
// patch_coverage_viol).
//
// Thread layout of a CUDA block of kPatchThreads threads: G = kPatchThreads
// / (R*S) coherent blocks; thread (jb*R + p)*S + s holds sample s of ray p
// of coherent block jb, so a ray is an S-lane segment of a warp.

#pragma once

#include "shade_core.cuh"

// global scope: see the note on PackParams in pack_build.cu
struct PatchParams {
  int B, S, W, H, C, R, px, py, phase_major;
};

constexpr int kPatchThreads = 256;

namespace patch_core {

// 16-byte vectors of one patch row (px*py*C bf16), and the row stride in
// shared memory: odd, so that the 16-byte loads of 8 neighbouring slots
// fall in distinct banks
__host__ __device__ inline int row_vecs(const PatchParams& q) {
  return q.px * q.py * q.C / 8;
}
__host__ __device__ inline int row_stride(const PatchParams& q) {
  return row_vecs(q) | 1;
}
// slots (coherent block, sample slot) of one CUDA block
__host__ __device__ inline int block_slots(const PatchParams& q) {
  return kPatchThreads / q.R;
}
// dynamic shared memory: the slots' patch rows, then per thread xn, yn,
// valid; per slot x0, y0, row index; one violation count
__host__ __device__ inline size_t smem_bytes(const PatchParams& q) {
  return (size_t)block_slots(q) * row_stride(q) * 16 +
         (size_t)kPatchThreads * 3 * 4 + (size_t)block_slots(q) * 3 * 4 +
         16;
}

// the thread's coherent block, ray and sample slot, and its ray's position
// in the caller's order
struct Slot {
  int jb, p, s;
  int64_t j, pos;
  bool live;
};

template <int R>
__device__ __forceinline__ Slot thread_slot(const PatchParams& q) {
  const int S = q.S;
  const int tid = threadIdx.x;
  Slot t;
  t.s = tid % S;
  t.p = (tid / S) % R;
  t.jb = tid / (S * R);
  const int64_t J = q.B / R;
  t.j = (int64_t)blockIdx.x * (kPatchThreads / (R * S)) + t.jb;
  t.live = t.j < J;
  t.pos = !t.live ? 0 : q.phase_major ? t.p * J + t.j : t.j * R + t.p;
  return t;
}

// the unnormalised texel coordinate (align_corners=True)
__device__ __forceinline__ float texel(float coord, int size) {
  return (coord + 1.0f) * 0.5f * (float)(size - 1);
}

// The collective prologue; every thread of the CUDA block calls it with its
// sample's normalised plane coordinates and validity. Computes each slot's
// anchor (the min over its R rays, every sample counted, as the JAX
// anchors do), adds the block's coverage violations to *viol, stages each
// slot's patch row in shared memory, and returns the thread's row with its
// offsets (u, v) inside the patch.
template <int R>
__device__ const uint4* stage_patch(const uint4* __restrict__ ptab,
                                    const PatchParams& q, const Slot& t,
                                    float xn, float yn, bool valid,
                                    uint4* smem, int* viol, float& u,
                                    float& v) {
  const int S = q.S;
  const int slots = block_slots(q);
  const int stride = row_stride(q);
  const int rv = row_vecs(q);
  float* sx = reinterpret_cast<float*>(smem + (size_t)slots * stride);
  float* sy = sx + kPatchThreads;
  int* sok = reinterpret_cast<int*>(sy + kPatchThreads);
  float* sax = reinterpret_cast<float*>(sok + kPatchThreads);
  float* say = sax + slots;
  int* sidx = reinterpret_cast<int*>(say + slots);
  int* scount = sidx + slots;

  const int tid = threadIdx.x;
  const int slot = t.jb * S + t.s;
  sx[tid] = xn;
  sy[tid] = yn;
  sok[tid] = valid;
  if (tid == 0) *scount = 0;
  __syncthreads();

  if (t.p == 0) {
    int idx = 0;
    float x0 = 0.0f, y0 = 0.0f;
    if (t.live) {
      const int base = t.jb * R * S + t.s;
      float xmin = sx[base], ymin = sy[base];
      float lox = 0.0f, hix = 0.0f, loy = 0.0f, hiy = 0.0f;
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = sx[base + r * S], y = sy[base + r * S];
        xmin = fminf(xmin, x);
        ymin = fminf(ymin, y);
        if (sok[base + r * S]) {
          const float fx = floorf(texel(x, q.W)), fy = floorf(texel(y, q.H));
          lox = any ? fminf(lox, fx) : fx;
          hix = any ? fmaxf(hix, fx) : fx;
          loy = any ? fminf(loy, fy) : fy;
          hiy = any ? fmaxf(hiy, fy) : fy;
          any = true;
        }
      }
      if (any && (hix - lox > (float)(q.px - 2) ||
                  hiy - loy > (float)(q.py - 2))) {
        atomicAdd(scount, 1);
      }
      x0 = fminf(fmaxf(floorf(texel(xmin, q.W)), -1.0f), (float)(q.W - 1));
      y0 = fminf(fmaxf(floorf(texel(ymin, q.H)), -1.0f), (float)(q.H - 1));
      idx = ((int)y0 + 1) * (q.W + 1) + ((int)x0 + 1);
    }
    sax[slot] = x0;
    say[slot] = y0;
    sidx[slot] = idx;
  }
  __syncthreads();

  for (int i = tid; i < slots * rv; i += kPatchThreads) {
    const int sl = i / rv, k = i - sl * rv;
    smem[sl * stride + k] = __ldg(ptab + (int64_t)sidx[sl] * rv + k);
  }
  if (tid == 0 && *scount) atomicAdd(viol, *scount);
  __syncthreads();

  // op order of the JAX kernels: ((xn + 1) * 0.5) * (W - 1) - x0, with no
  // fused multiply-add
  u = __fmul_rn((xn + 1.0f) * 0.5f, (float)(q.W - 1)) - sax[slot];
  v = __fmul_rn((yn + 1.0f) * 0.5f, (float)(q.H - 1)) - say[slot];
  return smem + slot * stride;
}

// The hat blend of one sample from its slot's patch row (see the top).
template <int C>
__device__ __forceinline__ void patch_features(const uint4* row, float u,
                                               float v, int px, int py,
                                               float* feat) {
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.0f;
  const float fx0 = floorf(u), fy0 = floorf(v);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float ty = fy0 + (float)dy;
    if (!(ty >= 0.0f && ty <= (float)(py - 1))) continue;
    const float wy = fmaxf(0.0f, 1.0f - fabsf(v - ty));
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float tx = fx0 + (float)dx;
      if (!(tx >= 0.0f && tx <= (float)(px - 1))) continue;
      const float w = fmaxf(0.0f, 1.0f - fabsf(u - tx)) * wy;
      const uint4* tex = row + ((int)ty * px + (int)tx) * (C / 8);
#pragma unroll
      for (int k = 0; k < C / 8; ++k) {
        shade_core::axpy_bf16x8(feat + 8 * k, w, tex[k]);
      }
    }
  }
}

}  // namespace patch_core
