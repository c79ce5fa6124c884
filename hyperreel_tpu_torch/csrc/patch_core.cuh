// Device code shared by the kernels of the coherent patch-gather routes:
// K3 (shade_patch.cuh, the blend inside the flagship's shade kernel), K4
// (patch_blend.cu, the blend alone, over every plane of a chunk) and K6
// (shade_multi_patch.cu, the blend of the three plane axes inside the
// multi-axis shade kernel). Port of hyperreel_tpu/ops/patch_gather.py and
// the blend of ops/pallas/patch_blend.py:_patch_blend_kernel with
// patch_anchor_idx.
//
// A coherent block j is R rays of one chunk; at every sample slot s the R
// rays' samples share one patch row per plane axis: px*py texels of C bf16
// channels, texel t = ty*px + tx channel-major, anchored at (x0, y0) =
// clip(floor(min over the R rays of the unnormalised coordinate), -1, W-1 /
// H-1), the coordinates being the plane's two point components (pack rows
// m0 and m1: 0 and 1 for the flagship's space plane, MAT_MODE of the static
// net's axis otherwise). Ray p of block j is the caller's ray R*j + p,
// found at position R*j + p, or at p*(B/R) + j when the caller delivers the
// rays phase-major; the kernels read and write each ray at its position, so
// there is no permutation and no index array. A sample's feature is
//   sum over ty < py, tx < px of max(0, 1-|u-tx|) * max(0, 1-|v-ty|) *
//   patch[t],  u = (x+1)*0.5*(W-1) - x0, v likewise,
// which is the bilinear lookup when the sample's 2x2 footprint lies in the
// patch and zero-degrades where it leaves it. Only the taps floor(u),
// floor(u)+1 (and those of v) can have a non-zero hat weight, so a thread
// blends at most four texels (the same non-zero terms in the same order as
// the full sum). The kernels also count the coverage violations: the
// slots whose valid samples' footprint exits the patch on some axis,
// floor(max) - floor(min) > p - 2 (hyperreel_tpu/models/fused_eval.py
// patch_coverage_viol, the OR over every plane's two coordinates).
//
// Two prologues compute the anchors and the witness:
// - K3 and K4 hold the R rays of a coherent block in R neighbouring lanes
//   of a warp at each sample slot, so a slot's min, its coverage test and
//   its OR are __shfl_xor_sync butterflies over those lanes (slot_anchor),
//   with no barrier; the taps are read from the patch table through L1
//   (patch_taps).
// - K6 keeps the block-wide prologue (stage_patches): thread layout below,
//   anchors through shared memory and each slot's patch rows staged there
//   behind three barriers.
//
// K6's thread layout: a CUDA block of kPatchThreads threads, with SPL = 1
// sample per lane for S <= 32 and 2 for S = 64 (lanes = S / SPL per ray):
// G = kPatchThreads / (R*lanes) coherent blocks; thread (jb*R + p)*lanes + l
// holds samples SPL*l + i (i < SPL) of ray p of coherent block jb, so a ray
// is a warp segment (a whole warp at S = 64). Sample s of ray p of block jb
// is sample (jb*R + p)*S + s of the CUDA block, in shared memory too.

#pragma once

#include "shade_core.cuh"

// global scope: see the note on PackParams in pack_build.cu. K3 reads every
// field; K6 reads B, S, R, px, py and phase_major (its planes' shapes are in
// its MultiParams). K4 takes its own (patch_blend.cu BlendParams).
struct PatchParams {
  int B, S, W, H, C, R, px, py, phase_major, m0, m1;
};

constexpr int kPatchThreads = 256;
constexpr int kMaxPatchAxes = 3;

namespace patch_core {

// One plane axis as the prologue sees it: its patch table, its shape, the
// pack rows of its two coordinates and the 16-byte vectors of one patch
// row (px*py*C bf16).
struct PatchAxis {
  const uint4* ptab;
  int W, H, m0, m1, vecs;
};

// the row stride in shared memory: odd, so that the 16-byte loads of 8
// neighbouring slots fall in distinct banks
__host__ __device__ inline int row_stride(int vecs) { return vecs | 1; }

// samples per lane for S samples per ray
__host__ __device__ inline int samples_per_lane(int S) {
  return S > 32 ? S / 32 : 1;
}

// slots (coherent block, sample slot) of one CUDA block
__host__ __device__ inline int block_slots(int R, int SPL) {
  return kPatchThreads * SPL / R;
}

// dynamic shared memory: each axis's patch rows for the block's slots, then
// per sample x, y, z and valid; per axis and slot x0, y0 and the row index;
// one violation count
__host__ __device__ inline size_t smem_bytes(const int* vecs, int na, int R,
                                             int SPL) {
  size_t rows = 0;
  for (int a = 0; a < na; ++a) rows += (size_t)row_stride(vecs[a]);
  return (size_t)block_slots(R, SPL) * rows * 16 +
         (size_t)kPatchThreads * SPL * 4 * 4 +
         (size_t)na * block_slots(R, SPL) * 3 * 4 + 16;
}

// the thread's coherent block, ray and lane in the ray's segment (s), and
// its ray's position in the caller's order
struct Slot {
  int jb, p, s;
  int64_t j, pos;
  bool live;
};

template <int R, int SPL>
__device__ __forceinline__ Slot thread_slot(const PatchParams& q) {
  const int lanes = q.S / SPL;
  const int tid = threadIdx.x;
  Slot t;
  t.s = tid % lanes;
  t.p = (tid / lanes) % R;
  t.jb = tid / (lanes * R);
  const int64_t J = q.B / R;
  t.j = (int64_t)blockIdx.x * (kPatchThreads / (R * lanes)) + t.jb;
  t.live = t.j < J;
  t.pos = !t.live ? 0 : q.phase_major ? t.p * J + t.j : t.j * R + t.p;
  return t;
}

// xyz[m] by selects (m is a kernel parameter: no local-memory indexing)
__device__ __forceinline__ float pick3(const float* xyz, int m) {
  return m == 0 ? xyz[0] : m == 1 ? xyz[1] : xyz[2];
}

// the unnormalised texel coordinate (align_corners=True)
__device__ __forceinline__ float texel(float coord, int size) {
  return (coord + 1.0f) * 0.5f * (float)(size - 1);
}

// The collective prologue; every thread of the CUDA block calls it with its
// SPL samples' normalised points (pack rows 0..2 of sample i at xyz + i *
// PKS) and validity. For each of the NA plane axes it computes each slot's
// anchor (the min over its R rays, every sample counted, as the JAX anchors
// do) and stages each slot's patch row in shared memory; it adds the
// block's coverage violations (slots that violate on any axis) to *viol,
// sets flags[j*S + s] = 1 for each such slot when `flags` is not null, and
// returns per sample i and axis a (index i * NA + a) the sample's row and
// its offsets (u, v) inside the patch.
template <int R, int NA, int SPL, int PKS>
__device__ __forceinline__ void stage_patches(
    const PatchAxis* ax, const PatchParams& q, const Slot& t, const float* xyz,
    const bool* valid, uint4* smem, int* viol, unsigned char* flags,
    const uint4** rows, float* u, float* v) {
  constexpr int NS = kPatchThreads * SPL;   // samples of the CUDA block
  const int S = q.S;
  const int slots = block_slots(R, SPL);
  size_t row_off[NA];
  size_t off = 0;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    row_off[a] = off;
    off += (size_t)slots * row_stride(ax[a].vecs);
  }
  float* sc = reinterpret_cast<float*>(smem + off);   // [3][NS]
  int* sok = reinterpret_cast<int*>(sc + 3 * NS);
  float* sax = reinterpret_cast<float*>(sok + NS);  // [NA][slots]
  float* say = sax + NA * slots;
  int* sidx = reinterpret_cast<int*>(say + NA * slots);
  int* scount = sidx + NA * slots;

  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sc[c * NS + tid * SPL + i] = xyz[i * PKS + c];
    sok[tid * SPL + i] = valid[i];
  }
  if (tid == 0) *scount = 0;
  __syncthreads();

  if (t.p == 0) {
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      const int s = SPL * t.s + i;
      const int slot = t.jb * S + s;
      const int base = t.jb * R * S + s;
      bool violates = false;
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const float* sx = sc + ax[a].m0 * NS;
        const float* sy = sc + ax[a].m1 * NS;
        int idx = 0;
        float x0 = 0.0f, y0 = 0.0f;
        if (t.live) {
          float xmin = sx[base], ymin = sy[base];
          float lox = 0.0f, hix = 0.0f, loy = 0.0f, hiy = 0.0f;
          bool any = false;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float x = sx[base + r * S], y = sy[base + r * S];
            xmin = fminf(xmin, x);
            ymin = fminf(ymin, y);
            if (sok[base + r * S]) {
              const float fx = floorf(texel(x, ax[a].W));
              const float fy = floorf(texel(y, ax[a].H));
              lox = any ? fminf(lox, fx) : fx;
              hix = any ? fmaxf(hix, fx) : fx;
              loy = any ? fminf(loy, fy) : fy;
              hiy = any ? fmaxf(hiy, fy) : fy;
              any = true;
            }
          }
          violates |= any && (hix - lox > (float)(q.px - 2) ||
                              hiy - loy > (float)(q.py - 2));
          x0 = fminf(fmaxf(floorf(texel(xmin, ax[a].W)), -1.0f),
                     (float)(ax[a].W - 1));
          y0 = fminf(fmaxf(floorf(texel(ymin, ax[a].H)), -1.0f),
                     (float)(ax[a].H - 1));
          idx = ((int)y0 + 1) * (ax[a].W + 1) + ((int)x0 + 1);
        }
        sax[a * slots + slot] = x0;
        say[a * slots + slot] = y0;
        sidx[a * slots + slot] = idx;
      }
      if (violates) {
        atomicAdd(scount, 1);
        if (flags) flags[t.j * S + s] = 1;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int rv = ax[a].vecs, stride = row_stride(rv);
    uint4* dst = smem + row_off[a];
    const int* idx = sidx + a * slots;
    for (int i = tid; i < slots * rv; i += kPatchThreads) {
      const int sl = i / rv, k = i - sl * rv;
      dst[sl * stride + k] = __ldg(ax[a].ptab + (int64_t)idx[sl] * rv + k);
    }
  }
  if (tid == 0 && *scount) atomicAdd(viol, *scount);
  __syncthreads();

  // op order of the JAX kernels: ((x + 1) * 0.5) * (W - 1) - x0, with no
  // fused multiply-add
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    const int slot = t.jb * S + SPL * t.s + i;
    const float* p = xyz + i * PKS;
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      u[i * NA + a] = __fmul_rn((pick3(p, ax[a].m0) + 1.0f) * 0.5f,
                                (float)(ax[a].W - 1)) -
                      sax[a * slots + slot];
      v[i * NA + a] = __fmul_rn((pick3(p, ax[a].m1) + 1.0f) * 0.5f,
                                (float)(ax[a].H - 1)) -
                      say[a * slots + slot];
      rows[i * NA + a] = smem + row_off[a] + slot * row_stride(ax[a].vecs);
    }
  }
}

// The hat blend of one sample from its slot's patch row (see the top),
// staged in shared memory (K6).
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

// The warp prologue of K3 and K4. At one sample slot the R rays of a
// coherent block sit in R neighbouring lanes of a warp (lane bits below R;
// every lane of the warp takes part, the lanes of a dead coherent block
// too). One coordinate's span over them: the min over every sample (the
// anchor counts every sample, as the JAX anchors do) and the min and max
// over the valid samples (the coverage test counts those); `all_valid`
// (warp-uniform) says that every live lane's sample is valid, so that the
// min over the valid samples is the min over all.
struct Span {
  float mn, lo, hi;
};

template <int R>
__device__ __forceinline__ Span span(float x, bool valid, bool all_valid) {
  const int kLanes = R;
  const unsigned full = 0xffffffffu;
  const float inf = __int_as_float(0x7f800000);
  Span s{x, valid ? x : inf, valid ? x : -inf};
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    s.mn = fminf(s.mn, __shfl_xor_sync(full, s.mn, o));
    s.hi = fmaxf(s.hi, __shfl_xor_sync(full, s.hi, o));
    if (!all_valid) s.lo = fminf(s.lo, __shfl_xor_sync(full, s.lo, o));
  }
  if (all_valid) s.lo = s.mn;
  return s;
}

// The anchor (x0, y0), the patch-table row and the witness of one plane
// at one slot from its two coordinates' spans. floor(texel(.)) is
// monotone, so the floors' min and max are the floors of the coordinates'
// min and max; with no valid sample hi = -inf < lo and nothing violates.
struct SlotAnchor {
  float x0, y0;
  int idx;
  bool viol;
};

__device__ __forceinline__ SlotAnchor anchor_of(const Span& x, const Span& y,
                                                int W, int H, int px,
                                                int py) {
  SlotAnchor a;
  a.viol = x.hi >= x.lo &&
           (floorf(texel(x.hi, W)) - floorf(texel(x.lo, W)) >
                (float)(px - 2) ||
            floorf(texel(y.hi, H)) - floorf(texel(y.lo, H)) >
                (float)(py - 2));
  a.x0 = fminf(fmaxf(floorf(texel(x.mn, W)), -1.0f), (float)(W - 1));
  a.y0 = fminf(fmaxf(floorf(texel(y.mn, H)), -1.0f), (float)(H - 1));
  a.idx = ((int)a.y0 + 1) * (W + 1) + ((int)a.x0 + 1);
  return a;
}

// The hat blend of one sample from its slot's row in the patch table, read
// through L1 (K3, K4): the terms of patch_features in the same order, with
// the taps' indices clamped into the row and the weight of a tap outside
// the patch 0 (an added 0 changes no sum). Skipping those taps by branches,
// as patch_features does, measured slower in both kernels
// (scripts/patch_variants.py `skip_taps`: K3 0.437 against 0.416 ms, K4
// over n3d's three planes 1.24 against 0.82).
template <int C>
__device__ __forceinline__ void patch_taps(const uint4* __restrict__ row,
                                           float u, float v, int px, int py,
                                           float* feat) {
  const float fx0 = floorf(u), fy0 = floorf(v);
  float wx[2], wy[2];
  int ix[2], iy[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const float tx = fx0 + (float)d, ty = fy0 + (float)d;
    const bool inx = tx >= 0.0f && tx <= (float)(px - 1);
    const bool iny = ty >= 0.0f && ty <= (float)(py - 1);
    wx[d] = inx ? fmaxf(0.0f, 1.0f - fabsf(u - tx)) : 0.0f;
    wy[d] = iny ? fmaxf(0.0f, 1.0f - fabsf(v - ty)) : 0.0f;
    ix[d] = inx ? (int)tx : 0;
    iy[d] = iny ? (int)ty : 0;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) feat[c] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float w = wx[dx] * wy[dy];
      const uint4* tex = row + (iy[dy] * px + ix[dx]) * (C / 8);
#pragma unroll
      for (int k = 0; k < C / 8; ++k) {
        shade_core::axpy_bf16x8(feat + 8 * k, w, __ldg(tex + k));
      }
    }
  }
}

// A sample's offsets inside its slot's patch, in the JAX kernels' op order:
// ((x + 1) * 0.5) * (W - 1) - x0, with no fused multiply-add.
__device__ __forceinline__ float patch_offset(float coord, int size,
                                              float anchor) {
  return __fmul_rn((coord + 1.0f) * 0.5f, (float)(size - 1)) - anchor;
}

}  // namespace patch_core
