// Patch-blend kernel (K4): the features of every plane of the coherent
// patch-gather route in one launch per chunk, one bf16 row of C channels
// per sample and plane, for the pre-blended shade kernels that read them
// (shade.cu shade_preblended_launch: the flagship's space plane;
// shade_multi.cu shade_multi_preblended_launch: the multi-axis nets' three
// planes, each plane's coordinates in pack rows (m0, m1)).
//
// Replaces hyperreel_tpu/ops/pallas/patch_blend.py:_patch_blend_kernel
// (one pallas_call per plane on the JAX route, models/fused_eval.py)
// together with patch_anchor_idx, the XLA patch-row gathers that fed it and
// the OR of the planes' coverage flags. The JAX route stores the features
// as bf16 (`out_dtype=jnp.bfloat16`); this kernel rounds them at the same
// point (round to nearest even), but writes them ray-major, one row per
// sample at its position in the caller's order (the pack's order), one
// tensor per plane, instead of the TPU's phase-major [R*C, J] tiles.
//
// Bound on the H100 by device-memory bytes: per sample the four pack rows
// that hold its point and decide validity (xn, yn, zn, dist), read once for
// every plane, the 2*C-byte feature row of each plane written, and each
// slot's patch rows (px*py*C*2 bytes per plane, shared by the slot's R
// rays). Design:
// - A lane holds kV = 4 consecutive samples of one ray (one float4 per pack
//   row: the R rays' lanes read R runs of 32/R float4); a warp is R rays x
//   32/R lanes, so the R lanes of a coherent block at one slot are
//   neighbours and each slot's anchors and witness are shuffle butterflies
//   over them (patch_core.cuh span, anchor_of): no block barrier, no
//   shared memory for the anchors; on three planes each coordinate's span
//   is taken once for the two planes that use it.
// - The four taps of a sample are read from the patch table through L1 (a
//   warp instruction reads the rows of 32/R slots, each shared by its R
//   lanes), at indices clamped into the row with a weight of 0 where a tap
//   leaves the patch (patch_core.cuh patch_taps: skipping those taps by
//   branches measured 1.5x slower). The per-launch kernel before this one
//   staged each slot's row in shared memory behind block barriers, which
//   paid 1-7 % there, where a warp read 32 slots' rows; staging here is
//   not measured (PERF.md).
// - The features, rounded to bf16, go to a per-warp tile in shared memory
//   (padded so that neither pass has bank conflicts), and the warp stores
//   each plane's runs of rows with coalesced 16-byte stores.
// - The witness is the OR over the planes in registers; each warp with a
//   violating slot adds its count to the one int32 (no flag buffer).
// Built for one plane of C in {8, 16} channels (the flagship's space
// plane) and for three planes of 16, 8, 8 channels on pack rows (0, 1), (0,
// 2), (1, 2) (multi_core.cuh PatchLayout, Mode), R in {4, 8} and S a power
// of two in 4 .. 64.

#include <cuda_bf16.h>

#include "patch_core.cuh"

// global scope: see the note on PackParams in pack_build.cu. One plane:
// its patch table [(H+1)*(W+1), px*py*C] bf16, its features [B*S, C] bf16,
// its shape and the pack rows of its coordinates.
struct BlendPlane {
  const void* ptab;
  void* feats;
  int W, H, C, m0, m1;
};

struct BlendParams {
  int B, S, R, px, py, phase_major, na;
  BlendPlane plane[kMaxPatchAxes];
};

namespace {

using namespace shade_core;
using namespace patch_core;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kV = 4;          // consecutive samples of a ray per lane

// two floats as bf16 (round to nearest even), lo in the lower half
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The lane's samples: lane = p + R * qi holds samples s0 .. s0 + kV - 1
// of ray p of the coherent block of slot group t = item * (32 / R) + qi
// (slot groups j * (S / kV) + s0 / kV enumerate the chunk's coherent
// blocks and their runs of kV slots; item is the warp's index in the
// grid). Returns the index of its first sample in the pack's order
// (position * S + s0), or -1 past the chunk's last block.
template <int R>
__device__ __forceinline__ int first_sample(const BlendParams& q,
                                            int64_t item, int lane) {
  const int p = lane % R, G = q.S / kV, gshift = __ffs(G) - 1;
  const int J = q.B / R;
  const int64_t t = item * (32 / R) + lane / R;
  if (t >= (int64_t)J * G) return -1;
  const int j = (int)(t >> gshift), s0 = (int)(t & (G - 1)) * kV;
  return (q.phase_major ? p * J + j : j * R + p) * q.S + s0;
}

// The planes' channels: one plane of C0, or three of C0, C1, C2 (C1 > 0),
// whose coordinates are then pack rows (0, 1), (0, 2), (1, 2)
// (multi_core.cuh Mode). A lane's rows in the warp's tile: kV rows of
// each plane (V8 16-byte vectors), plane after plane, and one vector of
// pad (an odd stride: neither pass has bank conflicts).
template <int C0, int C1, int C2>
struct Planes {
  static constexpr int kNa = C1 > 0 ? 3 : 1;
  static constexpr int kOff1 = kV * C0 / 8, kOff2 = kOff1 + kV * C1 / 8;
  static constexpr int kStride = kOff2 + kV * C2 / 8 + 1;
};

// Plane `pl`'s kV rows of every lane, from the warp's tile (at `off` in
// each lane's rows) to sample `first` of that lane: consecutive lanes on
// consecutive 16-byte vectors (a run of 64 or 128 bytes, and the next
// lane's run of the same ray follows it wherever its slots continue the
// ray's samples).
template <int C, int kStride>
__device__ __forceinline__ void store_features(const BlendPlane& pl,
                                               int first, int lane,
                                               const uint4* tile, int off) {
  constexpr int V8 = kV * C / 8;
  uint4* feats = static_cast<uint4*>(pl.feats);
#pragma unroll
  for (int k = 0; k < V8; ++k) {
    const int o = k * 32 + lane;
    const int l = o / V8, w = o - l * V8;     // lane-row and its vector
    const int row = __shfl_sync(0xffffffffu, first, l);
    if (row >= 0) {
      feats[(int64_t)row * (C / 8) + w] = tile[l * kStride + off + w];
    }
  }
}

// One plane's feature of one sample, rounded to bf16 into `dst` (C / 8
// vectors): the anchor from the spans of its coordinates, the offsets and
// the taps.
template <int C>
__device__ __forceinline__ bool blend_sample(const BlendParams& q,
                                             const BlendPlane& pl,
                                             const Span& sx, const Span& sy,
                                             float x, float y, uint4* dst) {
  const SlotAnchor a = anchor_of(sx, sy, pl.W, pl.H, q.px, q.py);
  float feat[C];
  patch_taps<C>(static_cast<const uint4*>(pl.ptab) +
                           (int64_t)a.idx * (q.px * q.py * C / 8),
                       patch_offset(x, pl.W, a.x0),
                       patch_offset(y, pl.H, a.y0), q.px, q.py, feat);
#pragma unroll
  for (int k = 0; k < C / 8; ++k) {
    const float* f = feat + 8 * k;
    dst[k] = make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]),
                        bf16x2(f[4], f[5]), bf16x2(f[6], f[7]));
  }
  return a.viol;
}

template <int R, int C0, int C1, int C2>
__global__ void __launch_bounds__(kThreads)
    patch_blend_kernel(const float* __restrict__ pack,
                       int* __restrict__ viol,
                       const __grid_constant__ BlendParams q) {
  using Pl = Planes<C0, C1, C2>;
  __shared__ uint4 tiles[kWarps][32 * Pl::kStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int first = first_sample<R>(q, (int64_t)blockIdx.x * kWarps + warp,
                                    lane);
  const bool live = first >= 0;
  const int64_t N = (int64_t)q.B * q.S;

  // pack rows xn, yn, zn, dist of the lane's kV samples
  float P[4][kV];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 v = live ? __ldg(reinterpret_cast<const float4*>(
                                pack + r * N + first))
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    P[r][0] = v.x;
    P[r][1] = v.y;
    P[r][2] = v.z;
    P[r][3] = v.w;
  }
  uint4* mine = tiles[warp] + lane * Pl::kStride;
  int n = 0;   // the lane's violating slots (counted by lane p = 0)
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const float pk[4] = {P[0][i], P[1][i], P[2][i], P[3][i]};
    const bool valid = live && sample_valid(pk);
    const bool all_valid = __all_sync(0xffffffffu, valid || !live);
    bool bad;
    if constexpr (Pl::kNa == 1) {
      const BlendPlane& pl = q.plane[0];
      const float x = pick3(pk, pl.m0), y = pick3(pk, pl.m1);
      bad = blend_sample<C0>(q, pl, span<R>(x, valid, all_valid),
                             span<R>(y, valid, all_valid), x, y,
                             mine + i * (C0 / 8));
    } else {
      // each coordinate's span once for the planes (0, 1), (0, 2), (1, 2)
      const Span s0 = span<R>(pk[0], valid, all_valid);
      const Span s1 = span<R>(pk[1], valid, all_valid);
      const Span s2 = span<R>(pk[2], valid, all_valid);
      bad = blend_sample<C0>(q, q.plane[0], s0, s1, pk[0], pk[1],
                             mine + i * (C0 / 8));
      bad |= blend_sample<C1>(q, q.plane[1], s0, s2, pk[0], pk[2],
                              mine + Pl::kOff1 + i * (C1 / 8));
      bad |= blend_sample<C2>(q, q.plane[2], s1, s2, pk[1], pk[2],
                              mine + Pl::kOff2 + i * (C2 / 8));
    }
    n += (lane % R == 0 && live && bad) ? 1 : 0;
  }
  __syncwarp();
  const uint4* tile = tiles[warp];
  store_features<C0, Pl::kStride>(q.plane[0], first, lane, tile, 0);
  if constexpr (Pl::kNa == 3) {
    store_features<C1, Pl::kStride>(q.plane[1], first, lane, tile,
                                    Pl::kOff1);
    store_features<C2, Pl::kStride>(q.plane[2], first, lane, tile,
                                    Pl::kOff2);
  }
  // the witness: one atomic per warp with a violating slot
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0 && n) atomicAdd(viol, n);
}

template <int R, int C0, int C1, int C2>
cudaError_t launch(const float* pack, int* viol, const BlendParams& q,
                   cudaStream_t st) {
  const int64_t groups = (int64_t)(q.B / R) * (q.S / kV);
  const int64_t items = (groups + 32 / R - 1) / (32 / R);
  const unsigned blocks = (unsigned)((items + kWarps - 1) / kWarps);
  patch_blend_kernel<R, C0, C1, C2><<<blocks, kThreads, 0, st>>>(pack, viol,
                                                                  q);
  return cudaGetLastError();
}

template <int C0, int C1, int C2>
cudaError_t launch_r(const float* pack, int* viol, const BlendParams& q,
                     cudaStream_t st) {
  return q.R == 8 ? launch<8, C0, C1, C2>(pack, viol, q, st)
                  : launch<4, C0, C1, C2>(pack, viol, q, st);
}

// the built layouts: one plane of 8 or 16 channels, or PatchLayout's three
bool built(const BlendParams& q) {
  const int S = q.S;
  // sample indices in 32 bits
  if (S < kV || S > 64 || (S & (S - 1)) || (q.R != 4 && q.R != 8) ||
      q.B % q.R || q.px < 1 || q.py < 1 || q.B < 0 ||
      (int64_t)q.B * S >= (int64_t)1 << 31) {
    return false;
  }
  for (int a = 0; a < q.na; ++a) {
    const BlendPlane& pl = q.plane[a];
    if (pl.m0 < 0 || pl.m0 > 2 || pl.m1 < 0 || pl.m1 > 2) return false;
  }
  if (q.na == 1) return q.plane[0].C == 8 || q.plane[0].C == 16;
  const int m[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  for (int a = 0; a < 3; ++a) {
    if (q.plane[a].m0 != m[a][0] || q.plane[a].m1 != m[a][1]) return false;
  }
  return q.na == 3 && q.plane[0].C == 16 && q.plane[1].C == 8 &&
         q.plane[2].C == 8;
}

}  // namespace

extern "C" int patch_blend_launch(const float* pack, int* viol,
                                  const BlendParams* q, void* stream) {
  if (!built(*q)) return (int)cudaErrorInvalidValue;
  if (q->B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (q->na == 3) return (int)launch_r<16, 8, 8>(pack, viol, *q, st);
  return q->plane[0].C == 16 ? (int)launch_r<16, 0, 0>(pack, viol, *q, st)
                             : (int)launch_r<8, 0, 0>(pack, viol, *q, st);
}

extern "C" int blend_params_size() { return (int)sizeof(BlendParams); }
