// Pack-build kernel (K1): the prediction MLP and eval embedding tail of the
// z-plane chains in one kernel, from the encoded rays to the per-sample
// pack: the flagship's dynamic chain, and the static llff_z_plane chain
// (no flow stage; the mipnerf scene contraction).
//
// Replaces hyperreel_tpu/ops/pallas/pack_build.py:_pack_build_kernel with
// its in-kernel MLP (_mlp_rows, the HYPERREEL_PK_MLP route the JAX package
// takes by default) and _bitonic_sublane.
//
// Bound on the H100: the MLP's tensor-core work (about 0.8 MFLOP per ray,
// 1.04 at the neural_3d width), about two thirds of the kernel's time on
// an H100 80GB HBM3 at 700 W (prefetching weight fragments deeper does not
// shorten it); the tail is a few dozen flops per sample against 40 bytes
// of pack written. Design: a block of 16 warps takes 64 rays (32 under
// the f32 policy). Their activations never leave shared memory: two
// operand buffers (bf16 under the bench policy, f32 under the f32 policy)
// hold a layer's input and the next layer's, with the encoded rays parked
// in columns [xcol, xcol + cin) of both for the first and the skip layer,
// and `out` holds the f32 sums. A warp takes a 16-column strip of a layer
// for all the block's rays: WMMA m16n16k16 (bf16 operands, f32
// accumulation) with the weights [k, n] read as fragments from global
// memory, where the 0.8 MB of the flagship's weights stay in L2, the next
// k-step's fragment loaded while this one's products run (the f32 policy
// runs the strip as plain FMAs). The warp then adds the bias, applies the
// leaky relu and rounds the strip into the next layer's operand buffer at
// once, so one barrier per layer remains; the last layer stays f32 in
// `out`. Where the last layer is too wide for `out` at that many rays (64
// samples: 15 x 64 = 960 columns, 250 KB for 64 rays in bf16), the block
// takes half as many rays (32; 16 under the f32 policy), so each weight
// fragment feeds half as many products (chosen at launch from the widths;
// the flagship and llff_z_plane keep 64 / 32). The tail then runs one
// warp segment per ray: one lane per sample for S <= 32, and for S = 64 a
// whole warp with two samples per lane (samples 2l and 2l + 1 in lane l),
// reading its fields from `out` (columns field-major: the host permutes
// the last layer), sorting the distances with __shfl_xor_sync (at S = 64
// the j = 1 stages compare the lane's own pair, the others shuffle both
// values) and writing pack column r*S + s of each row, 128 contiguous
// bytes per warp (256 at S = 64). The mipnerf contraction
// (hyperreel_tpu/ops/contract.py inverse_contract_distance and
// contract_rows, the JAX kernel's :191-194 and :209-221) runs per sample
// in the JAX operation order, with __f*_rn intrinsics so that no
// multiply-add is fused where the JAX and plain versions round twice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

// field slots (PackParams.foff) and activation slots (PackParams.act)
enum PackField { F_Z, F_SIGMA, F_FLOW, F_PSIG, F_POFF, F_CS, F_CSH, F_N };
enum PackActSlot { A_Z, A_ISECT, A_SIGMA, A_FLOW, A_FLOW_STAGE, A_PSIG, A_POFF,
               A_PO_STAGE, A_CS, A_CSH, A_N };
constexpr int kPackMaxS = 64;
constexpr int kMaxLayers = 12;

// The C interface's types live at global scope: a signature naming a type
// of an unnamed namespace would give the extern "C" entry internal linkage.
struct PackAct {
  int kind;  // 0 identity, 1 sigmoid, 2 tanh
  float inner, outer, shift, w, start;
};

// One MLP layer: out[:, :n] = A[:, k0:k0 + k] @ w + b, then leaky relu
// when `act`. w is row-major [k, n] in the operand type, b f32 [n].
struct MlpLayer {
  const void* w;
  const float* b;
  int k0, k, n, act;
};

struct PackParams {
  int B, S, P;
  int cin, xcol, n_layers, bf16;
  float leaky;
  MlpLayer layer[kMaxLayers];
  int foff[F_N];  // channel offset of each field in the MLP row
  PackAct act[A_N];
  float samples[kPackMaxS];
  float z_scale[kPackMaxS];
  float aabb_lo[3];
  float aabb_inv[3];
  // scene contraction: 0 identity, 1 mipnerf; contract_samples: the
  // anchors live in contracted space (z -> inverse_contract_distance(z))
  int contract, contract_samples;
  float c_start_r, c_inv_end_r, c_r_scale, c_start_d, c_inv_end_d, c_d_scale;
};

namespace {

using namespace nvcuda;

constexpr int kPackRows = 10;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 16;      // output columns per warp task
constexpr size_t kMaxSmem = 227 * 1024;

// rays per block: the operand buffers and the f32 sums of a block's rays
// fit shared memory at 64 rays in bf16 and 32 in f32 up to the flagship's
// and llff_z_plane's widths; a wider last layer halves them (plan)
template <typename T>
constexpr int kRaysOf = std::is_same_v<T, __nv_bfloat16> ? 64 : 32;

__device__ __forceinline__ float apply_act(const PackAct& a, float x) {
  float u = x * a.inner + a.shift;
  float f;
  if (a.kind == 1) {
    f = 1.0f / (1.0f + expf(-u));
  } else if (a.kind == 2) {
    f = tanhf(u);
  } else {
    f = u;
  }
  f = f * a.outer;
  return a.w * f + (1.0f - a.w) * a.start;
}

// mipnerf inverse_contract_distance with the identity distance activation:
// contracted distance in [-2, 2] -> metric distance
__device__ __forceinline__ float inverse_contract_distance(
    float d, const PackParams& p) {
  float x = __fmul_rn(__fdiv_rn(d, 2.0f), 2.0f);
  x = fminf(fmaxf(x, -2.0f), 2.0f);
  const float t = __fsub_rn(2.0f, fabsf(x));
  const float inv = __fadd_rn(__fdiv_rn(t, p.c_d_scale), p.c_inv_end_d);
  const float r =
      fabsf(x) < 1.0f ? x : (x > 0.0f ? 1.0f : -1.0f) * __fdiv_rn(1.0f, inv);
  return __fmul_rn(r, p.c_start_d);
}

// mipnerf contract_rows: the point scaled onto the radius-2 ball (inside
// the unit ball it stays)
__device__ __forceinline__ void contract_rows(float* v, const PackParams& p) {
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(v[c], p.c_start_r);
  const float sq = __fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]),
                                       __fmul_rn(v[1], v[1])),
                             __fmul_rn(v[2], v[2]));
  const float dist = __fsqrt_rn(fmaxf(sq, 1e-24f));
  const float inv = __fdiv_rn(1.0f, fmaxf(dist, 1e-12f));
  const float t = __fmul_rn(__fsub_rn(inv, p.c_inv_end_r), p.c_r_scale);
  const float scale =
      dist < 1.0f ? 1.0f : __fdiv_rn(__fsub_rn(2.0f, t), fmaxf(dist, 1e-12f));
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fmul_rn(v[c], scale);
}

// out[:, c0:c0 + 16] = A[:, L.k0:L.k0 + L.k] @ w[:, c0:c0 + 16] for all R
// rows, on the tensor cores; the next k-step's weight fragment is loaded
// while this one's products run.
template <int R>
__device__ void strip_mma(const __nv_bfloat16* A, int lda, const MlpLayer& L,
                          int c0, float* out, int lds) {
  constexpr int RT = R / 16;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(L.w) + c0;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) wmma::fill_fragment(acc[rt], 0.0f);
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      b, b_next;
  wmma::load_matrix_sync(b, w, L.n);
  for (int kk = 0; kk < L.k; kk += 16) {
    if (kk + 16 < L.k) {
      wmma::load_matrix_sync(b_next, w + (int64_t)(kk + 16) * L.n, L.n);
    }
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, A + rt * 16 * lda + L.k0 + kk, lda);
      wmma::mma_sync(acc[rt], a, b, acc[rt]);
    }
    b = b_next;
  }
#pragma unroll
  for (int rt = 0; rt < RT; ++rt) {
    wmma::store_matrix_sync(out + rt * 16 * lds + c0, acc[rt], lds,
                            wmma::mem_row_major);
  }
}

// the same strip in f32 FMAs (the f32 policy): lane -> column c0 + lane %
// 16, rows lane / 16, + 2, ...
template <int R>
__device__ void strip_fma(const float* A, int lda, const MlpLayer& L, int c0,
                          float* out, int lds) {
  const int lane = threadIdx.x % 32;
  const int c = c0 + lane % kStrip;
  const float* w = static_cast<const float*>(L.w) + c;
  for (int r = lane / kStrip; r < R; r += 32 / kStrip) {
    const float* a = A + r * lda + L.k0;
    float s = 0.0f;
    for (int kk = 0; kk < L.k; ++kk) s += a[kk] * __ldg(w + (int64_t)kk * L.n);
    out[r * lds + c] = s;
  }
}

__device__ __forceinline__ void store_operand(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_operand(float* p, float v) { *p = v; }

// The tail of this lane's SPL samples of ray r: lane l of the ray's warp
// segment holds samples SPL*l + j, j < SPL (SPL = 1 for S <= 32, 2 for
// S = 64); `row` is the ray's f32 MLP output in `out`. z, the distance,
// the ascending values-only sort over the ray's S samples, the points
// and the pack. Every lane of the warp must call it (the sort shuffles);
// a lane past B (live = false) runs on with the last ray's data and
// stores nothing.
template <int SPL>
__device__ __forceinline__ void tail(const PackParams& p,
                                     const float* row, const float* ray,
                                     int64_t r, bool live, int l,
                                     float* __restrict__ pack) {
  const int S = p.S;
  const int64_t N = (int64_t)p.B * S;
  const float o[3] = {__ldg(ray + 0), __ldg(ray + 1), __ldg(ray + 2)};
  const float d[3] = {__ldg(ray + 3), __ldg(ray + 4), __ldg(ray + 5)};
  const float dt = __ldg(ray + 6);

  // z processing (intersect.py z_plane): act(z) * (1 - sigma)
  float dist[SPL];
#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = SPL * l + j;
    auto field = [&](int f, int c) { return row[(p.foff[f] + c) * S + s]; };
    float z = apply_act(p.act[A_ISECT], apply_act(p.act[A_Z], field(F_Z, 0)));
    z = z * (1.0f - apply_act(p.act[A_SIGMA], field(F_SIGMA, 0)));
    z = z * p.z_scale[s] + p.samples[s];
    if (p.contract_samples) z = inverse_contract_distance(z, p);
    const float dz = fabsf(d[2]) < 1e-5f ? 1e12f : d[2];
    dist[j] = (z - o[2]) / dz;
    if (dist[j] <= 0.0f) dist[j] = 0.0f;
  }

  // values-only ascending bitonic sort over the ray's S samples
  if constexpr (SPL == 1) {
    const int s = l;
    for (int k = 2; k <= S; k <<= 1) {
      for (int j = k >> 1; j >= 1; j >>= 1) {
        const float partner = __shfl_xor_sync(0xffffffffu, dist[0], j);
        const bool lo_half = (s & j) == 0;
        const bool take_min = ((s & k) == 0) == lo_half;
        dist[0] = take_min ? fminf(dist[0], partner) : fmaxf(dist[0], partner);
      }
    }
  } else {
    // S = 64 over a whole warp: the stage j = 1 compares the lane's own
    // pair (positions 2l, 2l + 1); a stage j >= 2 pairs position 2l + i
    // with 2(l ^ j/2) + i, the same register of lane l ^ j/2
    static_assert(SPL == 2, "two samples per lane");
    for (int k = 2; k <= 64; k <<= 1) {
      const bool asc = ((2 * l) & k) == 0;
      for (int j = k >> 1; j >= 2; j >>= 1) {
        const int m = j >> 1;
        const bool take_min = asc == ((l & m) == 0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float partner = __shfl_xor_sync(0xffffffffu, dist[i], m);
          dist[i] = take_min ? fminf(dist[i], partner)
                             : fmaxf(dist[i], partner);
        }
      }
      const float lo = fminf(dist[0], dist[1]), hi = fmaxf(dist[0], dist[1]);
      dist[0] = asc ? lo : hi;
      dist[1] = asc ? hi : lo;
    }
  }

#pragma unroll
  for (int j = 0; j < SPL; ++j) {
    const int s = SPL * l + j;
    auto field = [&](int f, int c) { return row[(p.foff[f] + c) * S + s]; };
    // points; flow / offset / colour fields stay in prediction order
    float base[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) base[c] = o[c] + d[c] * dist[j];
    if (p.contract) {
      // contract the point and measure its distance from the contracted
      // origin (hyperreel_tpu/ops/pallas/pack_build.py:209-221)
      float oc[3] = {o[0], o[1], o[2]};
      contract_rows(base, p);
      contract_rows(oc, p);
      float sq = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float e = __fsub_rn(base[c], oc[c]);
        sq = c == 0 ? __fmul_rn(e, e) : __fadd_rn(sq, __fmul_rn(e, e));
      }
      dist[j] = dist[j] <= 0.0f ? 0.0f : __fsqrt_rn(fmaxf(sq, 1e-24f));
    }
    const float po_fac = 1.0f - apply_act(p.act[A_PSIG], field(F_PSIG, 0));
    float vals[kPackRows];
    for (int c = 0; c < 3; ++c) {
      float v = base[c];
      if (p.foff[F_FLOW] >= 0) {
        v = v + apply_act(p.act[A_FLOW_STAGE],
                          apply_act(p.act[A_FLOW], field(F_FLOW, c))) * dt;
      }
      v = v + apply_act(p.act[A_PO_STAGE],
                        apply_act(p.act[A_POFF], field(F_POFF, c))) * po_fac;
      vals[c] = (v - p.aabb_lo[c]) * p.aabb_inv[c] - 1.0f;
      vals[4 + c] = apply_act(p.act[A_CS], field(F_CS, c));
      vals[7 + c] = apply_act(p.act[A_CSH], field(F_CSH, c));
    }
    vals[3] = dist[j];
    if (live) {
      const int64_t g = r * S + s;
#pragma unroll
      for (int i = 0; i < kPackRows; ++i) pack[(int64_t)i * N + g] = vals[i];
    }
  }
}

// R rays per block (a multiple of 16: WMMA row tiles)
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
pack_build_kernel(const float* __restrict__ x0, const float* __restrict__ rays,
                  float* __restrict__ pack, const __grid_constant__ PackParams p,
                  int lda, int lds) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* bufs[2] = {reinterpret_cast<T*>(smem),
                reinterpret_cast<T*>(smem) + (size_t)R * lda};
  float* out =
      reinterpret_cast<float*>(smem + 2 * (size_t)R * lda * sizeof(T));
  const int64_t r0 = (int64_t)blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // ---- the encoded rays (zero columns up to the first layer's k, zero
  // rows past B), in both operand buffers: the first and the skip layer
  // read them, and no hidden layer's output reaches their columns
  const int kin = p.layer[0].k;
  for (int i = tid; i < R * kin; i += kThreads) {
    const int r = i / kin, c = i % kin;
    const int64_t gr = r0 + r;
    const float v = (c < p.cin && gr < p.B) ? __ldg(x0 + gr * p.cin + c) : 0.0f;
    store_operand(bufs[0] + r * lda + p.xcol + c, v);
    store_operand(bufs[1] + r * lda + p.xcol + c, v);
  }
  __syncthreads();

  // ---- the MLP: layer l reads buffer l % 2 and writes the other, so a
  // warp finishes each 16-column strip (products, bias, leaky relu, the
  // rounding to the next operand) while other warps still read the input
  for (int l = 0; l < p.n_layers; ++l) {
    const MlpLayer& L = p.layer[l];
    const T* in = bufs[l & 1];
    T* next = bufs[(l + 1) & 1];
    const bool last = l == p.n_layers - 1;
    for (int c0 = warp * kStrip; c0 < L.n; c0 += kWarps * kStrip) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        strip_mma<R>(in, lda, L, c0, out, lds);
      } else {
        strip_fma<R>(in, lda, L, c0, out, lds);
      }
      __syncwarp();
      const int c = c0 + lane % kStrip;
      const float b = __ldg(L.b + c);
      for (int r = lane / kStrip; r < R; r += 32 / kStrip) {
        float v = out[r * lds + c] + b;
        if (L.act && v < 0.0f) v *= p.leaky;
        if (last) {
          out[r * lds + c] = v;
        } else {
          store_operand(next + r * lda + c, v);
        }
      }
    }
    __syncthreads();
  }

  // ---- the tail: one warp segment per ray, S lanes (S <= 32) or the
  // whole warp with two samples per lane (S = 64). R * lanes and kThreads
  // are multiples of 32, so a warp enters and leaves the loop as a whole.
  const int S = p.S;
  const int lanes = S < 32 ? S : 32;
  for (int i = tid; i < R * lanes; i += kThreads) {
    const int rl = i / lanes, l = i % lanes;
    const int64_t r = r0 + rl;
    const bool live = r < p.B;
    // rows past B run on (with the last ray's data) so that every lane
    // takes part in the shuffles; they store nothing
    const float* ray = rays + (live ? r : (int64_t)p.B - 1) * 8;
    if (S <= 32) {
      tail<1>(p, out + rl * lds, ray, r, live, l, pack);
    } else {
      tail<2>(p, out + rl * lds, ray, r, live, l, pack);
    }
  }
}

// The launch plan for p's widths: the operand and `out` row strides
// (padded against bank conflicts: operand rows 8 elements past a multiple
// of 16, `out` rows 16 floats past a multiple of 32), the rays per block
// (kRaysOf, or half as many where those do not fit shared memory) and the
// shared memory; R = 0 where p is not a valid layout or nothing fits.
struct Plan {
  int lda, lds, R;
  size_t smem;
};

Plan plan(const PackParams& p) {
  Plan pl{0, 0, 0, 0};
  const int S = p.S;
  if (S < 1 || S > kPackMaxS || (S & (S - 1)) || p.n_layers < 1 ||
      p.n_layers > kMaxLayers) {
    return pl;
  }
  // the operand buffers' width covers every layer's input columns; `out`
  // every layer's n. Hidden outputs stay left of the encoded rays.
  int cols = 0, width = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const MlpLayer& L = p.layer[l];
    if (L.k < 16 || L.k % 16 || L.n < kStrip || L.n % kStrip || L.k0 % 16 ||
        (l + 1 < p.n_layers && L.n > p.xcol)) {
      return pl;
    }
    cols = L.k0 + L.k > cols ? L.k0 + L.k : cols;
    width = L.n > width ? L.n : width;
  }
  if (p.P * S > p.layer[p.n_layers - 1].n) return pl;
  pl.lda = cols + 8;
  pl.lds = (width + 31) / 32 * 32 + 16;
  const size_t esize = p.bf16 ? 2 : 4;
  const int full = p.bf16 ? kRaysOf<__nv_bfloat16> : kRaysOf<float>;
  for (int R = full; R >= full / 2; R /= 2) {
    const size_t smem =
        2 * (size_t)R * pl.lda * esize + (size_t)R * pl.lds * 4;
    if (smem <= kMaxSmem && R * (S < 32 ? S : 32) % 32 == 0) {
      pl.R = R;
      pl.smem = smem;
      break;
    }
  }
  return pl;
}

template <typename T, int R>
cudaError_t launch(const float* x0, const float* rays, float* pack,
                   const PackParams& p, const Plan& pl, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      pack_build_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((p.B + R - 1) / R);
  pack_build_kernel<T, R><<<blocks, kThreads, pl.smem, st>>>(
      x0, rays, pack, p, pl.lda, pl.lds);
  return cudaGetLastError();
}

}  // namespace

extern "C" int pack_build_launch(const float* x0, const float* rays,
                                 float* pack, const PackParams* p,
                                 void* stream) {
  const Plan pl = plan(*p);
  if (pl.R == 0) return (int)cudaErrorInvalidValue;
  if (p->B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (p->bf16) {
    return pl.R == 64
        ? (int)launch<__nv_bfloat16, 64>(x0, rays, pack, *p, pl, st)
        : (int)launch<__nv_bfloat16, 32>(x0, rays, pack, *p, pl, st);
  }
  return pl.R == 32 ? (int)launch<float, 32>(x0, rays, pack, *p, pl, st)
                    : (int)launch<float, 16>(x0, rays, pack, *p, pl, st);
}

// The rays per block that pack_build_launch takes for p (0: p is refused)
extern "C" int pack_rays_per_block(const PackParams* p) {
  return plan(*p).R;
}

extern "C" int pack_params_size() { return (int)sizeof(PackParams); }
