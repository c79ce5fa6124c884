// Pack-build kernels (K1): the prediction MLP and eval embedding tail of the
// z-plane chains in one kernel, from the encoded rays to the per-sample
// pack: the flagship's dynamic chain, the static llff_z_plane chain (no
// flow stage; the mipnerf scene contraction) and neural_3d_z_plane's (flow
// and contraction, 64 samples).
//
// Replaces hyperreel_tpu/ops/pallas/pack_build.py:_pack_build_kernel with
// its in-kernel MLP (_mlp_rows, the HYPERREEL_PK_MLP route the JAX package
// takes by default) and _bitonic_sublane.
//
// Bound on the H100 by the MLP's tensor-core work: 0.8 MFLOP per ray (1.04
// at the neural_3d width) against a tail of a few dozen flops and 40 bytes
// of pack per sample. Design of the bf16-policy kernel (pack_build_wgmma):
// - Products on wgmma (m64nNk16, bf16 operands from shared memory, f32
//   accumulators in registers). A persistent block (one per SM) loops over
//   tiles of 128 rays; each of its two warpgroups owns 64 rays of the
//   tile. A hidden layer runs in two 128-column blocks (hidden_layers): a
//   block's 64 accumulator registers are all that is live, where a whole
//   256-column layer's 128 made ptxas spill.
// - The A operand (a warpgroup's activations, bf16) lives in shared memory
//   in the wgmma canonical K-major layout without swizzle (desc_a):
//   K-chunks of 64 columns, the encoded rays in the chunk after the hidden
//   ones for the first and the skip layer. Each block's epilogue (bias,
//   leaky relu, rounding to bf16) runs on the accumulators in registers and
//   stores them once, as the next layer's A, into the rows the same warp's
//   products depended on. Kept in registers (as FlashAttention-3 feeds P)
//   the A fragments would hold 64 registers through the whole last layer
//   and force every k-step's product to be unrolled; from shared memory the
//   products run as rolled loops over descriptors, which keeps the build
//   under a minute.
// - The weights are staged in shared memory by TMA: cp.async.bulk.tensor
//   loads of weight slabs (K = 64 rows x N <= 128 columns, 128-byte
//   swizzle) through a ring of 16 KB stages on mbarriers, as many as the
//   block's shared memory holds (5 at S = 64, 7 at S <= 32): the ring's
//   depth is what keeps the products fed, a slab's TMA round trip from L2
//   lasting several slabs' products. The second of the two warpgroups to
//   release a slab refills its stage, so the block needs no producer warps
//   and keeps 255 registers a thread (with a producer warpgroup ptxas held
//   every thread to 168 and spilled). Each slab feeds both warpgroups, so
//   the weights are read from L2 once per 128 rays (not once per 64 rays
//   and per warp as with WMMA fragments). The host (mlp_tables) lays the
//   slabs out in the order the kernel consumes them, once per checkpoint,
//   and passes that order with them (PackParams.slab_rows, strip_fc); the
//   launch plan refuses a layout whose slabs or strips differ from what
//   this kernel consumes (pack_build.cu plan_wgmma). TMA applies the
//   swizzle.
// - The last layer is drained in strips (the kernel's column order,
//   strip_desc: z and sigma, point sigma, the six point channels per group
//   of 16 samples, then each colour component), so no [R, P*S] f32 buffer
//   exists and the ray tile does not depend on P*S. z and sigma give the
//   distances in the accumulator layout; the values-only sort runs on a
//   warp segment per ray (one lane per sample, two at S = 64) over a [64,
//   S] buffer in shared memory, which then keeps the sorted distances;
//   point sigma gives the offsets' factor in a second [64, S] buffer; a
//   point strip holds all six point channels of its samples, so each
//   sample's (contracted) base point and distance are computed once, from
//   its sorted distance; they and the colour strips are consumed
//   elementwise in the accumulator layout and written to the pack. A
//   strip's accumulators start from its bias (strip_bias), loaded before
//   its products, so that the tail reads no bias.
// - The two warpgroups share the weight ring but not their barriers (named
//   barriers per warpgroup), and issue their products as they come: the
//   tail is two to three times as long as the products, so the tensor
//   cores idle through much of it whatever the order. Turns on the tensor
//   cores (FlashAttention-3's ping-pong: one warpgroup's product block
//   after the other's, so that one's tail runs under the other's products)
//   were measured 3-7 % slower and are not used (PERF.md).
// - Chains without a flow stage keep zero flow columns in the point
//   strips (6 % more last-layer products for llff_z_plane): a strip's
//   width is a compile-time accumulator size, so dropping them would need
//   a second instantiation of the kernel per sample count, and the build
//   time with it.
// - The render-time sample counts (first-k compaction with the far
//   sentinel, the positional stride; PackParams k, stride, far) are run-time
//   parameters of the tail, not template instances: the MLP still computes
//   all S x P columns and the sort runs over all S distances (the far
//   sentinel sorts an invalid sample last); the point and colour strips
//   skip the samples the pack does not keep (kept_sample): sample s = j *
//   stride goes to column j. The sort carries no payload, so the kept
//   sorted position s pairs with prediction row s, as in the JAX kernel.
//   Those strips are compiled twice, for all S kept (the full routes'
//   code: one 8-byte store per two samples) and for k < S, and a uniform
//   branch on k picks one per strip. The second copy costs the full
//   routes' K1 1.4-2.2 %; one copy for both cost them 5-8 % (PERF.md).
// - The activations (PackAct: the host folds an ease_value's or an
//   interp_value's schedule into the coefficients of at most two
//   elementwise functions) come in two instantiations, chosen at the launch
//   (PackParams.generic). The default one is the code above: a
//   piecewise-linear layer activation (the leaky relu; its slope below 0
//   a parameter, so identity, relu and abs too) and field activations of
//   one identity, sigmoid or tanh each, inlined where they are used. The generic one takes any
//   layer and field activation (pack_build_gen_s<S>.cu): the accumulators
//   of each hidden block and of each strip pass through a per-thread
//   staging buffer in shared memory (act_staged, 16 KB per warpgroup, two
//   ring stages fewer), where a loop applies the activations; inlined at
//   every accumulator instead, their code made the kernel five times
//   slower and its build take minutes (PERF.md). The piecewise-linear
//   layer activation stays inline in both.
// - The encoded rays take kXCols-column steps of A and of the first and
//   the skip layer's slabs, whole 64-column chunks and a half one, up to
//   kMaxXCols columns (mma_x); A grows with them and the ring takes what
//   shared memory is left.
// The f32-policy kernel (pack_build_f32, the 1e-5 check against the plain
// version) runs its layers as plain f32 FMAs over operand buffers in shared
// memory, 64 rays per block, and its last layer through the same strip
// drain: the FMA strips produce the wgmma accumulator layout, so one set of
// tail functions serves both. It comes in both instantiations too: the
// generic one applies a layer activation by a rolled pass over the layer's
// output buffer and stages the field activations in the operand buffer
// that the last layer does not read (so it takes the default one's
// widths). The tail runs in
// the JAX operation order, with __f*_rn intrinsics in the mipnerf contraction
// (hyperreel_tpu/ops/contract.py inverse_contract_distance and
// contract_rows, the JAX kernel's :191-194 and :209-221) so that no
// multiply-add is fused where the JAX and plain versions round twice.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma.cuh"

// field slots (PackParams.foff) and activation slots (PackParams.act)
enum PackField { F_Z, F_SIGMA, F_FLOW, F_PSIG, F_POFF, F_CS, F_CSH, F_N };
enum PackActSlot { A_Z, A_ISECT, A_SIGMA, A_FLOW, A_FLOW_STAGE, A_PSIG, A_POFF,
               A_PO_STAGE, A_CS, A_CSH, A_N };
constexpr int kPackMaxS = 64;
constexpr int kMaxLayers = 12;
constexpr int kMaxSlabs = 96;
constexpr int kMaxStrips = 2 + 4 + 6;   // S = 64: four point strips
constexpr int kStripChannels = 6;

// The C interface's types live at global scope: a signature naming a type
// of an unnamed namespace would give the extern "C" entry internal linkage.

// the elementwise activation kinds (models/activations.py KINDS); kinds
// below kBasicKinds run in the default instantiation
enum ActKind {
  K_IDENTITY, K_SIGMOID, K_TANH, K_SOFTPLUS, K_RELU, K_LEAKY, K_ABS, K_ZERO,
  K_IDENTITY_TANH, K_POWER, K_GAUSSIAN
};
constexpr int kBasicKinds = 3;
constexpr int kActLeaves = 2;

// f(x) = g_kind(x * inner + shift) * outer, `a` the kind's parameter
// (leaky slope, identity_tanh fac, power exponent, gaussian sigma)
struct ActLeaf {
  int kind;
  float inner, outer, shift, a;
};

// An activation as K1 evaluates it: c0 + sum over its n leaves of c[i] *
// f_i(x). The host folds ease_value's and interp_value's schedules at the
// launch's iteration into the coefficients (models/activations.py
// kernel_terms).
struct PackAct {
  int n;
  float c0, c[kActLeaves];
  ActLeaf f[kActLeaves];
};

// One MLP layer: out[:, :n] = A[:, k0:k0 + k] @ w + b, then the layer
// activation when `act`. w is row-major [k, n] in the operand type, b f32
// [n]; the last layer's columns are field-major, at PackParams.foff.
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
  // the bf16 kernel's weights: every slab of a tile's sequence, bf16 rows
  // of 64 (SlabPlan), as the host laid them out: the rows (N) of each
  // slab; each strip's channels (4 field + component, -1 past the strip's
  // channels) and samples (s0, ns). The plan checks them against its own.
  const void* wt;
  int wt_rows;
  int n_slabs;
  int slab_rows[kMaxSlabs];
  int n_strips;
  int strip_fc[kMaxStrips][kStripChannels];
  int strip_s[kMaxStrips][2];
  // the samples the pack keeps (hyperreel_tpu/ops/pallas/pack_build.py
  // :161-175, :198-207): k of the S, sorted position and prediction row
  // s = j * stride for j < k (stride 1: first-k compaction, or all S when
  // k = S); `far` is the distance of an invalid sample before the sort (0,
  // or the far sentinel 1e9 of invalid_sort_far chains)
  int k, stride;
  float far;
  // the layer activation: lact, or where lpl is 1 the piecewise-linear
  // function v >= 0 ? v : v * leaky (identity, relu, leaky relu, abs);
  // the default instantiation (generic 0) takes such a layer activation
  // and field activations of the kinds below kBasicKinds with one leaf,
  // the generic one (1) any
  PackAct lact;
  int generic, lpl;
};


constexpr int kWgThreads = 128;
constexpr int kWgRays = 64;                        // a wgmma row tile
constexpr int kConsumers = 2;
constexpr int kTileRays = kConsumers * kWgRays;    // 128
constexpr int kThreadsWg = kConsumers * kWgThreads;
constexpr int kChunkK = 64;          // K columns of a slab or A chunk:
                                     // one 128-byte swizzle row of bf16
constexpr int kChunkBytes = kWgRays * kChunkK * 2;         // 8 KB
constexpr int kXCols = 32;           // the encoded rays' column step (k of
                                     // layer 0 and the skip layer's input
                                     // are whole steps of it)
constexpr int kMaxXCols = 128;       // the most encoded columns (two chunks)
constexpr int kHiddenBlock = 128;    // hidden-layer columns per product
constexpr int kStageRows = 128;      // the widest slab: a hidden block,
                                     // or z and sigma at S = 64
constexpr int kStageBytes = kStageRows * kChunkK * 2;      // 16 KB
// A of one warpgroup: H / 64 chunks of hidden columns, then the encoded
// rays' xk columns (whole chunks and a half one where xk % 64 = 32)
__host__ __device__ constexpr int a_bytes(int H, int xk) {
  return (H / kChunkK + xk / kChunkK) * kChunkBytes +
         (xk % kChunkK ? kWgRays * kXCols * 2 : 0);
}
// the encoded columns the kernels multiply: layer 0's k rounded up to a
// whole step of kXCols (the rows past k are zero in A and in the slabs)
__host__ __device__ constexpr int x_cols(int k) {
  return (k + kXCols - 1) / kXCols * kXCols;
}
constexpr int kBoxRows = 32;         // TMA box: 32 rows x 64 bf16
constexpr int kMaxStages = 8;
constexpr size_t kMaxSmem = 232448;  // 227 KB

// per-warpgroup tail buffers [64, S]: the distances (sorted in place) and
// the offsets' factor, rows S + 8 floats apart against bank conflicts;
// during the hidden layers the scratch of their first column blocks
template <int S>
constexpr int kRowF = S + 8;
__host__ __device__ constexpr int tail_floats(int S) {
  return 2 * kWgRays * (S + 8) > (256 - kHiddenBlock) * kWgRays / 2
             ? 2 * kWgRays * (S + 8)
             : (256 - kHiddenBlock) * kWgRays / 2;
}

__host__ __device__ constexpr int strip_width(int channels, int S) {
  return (channels * S + 31) / 32 * 32;
}

// The last layer's strips in the kernel's order: z and sigma; point
// sigma; per group of point_group(S) samples the six point channels (flow
// xyz, offset xyz), so that a thread holds every point channel of its
// samples and computes each sample's base point once; then each component
// of colour scale and colour shift. A strip takes samples [s0, s0 + ns)
// of each of its nch channels, channel-major; its width is rounded up to
// whole 32-row TMA boxes. A chain without a flow stage keeps the flow
// channels as zero columns. mlp_tables (ops/kernels/pack_build.py
// kernel_strips) lays the slabs out in this order and passes it with them
// (PackParams.strip_fc, strip_s), and the plan checks the two agree.
struct StripDesc {
  int nch, s0, ns;
};

__host__ __device__ constexpr int point_group(int S) { return S < 16 ? S : 16; }
__host__ __device__ constexpr int point_strips(int S) {
  return S / point_group(S);
}
__host__ __device__ constexpr int n_strips(int S) {
  return 2 + point_strips(S) + 6;
}

__host__ __device__ constexpr StripDesc strip_desc(int q, int S) {
  return q == 0 ? StripDesc{2, 0, S}
         : q == 1 ? StripDesc{1, 0, S}
         : q < 2 + point_strips(S)
             ? StripDesc{6, (q - 2) * point_group(S), point_group(S)}
             : StripDesc{1, 0, S};
}

// channel j of strip q: field *f, component *c (false past the strip's
// channels)
__host__ __device__ __forceinline__ bool strip_channel(int q, int j, int S,
                                                       int* f, int* c) {
  if (j >= strip_desc(q, S).nch) return false;
  const int np = point_strips(S);
  if (q == 0) {
    *f = j == 0 ? F_Z : F_SIGMA;
    *c = 0;
  } else if (q == 1) {
    *f = F_PSIG;
    *c = 0;
  } else if (q < 2 + np) {
    *f = j < 3 ? F_FLOW : F_POFF;
    *c = j % 3;
  } else {
    *f = q - 2 - np < 3 ? F_CS : F_CSH;
    *c = (q - 2 - np) % 3;
  }
  return true;
}

// column n of strip q -> the last layer's field-major column (-1: a pad
// column, or a field the chain lacks)
__host__ __device__ __forceinline__ int strip_column(const int* foff, int q,
                                                     int n, int S) {
  const StripDesc d = strip_desc(q, S);
  int f, c;
  return strip_channel(q, n / d.ns, S, &f, &c) && foff[f] >= 0
             ? (foff[f] + c) * S + d.s0 + n % d.ns
             : -1;
}

// The weight slabs of one tile, in the order the consumers take them
// (mlp_tables lays out the same sequence): per hidden layer H/64 slabs of
// its hidden rows and one of its encoded-ray rows where it reads them; per
// strip of the last layer H/64 slabs of the strip's width.
struct SlabPlan {
  int n;                 // slabs per tile
  int stages;            // ring stages
  int a_bytes;           // a warpgroup's A (a_bytes)
  int rows[kMaxSlabs];   // N of each slab (its rows in the weight tensor)
  int row0[kMaxSlabs];   // its first row
};

// The launch plan of one PackParams (pack_build.cu plan)
struct K1Plan {
  int R;            // rays per block (0: p is refused)
  int lda;          // f32 kernel: operand row stride
  size_t smem;
  SlabPlan slabs;   // bf16 kernel
};

// One sample count's launcher (the bf16 and the f32 kernel), each compiled
// in its own pack_build_s<S>.cu so that the sample counts build in
// parallel.
// The default instantiations (k1_launch_s<S>) and the generic ones
// (k1_launch_gen_s<S>), each of the bf16 and the f32 kernel, are separate
// sources too.
#define K1_LAUNCHERS(X) X(8) X(16) X(32) X(64)
#define K1_DECLARE(S)                                                    \
  cudaError_t k1_launch_s##S(const float* x0, const float* rays,         \
                             float* pack, const PackParams& p,          \
                             const K1Plan& pl, const CUtensorMap& map,  \
                             cudaStream_t st);                          \
  cudaError_t k1_launch_gen_s##S(const float* x0, const float* rays,     \
                                 float* pack, const PackParams& p,      \
                                 const K1Plan& pl,                      \
                                 const CUtensorMap& map, cudaStream_t st);
K1_LAUNCHERS(K1_DECLARE)

namespace {

// an activation of the default instantiation: one leaf of kind identity,
// sigmoid or tanh (PackParams.generic is 0)
__device__ __forceinline__ float apply_act(const PackAct& a, float x) {
  const ActLeaf& l = a.f[0];
  float u = x * l.inner + l.shift;
  float f;
  if (l.kind == K_SIGMOID) {
    f = 1.0f / (1.0f + expf(-u));
  } else if (l.kind == K_TANH) {
    f = tanhf(u);
  } else {
    f = u;
  }
  f = f * l.outer;
  return a.c[0] * f + a.c0;
}

// one leaf of the generic instantiation, of kind K, in the JAX closures'
// operations (models/activations.py leaf_value, the plain version's).
// Accurate functions: under the bf16 policy an error of a few f32 ulps
// already moves hidden values across bf16 rounding boundaries that the
// plain version does not cross.
template <int K>
__device__ __forceinline__ float leaf_k(const ActLeaf& l, float x) {
  const float u = x * l.inner + l.shift;
  float f;
  if constexpr (K == K_SIGMOID) {
    f = 1.0f / (1.0f + expf(-u));
  } else if constexpr (K == K_TANH) {
    f = tanhf(u);
  } else if constexpr (K == K_IDENTITY_TANH) {
    // the identity below the edge, 2 tanh above, times fac / 2 (JAX
    // activations.py:70-77; u = 2x)
    f = (fabsf(u) < 1.91501f ? u : tanhf(u) * 2.0f) * l.a * 0.5f;
  } else if constexpr (K == K_SOFTPLUS) {  // logaddexp(u, 0)
    f = fmaxf(u, 0.0f) + log1pf(expf(-fabsf(u)));
  } else if constexpr (K == K_RELU) {
    f = fmaxf(u, 0.0f);
  } else if constexpr (K == K_LEAKY) {
    f = u >= 0.0f ? u : l.a * u;
  } else if constexpr (K == K_ABS) {
    f = fabsf(u);
  } else if constexpr (K == K_ZERO) {
    f = 0.0f;
  } else if constexpr (K == K_POWER) {  // sign(u) (|u| + 1e-8)^a
    const float m = powf(fabsf(u) + 1e-8f, l.a);
    f = u > 0.0f ? m : (u < 0.0f ? -m : 0.0f);
  } else if constexpr (K == K_GAUSSIAN) {
    const float t = u / l.a;
    f = expf(-0.5f * (t * t));
  } else {
    f = u;
  }
  return f * l.outer;
}

// the kind-K function of a kind known only at run time, for each kind
#define ACT_KINDS(X)                                                    \
  X(K_IDENTITY) X(K_SIGMOID) X(K_TANH) X(K_SOFTPLUS) X(K_RELU) X(K_LEAKY) \
  X(K_ABS) X(K_ZERO) X(K_IDENTITY_TANH) X(K_POWER) X(K_GAUSSIAN)

__device__ __forceinline__ float act_leaf(const ActLeaf& l, float x) {
  switch (l.kind) {
#define ACT_CASE(K) \
  case K:           \
    return leaf_k<K>(l, x);
    ACT_KINDS(ACT_CASE)
#undef ACT_CASE
  }
  return x * l.inner + l.shift;
}

// an activation of the generic instantiation: c0 + sum of c[i] f_i(x), in
// the plain version's order
__device__ __forceinline__ float act_eval(const PackAct& a, float x) {
  float v = a.c0;
#pragma unroll 1
  for (int i = 0; i < a.n; ++i) v = a.c[i] * act_leaf(a.f[i], x) + v;
  return v;
}

// a field activation slot in the tail: the default instantiation's form;
// in the generic one the staging pass (strip_acts) has applied it
template <bool kGen>
__device__ __forceinline__ float field_act(const PackAct& a, float x) {
  if constexpr (kGen) {
    return x;
  } else {
    return apply_act(a, x);
  }
}

// The generic instantiation's activations: a thread's accumulators pass
// through its own column of a staging buffer G [kStageK][kWgThreads] in
// shared memory, kStageK at a time, and a loop applies f(j, acc[j]) to
// each, so that the activations' code exists a few times per pass and not
// once per accumulator (hundreds of inlined copies made the kernel five
// times slower and its build take minutes). The loop is unrolled U times,
// so that U activations are in flight per thread.
constexpr int kStageK = 32;
constexpr size_t kStagingBytes = (size_t)kStageK * kWgThreads * 4;

// The f32 kernel's staging buffer is the operand buffer that its last
// layer does not read (its hidden layers are done with it) where that
// buffer holds kStagingBytes
__host__ __device__ constexpr bool f32_staging_in_operands(int lda) {
  return (size_t)kWgRays * lda * 4 >= kStagingBytes;
}

template <int U, int N, class F>
__device__ __forceinline__ void act_staged(float (&acc)[N], float* G,
                                           int wtid, F&& f) {
#pragma unroll
  for (int j0 = 0; j0 < N; j0 += kStageK) {
#pragma unroll
    for (int j = 0; j < kStageK; ++j) {
      if (j0 + j < N) G[j * kWgThreads + wtid] = acc[j0 + j];
    }
    const int n = N - j0 < kStageK ? N - j0 : kStageK;
#pragma unroll U
    for (int j = 0; j < n; ++j) {
      float* q = G + j * kWgThreads + wtid;
      *q = f(j0 + j, *q);
    }
#pragma unroll
    for (int j = 0; j < kStageK; ++j) {
      if (j0 + j < N) acc[j0 + j] = G[j * kWgThreads + wtid];
    }
  }
}

// The generic instantiation's layer activation on a thread's accumulators
// through the staging buffer: one leaf by a loop of its own kind (the
// kind's dispatch hoisted out of the loop), any other by act_eval
template <int U, int N>
__device__ __forceinline__ void layer_staged(float (&acc)[N], float* G,
                                             int wtid, const PackAct& a) {
  if (a.n == 1) {
    const ActLeaf l = a.f[0];
    const float c = a.c[0], c0 = a.c0;
    switch (l.kind) {
#define ACT_CASE(K)                                              \
  case K:                                                        \
    act_staged<U>(acc, G, wtid, [&](int, float v) {              \
      return c * leaf_k<K>(l, v) + c0;                           \
    });                                                          \
    return;
      ACT_KINDS(ACT_CASE)
#undef ACT_CASE
    }
  }
  act_staged<U>(acc, G, wtid, [&](int, float v) { return act_eval(a, v); });
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

// ---------------------------------------------------------------- the tail
// A warpgroup's 64 rays after the last layer. The strip functions take a
// strip's f32 sums in the wgmma accumulator layout (wgmma.cuh): thread
// `wtid` of the warpgroup holds rows r0 = 16 (wtid / 32) + lane / 4 and r0
// + 8, columns 8i + 2 (lane % 4) + e; column n of a strip is channel n / S,
// sample n % S.

struct Tail {
  const float* rays;   // [B, 8]
  float* pack;         // [10, B * k]
  float* D;            // [64, S + 8]: the distances, then sorted
  float* PF;           // [64, S + 8]: the offsets' factor 1 - point sigma
  int64_t ray0;        // the warpgroup's first ray
  int wtid;            // thread in the warpgroup
  int bar;             // the warpgroup's named barrier
  float* G;            // the generic instantiation's staging buffer
};

__device__ __forceinline__ void named_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kWgThreads) : "memory");
}

// a last-layer column from its biased sum: the layer activation where the
// layer has one (in the default instantiation the piecewise-linear one of
// slope p.leaky below 0)
template <bool kGen>
__device__ __forceinline__ float last_value(const PackParams& p, float v) {
  if constexpr (kGen) {
    return v;   // applied by the staging pass (strip_acts)
  } else {
    return p.layer[p.n_layers - 1].act && v < 0.0f ? v * p.leaky : v;
  }
}

// strip q's bias in the accumulator layout (0 in pad columns and in the
// columns of a field the chain lacks): the products accumulate onto it
template <int S, int W>
__device__ __forceinline__ void strip_bias(const PackParams& p, int q,
                                           float (&acc)[W / 2], int wtid) {
  const float* b = p.layer[p.n_layers - 1].b;
  const int t = wtid % 4;
#pragma unroll
  for (int i = 0; i < W / 8; ++i) {
    // columns n and n + 1 are samples s, s + 1 of one channel
    const int col = strip_column(p.foff, q, 8 * i + 2 * t, S);
    const float2 v = col >= 0
        ? __ldg(reinterpret_cast<const float2*>(b + col))
        : make_float2(0.0f, 0.0f);
    acc[4 * i] = acc[4 * i + 2] = v.x;
    acc[4 * i + 1] = acc[4 * i + 3] = v.y;
  }
}

__device__ __forceinline__ const float* ray_row(const PackParams& p,
                                                const float* rays,
                                                int64_t ray) {
  return rays + (ray < p.B ? ray : (int64_t)p.B - 1) * 8;
}

__device__ __forceinline__ void store2(float* q, float a, float b) {
  *reinterpret_cast<float2*>(q) = make_float2(a, b);
}

// z processing (intersect.py z_plane): act(z) * (1 - sigma), the anchors,
// the contraction's inverse, and the distance along the ray
template <bool kGen>
__device__ __forceinline__ float sample_dist(const PackParams& p, float zf,
                                             float sf, int s, float oz,
                                             float dz) {
  float z = field_act<kGen>(p.act[A_ISECT],
                            field_act<kGen>(p.act[A_Z], zf));
  z = z * (1.0f - field_act<kGen>(p.act[A_SIGMA], sf));
  z = z * p.z_scale[s] + p.samples[s];
  if (p.contract_samples) z = inverse_contract_distance(z, p);
  const float dzg = fabsf(dz) < 1e-5f ? 1e12f : dz;
  const float dist = (z - oz) / dzg;
  return dist <= 0.0f ? 0.0f : dist;
}

// The pack column of sample s (its sorted position and prediction row)
// within its ray's k, or -1 where the pack does not keep it; the stride is
// a power of two (pack_build.cu samples_kept_ok). kAll: the pack keeps all
// S samples, column s.
template <bool kAll>
__device__ __forceinline__ int kept_sample(const PackParams& p, int s) {
  if constexpr (kAll) return s;
  const int j = s >> (__ffs(p.stride) - 1);
  return (s & (p.stride - 1)) == 0 && j < p.k ? j : -1;
}

// pack row `row` of samples s0 and s0 + 1 of `ray` (columns j[0], j[1]; -1
// where not kept): one 8-byte store where the pack keeps every sample
template <int S, bool kAll>
__device__ __forceinline__ void store_kept(const PackParams& p, float* pack,
                                           int row, int64_t ray, int s0,
                                           const int (&j)[2], float a,
                                           float b) {
  if constexpr (kAll) {
    store2(pack + row * ((int64_t)p.B * S) + ray * S + s0, a, b);
  } else {
    float* q = pack + row * ((int64_t)p.B * p.k) + ray * p.k;
    if (j[0] >= 0) q[j[0]] = a;
    if (j[1] >= 0) q[j[1]] = b;
  }
}

// A compiler barrier between the iterations of an unrolled loop over a
// strip's accumulators: without it the compiler hoists every iteration's
// loads ahead, and with a layer's accumulators live that spills
__device__ __forceinline__ void bound_live() {
  asm volatile("" ::: "memory");
}

// strip 0 (z, sigma) -> the unsorted distances in D
template <int S, int W, bool kGen>
__device__ __forceinline__ void strip_z(const PackParams& p,
                                        const float (&acc)[W / 2],
                                        const Tail& T) {
  constexpr int RF = kRowF<S>;
  const int lane = T.wtid % 32, t = lane % 4;
  const int r0 = 16 * (T.wtid / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const float* ray = ray_row(p, T.rays, T.ray0 + r);
    const float oz = __ldg(ray + 2), dz = __ldg(ray + 5);
#pragma unroll
    for (int i = 0; i < S / 8; ++i) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = 8 * i + 2 * t + e;
        v[e] = sample_dist<kGen>(
            p, last_value<kGen>(p, acc[4 * i + 2 * h + e]),
            last_value<kGen>(p, acc[4 * (i + S / 8) + 2 * h + e]), s, oz,
            dz);
      }
      store2(T.D + r * RF + 8 * i + 2 * t, v[0], v[1]);
      bound_live();
    }
  }
}

// values-only ascending bitonic sort over a ray's S samples: lane l of the
// ray's warp segment holds sample l (S <= 32), or samples 2l and 2l + 1 of
// a whole warp (S = 64)
template <int S>
__device__ __forceinline__ void bitonic(float (&dist)[S > 32 ? 2 : 1],
                                        int l) {
  if constexpr (S <= 32) {
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
    static_assert(S == 64, "two samples per lane");
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
}

// A sample's base point o + d * dist; under the mipnerf contraction the
// contracted point, and dist becomes its distance from the contracted
// origin oc (hyperreel_tpu/ops/pallas/pack_build.py:209-221; 0 where the
// sorted distance was 0)
__device__ __forceinline__ void base_point(const PackParams& p,
                                           const float (&o)[3],
                                           const float (&d)[3],
                                           const float (&oc)[3], float& dist,
                                           float (&base)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) base[c] = o[c] + d[c] * dist;
  if (p.contract) {
    contract_rows(base, p);
    float sq = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float e = __fsub_rn(base[c], oc[c]);
      sq = c == 0 ? __fmul_rn(e, e) : __fadd_rn(sq, __fmul_rn(e, e));
    }
    dist = dist <= 0.0f ? 0.0f : __fsqrt_rn(fmaxf(sq, 1e-24f));
  }
}

// a ray's origin and direction, and the origin contracted where the chain
// contracts
__device__ __forceinline__ void ray_od(const PackParams& p, const float* ray,
                                       float (&o)[3], float (&d)[3],
                                       float (&oc)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c] = __ldg(ray + c);
    d[c] = __ldg(ray + 3 + c);
    oc[c] = o[c];
  }
  if (p.contract) contract_rows(oc, p);
}

// D -> the sort over each ray's samples, the sorted distances back into D.
// A warp segment per ray; rows past B sort the last ray's distances. With
// the far sentinel (p.far > 0) an invalid sample's distance, 0 in D (a
// valid one is > 0), becomes p.far before the sort, which then puts it
// last.
template <int S>
__device__ __forceinline__ void sort_rays(const PackParams& p,
                                          const Tail& T) {
  constexpr int RF = kRowF<S>;
  constexpr int SPL = S > 32 ? 2 : 1;
  constexpr int LANES = S / SPL;
  constexpr int PER_PASS = kWgThreads / LANES;
  const int l = T.wtid % LANES;
#pragma unroll 1
  for (int pass = 0; pass < kWgRays / PER_PASS; ++pass) {
    float* row = T.D + (pass * PER_PASS + T.wtid / LANES) * RF + SPL * l;
    float dist[SPL];
#pragma unroll
    for (int j = 0; j < SPL; ++j) dist[j] = row[j];
    if (p.far > 0.0f) {
#pragma unroll
      for (int j = 0; j < SPL; ++j) dist[j] = dist[j] == 0.0f ? p.far : dist[j];
    }
    bitonic<S>(dist, l);
#pragma unroll
    for (int j = 0; j < SPL; ++j) row[j] = dist[j];
  }
}

// strip 1 (point sigma) -> the offsets' factor 1 - act(point sigma) in PF
template <int S, int W, bool kGen>
__device__ __forceinline__ void strip_psig(const PackParams& p,
                                           const float (&acc)[W / 2],
                                           const Tail& T) {
  constexpr int RF = kRowF<S>;
  const int lane = T.wtid % 32, t = lane % 4;
  const int r0 = 16 * (T.wtid / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = 0; i < S / 8; ++i) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = 1.0f - field_act<kGen>(
                          p.act[A_PSIG],
                          last_value<kGen>(p, acc[4 * i + 2 * h + e]));
      }
      store2(T.PF + (r0 + 8 * h) * RF + 8 * i + 2 * t, v[0], v[1]);
      bound_live();
    }
  }
}

// point strip g (the six point channels of samples [16g, 16g + 16), or
// of all S < 16) -> pack rows 0-3: per sample the base point and distance
// from the sorted distance (contracted where the chain contracts), then
// per coordinate + flow * dt (chains with a flow stage), + offset * (1 -
// point sigma), the aabb normalisation; the fields in prediction order.
// Only the samples the pack keeps (kept_sample): sample s pairs sorted
// position s with prediction row s, as the JAX kernel's first-k and
// positional stride selections do
template <int S, int W, bool kAll, bool kGen>
__device__ __forceinline__ void strip_point(const PackParams& p,
                                            const float (&acc)[W / 2], int g,
                                            const Tail& T) {
  constexpr int RF = kRowF<S>;
  constexpr int G = point_group(S);
  constexpr int GB = G / 8;   // a channel's 8-column blocks
  const bool flow = p.foff[F_FLOW] >= 0;
  const int lane = T.wtid % 32, t = lane % 4;
  const int r0 = 16 * (T.wtid / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const int64_t ray = T.ray0 + r;
    const float* rp = ray_row(p, T.rays, ray);
    float o[3], d[3], oc[3];
    ray_od(p, rp, o, d, oc);
    const float dt = __ldg(rp + 6);
#pragma unroll
    for (int i = 0; i < GB; ++i) {
      const int s0 = g * G + 8 * i + 2 * t;
      const int j[2] = {kept_sample<kAll>(p, s0),
                        kept_sample<kAll>(p, s0 + 1)};
      float v[4][2] = {};   // pack rows 0-3 of samples s0, s0 + 1
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!kAll && j[e] < 0) continue;
        float base[3], dist = T.D[r * RF + s0 + e];
        base_point(p, o, d, oc, dist, base);
        const float pf = T.PF[r * RF + s0 + e];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float x = base[c];
          if (flow) {
            x = x + field_act<kGen>(
                        p.act[A_FLOW_STAGE],
                        field_act<kGen>(
                            p.act[A_FLOW],
                            last_value<kGen>(p, acc[4 * (c * GB + i) +
                                                    2 * h + e]))) * dt;
          }
          x = x + field_act<kGen>(
                      p.act[A_PO_STAGE],
                      field_act<kGen>(
                          p.act[A_POFF],
                          last_value<kGen>(p, acc[4 * ((3 + c) * GB + i) +
                                                  2 * h + e]))) * pf;
          v[c][e] = (x - p.aabb_lo[c]) * p.aabb_inv[c] - 1.0f;
        }
        v[3][e] = dist;
      }
      if (ray < p.B) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          store_kept<S, kAll>(p, T.pack, c, ray, s0, j, v[c][0], v[c][1]);
        }
      }
      bound_live();
    }
  }
}

// the colour strips (colour scale, colour shift; a component each) -> pack
// row `row`, the kept samples' prediction rows
template <int S, int W, bool kAll, bool kGen>
__device__ __forceinline__ void strip_colour(const PackParams& p,
                                             const float (&acc)[W / 2], int a,
                                             int row, const Tail& T) {
  const int lane = T.wtid % 32, t = lane % 4;
  const int r0 = 16 * (T.wtid / 32) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t ray = T.ray0 + r0 + 8 * h;
    if (ray >= p.B) continue;
#pragma unroll
    for (int i = 0; i < S / 8; ++i) {
      const int s0 = 8 * i + 2 * t;
      const int j[2] = {kept_sample<kAll>(p, s0),
                        kept_sample<kAll>(p, s0 + 1)};
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = field_act<kGen>(p.act[a],
                               last_value<kGen>(p, acc[4 * i + 2 * h + e]));
      }
      store_kept<S, kAll>(p, T.pack, row, ray, s0, j, v[0], v[1]);
      bound_live();
    }
  }
}

// The generic instantiation's activations of strip q's accumulators (the
// layer activation where the last layer has one, then each field's: z and
// the intersect's, sigma, point sigma, flow and the flow stage's, offset
// and the point-offset stage's, colour), applied by a staging pass before
// the tail reads them. A thread's accumulators of one channel are
// contiguous (acc[4 i + 2 h + e] holds column 8 i + 2 t + e, and a
// channel's ns columns are whole 8-column blocks), so the slots are found
// and their activations read once per channel; pad columns keep their
// value.
template <int S, int W>
__device__ __forceinline__ void strip_acts(const PackParams& p, int q,
                                           float (&acc)[W / 2],
                                           const Tail& T) {
  constexpr int N = W / 2;
  const int per = strip_desc(q, S).ns / 2;
  const bool last = p.layer[p.n_layers - 1].act;
  float* G = T.G;
  const int wtid = T.wtid;
#pragma unroll
  for (int j0 = 0; j0 < N; j0 += kStageK) {
#pragma unroll
    for (int j = 0; j < kStageK; ++j) {
      if (j0 + j < N) G[j * kWgThreads + wtid] = acc[j0 + j];
    }
    const int n = N - j0 < kStageK ? N - j0 : kStageK;
#pragma unroll 1
    for (int ch = j0 / per; ch * per < j0 + n; ++ch) {
      int f = 0, c = 0;
      if (!strip_channel(q, ch, S, &f, &c)) break;
      const PackAct a1 = p.act[f == F_Z ? A_Z : f == F_SIGMA ? A_SIGMA
                                 : f == F_PSIG ? A_PSIG : f == F_FLOW ? A_FLOW
                                 : f == F_POFF ? A_POFF : f == F_CS ? A_CS
                                                                    : A_CSH];
      const int b = f == F_Z ? A_ISECT : f == F_FLOW ? A_FLOW_STAGE
                  : f == F_POFF ? A_PO_STAGE : -1;
      const PackAct a2 = p.act[b >= 0 ? b : 0];
      const int lo = ch * per > j0 ? ch * per - j0 : 0;
      const int hi = (ch + 1) * per - j0 < n ? (ch + 1) * per - j0 : n;
#pragma unroll 2
      for (int j = lo; j < hi; ++j) {
        float* g = G + j * kWgThreads + wtid;
        float v = *g;
        if (last) {
          v = p.lpl ? (v < 0.0f ? v * p.leaky : v) : act_eval(p.lact, v);
        }
        v = act_eval(a1, v);
        *g = b >= 0 ? act_eval(a2, v) : v;
      }
    }
#pragma unroll
    for (int j = 0; j < kStageK; ++j) {
      if (j0 + j < N) acc[j0 + j] = G[j * kWgThreads + wtid];
    }
  }
}

// The last layer, strip by strip: `mma(acc, q)` leaves strip q's f32 sums,
// bias included, in acc (the wgmma accumulator layout, acc's extent the
// strip's width / 2).
template <int S, bool kGen, class Mma0>
__device__ __forceinline__ void drain_last_layer(const PackParams& p,
                                                 const Tail& T, Mma0&& mma0) {
  // the strip's sums, activated by the staging pass in the generic
  // instantiation
  auto mma = [&](auto& acc, int q) {
    mma0(acc, q);
    if constexpr (kGen) {
      constexpr int W =
          2 * std::extent_v<std::remove_reference_t<decltype(acc)>>;
      strip_acts<S, W>(p, q, acc, T);
    }
  };
  constexpr int NP = point_strips(S);
  constexpr int WZ = strip_width(2, S);
  constexpr int WS = strip_width(1, S);
  constexpr int WP = strip_width(6, point_group(S));
  constexpr int WC = strip_width(1, S);
  {
    float acc[WZ / 2];
    mma(acc, 0);
    strip_z<S, WZ, kGen>(p, acc, T);
  }
  named_bar(T.bar);
  sort_rays<S>(p, T);
  {
    float acc[WS / 2];
    mma(acc, 1);
    strip_psig<S, WS, kGen>(p, acc, T);
  }
  named_bar(T.bar);
  // the pack keeps all S samples (the code the full routes run), or k of
  // them; a point strip past the first k under compaction keeps none
  const bool all = p.k == S;
#pragma unroll 1
  for (int g = 0; g < NP; ++g) {
    float acc[WP / 2];
    mma(acc, 2 + g);
    if (all) {
      strip_point<S, WP, true, kGen>(p, acc, g, T);
    } else if (p.stride > 1 || g * point_group(S) < p.k) {
      strip_point<S, WP, false, kGen>(p, acc, g, T);
    }
  }
#pragma unroll 1
  for (int c = 0; c < 6; ++c) {
    // colour scale components 0-2 (pack rows 4-6), then colour shift
    // (rows 7-9), a strip each: the smallest accumulators of the layer
    float acc[WC / 2];
    mma(acc, 2 + NP + c);
    const int a = c < 3 ? A_CS : A_CSH;
    if (all) {
      strip_colour<S, WC, true, kGen>(p, acc, a, 4 + c, T);
    } else {
      strip_colour<S, WC, false, kGen>(p, acc, a, 4 + c, T);
    }
  }
}

// ------------------------------------------------------- Hopper primitives

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed: the
// spin loop is PTX (labels scoped by the braces), so the compiler sees no
// divergent branch between the products. A wait that outlasts 2e10 SM
// clocks (~10 s) traps, failing the launch, rather than hang the card on a
// broken pipeline.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .u64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.u64 t1, t1, t0;\n"
      "setp.gt.u64 p, t1, 20000000000;\n"
      "@p trap;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving register accesses across the asynchronous
// products (CUTLASS's warpgroup_fence_operand)
template <int M>
__device__ __forceinline__ void fence_regs(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle (the weight slabs, as TMA writes them): rows of 128 bytes, 8-row
// groups 1024 bytes apart (SBO), the leading offset unused, base offset 0
// (stages are 1024-byte aligned; a k-step inside the 128-byte row adds 32
// bytes to the start address)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A warpgroup's A operand in the K-major layout without swizzle: core
// matrices of 8 rows x 16 bytes (8 bf16 of K), the 8 row groups of one K
// group 128 bytes apart (SBO), the 8 K groups of a 64-column chunk 1024
// bytes apart (LBO; a k-step spans two, 2048 bytes). A thread's epilogue
// stores then sit at one base address plus constants, and a warp's 32
// stores of a column pair fill 128 contiguous bytes.
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// byte offset of the bf16 pair (row r, columns k, k + 1) in the A operand
__device__ __forceinline__ uint32_t a_offset(int r, int k) {
  return (k / kChunkK) * kChunkBytes + ((k % kChunkK) / 8) * 1024 +
         (r / 8) * 128 + (r % 8) * 16 + (k % 8) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The weight ring: slab k of the block's sequence (its tiles' slabs in
// order) sits in stage k % stages, its full barrier's phase k / stages. A
// warpgroup releases a slab once its products have completed; the second
// of the two releases refills the stage with slab k + stages by TMA, so no
// warp waits on its own to feed the ring and the block needs no producer
// warps (and keeps 255 registers a thread for a hidden layer's 128
// accumulators).
struct Ring {
  unsigned char* base;
  uint64_t* full;      // [stages] TMA completion
  int* released;       // [stages] releases so far
  const CUtensorMap* map;
  const SlabPlan* sp;
  int64_t total;       // slabs of the block's tiles
  bool signal;         // this thread releases for its warpgroup
  int64_t next;        // the next slab this warpgroup takes

  // issue slab k's TMA loads into its stage (one thread)
  __device__ __forceinline__ void fill(int64_t k) const {
    if (k >= total) return;
    const int st = (int)(k % sp->stages), j = (int)(k % sp->n);
    mbar_expect_tx(&full[st], sp->rows[j] * kChunkK * 2);
    for (int b = 0; b < sp->rows[j]; b += kBoxRows) {
      tma_load_2d(base + st * kStageBytes + b * kChunkK * 2, map, 0,
                  sp->row0[j] + b, &full[st]);
    }
  }
  // wait for the next slab; its stage's shared address
  __device__ __forceinline__ uint32_t acquire() {
    const int st = (int)(next % sp->stages);
    mbar_wait(&full[st], (uint32_t)((next / sp->stages) & 1));
    return smem_u32(base + st * kStageBytes);
  }
  __device__ __forceinline__ int64_t advance() { return next++; }
  __device__ __forceinline__ void release(int64_t k) {
    if (signal &&
        (atomicAdd(&released[k % sp->stages], 1) & 1)) {
      fill(k + sp->stages);
    }
  }
};

// acc (+)= A[:, chunks c0 .. c0 + n) @ the ring's next n slabs, KS k16
// steps of each (A at shared address a); the next slab is awaited while
// this one's products run
template <int N, int KS>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], uint32_t a, int c0,
                                       int n, bool accumulate, Ring& ring) {
  wgmma_fence();
  int64_t prev = 0;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    const uint32_t b = ring.acquire();
    const uint32_t aj = a + (c0 + j) * kChunkBytes;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      WgmmaSS<N>::mma(acc, desc_a(aj + 2048 * kk), desc_sw128(b + 32 * kk),
                      (accumulate || j || kk) ? 1 : 0);
    }
    wgmma_commit();
    const int64_t k = ring.advance();
    if (j > 0) {
      wgmma_wait<1>();
      ring.release(prev);
    }
    prev = k;
  }
  wgmma_wait<0>();
  ring.release(prev);
  fence_regs(acc);
}

// a hidden layer's epilogue on the accumulators of HB columns: bias b,
// the layer activation (in f32, before the next layer's bf16 rounding, as
// the JAX kernel's _mlp_rows; kGen: any, else the piecewise-linear one of
// slope p.leaky below 0), bf16,
// stored in the A layout at dst (the chunk of the block's first column),
// in the rows of this thread's warp
template <int HB, bool kGen>
__device__ __forceinline__ void hidden_epilogue(float (&acc)[HB / 2],
                                                unsigned char* dst,
                                                const float* b, bool act,
                                                const PackParams& p,
                                                float* G, int r0, int t) {
  if constexpr (kGen) {
    // the bias, then the layer activation by a staging pass
#pragma unroll
    for (int i = 0; i < HB / 8; ++i) {
      const float2 bi =
          __ldg(reinterpret_cast<const float2*>(b + 8 * i + 2 * t));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * i + 2 * h] += bi.x;
        acc[4 * i + 2 * h + 1] += bi.y;
      }
    }
    if (act && p.lpl) {
#pragma unroll
      for (int j = 0; j < HB / 2; ++j) {
        acc[j] = acc[j] < 0.0f ? acc[j] * p.leaky : acc[j];
      }
    } else if (act) {
      layer_staged<2>(acc, G, threadIdx.x % kWgThreads, p.lact);
    }
  }
  auto f = [&](float v) { return act && v < 0.0f ? v * p.leaky : v; };
  unsigned char* base = dst + a_offset(r0, 2 * t);
#pragma unroll
  for (int i = 0; i < HB / 8; ++i) {
    float2 bi = make_float2(0.0f, 0.0f);
    if constexpr (!kGen) {
      bi = __ldg(reinterpret_cast<const float2*>(b + 8 * i + 2 * t));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // row r0 + 8h, columns 8i + 2t: chunk i / 8, K group i % 8
      uint32_t* q = reinterpret_cast<uint32_t*>(
          base + (i / 8) * kChunkBytes + (i % 8) * 1024 + h * 128);
      if constexpr (kGen) {
        *q = pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      } else {
        *q = pack_bf16(f(acc[4 * i + 2 * h] + bi.x),
                       f(acc[4 * i + 2 * h + 1] + bi.y));
      }
    }
    bound_live();
  }
}

// make a warpgroup's generic-proxy stores to its A visible to its next
// products
__device__ __forceinline__ void publish_a(int bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_bar(bar);
}

// acc (+)= A[:, the encoded rays' xk columns] @ the ring's next slabs: a
// slab per whole chunk of 64 columns, then one of which a half chunk's 32
// rows are read where xk % 64 = 32 (the default: xk = 32)
template <int N>
__device__ __forceinline__ void mma_x(float (&acc)[N / 2], uint32_t a,
                                      int xc, int xk, bool accumulate,
                                      Ring& ring) {
  const int whole = xk / kChunkK;
  if (whole) mma_ss<N, kChunkK / 16>(acc, a, xc, whole, accumulate, ring);
  if (xk % kChunkK) {
    mma_ss<N, kXCols / 16>(acc, a, xc + whole, 1, accumulate || whole,
                           ring);
  }
}

// ------------------------------------------------------ the bf16 kernel
// The hidden layers of one tile at hidden width H (A holds the encoded
// rays' xk columns from chunk H/64 on); leaves the last hidden layer's
// output in A. A layer
// runs in column blocks of at most kHiddenBlock: a block's accumulators
// (64 registers) are all that is live, where the whole 256-column layer's
// 128 made ptxas spill. The weight slabs come per block (mlp_tables). The
// blocks but the last store their output in `scratch` (the warpgroup's
// tail buffers, idle during the hidden layers), since A is still the input
// of the next block; the last block stores into A, and each warp then
// copies its own rows of the others over.
template <int H, bool kGen>
__device__ __forceinline__ void hidden_layers(const PackParams& p,
                                              unsigned char* A,
                                              unsigned char* scratch,
                                              float* G, Ring& ring, int bar,
                                              int r0, int t, int xk) {
  constexpr int XC = H / kChunkK;   // the encoded rays' chunk
  constexpr int HB = H < kHiddenBlock ? H : kHiddenBlock;
  constexpr int NB = H / HB;
  const uint32_t a = smem_u32(A);
#pragma unroll 1
  for (int l = 0; l + 1 < p.n_layers; ++l) {
    const MlpLayer& L = p.layer[l];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float acc[HB / 2];
      if (l == 0) {
        mma_x<HB>(acc, a, XC, xk, false, ring);
      } else {
        mma_ss<HB, kChunkK / 16>(acc, a, 0, XC, false, ring);
        if (L.k > H) mma_x<HB>(acc, a, XC, xk, true, ring);
      }
      hidden_epilogue<HB, kGen>(acc, (b + 1 < NB ? scratch : A) +
                                         b * HB / kChunkK * kChunkBytes,
                                L.b + b * HB, L.act, p, G, r0, t);
    }
    if (NB > 1) {
      // this warp's rows (row groups 2w, 2w + 1) of the scratch chunks:
      // 256 contiguous bytes of each K group
      const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
#pragma unroll
      for (int c = 0; c < (NB - 1) * HB / kChunkK; ++c) {
#pragma unroll
        for (int g = 0; g < kChunkK / 8; ++g) {
          const int off = c * kChunkBytes + g * 1024 + 2 * w * 128 + 8 * lane;
          *reinterpret_cast<uint2*>(A + off) =
              *reinterpret_cast<const uint2*>(scratch + off);
        }
      }
    }
    publish_a(bar);
  }
}

__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           size_t bytes, int tid) {
  for (size_t i = tid; i < bytes / 4; i += kThreadsWg) {
    static_cast<uint32_t*>(dst)[i] = static_cast<const uint32_t*>(src)[i];
  }
}

// Two warpgroups, each 64 rays of every tile the block takes
template <int S, bool kGen>
__global__ void __launch_bounds__(kThreadsWg, 1)
pack_build_wgmma(const float* __restrict__ x0, const float* __restrict__ rays,
                 float* __restrict__ pack,
                 const __grid_constant__ PackParams p,
                 const __grid_constant__ CUtensorMap wmap,
                 const __grid_constant__ SlabPlan sp_in) {
  extern __shared__ __align__(1024) unsigned char smem_wg[];
  constexpr int RF = kRowF<S>;
  // [ring stages][A of warpgroup 0, 1][D, PF of warpgroup 0, 1][the
  // generic instantiation's staging buffers of warpgroup 0, 1][barriers,
  // release counts][the parameters]
  unsigned char* As = smem_wg + sp_in.stages * kStageBytes;
  float* tails = reinterpret_cast<float*>(As + kConsumers * sp_in.a_bytes);
  float* stage = tails + kConsumers * tail_floats(S);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      stage + (kGen ? kConsumers * kStagingBytes / 4 : 0));
  int* released = reinterpret_cast<int*>(full + kMaxStages);
  // the slab plan, copied to shared memory for the thread that refills
  // the ring
  SlabPlan* spp = reinterpret_cast<SlabPlan*>(full + 2 * kMaxStages);
  const int tid = threadIdx.x, lane = tid % 32;
  copy_words(spp, &sp_in, sizeof(SlabPlan), tid);
  __syncthreads();
  const SlabPlan& sp = *spp;
  const int wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int64_t n_tiles = ((int64_t)p.B + kTileRays - 1) / kTileRays;
  Ring ring{smem_wg, full, released, &wmap, spp,
            sp.n * ((n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x),
            wtid == 0, 0};
  if (tid == 0) {
    for (int i = 0; i < sp.stages; ++i) {
      mbar_init(&full[i], 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < sp.stages; ++i) ring.fill(i);
  }
  __syncthreads();

  unsigned char* A = As + wg * sp.a_bytes;
  float* D = tails + wg * tail_floats(S);
  Tail T{rays, pack, D, D + kWgRays * RF, 0, wtid, 1 + wg,
         stage + wg * kStagingBytes / 4};
  const int t = lane % 4, r0 = 16 * (wtid / 32) + lane / 4;
  const int H = p.layer[0].n;
  const int XC = H / kChunkK;
  const int xk = x_cols(p.layer[0].k);
  const uint32_t a = smem_u32(A);

#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    T.ray0 = tile * kTileRays + wg * kWgRays;
    // the previous tile's tail is done with D and PF, and its products
    // with A
    named_bar(T.bar);
    // the encoded rays, kXCols columns at a time (pad columns zero)
#pragma unroll 1
    for (int k0 = 0; k0 < xk; k0 += kXCols) {
      for (int i = wtid; i < kWgRays * kXCols / 2; i += kWgThreads) {
        const int r = i / (kXCols / 2), k = k0 + 2 * (i % (kXCols / 2));
        const int64_t ray = T.ray0 + r;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = (k + e < p.cin && ray < p.B)
                     ? __ldg(x0 + ray * p.cin + k + e)
                     : 0.0f;
        }
        *reinterpret_cast<uint32_t*>(A + a_offset(r, XC * kChunkK + k)) =
            pack_bf16(v[0], v[1]);
      }
    }
    publish_a(T.bar);

    unsigned char* scratch = reinterpret_cast<unsigned char*>(D);
    if (H == 256) {
      hidden_layers<256, kGen>(p, A, scratch, T.G, ring, T.bar, r0, t, xk);
    } else {
      hidden_layers<64, kGen>(p, A, scratch, T.G, ring, T.bar, r0, t, xk);
    }
    drain_last_layer<S, kGen>(p, T, [&](auto& acc, int q) {
      constexpr int W =
          2 * std::extent_v<std::remove_reference_t<decltype(acc)>>;
      strip_bias<S, W>(p, q, acc, wtid);
      mma_ss<W, kChunkK / 16>(acc, a, 0, XC, true, ring);
    });
  }
}

// ------------------------------------------------------- the f32 kernel
// acc (wgmma accumulator layout, N columns) += A[:, L.k0:L.k0 + L.k] @
// w[:, col(n)] in plain f32 FMAs, in k order (col < 0: a pad column)
template <int N, class Col>
__device__ __forceinline__ void fma_cols(float (&acc)[N / 2], const float* A,
                                         int lda, const MlpLayer& L, Col col,
                                         int r0, int t) {
  int cols[N / 8][2];
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) cols[i][e] = col(8 * i + 2 * t + e);
  }
  const float* w = static_cast<const float*>(L.w);
  const float* a0 = A + r0 * lda + L.k0;
  const float* a1 = a0 + 8 * lda;
#pragma unroll 1
  for (int k = 0; k < L.k; ++k) {
    const float x0 = a0[k], x1 = a1[k];
    const float* wk = w + (int64_t)k * L.n;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float wv = cols[i][e] >= 0 ? __ldg(wk + cols[i][e]) : 0.0f;
        acc[4 * i + e] += x0 * wv;
        acc[4 * i + 2 + e] += x1 * wv;
      }
    }
  }
}

// 64 rays per block, one warpgroup; two f32 operand buffers hold a layer's
// input and the next layer's, the encoded rays parked in columns [xcol,
// xcol + k) of both for the first and the skip layer
template <int S, bool kGen>
__global__ void __launch_bounds__(kWgThreads)
pack_build_f32(const float* __restrict__ x0, const float* __restrict__ rays,
               float* __restrict__ pack, const __grid_constant__ PackParams p,
               int lda) {
  extern __shared__ __align__(16) unsigned char smem_f32[];
  constexpr int RF = kRowF<S>;
  float* bufs[2] = {reinterpret_cast<float*>(smem_f32),
                    reinterpret_cast<float*>(smem_f32) + kWgRays * lda};
  float* D = bufs[1] + kWgRays * lda;
  const int tid = threadIdx.x, lane = tid % 32;
  const int t = lane % 4, r0 = 16 * (tid / 32) + lane / 4;
  // [two operand buffers][D, PF][the staging buffer, where the operand
  // buffer that the last layer does not read is too small for it]
  Tail T{rays, pack, D, D + kWgRays * RF, (int64_t)blockIdx.x * kWgRays, tid,
         1, f32_staging_in_operands(lda) ? bufs[p.n_layers & 1]
                                         : D + 2 * kWgRays * RF};

  const int kin = p.layer[0].k;
  for (int i = tid; i < kWgRays * kin; i += kWgThreads) {
    const int r = i / kin, c = i % kin;
    const int64_t ray = T.ray0 + r;
    const float v = (c < p.cin && ray < p.B) ? __ldg(x0 + ray * p.cin + c)
                                             : 0.0f;
    bufs[0][r * lda + p.xcol + c] = v;
    bufs[1][r * lda + p.xcol + c] = v;
  }
  __syncthreads();

  // hidden layers: layer l reads buffer l % 2 and writes the other, 32
  // columns at a time
#pragma unroll 1
  for (int l = 0; l + 1 < p.n_layers; ++l) {
    const MlpLayer& L = p.layer[l];
    const float* in = bufs[l & 1];
    float* out = bufs[(l + 1) & 1];
#pragma unroll 1
    for (int c0 = 0; c0 < L.n; c0 += 32) {
      float acc[16] = {};
      fma_cols<32>(acc, in, lda, L, [&](int n) { return c0 + n; }, r0, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c0 + 8 * i + 2 * t + e;
            float v = acc[4 * i + 2 * h + e] + __ldg(L.b + c);
            if constexpr (!kGen) {
              if (L.act && v < 0.0f) v *= p.leaky;
            }
            out[(r0 + 8 * h) * lda + c] = v;
          }
        }
      }
    }
    __syncthreads();
    if constexpr (kGen) {
      // the layer activation over the layer's output, in one rolled loop
      if (L.act) {
#pragma unroll 1
        for (int i = tid; i < kWgRays * L.n; i += kWgThreads) {
          float* q = out + (i / L.n) * lda + i % L.n;
          *q = p.lpl ? (*q < 0.0f ? *q * p.leaky : *q)
                     : act_eval(p.lact, *q);
        }
      }
      __syncthreads();
    }
  }

  // the last layer strip by strip, its columns gathered from the
  // field-major weights
  const float* A = bufs[(p.n_layers - 1) & 1];
  const MlpLayer& L = p.layer[p.n_layers - 1];
  drain_last_layer<S, kGen>(p, T, [&](auto& acc, int q) {
    constexpr int W =
        2 * std::extent_v<std::remove_reference_t<decltype(acc)>>;
    strip_bias<S, W>(p, q, acc, T.wtid);
    fma_cols<W>(acc, A, lda, L,
                [&](int n) { return strip_column(p.foff, q, n, S); }, r0, t);
  });
}

template <int S, bool kGen>
cudaError_t launch_wgmma(const float* x0, const float* rays, float* pack,
                         const PackParams& p, const K1Plan& pl,
                         const CUtensorMap& map, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      pack_build_wgmma<S, kGen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t tiles = ((int64_t)p.B + kTileRays - 1) / kTileRays;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);
  pack_build_wgmma<S, kGen><<<blocks, kThreadsWg, pl.smem, st>>>(
      x0, rays, pack, p, map, pl.slabs);
  return cudaGetLastError();
}

template <int S, bool kGen>
cudaError_t launch_f32(const float* x0, const float* rays, float* pack,
                       const PackParams& p, const K1Plan& pl,
                       cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      pack_build_f32<S, kGen>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pl.smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = (unsigned)((p.B + kWgRays - 1) / kWgRays);
  pack_build_f32<S, kGen><<<blocks, kWgThreads, pl.smem, st>>>(
      x0, rays, pack, p, pl.lda);
  return cudaGetLastError();
}

}  // namespace

// the default instantiations: the bf16 and the f32 kernel with a
// piecewise-linear layer activation and the basic field activations
#define K1_DEFINE(S)                                                     \
  cudaError_t k1_launch_s##S(const float* x0, const float* rays,         \
                             float* pack, const PackParams& p,          \
                             const K1Plan& pl, const CUtensorMap& map,  \
                             cudaStream_t st) {                         \
    return p.bf16 ? launch_wgmma<S, false>(x0, rays, pack, p, pl, map, st) \
                  : launch_f32<S, false>(x0, rays, pack, p, pl, st);    \
  }

// the generic instantiations: the bf16 and the f32 kernel with any
// activation
#define K1_DEFINE_GEN(S)                                                 \
  cudaError_t k1_launch_gen_s##S(const float* x0, const float* rays,     \
                                 float* pack, const PackParams& p,      \
                                 const K1Plan& pl,                      \
                                 const CUtensorMap& map,                \
                                 cudaStream_t st) {                     \
    return p.bf16 ? launch_wgmma<S, true>(x0, rays, pack, p, pl, map, st) \
                  : launch_f32<S, true>(x0, rays, pack, p, pl, st);     \
  }
