// Pack-build (K1): the host side, the launch plans and the C interface.
// The kernels and their design note are in pack_build.cuh, compiled per
// sample count in pack_build_s<S>.cu (the default instantiation) and
// pack_build_gen_s<S>.cu (the generic ones).

#include "pack_build.cuh"

namespace {

// pack_build_launch's return where no launch plan takes p: no cudaError_t
constexpr int kNoPlan = -1;

bool sample_count_ok(int S) {
  return S == 8 || S == 16 || S == 32 || S == 64;
}

// k of the S samples: the first k (stride 1), or every stride-th with k *
// stride = S, the stride a power of two
bool samples_kept_ok(const PackParams& p) {
  return p.k >= 1 && p.k <= p.S && p.stride >= 1 &&
         (p.stride & (p.stride - 1)) == 0 &&
         (p.stride == 1 || p.k * p.stride == p.S);
}

bool fields_ok(const PackParams& p) {
  const int need[] = {F_Z, F_SIGMA, F_PSIG, F_POFF, F_CS, F_CSH};
  for (int f : need) {
    if (p.foff[f] < 0) return false;
  }
  return p.n_layers >= 2 && p.n_layers <= kMaxLayers &&
         p.P * p.S <= p.layer[p.n_layers - 1].n;
}

bool act_ok(const PackAct& a, bool basic) {
  if (a.n < 1 || a.n > (basic ? 1 : kActLeaves)) return false;
  for (int i = 0; i < a.n; ++i) {
    if (a.f[i].kind < 0 || a.f[i].kind > (basic ? kBasicKinds - 1
                                                 : K_GAUSSIAN)) {
      return false;
    }
  }
  return true;
}

// The activations are ones the chosen instantiation evaluates: in the
// default one every field slot one basic leaf and the layer activation
// piecewise linear (lpl)
bool acts_ok(const PackParams& p) {
  const bool basic = !p.generic;
  for (int i = 0; i < A_N; ++i) {
    if (!act_ok(p.act[i], basic)) return false;
  }
  return act_ok(p.lact, false) && (p.lpl || !basic);
}

size_t tail_bytes(int S) { return 2 * (size_t)kWgRays * (S + 8) * 4; }

K1Plan plan_f32(const PackParams& p) {
  K1Plan pl{};
  int cols = 0;
  for (int l = 0; l < p.n_layers; ++l) {
    const MlpLayer& L = p.layer[l];
    const bool last = l + 1 == p.n_layers;
    if (L.k < 1 || (!last && (L.n % 32 || L.n > p.xcol))) return pl;
    cols = L.k0 + L.k > cols ? L.k0 + L.k : cols;
  }
  pl.lda = (cols + 31) / 32 * 32 + 4;
  // the generic instantiation's staging buffer: the operand buffer the
  // last layer does not read, or its own beside the tail's where that
  // buffer is smaller (f32_staging_in_operands)
  pl.smem = 2 * (size_t)kWgRays * pl.lda * 4 + tail_bytes(p.S) +
            (p.generic && !f32_staging_in_operands(pl.lda) ? kStagingBytes
                                                           : 0);
  if (pl.smem <= kMaxSmem) pl.R = kWgRays;
  return pl;
}

K1Plan plan_wgmma(const PackParams& p) {
  K1Plan pl{};
  const int H = p.layer[0].n, xk = p.layer[0].k;
  if ((H != 64 && H != 256) || p.xcol != H || p.layer[0].k0 != H ||
      xk < 16 || xk % 16 || xk > kMaxXCols || p.cin > xk ||
      p.wt == nullptr || reinterpret_cast<uintptr_t>(p.wt) % 16) {
    return pl;
  }
  // the encoded rays' slabs per column block: one per chunk of 64 rows
  const int xs = (x_cols(xk) + kChunkK - 1) / kChunkK;
  SlabPlan& sp = pl.slabs;
  auto push = [&](int rows, int count) {
    for (int j = 0; j < count && sp.n < kMaxSlabs; ++j) sp.rows[sp.n++] = rows;
  };
  // hidden layers in column blocks of HB (pack_build.cuh hidden_layers)
  const int HB = H < kHiddenBlock ? H : kHiddenBlock;
  push(HB, H / HB * xs);
  for (int l = 1; l + 1 < p.n_layers; ++l) {
    const MlpLayer& L = p.layer[l];
    if (L.n != H || L.k0 != 0 || (L.k != H && L.k != H + xk)) return pl;
    push(HB, H / HB * (H / kChunkK + (L.k > H ? xs : 0)));
  }
  const MlpLayer& last = p.layer[p.n_layers - 1];
  if (last.k0 != 0 || last.k != H) return pl;
  if (p.n_strips != n_strips(p.S)) return pl;
  for (int q = 0; q < n_strips(p.S); ++q) {
    const StripDesc d = strip_desc(q, p.S);
    push(strip_width(d.nch, d.ns), H / kChunkK);
    // the host's strips are the tail's (strip_desc, strip_channel)
    if (p.strip_s[q][0] != d.s0 || p.strip_s[q][1] != d.ns) return pl;
    for (int j = 0; j < kStripChannels; ++j) {
      int f = 0, c = 0;
      const int fc = strip_channel(q, j, p.S, &f, &c) ? 4 * f + c : -1;
      if (p.strip_fc[q][j] != fc) return pl;
    }
  }
  if (sp.n == kMaxSlabs) return pl;   // a layout this kernel does not hold
  // the host's slabs, one by one, are the ones this kernel consumes
  if (p.n_slabs != sp.n) return pl;
  int rows = 0;
  for (int j = 0; j < sp.n; ++j) {
    if (p.slab_rows[j] != sp.rows[j] || sp.rows[j] > kStageRows) return pl;
    sp.row0[j] = rows;
    rows += sp.rows[j];
  }
  if (rows != p.wt_rows) return pl;
  sp.a_bytes = a_bytes(H, x_cols(xk));
  const size_t fixed = 2 * kMaxStages * sizeof(uint64_t) +
      sizeof(SlabPlan) +
      kConsumers * (sp.a_bytes + (size_t)tail_floats(p.S) * 4 +
                    (p.generic ? kStagingBytes : 0));
  sp.stages = (int)((kMaxSmem - fixed) / kStageBytes);
  if (sp.stages > kMaxStages) sp.stages = kMaxStages;
  if (sp.stages < 2) return pl;
  pl.smem = (size_t)sp.stages * kStageBytes + fixed;
  pl.R = kTileRays;
  return pl;
}

// The launch plan for p's widths; R = 0 where p is not a layout the
// kernels take or nothing fits
K1Plan plan(const PackParams& p) {
  if (!sample_count_ok(p.S) || !samples_kept_ok(p) || !fields_ok(p) ||
      !acts_ok(p)) {
    return K1Plan{};
  }
  return p.bf16 ? plan_wgmma(p) : plan_f32(p);
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (no
// link against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// the weight tensor [wt_rows, 64] bf16 as TMA boxes of 32 x 64, 128-byte
// swizzle
cudaError_t weight_map(const PackParams& p, CUtensorMap* map) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)kChunkK, (cuuint64_t)p.wt_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kChunkK * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kChunkK, (cuuint32_t)kBoxRows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                         const_cast<void*>(p.wt), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// K1 on p's rays: a cudaError_t, or kNoPlan where p is refused (plan)
extern "C" int pack_build_launch(const float* x0, const float* rays,
                                 float* pack, const PackParams* p,
                                 void* stream) {
  const K1Plan pl = plan(*p);
  if (pl.R == 0) return kNoPlan;
  if (p->B == 0) return 0;
  CUtensorMap map{};
  if (p->bf16) {
    const cudaError_t e = weight_map(*p, &map);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = (cudaStream_t)stream;
#define K1_CASE(S)                                                         \
  case S:                                                                  \
    return (int)(p->generic                                                \
                     ? k1_launch_gen_s##S(x0, rays, pack, *p, pl, map, st) \
                     : k1_launch_s##S(x0, rays, pack, *p, pl, map, st));
  switch (p->S) {
    K1_LAUNCHERS(K1_CASE)
    default: return (int)cudaErrorInvalidValue;
  }
#undef K1_CASE
}

// The rays per block that pack_build_launch takes for p (0: p is refused)
extern "C" int pack_rays_per_block(const PackParams* p) {
  return plan(*p).R;
}

extern "C" int pack_params_size() { return (int)sizeof(PackParams); }
