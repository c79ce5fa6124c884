"""K5 (multi-axis shade), K5-preblended and K6 (the multi-axis patch shade)
built as text-patched variants of a checkout's csrc/, on one NVIDIA GPU:
ptxas's registers, spills and shared memory of each variant's
instantiations, and the kernels' times, the variants in turns (CUDA events
over 20 launches, twice), with the error against the plain version
(meaningless for the variants that change what is computed).

Run from the root of the checkout whose kernels are measured (its
chip_smoke.py and hyperreel_tpu_torch are the ones imported):

    python3 /path/to/scripts/k5_variants.py [--patch] [base] [nocolour] ...

Without --patch: K5 on chip_smoke.py's llff_z_plane, shiny_z_plane and
neural_3d_z_plane chunks (n3d on the time planes, TH = 12, with the frame's
t and with a t per ray spread over the keyframes, and on the planes
premixed for the frame's t) and K5-preblended on K4's features of the same
chunks in phase-major order (R = 8). With --patch: K5-preblended and K6 on
the llff and shiny chunks (phase-major, R=8 (5, 2)) and the n3d chunk
(phase-major, R=8 (5, 3); K6 also at R=4 (4, 3) on the scanline chunk),
each line with the launch's blocks per SM (from its registers, its shared
memory and its block size against the H100's limits).

Variants of the one-warp-per-ray K5 (a lane per sample):
  base           the source as it is;
  bcast_line     axis 0's z line read at the ray's first sample's row (every
                 lane of the ray on one row);
  bcast_quad     the quad rows of axes 1 and 2 (the xz and yz planes) read
                 at the ray's first sample's (x, z) and (y, z);
  nocolour       the colour replaced by the sum of the appearance channels;
  notime_branch  both keyframe rows of a time plane always read (their
                 indices clamped), without the `w != 0` branches.
Variants of the ray-run quad K5 (a thread per ray over its samples):
  base, nocolour as above;
  nofold   the SH colour of each sample from the unfolded [27, 16] basis
           product (shade_core.cuh sh_colour), no fold per ray;
  cap1, cap2  at most 1 or 2 of its blocks per SM (else as many as fit);
  regs2    registers for two of its blocks per SM (at most 128).
Variants of K5-preblended (a lane per sample) and K6 (either design: a
lane per sample with the block prologue, or a thread per ray):
  base, nocolour as above;
  noprologue  K6's anchors from the sample itself (no min over the R
              rays, no witness): with the block prologue the patch rows
              are read through L1 and nothing goes through shared memory
              or barriers; with the warp prologue no shuffles;
  noscan   the warp-scan composite replaced by a per-lane store (the
           lane-per-sample kernels only);
  pr_regs1, pr_regs2, pr_regs3  the thread-per-ray K6 with registers
           for 1 (ptxas free), 2 or 3 of its blocks of 128 per SM (the
           source: 4, at most 128);
  notime   no time taps: each axis's second factor the z taps of its
           first row (of the first keyframe on a time plane);
  nofeat   no plane features read (neither patch rows nor feature rows):
           the features made from the sample's own numbers.
Each variant builds into build/variants/<name>/ (git-ignored); ctypes
keeps the libraries' symbols apart. A variant whose anchor is not in the
checkout's source is skipped with a note.
"""

import dataclasses
import functools
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(os.getcwd())
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from compare_trees import blend_planes  # noqa: E402
from hyperreel_tpu_torch.models.ctx import StepCtx  # noqa: E402
from hyperreel_tpu_torch.ops.kernels import build  # noqa: E402
from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build  # noqa: E402
from hyperreel_tpu_torch.ops.kernels.shade import premix_time  # noqa: E402
from hyperreel_tpu_torch.ops.kernels.shade_multi import (  # noqa: E402
    MultiSpec, shade_multi, shade_multi_plain, shade_multi_preblended,
    shade_multi_preblended_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (  # noqa: E402
    shade_multi_patch, shade_multi_patch_plain)

MULTI, KERNEL = "multi_core.cuh", "shade_multi.cu"
PATCH, PCORE, CORE = "shade_multi_patch.cu", "patch_core.cuh", \
    "shade_core.cuh"
FILES = (MULTI, KERNEL, PATCH, PCORE, CORE)
# the H100's limits per SM: registers, shared memory (1 KB of it reserved
# per block), threads, blocks; registers are allocated per warp in units of
# 256
SM_REGS, SM_SMEM, SM_THREADS, SM_BLOCKS = 65536, 233472, 2048, 32


def sub(t, old, new, count=1):
    assert t.count(old) >= count, old
    return t.replace(old, new)


def design(files):
    """"run": the ray-run kernel (a running composite per thread); "warp":
    one warp per ray."""
    return "run" if "composite_add(" in files[KERNEL] else "warp"


# ---- the one-warp-per-ray kernel: the first sample's x, y, z ride in
# pk[kPackRows .. kPackRows + 2] (K6 compiles with the same header; it is
# not launched here)
FIRST = """  const float first[3] = {
      live ? __ldg(pack + ray_i * S) : 0.0f,
      live ? __ldg(pack + N + ray_i * S) : 0.0f,
      live ? __ldg(pack + 2 * N + ray_i * S) : 0.0f};
  float sigma[SPL], rgb[SPL][3], dist[SPL];"""


def first_sample(files):
    assert design(files) == "warp", "the one-warp-per-ray kernel"
    k = files[KERNEL]
    k = sub(k, "  float sigma[SPL], rgb[SPL][3], dist[SPL];", FIRST)
    k = sub(k, "    float pk[kPackRows];", "    float pk[kPackRows + 3];")
    k = sub(k, "    sigma[j] = 0.0f;",
            "    pk[kPackRows] = first[0];\n"
            "    pk[kPackRows + 1] = first[1];\n"
            "    pk[kPackRows + 2] = first[2];\n    sigma[j] = 0.0f;")
    files[KERNEL] = k


def bcast_line(files):
    first_sample(files)
    files[MULTI] = sub(files[MULTI], "taps(pk[Mode<A>::v], ax.L)",
                       "taps(pk[(A == 0 ? kPackRows : 0) + Mode<A>::v], "
                       "ax.L)", 2)


def bcast_quad(files):
    first_sample(files)
    m = files[MULTI]
    m = sub(m, "taps(pk[Mode<A>::m0], ax.W)",
            "taps(pk[(A > 0 ? kPackRows : 0) + Mode<A>::m0], ax.W)")
    m = sub(m, "taps(pk[Mode<A>::m1], ax.H)",
            "taps(pk[(A > 0 ? kPackRows : 0) + Mode<A>::m1], ax.H)")
    files[MULTI] = m


def notime_branch(files):
    assert design(files) == "warp", "the one-warp-per-ray kernel"
    m = files[MULTI]
    m = sub(m, "if (tt.w0 != 0.0f) {", "{")
    m = sub(m, "if (tt.w1 != 0.0f) {", "{")
    m = sub(m, "ax.line + (int64_t)tt.i0 * ax.L * C",
            "ax.line + (int64_t)max(tt.i0, 0) * ax.L * C")
    m = sub(m, "ax.line + (int64_t)(tt.i0 + 1) * ax.L * C",
            "ax.line + (int64_t)min(tt.i0 + 1, ax.TH - 1) * ax.L * C")
    files[MULTI] = m


SUM_APP = """{
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kApp; ++c) s += app[c];
    rgb[0] = rgb[1] = rgb[2] = s;
  }"""
SIGMA = "  sigma = fmaxf(kWeights ? dsum * wt : dsum, 0.0f);\n"


def nocolour(files):
    """The colour replaced by the sum of the appearance channels, in each
    per-sample body the checkout has (shade_axes, the lane-per-sample
    kernels'; shade_k5_sample, the ray-run kernels')."""
    m = files[MULTI]
    if design(files) == "warp":
        files[MULTI] = sub(
            m, "shade_core::colour<kApp, kRgb>(app, p.wb, pk, ray, rgb);",
            SUM_APP)
        return
    app = SUM_APP.replace("kApp", "L::kApp")
    axes_colour = "shade_core::colour<L::kApp, kRgb>(app, p.wb, pk, ray, rgb);"
    if axes_colour in m:
        m = m.replace(axes_colour, app)
    # shade_k5_sample: the sum, and the colour after it never reached
    i = m.index("void shade_k5_sample(")
    files[MULTI] = m[:i] + sub(m[i:], SIGMA, SIGMA + "  " + app
                               + "\n  return;\n")


def nofold(files):
    """The unfolded colour reads the ray's direction itself: the ray rides
    into shade_k5_sample."""
    assert design(files) == "run", "the ray-run kernel"
    k = files[KERNEL]
    k = sub(k, "sh_fold<kApp>(p.wb, __ldg(ray + 3), __ldg(ray + 4), "
            "__ldg(ray + 5), M);", "")
    k = sub(k, "shade_k5_sample<kTime, kRgb, kWeights>(p, pk, tt,",
            "shade_k5_sample<kTime, kRgb, kWeights>(p, pk, ray, tt,")
    files[KERNEL] = k
    m = files[MULTI]
    m = sub(m, "const float* pk, const shade_core::Taps* tt,",
            "const float* pk, const float* ray,\n"
            "    const shade_core::Taps* tt,")
    m = sub(m, "shade_core::sh_folded_colour<kApp>(app, M, pk, rgb);",
            "shade_core::sh_colour<kApp>(app, p.wb, pk, ray, rgb);")
    files[MULTI] = m


def min_blocks(n):
    """Registers for n blocks of the quad kernel per SM
    (__launch_bounds__)."""
    def patch(files):
        assert design(files) == "run", "the ray-run kernel"
        files[KERNEL] = sub(files[KERNEL], "__launch_bounds__(kThreads, 1)",
                            f"__launch_bounds__(kThreads, {n})")
    return patch


def cap(n):
    """At most n blocks of the quad kernel per SM."""
    def patch(files):
        anchor = ("  if (per_sm < 1) return "
                  "cudaErrorInvalidConfiguration;\n")
        files[KERNEL] = sub(files[KERNEL], anchor,
                            anchor + f"  if (per_sm > {n}) per_sm = {n};\n")
    return patch


def block_prologue(files):
    """K6 with the block prologue (stage_patches) rather than the warp
    one."""
    return "stage_patches<" in files[PATCH]


NOPROLOGUE = """#pragma unroll
  for (int i = 0; i < SPL; ++i) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = pick3(pk[i], ax[a].m0), y = pick3(pk[i], ax[a].m1);
      const float x0 = fminf(fmaxf(floorf(texel(x, ax[a].W)), -1.0f),
                             (float)(ax[a].W - 1));
      const float y0 = fminf(fmaxf(floorf(texel(y, ax[a].H)), -1.0f),
                             (float)(ax[a].H - 1));
      rows[i * 3 + a] = ax[a].ptab + (int64_t)(((int)y0 + 1) *
          (ax[a].W + 1) + ((int)x0 + 1)) * ax[a].vecs;
      u[i * 3 + a] = patch_offset(x, ax[a].W, x0);
      v[i * 3 + a] = patch_offset(y, ax[a].H, y0);
    }
  }"""


def noprologue(files):
    k = files[PATCH]
    if block_prologue(files):
        i = k.index("  stage_patches<")
        j = k.index(");", i) + 2
        k = k[:i] + NOPROLOGUE + k[j:]
        k = sub(k, "const size_t smem = multi_smem_bytes<L>(q);",
                "const size_t smem = 0;")
    else:
        k = sub(k, "span<R>(", "span<1>(", 2)
    files[PATCH] = k


def noscan(files):
    """The warp composites (composite_store and its pair form) replaced by
    a per-lane store of the sample's density, colour and distance."""
    c = files[CORE]
    assert "void composite_store(" in c, "composite_store"
    for name, args in (("composite_store(", "s, S, live"),
                       ("composite_store_pair(", "l, live")):
        i = c.index(f"__device__ __forceinline__ void {name}")
        j = c.index(") {\n", i) + 4
        if name == "composite_store(":
            body = ("  if (store) out[s % 5] = sigma + rgb[0] + rgb[1] + "
                    "rgb[2] + dist;\n  return;\n")
        else:
            body = ("  if (store) out[l % 5] = sigma[0] + sigma[1] + rgb[0] + "
                    "rgb[3] + dist[0] + dist[1];\n  return;\n")
        c = c[:j] + body + c[j:]
    files[CORE] = c


def notime(files):
    """Each axis's second factor: the z taps of its first row."""
    m = files[MULTI]
    n = 0
    if "if (!kTime || ax.TH == 0) {" in m:
        m = m.replace("if (!kTime || ax.TH == 0) {", "if (true) {")
        n += 1
    if "  if constexpr (!kTime) {\n    blend_rows" in m:
        m = m.replace("  if constexpr (!kTime) {\n    blend_rows",
                      "  if constexpr (true) {\n    blend_rows")
        n += 1
    assert n, "the second factors' time branch"
    files[MULTI] = m


def insert_at_body(text, signature, code):
    """text with `code` first in the body of the function whose
    declaration contains `signature`."""
    i = text.index(signature)
    j = text.index(") {\n", i) + 4
    return text[:j] + code + text[j:]


def nofeat(files):
    """No plane features read: K5-pre's rows and K6's taps made from the
    sample's own numbers."""
    files[MULTI] = insert_at_body(
        files[MULTI], "void row_features(",
        "#pragma unroll\n  for (int c = 0; c < C; ++c) feat[c] = 0.125f * "
        "(float)((g + c) & 7);\n  return;\n")
    pc = files[PCORE]
    for name in ("void patch_features(", "void patch_taps("):
        if name in pc:
            pc = insert_at_body(
                pc, name, "#pragma unroll\n  for (int c = 0; c < C; ++c) "
                "feat[c] = u + 0.5f * v + (float)c;\n  return;\n")
    files[PCORE] = pc


def k6_blocks(n):
    """The thread-per-ray K6: registers for n of its blocks of 128 per SM
    (the source: 4; n = 1 leaves ptxas free)."""
    def patch(files):
        assert not block_prologue(files), "the thread-per-ray K6"
        files[PATCH] = sub(files[PATCH], "constexpr int kBlocksPerSm = 4;",
                           f"constexpr int kBlocksPerSm = {n};")
    return patch


VARIANTS = {"base": [], "bcast_line": [bcast_line],
            "bcast_quad": [bcast_quad], "nocolour": [nocolour],
            "notime_branch": [notime_branch], "nofold": [nofold],
            "cap1": [cap(1)], "cap2": [cap(2)], "regs2": [min_blocks(2)],
            "noprologue": [noprologue], "noscan": [noscan],
            "notime": [notime], "nofeat": [nofeat],
            "pr_regs1": [k6_blocks(1)], "pr_regs2": [k6_blocks(2)],
            "pr_regs3": [k6_blocks(3)]}


def ptxas_stats(log):
    """{(kernel, template arguments): (registers, spill stores, spill loads,
    static shared memory bytes)} of the multi-axis kernels from the
    compilers' -Xptxas -v output; the template arguments are the mangled
    int and bool tokens after the layout's six (K6: R[, SPL], kTime,
    kRgb; K5-pre: [SPL,] kTime, kRgb)."""
    stats, key, src = {}, None, ""
    for line in log.splitlines():
        if line.startswith("== "):
            src = line
        if KERNEL not in src and PATCH not in src:
            continue
        m = re.search(r"(shade_multi(?:_pre|_patch)?_kernel)I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            toks = re.findall(r"L[ib](\d+)E", m[2])
            key = (m[1], tuple(int(x) for x in toks[6:]))
            stats[key] = [0, 0, 0, 0]
        elif key and "bytes spill stores" in line:
            n = re.findall(r"(\d+) bytes", line)
            stats[key][1:3] = [int(n[1]), int(n[2])]
        elif key and "Used" in line and "registers" in line:
            stats[key][0] = int(re.search(r"Used (\d+) registers", line)[1])
            sm = re.search(r"(\d+) bytes smem", line)
            stats[key][3] = int(sm[1]) if sm else 0
    return stats


def blocks_per_sm(regs, smem, threads):
    """Blocks of `threads` threads with `regs` registers per thread and
    `smem` bytes of shared memory (static and dynamic) that fit on one SM
    of the H100."""
    warps = (threads + 31) // 32
    per_warp = (regs * 32 + 255) // 256 * 256
    by_regs = (SM_REGS // per_warp) // warps if per_warp else SM_BLOCKS
    by_smem = SM_SMEM // (smem + 1024)
    return min(by_regs, by_smem, SM_THREADS // threads, SM_BLOCKS)


def build_variant(name):
    """Build the variant's library; returns it, or None where its anchors
    are not in this checkout's source or it does not build."""
    vd = ROOT / "build" / "variants" / name
    shutil.rmtree(vd, ignore_errors=True)
    csrc0 = build.CSRC
    shutil.copytree(csrc0, vd / "csrc")
    files = {f: (vd / "csrc" / f).read_text() for f in FILES}
    threads = 256 if block_prologue(files) else 128
    try:
        for f in VARIANTS[name]:
            f(files)
    except (AssertionError, ValueError) as e:
        print(f"== {name}: not a variant of this source (anchor {e})",
              flush=True)
        return None
    for f, t in files.items():
        (vd / "csrc" / f).write_text(t)
    build.CSRC, build.BUILD_DIR, build._LOADED = (vd / "csrc", vd / "build",
                                                  None)
    t0 = time.time()
    try:
        lib = build.load_library()
    except RuntimeError as e:
        print(f"== {name}: BUILD FAILED", str(e)[-3000:], flush=True)
        return None
    finally:
        build.CSRC = csrc0
    lib.stats = ptxas_stats(lib.compiler_log)
    lib.threads = {"shade_multi_patch_kernel": threads,
                   "shade_multi_pre_kernel": 128}
    lib.block_prologue = block_prologue(files)
    for (fn, args), (regs, st, ld, smem) in sorted(lib.stats.items()):
        print(f"== {name}: {fn}<{', '.join(map(str, args))}>: {regs} "
              f"registers, {st} / {ld} bytes spill stores / loads, {smem} "
              f"bytes static shared memory", flush=True)
    print(f"== {name}: built in {time.time() - t0:.1f} s", flush=True)
    return lib


def k6_smem(pspec, S):
    """The dynamic shared memory of a K6 launch with the block prologue
    (csrc/patch_core.cuh smem_bytes at the [8, 4, 4] layout)."""
    spl = S // 32 if S > 32 else 1
    slots = 256 * spl // pspec.R
    rows = sum((pspec.px * pspec.py * c // 8) | 1 for c in (16, 8, 8))
    return slots * rows * 16 + 256 * spl * 16 + 3 * slots * 12 + 16


def occupancy(lib, kern, S, timed, rgb, pspec=None):
    """'<regs> registers, <spills>, <smem> bytes of shared memory, <n>
    blocks of <t> per SM' of the instantiation that a launch takes."""
    spl = 2 if S > 32 else 1
    for (fn, args), (regs, st, ld, smem) in lib.stats.items():
        if fn != kern or args[-2:] != (int(timed), int(rgb)):
            continue
        rest = args[:-2]
        if kern == "shade_multi_patch_kernel" and rest[0] != pspec.R:
            continue
        if len(rest) > (kern == "shade_multi_patch_kernel") \
                and rest[-1] != spl:
            continue
        dyn = k6_smem(pspec, S) if pspec is not None \
            and lib.block_prologue else 0
        t = lib.threads[kern]
        return (f"{regs} registers, spills {st}/{ld} bytes, "
                f"{smem + dyn} bytes of shared memory, "
                f"{blocks_per_sm(regs, smem + dyn, t)} blocks of {t} per SM")
    return "instantiation not found"


def chunks(dev):
    """[(name, kernel, plain)]: K5 on the first bench chunk of llff,
    n3d (on its time planes with the frame's t, premixed, and with a t per
    ray spread over all the keyframes) and shiny, K5-preblended on K4's
    features of the same chunks in phase-major order (R=8)."""
    ctx = StepCtx(it=cs.IT)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    out = []
    for fam in ("llff", "n3d", "shiny"):
        if fam != "n3d":
            model, params, prep = cs.static_model(dev, fam,
                                                  patch=cs.PATCH_R8)[1:]
            chunk, R = frame[0, :, :6].contiguous(), cs.PATCH_R8[2]
        else:
            model, params, prep = cs.n3d(dev, patch=cs.N3D_PATCH_R8)[1:]
            chunk, R = frame[0], cs.N3D_PATCH_R8[2]
        cf = model._cf_eval

        def packed(c):
            rp = cf.ray_pack(c)
            return pack_build(cf.pred.net_input(c, ctx).float().contiguous(),
                              prep["mlp"], rp, cf.spec, cs.IT), rp
        pack, rp = packed(chunk)
        spec = MultiSpec(S=cf.S, axes=prep["axes"], deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale,
                         shading=cf.net.shading)
        quads, wb = prep["quads"], prep["wb"]
        runs = [(fam, prep["lines"], spec, rp)]
        if fam == "n3d":
            # the frame's one t, premixed, and a t per ray spread over all
            # the keyframes
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            rp_spread = rp.clone()
            rp_spread[:, 7] = 2.0 * torch.rand(rp.shape[0], device=dev,
                                               generator=gen) - 1.0
            runs = [("n3d TH=12", prep["lines"], spec, rp), (
                "n3d premixed", [premix_time(t, rp[0, 7])
                                 for t in prep["lines"]],
                dataclasses.replace(spec, axes=tuple(
                    dataclasses.replace(a, TH=0) for a in spec.axes)), rp),
                ("n3d TH=12 t spread", prep["lines"], spec, rp_spread)]
        for name, lines, sp, r in runs:
            args = (quads, lines, pack, r, wb, sp)
            out.append((f"K5 {name}", functools.partial(shade_multi, *args),
                        functools.partial(shade_multi_plain, *args)))
        pack_pm, rp_pm = packed(cs.phase_major(chunk[None], R)[0]
                                .contiguous())
        feats, _ = blend_planes(prep["ptabs"], pack_pm, cf.patch_specs(
            [(a.W, a.H, a.C, a.m0, a.m1) for a in spec.axes], True))
        args = (feats, prep["lines"], pack_pm, rp_pm, wb, spec)
        out.append((f"K5-pre {runs[0][0]}",
                    functools.partial(shade_multi_preblended, *args),
                    functools.partial(shade_multi_preblended_plain, *args)))
        del model, params
    return out


def patch_chunks(dev):
    """[(name, kernel, plain, occupancy key)]: K5-preblended on K4's
    features and K6 on the llff and shiny chunks (phase-major, R=8 (5, 2))
    and the n3d chunk (phase-major, R=8 (5, 3); K6 also at R=4 (4, 3) on
    the scanline chunk, as chip_smoke.py times them)."""
    ctx = StepCtx(it=cs.IT)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    out = []
    for fam in ("llff", "shiny", "n3d"):
        if fam != "n3d":
            _, model, params, prep = cs.static_model(dev, fam,
                                                     patch=cs.PATCH_R8)
            shapes = [(cs.PATCH_R8, True, model, prep)]
            frame_f = frame[..., :6]
        else:
            _, model, params, prep = cs.n3d(dev, patch=cs.N3D_PATCH_R8)
            _, m4, _, p4 = cs.n3d(dev, patch=cs.N3D_PATCH_R4, params=params)
            shapes = [(cs.N3D_PATCH_R8, True, model, prep),
                      (cs.N3D_PATCH_R4, False, m4, p4)]
            frame_f = frame
        cf = model._cf_eval
        spec = MultiSpec(S=cf.S, axes=prep["axes"], deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale,
                         shading=cf.net.shading)
        timed = any(a.TH for a in spec.axes)
        rgb = spec.shading == "rgb"
        for shape, pm, m, pr in shapes:
            R = shape[2]
            chunk = (cs.phase_major(frame_f[:1], R)[0] if pm
                     else frame_f[0]).contiguous()
            rp = cf.ray_pack(chunk)
            pack = pack_build(cf.pred.net_input(chunk, ctx).float()
                              .contiguous(), prep["mlp"], rp, cf.spec, cs.IT)
            pspecs = m._cf_eval.patch_specs(
                [(a.W, a.H, a.C, a.m0, a.m1) for a in spec.axes], pm)
            tag = f"{fam} R={R} ({shape[0]},{shape[1]})"
            if pm and R == 8:
                feats, _ = blend_planes(pr["ptabs"], pack, pspecs)
                args = (feats, pr["lines"], pack, rp, pr["wb"], spec)
                out.append((f"K5-pre {tag}",
                            functools.partial(shade_multi_preblended, *args),
                            functools.partial(shade_multi_preblended_plain,
                                              *args),
                            ("shade_multi_pre_kernel", cf.S, timed, rgb,
                             None)))
            args = (pr["ptabs"], pr["lines"], pack, rp, pr["wb"], spec,
                    pspecs)
            out.append((f"K6 {tag}" + ("" if pm else " scanline"),
                        lambda a=args: shade_multi_patch(*a)[0],
                        lambda a=args: shade_multi_patch_plain(*a)[0],
                        ("shade_multi_patch_kernel", cf.S, timed, rgb,
                         pspecs[0])))
        del model, params
    return out


def main():
    args = sys.argv[1:]
    patch = "--patch" in args
    names = [a for a in args if a != "--patch"] or list(VARIANTS)
    if not torch.cuda.is_available():
        raise RuntimeError("k5_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    bdir0 = build.BUILD_DIR
    libs = {}
    for name in names:
        lib = build_variant(name)
        if lib is not None:
            libs[name] = lib
    build.BUILD_DIR = bdir0
    items = patch_chunks(dev) if patch else [
        (*c, None) for c in chunks(dev)]
    for cname, kernel, plain, occ in items:
        ref = plain()
        for rnd in range(2):
            for name, lib in libs.items():
                build._LOADED = lib
                out = kernel()
                torch.cuda.synchronize()
                err = (out[:, :4] - ref[:, :4]).abs().max().item()
                ms = cs.cuda_ms(torch, kernel, 20)
                where = f"; {occupancy(lib, *occ)}" if occ and rnd == 0 \
                    else ""
                print(f"round {rnd} {name}: {cname} {ms:.4f} ms, err "
                      f"{err:.2e}{where}", flush=True)
        del ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
