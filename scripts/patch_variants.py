"""K3 (fused patch shade) and K4 (patch blend) built as text-patched
variants of a checkout's csrc/, on one NVIDIA GPU: ptxas's registers and
spills of each variant's patch kernels, and their times on chip_smoke.py's
chunks, the variants in turns (CUDA events over 20 launches, twice), with
the error against the plain version (meaningless for the variants that
change what is computed):
  - K3 and K4 on the flagship's first bench chunk in phase-major order at
    R=8 (5, 2), the bench's route;
  - K4 over the three planes of llff_z_plane's and shiny_z_plane's chunk
    at R=8 (5, 2) and of neural_3d_z_plane's at R=8 (5, 3); where the
    checkout's K4 takes every plane in one launch, also one launch per
    plane (the route before that kernel).

Run from the root of the checkout whose kernels are measured (its
chip_smoke.py and hyperreel_tpu_torch are the ones imported):

    python3 /path/to/scripts/patch_variants.py [base] [nostage] ...

Variants of the kernels with a block-wide prologue (patch_core.cuh
stage_patches: anchors through shared memory, each slot's patch row
staged in shared memory behind three barriers):
  base      the source as it is;
  nostage   the taps read straight from the patch table through L1, no
            row staged (and no shared memory reserved for the rows);
  noanchor  each slot's anchor taken from its first ray: no min over the R
            rays and no coverage test;
  nowrite   K4: the features computed but not stored;
  nocolour  K3: the colour replaced by the sum of the features (no SH
            basis, no basis product).
Variants of the redesigned kernels (K4 over every plane of a chunk with
the anchors by warp shuffles; K3 a thread per ray over its samples):
  base, nowrite, nocolour as above;
  noanchor  each slot's anchor from the lane's own sample: no shuffles, no
            coverage test;
  nofold    K3: each sample's SH colour from the unfolded [27, C] basis
            product (shade_core.cuh sh_colour), no fold per ray;
  regs_free, regs3, regs5  K3: registers as many as ptxas takes, or for 3
            or 5 of its blocks of 128 threads per SM (at most 168 or 102;
            the source: 4, at most 128);
  rolled    K3: its loop over the 4 staged samples not unrolled;
  stage4, stage16  K3: the pack tiles staged 4 samples at a time (16
            bytes per ray and row, as K5 does), or 16 in blocks of 64
            threads;
  carve     K3: the L1/shared carve-out at 62 % (3 blocks' tiles);
  skip_taps K3, K4: the taps outside the patch skipped by branches
            instead of clamped with a weight of 0.
Each variant builds into build/variants/<name>/ (git-ignored); ctypes
keeps the libraries' symbols apart. A variant whose anchor is not in the
checkout's source is skipped with a note.
"""

import functools
import inspect
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
from hyperreel_tpu_torch.ops.kernels import patch_blend as K4  # noqa: E402
from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build  # noqa: E402
from hyperreel_tpu_torch.ops.kernels.shade import (  # noqa: E402
    ShadeSpec, premix_time)
from hyperreel_tpu_torch.ops.kernels.shade_patch import (  # noqa: E402
    shade_patch, shade_patch_plain)

CORE, BLEND, FUSED, SHADE = ("patch_core.cuh", "patch_blend.cu",
                             "shade_patch.cuh", "shade_core.cuh")
# K4 over every plane of a chunk in one call (the redesigned wrapper)
ALL_PLANES = "ptabs" in inspect.signature(K4.patch_blend).parameters
blend_plain = functools.partial(blend_planes, plain=True)


def sub(t, old, new, count=1):
    assert t.count(old) >= count, old
    return t.replace(old, new)


def redesigned(files):
    """The redesigned kernels: no block-wide prologue in K4."""
    return "stage_patches" not in files[BLEND]


def nostage(files):
    assert not redesigned(files), "the block-wide prologue"
    c = files[CORE]
    c = sub(c, "return (size_t)block_slots(R, SPL) * rows * 16 +",
            "return (size_t)0 * rows * 16 +")
    c = sub(c, "off += (size_t)slots * row_stride(ax[a].vecs);", "")
    c = sub(c, "for (int i = tid; i < slots * rv; i += kPatchThreads) {",
            "for (int i = tid; i < 0; i += kPatchThreads) {")
    c = sub(c, "rows[i * NA + a] = smem + row_off[a] + slot * "
            "row_stride(ax[a].vecs);",
            "rows[i * NA + a] = ax[a].ptab + (int64_t)sidx[a * slots + slot] "
            "* ax[a].vecs;")
    files[CORE] = c


def noanchor(files):
    if redesigned(files):
        files[CORE] = sub(files[CORE], "const int kLanes = R;",
                          "const int kLanes = 1;")
        return
    files[CORE] = sub(files[CORE], "for (int r = 0; r < R; ++r) {",
                      "for (int r = 0; r < 1; ++r) {")


def nowrite(files):
    files[BLEND] = sub(files[BLEND], "    if (row >= 0) {\n      feats[",
                       "    if (row >= 0 && pl.W < 0) {\n      feats[") \
        if redesigned(files) else sub(files[BLEND], "dst[k] = make_uint4(",
                                      "if (f[0] == -1234.5f) dst[k] = "
                                      "make_uint4(")


SUM = """{
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += feat[c];
    rgb[0] = rgb[1] = rgb[2] = s;
  }"""


def nocolour(files):
    if redesigned(files):
        files[FUSED] = sub(files[FUSED], "patch_colour<C, kRgb>(feat, M, "
                           "p.wb, pk, rgb);", SUM)
        return
    files[SHADE] = sub(files[SHADE], "  colour<C, kRgb>(feat, p.wb, pk, ray, "
                       "rgb);", "  " + SUM)


def nofold(files):
    assert redesigned(files), "the ray-run K3"
    k = files[FUSED]
    k = sub(k, "patch_colour<C, kRgb>(feat, M, p.wb, pk, rgb);",
            "colour<C, kRgb, kAnyDeg>(feat, p.wb, p.nb, pk, ray, rgb);")
    k = sub(k, "sh_fold<C / 2, C, kAnyDeg>(p.wb + C / 2, p.nb, "
            "__ldg(ray + 3),\n                               __ldg(ray + 4), "
            "__ldg(ray + 5), M);", "")
    files[FUSED] = k


def min_blocks(n):
    """K3: registers for n of its blocks per SM (__launch_bounds__; n = 1:
    as many as ptxas takes)."""
    def patch(files):
        assert redesigned(files), "the ray-run K3"
        files[FUSED] = sub(files[FUSED], "constexpr int kBlocksPerSm = 4;",
                           f"constexpr int kBlocksPerSm = {n};")
    return patch


def rolled(files):
    """K3: its loop over a stage's samples not unrolled."""
    assert redesigned(files), "the ray-run K3"
    files[FUSED] = sub(files[FUSED],
                       "    for (int j = 0; j < stage; ++j) {",
                       "#pragma unroll 1\n"
                       "    for (int j = 0; j < stage; ++j) {")


def stage(n, threads=128):
    """K3: its pack tiles staged n samples at a time, in blocks of
    `threads` threads."""
    def patch(files):
        assert redesigned(files), "the ray-run K3"
        k = files[FUSED]
        k = sub(k, "constexpr int kStageS = 8;", f"constexpr int kStageS = {n};")
        k = sub(k, "constexpr int kThreads = 128;",
                f"constexpr int kThreads = {threads};")
        files[FUSED] = k
    return patch


def skip_taps(files):
    """K3, K4: the taps of patch_core.cuh patch_taps that leave the patch
    skipped by branches (as the block-prologue K6's blend did), instead of
    clamped with a weight of 0."""
    assert redesigned(files), "patch_taps"
    c = files[CORE]
    i = c.index("__device__ __forceinline__ void patch_taps(")
    j = c.index("}\n\n", c.index("  for (int dy = 0; dy < 2; ++dy) {", i))
    files[CORE] = c[:i] + """__device__ __forceinline__ void patch_taps(const uint4* __restrict__ row,
                                           float u, float v, int px, int py,
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
        shade_core::axpy_bf16x8(feat + 8 * k, w, __ldg(tex + k));
      }
    }
  }
""" + c[j:]


def carve(files):
    """K3: the L1/shared carve-out at 62 %, the least that holds three of
    its blocks, the rest left to L1."""
    assert redesigned(files), "the ray-run K3"
    anchor = "  const unsigned blocks = (unsigned)((q.B + kThreads - 1) / kThreads);\n"
    files[FUSED] = sub(files[FUSED], anchor, anchor + (
        "  cudaFuncSetAttribute(shade_patch_kernel<C, R, true>,\n"
        "      cudaFuncAttributePreferredSharedMemoryCarveout, 62);\n"
        "  cudaFuncSetAttribute(shade_patch_kernel<C, R, false>,\n"
        "      cudaFuncAttributePreferredSharedMemoryCarveout, 62);\n"))


VARIANTS = {"base": [], "nostage": [nostage], "noanchor": [noanchor],
            "nowrite": [nowrite], "nocolour": [nocolour],
            "nofold": [nofold], "regs_free": [min_blocks(1)],
            "regs3": [min_blocks(3)], "regs5": [min_blocks(5)],
            "rolled": [rolled],
            "stage4": [stage(4)], "stage16": [stage(16, 64)],
            "carve": [carve], "skip_taps": [skip_taps]}


def build_variant(name):
    """Build the variant's library; returns it, or None where its anchors
    are not in this checkout's source or it does not build."""
    vd = ROOT / "build" / "variants" / name
    shutil.rmtree(vd, ignore_errors=True)
    csrc0 = build.CSRC
    shutil.copytree(csrc0, vd / "csrc")
    files = {f: (vd / "csrc" / f).read_text()
             for f in (CORE, BLEND, FUSED, SHADE)
             if (vd / "csrc" / f).exists()}
    try:
        for f in VARIANTS[name]:
            f(files)
    except AssertionError as e:
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
    src, fn = "", ""
    for line in lib.compiler_log.splitlines():
        if line.startswith("== "):
            src = line
        if "patch_blend" not in src and "shade_patch" not in src:
            continue
        m = re.search(r"\d([a-z_]+_kernel)I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            fn = f"{m[1]}<{m[2]}>"
        elif "registers" in line or "spill" in line:
            print(f"== {name}: {fn}: {line.strip()}")
    print(f"== {name}: built in {time.time() - t0:.1f} s", flush=True)
    return lib


def k4_err(got, ref):
    """The largest |difference| of the features, and whether the counts
    agree."""
    (f, v), (fp, vp) = got, ref
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(f, fp)), int(v) == int(vp)


def chunks(dev):
    """[(name, kernel, plain, err)] on chip_smoke.py's chunks."""
    ctx = StepCtx(it=cs.IT)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    out = []

    def packed(cf, prep, c):
        rp = cf.ray_pack(c)
        return pack_build(cf.pred.net_input(c, ctx).float().contiguous(),
                          prep["mlp"], rp, cf.spec, cs.IT), rp

    cfg, info, _, params, prep = cs.flagship(dev)
    model8, prep8 = cs.patch_model(cfg, info, params, cs.PATCH_R8)
    cf = model8._cf_eval
    chunk_pm = cs.phase_major(frame, cs.PATCH_R8[2])[0].contiguous()
    pack, rp = packed(cf, prep8, chunk_pm)
    H, W, TH, TW, C, nd = prep8["dims"]
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                     deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    ps, = cf.patch_specs([(W, H, C, 0, 1)], True)
    args = (prep8["patch"], pack, rp, premix_time(prep8["ttab"], rp[0, 7]),
            prep8["wb"], spec, ps)

    def k3_err(got, ref):
        return ((got[0][:, :4] - ref[0][:, :4]).abs().max().item(),
                int(got[1]) == int(ref[1]))
    out.append(("K3 flagship R=8 (5,2)", functools.partial(shade_patch, *args),
                functools.partial(shade_patch_plain, *args), k3_err))
    b1 = ([prep8["patch"]], pack, [ps])
    out.append(("K4 flagship R=8 (5,2)", functools.partial(blend_planes, *b1),
                functools.partial(blend_plain, *b1), k4_err))
    del model8, params
    for fam, shape in (("llff", cs.PATCH_R8), ("shiny", cs.PATCH_R8),
                       ("n3d", cs.N3D_PATCH_R8)):
        if fam == "n3d":
            model, params, prep = cs.n3d(dev, patch=shape)[1:]
            chunk = frame[0]
        else:
            model, params, prep = cs.static_model(dev, fam, patch=shape)[1:]
            chunk = frame[0, :, :6].contiguous()
        cf = model._cf_eval
        pack, _ = packed(cf, prep, cs.phase_major(chunk[None], shape[2])[0]
                         .contiguous())
        specs = cf.patch_specs([(a.W, a.H, a.C, a.m0, a.m1)
                                for a in prep["axes"]], True)
        b3 = (prep["ptabs"], pack, specs)
        out.append((f"K4 x3 {fam} R={shape[2]} {shape[:2]}",
                    functools.partial(blend_planes, *b3),
                    functools.partial(blend_plain, *b3), k4_err))
        if ALL_PLANES:
            def per_plane(ptabs=prep["ptabs"], pack=pack, specs=specs):
                got = [K4.patch_blend([t], pack, [s])
                       for t, s in zip(ptabs, specs)]
                return [g[0][0] for g in got], got[0][1]
            out.append((f"K4 one launch per plane {fam}", per_plane,
                        functools.partial(blend_plain, *b3),
                        lambda g, r: (k4_err(g, r)[0], None)))
        del model, params
    return out


def main():
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        raise RuntimeError("patch_variants needs a CUDA card")
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
    for cname, kernel, plain, err in chunks(dev):
        ref = plain()
        for rnd in range(2):
            for name, lib in libs.items():
                build._LOADED = lib
                got = kernel()
                torch.cuda.synchronize()
                e, same = err(got, ref)
                ms = cs.cuda_ms(torch, kernel, 20)
                print(f"round {rnd} {name}: {cname} {ms:.4f} ms, err "
                      f"{e:.2e}, counts equal {same}", flush=True)
        del ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
