"""K2 (shade) and K2-preblended built as text-patched variants of a
checkout's csrc/shade.cu and csrc/shade_core.cuh, on one NVIDIA GPU:
ptxas's registers and spills of each variant's shade kernels, and their
times on chip_smoke.py's flagship chunks, the variants in turns (CUDA
events over 20 launches, twice), with the error against the plain version
(meaningless for the variants that change what is computed):
  - K2 on the first bench chunk (scanline order), the time plane premixed
    for the frame's t (TH = 0, the quad route's) and on the time plane
    itself (TH = 4); and with RGB colour and the weights row (a seeded
    [3, C] basis and weights row in [0, 2), as scripts/compare_trees.py
    makes them);
  - K2-preblended on K4's features of the first chunk in phase-major order
    at R=8 (5, 2), the two-kernel patch route's.

Run from the root of the checkout whose kernels are measured (its
chip_smoke.py and hyperreel_tpu_torch are the ones imported):

    python3 /path/to/scripts/k2_variants.py [base] [nocolour] ...

Variants of the lane-per-sample kernel (one S-lane segment of a warp per
ray, the composite a warp scan):
  base      the source as it is;
  nocolour  the colour replaced by the sum of the features (no SH basis,
            no basis product);
  noscan    the composite (scan and butterfly) replaced by a per-lane
            store of the sample's density, colour and distance;
  notime    no time taps: the time features all 1;
  regs_cap  registers capped for 4 blocks of 128 threads per SM
            (__launch_bounds__(128, 4), at most 128).
Variants of the thread-per-ray kernel:
  base, nocolour, notime as above;
  nofold    each sample's SH colour from the unfolded [27, C] basis
            product (shade_core.cuh sh_colour), no fold per ray;
  fullfold  the SH basis folded over all C channels, not only the
            appearance half;
  stage4    the pack tiles staged 4 samples at a time (16 bytes per ray
            and row);
  nofeat    no space features loaded (neither quad rows nor feature
            rows): the features made from the sample's xn, yn, zn;
  preload   K2-pre: each sample's feature row loaded before the validity
            test, for every sample of a live ray (so that the loads of a
            stage's samples may issue ahead of the shading);
  regs_free, regs3  registers as many as ptxas takes, or for 3 blocks of
            128 threads per SM (the source: 4, at most 128);
  rolled    its loop over a stage's samples not unrolled.
Each variant builds into build/variants/<name>/ (git-ignored); ctypes
keeps the libraries' symbols apart. A variant whose anchor is not in the
checkout's source is skipped with a note.
"""

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
from hyperreel_tpu_torch.ops.kernels.shade import (  # noqa: E402
    ShadeSpec, premix_time, shade, shade_plain, shade_preblended,
    shade_preblended_plain)

KERNEL, CORE = "shade.cu", "shade_core.cuh"


def sub(t, old, new, count=1):
    assert t.count(old) >= count, old
    return t.replace(old, new)


def redesigned(files):
    """The thread-per-ray kernel: no warp composite in shade.cu."""
    return "composite_store" not in files[KERNEL]


SUM = """{
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) s += feat[c];
    rgb[0] = rgb[1] = rgb[2] = s;
  }"""


def nocolour(files):
    if redesigned(files):
        k = files[KERNEL]
        k = sub(k, "rgb_colour<C>(feat, p.wb, pk, rgb);", SUM)
        k = sub(k, "sh_folded_colour<A>(feat + F, M, pk, rgb);", SUM)
        files[KERNEL] = k
        return
    files[CORE] = sub(files[CORE], "  colour<C, kRgb>(feat, p.wb, pk, ray, "
                      "rgb);", "  " + SUM)


def noscan(files):
    assert not redesigned(files), "the warp composite"
    files[KERNEL] = sub(
        files[KERNEL],
        "  composite_store(sigma, rgb, pk[3], p.distance_scale, s, S, live,\n"
        "                  out + (live ? g / S : 0) * 5);",
        "  if (live) {\n"
        "    out[(g / S) * 5 + s % 5] = sigma + rgb[0] + rgb[1] + rgb[2] +"
        " pk[3];\n  }")


def notime(files):
    files[CORE] = sub(files[CORE],
                      "  if (p.TH == 0) {\n    z_blend<C>(ft, ttab, tz);",
                      "  if (p.TH >= 0) {\n#pragma unroll\n"
                      "    for (int c = 0; c < C; ++c) ft[c] = 1.0f;")


def regs_cap(files):
    assert not redesigned(files), "the lane-per-sample kernel"
    files[KERNEL] = sub(files[KERNEL], "__global__ void shade_kernel(",
                        "__global__ void __launch_bounds__(128, 4) "
                        "shade_kernel(")


def nofold(files):
    assert redesigned(files), "the thread-per-ray kernel"
    k = files[KERNEL]
    k = sub(k, "sh_folded_colour<A>(feat + F, M, pk, rgb);",
            "sh_colour<C, kAnyDeg>(feat, p.wb, p.nb, pk, ray, rgb);")
    k = sub(k, "    sh_fold<A, C, kAnyDeg>(p.wb + F, p.nb, __ldg(ray + 3), "
            "__ldg(ray + 4),\n                           __ldg(ray + 5), M);"
            "\n", "")
    files[KERNEL] = k


def fullfold(files):
    assert redesigned(files), "the thread-per-ray kernel"
    files[KERNEL] = sub(files[KERNEL], "if (zero_columns(p, C, C / 2)) {",
                        "if (false) {")


def stage(n):
    def patch(files):
        assert redesigned(files), "the thread-per-ray kernel"
        files[KERNEL] = sub(files[KERNEL], "constexpr int kStageS = 8;",
                            f"constexpr int kStageS = {n};")
    return patch


FEATURES = "space_features<C, kPre>(space, pk, p, b * S + s0 + j, feat);"


def nofeat(files):
    assert redesigned(files), "the thread-per-ray kernel"
    files[KERNEL] = sub(files[KERNEL], FEATURES, """#pragma unroll
        for (int c = 0; c < C; ++c) feat[c] = 0.5f + 0.5f * pk[c % 3];""")


def preload(files):
    assert redesigned(files), "the thread-per-ray kernel"
    files[KERNEL] = sub(
        files[KERNEL],
        "      if (live && sample_valid(pk)) {\n"
        "        float feat[C];\n        " + FEATURES,
        "      float feat[C];\n"
        "      if constexpr (kPre) {\n        " + FEATURES + "\n      }\n"
        "      if (live && sample_valid(pk)) {\n"
        "        if constexpr (!kPre) {\n          " + FEATURES + "\n"
        "        }")


def min_blocks(n):
    def patch(files):
        assert redesigned(files), "the thread-per-ray kernel"
        files[KERNEL] = sub(files[KERNEL], "constexpr int kBlocksPerSm = 4;",
                            f"constexpr int kBlocksPerSm = {n};")
    return patch


def rolled(files):
    assert redesigned(files), "the thread-per-ray kernel"
    files[KERNEL] = sub(files[KERNEL],
                        "    for (int j = 0; j < stage; ++j) {",
                        "#pragma unroll 1\n"
                        "    for (int j = 0; j < stage; ++j) {")


VARIANTS = {"base": [], "nocolour": [nocolour], "noscan": [noscan],
            "notime": [notime], "regs_cap": [regs_cap], "nofold": [nofold],
            "fullfold": [fullfold], "stage4": [stage(4)],
            "nofeat": [nofeat], "preload": [preload],
            "regs_free": [min_blocks(1)], "regs3": [min_blocks(3)],
            "rolled": [rolled]}


def build_variant(name):
    """Build the variant's library; returns it, or None where its anchors
    are not in this checkout's source or it does not build."""
    vd = ROOT / "build" / "variants" / name
    shutil.rmtree(vd, ignore_errors=True)
    csrc0 = build.CSRC
    shutil.copytree(csrc0, vd / "csrc")
    files = {f: (vd / "csrc" / f).read_text() for f in (KERNEL, CORE)}
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
        if "shade.cu" not in src:
            continue
        m = re.search(r"\d(shade_kernel)I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            fn = f"{m[1]}<{m[2]}>"
        elif "registers" in line or "spill" in line:
            print(f"== {name}: {fn}: {line.strip()}")
    print(f"== {name}: built in {time.time() - t0:.1f} s", flush=True)
    return lib


def err(got, ref):
    return (got[:, :4] - ref[:, :4]).abs().max().item()


def chunks(dev):
    """[(name, kernel, plain)] on chip_smoke.py's flagship chunks."""
    ctx = StepCtx(it=cs.IT)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    out = []

    def packed(cf, prep, c):
        rp = cf.ray_pack(c)
        return pack_build(cf.pred.net_input(c, ctx).float().contiguous(),
                          prep["mlp"], rp, cf.spec, cs.IT), rp

    cfg, info, model, params, prep = cs.flagship(dev)
    cf = model._cf_eval
    H, W, TH, TW, C, nd = prep["dims"]
    pack, rp = packed(cf, prep, frame[0])
    for th in (0, TH):
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        ttab = prep["ttab"] if th else premix_time(prep["ttab"], rp[0, 7])
        args = (prep["quad"], pack, rp, ttab, prep["wb"], spec)
        out.append((f"K2 flagship TH={th}", functools.partial(shade, *args),
                    functools.partial(shade_plain, *args)))
    gen = torch.Generator().manual_seed(cs.SEED)
    wb_rgb = torch.cat([torch.zeros(3, nd),
                        torch.randn(3, C - nd, generator=gen)], 1)
    pack_w = torch.cat([pack, 2.0 * torch.rand(
        1, pack.shape[1], generator=gen).to(dev)]).contiguous()
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd, deg=2,
                     distance_scale=cf.net.distance_scale, shading="rgb",
                     weights=True)
    args = (prep["quad"], pack_w, rp, premix_time(prep["ttab"], rp[0, 7]),
            wb_rgb, spec)
    out.append(("K2 flagship RGB+weights", functools.partial(shade, *args),
                functools.partial(shade_plain, *args)))
    model8, prep8 = cs.patch_model(cfg, info, params, cs.PATCH_R8)
    cf = model8._cf_eval
    pack_pm, rp_pm = packed(
        cf, prep8, cs.phase_major(frame, cs.PATCH_R8[2])[0].contiguous())
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                     deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    ps, = cf.patch_specs([(W, H, C, 0, 1)], True)
    (feats,), _ = blend_planes([prep8["patch"]], pack_pm, [ps])
    args = (feats, pack_pm, rp_pm, premix_time(prep8["ttab"], rp_pm[0, 7]),
            prep8["wb"], spec)
    out.append(("K2-pre flagship R=8 (5,2)",
                functools.partial(shade_preblended, *args),
                functools.partial(shade_preblended_plain, *args)))
    return out


def main():
    names = sys.argv[1:] or list(VARIANTS)
    if not torch.cuda.is_available():
        raise RuntimeError("k2_variants needs a CUDA card")
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
    for cname, kernel, plain in chunks(dev):
        ref = plain()
        for rnd in range(2):
            for name, lib in libs.items():
                build._LOADED = lib
                e = err(kernel(), ref)
                torch.cuda.synchronize()
                ms = cs.cuda_ms(torch, kernel, 20)
                print(f"round {rnd} {name}: {cname} {ms:.4f} ms, err "
                      f"{e:.2e}", flush=True)
        del ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
