"""K5 (multi-axis shade) built as text-patched variants of a checkout's
csrc/, on one NVIDIA GPU: ptxas's registers and spills of each variant's
K5 instantiations, and the time of K5 on chip_smoke.py's llff_z_plane,
shiny_z_plane and neural_3d_z_plane chunks (n3d on the time planes, TH =
12, with the frame's t and with a t per ray spread over the keyframes, and
on the planes premixed for the frame's t) and of K5-preblended on K4's
features of the same chunks in phase-major order (R = 8), the variants in
turns (CUDA events over 20 launches, twice), with the error against the
plain version (meaningless for the variants that change what is read).

Run from the root of the checkout whose kernel is measured (its
chip_smoke.py and hyperreel_tpu_torch are the ones imported):

    python3 /path/to/scripts/k5_variants.py [base] [bcast_line] ...

Variants of the one-warp-per-ray kernel (a lane per sample):
  base           the source as it is;
  bcast_line     axis 0's z line read at the ray's first sample's row (every
                 lane of the ray on one row);
  bcast_quad     the quad rows of axes 1 and 2 (the xz and yz planes) read
                 at the ray's first sample's (x, z) and (y, z);
  nocolour       the colour replaced by the sum of the appearance channels;
  notime_branch  both keyframe rows of a time plane always read (their
                 indices clamped), without the `w != 0` branches.
Variants of the ray-run quad kernel (a thread per ray over its samples):
  base, nocolour as above;
  nofold   the SH colour of each sample from the unfolded [27, 16] basis
           product (shade_core.cuh sh_colour), no fold per ray;
  cap1, cap2  at most 1 or 2 of its blocks per SM (else as many as fit);
  regs2    registers for two of its blocks per SM (at most 128).
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

MULTI, KERNEL = "multi_core.cuh", "shade_multi.cu"


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
    m = files[MULTI]
    if design(files) == "warp":
        files[MULTI] = sub(
            m, "shade_core::colour<kApp, kRgb>(app, p.wb, pk, ray, rgb);",
            SUM_APP)
        return
    # shade_k5_sample: the sum, and the colour after it never reached
    i = m.index("void shade_k5_sample(")
    files[MULTI] = m[:i] + sub(m[i:], SIGMA, SIGMA + "  " + SUM_APP
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


VARIANTS = {"base": [], "bcast_line": [bcast_line],
            "bcast_quad": [bcast_quad], "nocolour": [nocolour],
            "notime_branch": [notime_branch], "nofold": [nofold],
            "cap1": [cap(1)], "cap2": [cap(2)], "regs2": [min_blocks(2)]}


def build_variant(name):
    """Build the variant's library; returns it, or None where its anchors
    are not in this checkout's source or it does not build."""
    vd = ROOT / "build" / "variants" / name
    shutil.rmtree(vd, ignore_errors=True)
    csrc0 = build.CSRC
    shutil.copytree(csrc0, vd / "csrc")
    files = {f: (vd / "csrc" / f).read_text() for f in (MULTI, KERNEL)}
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
        if KERNEL not in src:
            continue
        m = re.search(r"(shade_multi(?:_pre)?_kernel)I(\w+?)EEv", line)
        if "Compiling entry" in line and m:
            fn = f"{m[1]}<{m[2]}>"
        elif "registers" in line or "spill" in line:
            print(f"== {name}: {fn}: {line.strip()}")
    print(f"== {name}: built in {time.time() - t0:.1f} s", flush=True)
    return lib


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


def main():
    names = sys.argv[1:] or list(VARIANTS)
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
    for cname, kernel, plain in chunks(dev):
        ref = plain()
        for rnd in range(2):
            for name, lib in libs.items():
                build._LOADED = lib
                out = kernel()
                torch.cuda.synchronize()
                err = (out[:, :4] - ref[:, :4]).abs().max().item()
                ms = cs.cuda_ms(torch, kernel, 20)
                print(f"round {rnd} {name}: {cname} {ms:.4f} ms, err "
                      f"{err:.2e}", flush=True)
        del ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
