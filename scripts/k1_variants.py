"""K1's bf16 kernel built as text-patched variants of csrc/, on one NVIDIA
GPU: ptxas's registers, stack and spills of pack_build_wgmma for each
variant, and K1's time on one 262,144-ray chunk of chip_smoke.py's bench
frame for the flagship and neural_3d_z_plane, the variants in turns
(CUDA events over 10 launches, twice), with the error against the plain
version (meaningless for `notail`, whose pack is not computed).

    python3 scripts/k1_variants.py [base] [notail] [nobound_tail] \
        [nobound_all] [one_tail] [store_only] [colour_once]

Variants: `base` the source as it is; `notail` the last layer's strips
consumed by a sink instead of the tail (the MLP's time alone);
`nobound_tail` / `nobound_all` without the compiler barriers (bound_live)
in the tail's loops / also in the hidden epilogue; `one_tail` the point
and colour strips compiled once, for k kept samples (their skip of the
samples the pack does not keep), where `base` compiles them also for all
S kept; `store_only` that one copy without the skip: every sample
computed, only the stores predicated; `colour_once` the colour strips
compiled once (the skip, and an 8-byte store where all S are kept). Each variant builds into
build/variants/<name>/ (git-ignored); ctypes keeps the libraries'
symbols apart. The models timed: the flagship and neural_3d_z_plane, and
with `--counts` also their render-time sample counts (the flagship with
with_compact_samples(16), n3d with with_inference_samples(16)).
"""

import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hyperreel_tpu_torch.models.ctx import StepCtx  # noqa: E402
from hyperreel_tpu_torch.ops.kernels import build  # noqa: E402
from hyperreel_tpu_torch.ops.kernels.pack_build import (  # noqa: E402
    pack_build, pack_build_plain)

HDR = "pack_build.cuh"
# text patches of csrc/pack_build.cuh, each asserting its anchor
SINK = """template <int W>
__device__ __forceinline__ void sink(const float (&acc)[W / 2], const Tail& T) {
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < W / 2; ++i) s += acc[i];
  T.D[T.wtid] = s;
}

// The last layer, strip by strip"""
POINT = r"strip_point<S, WP, (true|false), kGen>\(p, acc, g, T\);"
COLOUR = r"strip_colour<S, WC, (true|false), kGen>\(p, acc, a, 4 \+ c, T\);"


def notail(t):
    t = t.replace("// The last layer, strip by strip", SINK, 1)
    for a, w in (("strip_z<S, WZ, kGen>(p, acc, T);", "WZ"),
                 ("strip_psig<S, WS, kGen>(p, acc, T);", "WS")):
        assert a in t, a
        t = t.replace(a, f"sink<{w}>(acc, T);")
    for a, w in ((POINT, "WP"), (COLOUR, "WC")):
        t, n = re.subn(a, f"sink<{w}>(acc, T);", t)
        assert n == 2, a
    assert "  sort_rays<S>(p, T);\n" in t
    t = t.replace("  sort_rays<S>(p, T);\n", "")
    return t
def one_tail(t):
    for a in ("strip_point<S, WP, true, kGen>",
              "strip_colour<S, WC, true, kGen>"):
        assert a in t, a
        t = t.replace(a, a.replace("true", "false"))
    return t
def colour_once(t):
    a = """    if (all) {
      strip_colour<S, WC, true, kGen>(p, acc, a, 4 + c, T);
    } else {
      strip_colour<S, WC, false, kGen>(p, acc, a, 4 + c, T);
    }"""
    assert a in t
    t = t.replace(a, "    strip_colour<S, WC, false, kGen>(p, acc, a, 4 + c, T);")
    b = "    float* q = pack + row * ((int64_t)p.B * p.k) + ray * p.k;\n"
    assert b in t
    return t.replace(b, b + "    if (p.k == S) {\n      store2(q + s0, a, b);\n"
                     "      return;\n    }\n")
def store_only(t):
    a = "        if (!kAll && j[e] < 0) continue;\n"
    assert a in t
    return one_tail(t.replace(a, ""))
def nobound_tail(t):
    i = t.index("// strip 0 (z, sigma)")
    j = t.index("// The last layer, strip by strip")
    mid = t[i:j]
    assert "bound_live();" in mid
    return t[:i] + mid.replace("bound_live();", "") + t[j:]
def nobound_all(t):
    return nobound_tail(t).replace("    bound_live();\n  }\n}", "  }\n}")


VARIANTS = {"base": [], "notail": [notail], "nobound_tail": [nobound_tail],
            "nobound_all": [nobound_all], "one_tail": [one_tail],
            "store_only": [store_only], "colour_once": [colour_once]}

def main():
    counts = "--counts" in sys.argv
    names = [a for a in sys.argv[1:] if a != "--counts"] or list(VARIANTS)
    if not torch.cuda.is_available():
        raise RuntimeError("k1_variants needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = {}
    csrc0, bdir0 = build.CSRC, build.BUILD_DIR
    for name in names:
        patches = VARIANTS[name]
        vd = ROOT / "build" / "variants" / name
        shutil.rmtree(vd, ignore_errors=True)
        shutil.copytree(csrc0, vd / "csrc")
        h = vd / "csrc" / HDR
        t = h.read_text()
        for f in patches:
            t = f(t)
        h.write_text(t)
        build.CSRC, build.BUILD_DIR, build._LOADED = vd / "csrc", vd / "build", None
        t0 = time.time()
        try:
            lib = build.load_library()
        except RuntimeError as e:
            print(f"== {name}: BUILD FAILED", str(e)[-3000:], flush=True)
            continue
        libs[name] = lib
        src, fn = "", ""
        for line in lib.compiler_log.splitlines():
            if line.startswith("== "):
                src = line
            if "pack_build_s" not in src:
                continue
            if "Compiling entry" in line:
                fn = "wgmma" if "wgmma" in line else "f32"
            if fn == "wgmma" and any(k in line for k in ("registers", "spill", "C75")):
                print(f"== {name}: {line.strip()[:200]}")
        print(f"== {name}: built in {time.time() - t0:.1f} s", flush=True)
    build.CSRC, build.BUILD_DIR = csrc0, bdir0
    ctx = StepCtx(it=cs.IT)
    chunk = torch.from_numpy(cs.bench_frame()).to(dev)[0]
    cases = [("flagship", None), ("n3d", None)]
    if counts:
        cases += [("flagship", ("compact", 16)), ("n3d", ("stride", 16))]
    for base, count in cases:
        made = cs.flagship(dev) if base == "flagship" else cs.n3d(dev)
        model, params, prep = made[-3:]
        mname = base
        if count:
            info = made[1] if base == "flagship" else cs.n3d_info()
            model, params = cs.sample_count_model(made[0], info, *count,
                                                  params)
            prep = model.prepare_eval(params)
            mname = f"{base} {count[0]} {count[1]}"
        cf = model._cf_eval
        x0 = cf.pred.net_input(chunk, ctx).float().contiguous()
        rp = cf.ray_pack(chunk)
        tabs = prep["mlp"]
        ref = pack_build_plain(x0, tabs, rp, cf.spec, cs.IT)
        for rnd in range(2):
            for name, lib in libs.items():
                build._LOADED = lib
                out = pack_build(x0, tabs, rp, cf.spec, cs.IT)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                ms = cs.cuda_ms(torch, lambda: pack_build(x0, tabs, rp, cf.spec, cs.IT), 10)
                print(f"round {rnd} {name}: K1 {mname} {ms:.3f} ms, err {err:.2e}", flush=True)
        del made, model, params, prep, ref, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
