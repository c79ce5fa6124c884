"""The six shade kernels' times at SH degree 2 in one checkout, on one
NVIDIA GPU: K2 on the flagship's first bench chunk (the time plane
premixed, TH = 0, and on the time plane itself, TH = 4), K2-preblended on
K4's features of the phase-major chunk and K3 at R=8 (5, 2); K5,
K5-preblended and K6 on llff_z_plane's phase-major chunk (checkpoint grid,
R=8 (5, 2)), the models as chip_smoke.py builds them. Each kernel is timed
in 5 rounds of 20 launches (CUDA events); the script prints every round
and the least, and each shade kernel's registers (and K3's and
K5-preblended's stack and spills) from the build's ptxas output when it
built the library. Run from the root of the checkout that is measured:

    python3 /path/to/scripts/shade_times.py LABEL [single]

(`single`: the flagship's kernels only.) To compare two checkouts, unpack
the other under a git-ignored directory and run both in turns in one call
(A, B, B, A): a card's time moves with its power limit and its host.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main():
    import torch

    import chip_smoke as cs
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        PatchSpec, patch_blend)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_preblended)
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_preblended)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch)
    from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch

    label = sys.argv[1]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"{label}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    src = ""
    for line in lib.compiler_log.splitlines():
        if "Compiling entry function" in line:
            src = line.split("'")[1] if "'" in line else line
        elif "shade" not in src or "_kernel" not in src:
            continue
        elif "spill stores" in line and ("shade_patch_kernel" in src
                                         or "multi_pre" in src):
            print(f"{label} {src}: {line.strip()}")
        elif "Used" in line and "registers" in line:
            print(f"{label} {src}: "
                  f"{line.split('Used ')[1].split(',')[0]}")
    ctx = StepCtx(it=cs.IT)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    R8 = cs.PATCH_R8[2]
    out = {}

    cfg, info, model, params, prep = cs.flagship(dev)
    cf = model._cf_eval
    chunk, chunk_pm = frame[0], cs.phase_major(frame, R8)[0].contiguous()
    rp, rp_pm = cf.ray_pack(chunk), cf.ray_pack(chunk_pm)
    pack = pack_build(cf.pred.net_input(chunk, ctx).float().contiguous(),
                      prep["mlp"], rp, cf.spec, cs.IT)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), prep["mlp"], rp_pm, cf.spec, cs.IT)
    H, W, TH, TW, C, nd = prep["dims"]
    ttab = premix_time(prep["ttab"], rp[0, 7])
    _, prep8 = cs.patch_model(cfg, info, params, cs.PATCH_R8)
    ps = PatchSpec(R=R8, px=cs.PATCH_R8[0], py=cs.PATCH_R8[1], W=W, H=H,
                   C=C, S=cf.S, phase_major=True)
    (feats,), _ = patch_blend([prep8["patch"]], pack_pm, [ps])
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd, deg=2,
                     distance_scale=cf.net.distance_scale)
    spec4 = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd, deg=2,
                      distance_scale=cf.net.distance_scale)
    wb = prep["wb"]
    kern = {
        "K2": lambda: shade(prep["quad"], pack, rp, ttab, wb, spec),
        "K2 TH=4": lambda: shade(prep["quad"], pack, rp, prep["ttab"], wb,
                                 spec4),
        "K2-pre": lambda: shade_preblended(feats, pack_pm, rp_pm, ttab, wb,
                                           spec),
        "K3": lambda: shade_patch(prep8["patch"], pack_pm, rp_pm, ttab, wb,
                                  spec, ps)}
    for name, fn in kern.items():
        out[name] = [cs.cuda_ms(torch, fn, 20) for _ in range(5)]
    del model, prep, prep8, pack, pack_pm, feats
    torch.cuda.empty_cache()

    if sys.argv[2:] != ["single"]:
        cfg, model, params, prep = cs.static_model(dev, "llff")
        _, model8, _, prep8 = cs.static_model(dev, "llff",
                                              patch=cs.PATCH_R8,
                                              params=params)
        cf = model._cf_eval
        axes, lines, wb = prep["axes"], prep["lines"], prep["wb"]
        frame6 = frame[..., :6].contiguous()
        chunk_pm = cs.phase_major(frame6, R8)[0].contiguous()
        rp_pm = cf.ray_pack(chunk_pm)
        pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                             .contiguous(), prep["mlp"], rp_pm, cf.spec,
                             cs.IT)
        pspecs = model8._cf_eval.patch_specs(
            [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True)
        feats = patch_blend(prep8["ptabs"], pack_pm, pspecs)[0]
        mspec = MultiSpec(S=cf.S, axes=axes, deg=2,
                          distance_scale=cf.net.distance_scale)
        kern = {
            "K5": lambda: shade_multi(prep["quads"], lines, pack_pm, rp_pm,
                                      wb, mspec),
            "K5-pre": lambda: shade_multi_preblended(
                feats, lines, pack_pm, rp_pm, wb, mspec),
            "K6": lambda: shade_multi_patch(prep8["ptabs"], lines, pack_pm,
                                            rp_pm, wb, mspec, pspecs)}
        for name, fn in kern.items():
            out[name] = [cs.cuda_ms(torch, fn, 20) for _ in range(5)]
    print(f"{label}: " + "; ".join(
        f"{k} {min(v):.4f} (" + ", ".join(f"{x:.4f}" for x in v) + ")"
        for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main()
