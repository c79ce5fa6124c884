"""Compare two checkouts of hyperreel_tpu_torch on one NVIDIA GPU: the
outputs and the frame times of the routes that both render.

Run from the root of a checkout (its chip_smoke.py and hyperreel_tpu_torch
are the ones imported, its kernels are built into its own build/):

    python3 /path/to/scripts/compare_trees.py --save OUT.pt [--frames 10]

renders with chip_smoke.py's flagship (technicolor_z_plane), llff_z_plane,
neural_3d_z_plane and shiny_z_plane models, weights from its seed: K1's
pack of the bench frame's first chunk for each model (the flagship's
also under the f32 MLP policy, K1's FMA kernel), the bench frame's
rgb on every route (flagship quad, fused and two-kernel patch at R=8 (5,
2); llff quad, fused and two-kernel patch at R=8 (5, 2) and R=4 (4, 3);
n3d quad with one t and with a t per ray (K5 on the time planes); shiny
quad), K2's on the flagship's first chunk (scanline order: the time
plane premixed, the time plane itself (TH = 4), and RGB colour with the
weights row, a seeded [3, C] basis and weights row), the patch kernels'
output on the flagship's first chunk in phase-major order (K3, K4 and
K2-preblended at R=8 (5, 2)), K5's,
K5-preblended's, K4's (three planes) and K6's on the first chunk of llff,
shiny and n3d (K5 on the chunk in scanline and in phase-major order, on
n3d's time planes also with a t per ray spread over the keyframes and on
the planes premixed; K4, K5-preblended reading its features and K6 on the
phase-major chunk at R=8; n3d's K6 also at R=4 (4, 3) on the scanline
chunk), the patch routes of n3d at R=8 (5, 3) and
shiny's two-kernel route at R=8 (5, 2), the patch routes at S = k (the
flagship with compaction 16, n3d with the stride to 16, shiny with
compaction 16 at R=4 (4, 3); with the flagship's compaction also K2 on
the scanline chunk and K2-preblended on K4's features of the phase-major
chunk at S = 16), and K7's output on seeded inputs, and
saves them with each route's frame time and the kernels' times per chunk
(CUDA events, after a warm-up frame or launch; the kernels over 20
launches). Then

    python3 scripts/compare_trees.py --compare A.pt B.pt [C.pt ...]

prints, for every saved output, the largest |difference| of each file
from the first (0 where the kernels' arithmetic is unchanged; for the
shade kernels' [B, 5] outputs, of rgb/acc and of depth apart), and every
file's frame times. Run the checkouts' --save in turns (A, B, B, A) in
one call so that the times share a card.
"""

import argparse
import copy
import dataclasses
import inspect
import os
import subprocess
import sys


def blend_planes(ptabs, pack, specs, plain=False):
    """K4 over the planes of `specs` (or its plain version): (features,
    violation count), in the API of the checkout that is imported: one
    call over every plane, or (before that kernel) one call per plane with
    a flags buffer whose sum is the count."""
    import torch

    from hyperreel_tpu_torch.ops.kernels import patch_blend as K4
    fn = K4.patch_blend_plain if plain else K4.patch_blend
    if "ptabs" in inspect.signature(K4.patch_blend).parameters:
        return fn(ptabs, pack, specs)
    flags = torch.zeros(pack.shape[1] // specs[0].R, dtype=torch.uint8,
                        device=pack.device)
    feats = [fn(t, pack, s, flags)[0] for t, s in zip(ptabs, specs)]
    return feats, flags.sum().reshape(1)


def save(path, frames):
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.composite import composite
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_preblended)
    from hyperreel_tpu_torch.ops.kernels.shade_multi import (
        MultiSpec, shade_multi, shade_multi_preblended)
    from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
        shade_multi_patch)
    from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch

    if not torch.cuda.is_available():
        raise RuntimeError("compare_trees needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ctx = StepCtx(it=cs.IT)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    out, times = {}, {}

    def run(name, model, params, frames_in, rkw, env, R=None):
        with cs.EnvVar(*env):
            def render():
                return [model.apply(params, frames_in[i], ctx, rkw)
                        for i in range(frames_in.shape[0])]
            outs = render()
            rgb = torch.cat([cs.scanline(o["rgb"], R) if R else o["rgb"]
                             for o in outs])
            out[name] = rgb.cpu()
            times[name] = cs.cuda_ms(torch, render, frames)

    def k1(name, model, prep, chunk):
        cf = model._cf_eval
        x0 = cf.pred.net_input(chunk, ctx).float().contiguous()
        rp = cf.ray_pack(chunk)
        out[f"{name} K1 pack"] = pack_build(x0, prep["mlp"], rp, cf.spec,
                                            cs.IT).cpu()
        times[f"{name} K1 chunk"] = cs.cuda_ms(torch, lambda: pack_build(
            x0, prep["mlp"], rp, cf.spec, cs.IT), 20)

    def packed(model, prep, chunk):
        cf = model._cf_eval
        rp = cf.ray_pack(chunk)
        return pack_build(cf.pred.net_input(chunk, ctx).float().contiguous(),
                          prep["mlp"], rp, cf.spec, cs.IT), rp

    def kernel(key, fn):
        out[key] = fn().float().cpu()
        times[f"{key} chunk"] = cs.cuda_ms(torch, fn, 20)

    def k5(name, model, prep, chunk, R):
        """K5 on the chunk's pack and on the pack of the chunk in
        phase-major order for blocks of R, and K5-preblended on K4's
        features of the phase-major chunk; on time planes also K5 on the
        planes premixed for the chunk's first t and with a t per ray
        spread over every keyframe interval."""
        cf = model._cf_eval
        rp = cf.ray_pack(chunk)
        pack = pack_build(cf.pred.net_input(chunk, ctx).float().contiguous(),
                          prep["mlp"], rp, cf.spec, cs.IT)
        spec = MultiSpec(S=cf.S, axes=prep["axes"], deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale,
                         shading=cf.net.shading)
        chunk_pm = cs.phase_major(chunk[None], R)[0].contiguous()
        rp_pm = cf.ray_pack(chunk_pm)
        pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                             .contiguous(), prep["mlp"], rp_pm, cf.spec,
                             cs.IT)
        runs = {f"{name} K5": (prep["lines"], spec, pack, rp),
                f"{name} K5 phase-major": (prep["lines"], spec, pack_pm,
                                           rp_pm)}
        if any(a.TH for a in spec.axes):
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            rp_spread = rp.clone()
            rp_spread[:, 7] = 2.0 * torch.rand(
                rp.shape[0], device=dev, generator=gen) - 1.0
            th = f"{name} K5 TH={spec.axes[0].TH}"
            runs = {th: runs[f"{name} K5"],
                    f"{th} phase-major": runs[f"{name} K5 phase-major"],
                    f"{th} t spread": (prep["lines"], spec, pack, rp_spread),
                    f"{name} K5 premixed": (
                        [premix_time(t, rp[0, 7]) for t in prep["lines"]],
                        dataclasses.replace(spec, axes=tuple(
                            dataclasses.replace(a, TH=0)
                            for a in spec.axes)), pack, rp)}
        for key, (lines, sp, pk, r) in runs.items():
            def fn():
                return shade_multi(prep["quads"], lines, pk, r, prep["wb"],
                                   sp)
            out[key] = fn().cpu()
            times[f"{key} chunk"] = cs.cuda_ms(torch, fn, 20)
        pspecs = model._cf_eval.patch_specs(
            [(a.W, a.H, a.C, a.m0, a.m1) for a in spec.axes], True)
        feats, _ = blend_planes(prep["ptabs"], pack_pm, pspecs)
        patch = {
            "K4x3": lambda: blend_planes(prep["ptabs"], pack_pm, pspecs),
            "K5-pre": lambda: shade_multi_preblended(
                feats, prep["lines"], pack_pm, rp_pm, prep["wb"], spec),
            "K6": lambda: shade_multi_patch(
                prep["ptabs"], prep["lines"], pack_pm, rp_pm, prep["wb"],
                spec, pspecs)}
        for key, fn in patch.items():
            got = fn()
            out[f"{name} {key}"] = (torch.cat([f.float() for f in got[0]], 1)
                                    if key == "K4x3" else got if key ==
                                    "K5-pre" else got[0]).cpu()
            times[f"{name} {key} chunk"] = cs.cuda_ms(torch, fn, 20)

    cfg, info, model, params, prep = cs.flagship(dev)
    k1("flagship", model, prep, frame[0])
    # the f32 MLP policy's K1 (the FMA kernel) on the same chunk
    m32 = build_model(copy.deepcopy(cfg), dataset_info=info)
    k1("flagship f32", m32, {"mlp": m32._cf_eval.prepare(params)["mlp"]},
       frame[0])
    # K2 on the first chunk: the time plane premixed (the quad route's),
    # the time plane itself, RGB colour with the weights row
    cf = model._cf_eval
    pack0, rp0 = packed(model, prep, frame[0])
    H, W, TH, TW, C, nd = prep["dims"]
    sspec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                      deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    ttab0 = premix_time(prep["ttab"], rp0[0, 7])
    gen = torch.Generator().manual_seed(cs.SEED)
    wb_rgb = torch.cat([torch.zeros(3, nd),
                        torch.randn(3, C - nd, generator=gen)], 1)
    pack_w = torch.cat([pack0, 2.0 * torch.rand(
        1, pack0.shape[1], generator=gen).to(dev)]).contiguous()
    spec_th = dataclasses.replace(sspec, TH=TH)
    spec_w = dataclasses.replace(sspec, shading="rgb", weights=True)
    kernel("flagship K2", lambda: shade(prep["quad"], pack0, rp0, ttab0,
                                        prep["wb"], sspec))
    kernel(f"flagship K2 TH={TH}", lambda: shade(
        prep["quad"], pack0, rp0, prep["ttab"], prep["wb"], spec_th))
    kernel("flagship K2 RGB+weights", lambda: shade(
        prep["quad"], pack_w, rp0, ttab0, wb_rgb, spec_w))
    del pack0, pack_w
    rk = {"cf_prepared": prep, "uniform_time": True}
    run("flagship quad", model, params, frame, rk,
        ("HYPERREEL_FUSED_PATCH", "1"))
    model8, prep8 = cs.patch_model(cfg, info, params, cs.PATCH_R8)
    frame_pm = cs.phase_major(frame, cs.PATCH_R8[2]).contiguous()
    # K3, K4 and K2-preblended on the first phase-major chunk
    cf = model8._cf_eval
    rp_pm = cf.ray_pack(frame_pm[0])
    pack_pm = pack_build(cf.pred.net_input(frame_pm[0], ctx).float()
                         .contiguous(), prep8["mlp"], rp_pm, cf.spec, cs.IT)
    H, W, _, TW, C, nd = prep8["dims"]
    sspec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                      deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    ps, = cf.patch_specs([(W, H, C, 0, 1)], True)
    targs = (premix_time(prep8["ttab"], rp_pm[0, 7]), prep8["wb"], sspec)
    (feats,), _ = blend_planes([prep8["patch"]], pack_pm, [ps])
    single = {
        "K3": lambda: shade_patch(prep8["patch"], pack_pm, rp_pm, *targs,
                                  ps)[0],
        "K4": lambda: blend_planes([prep8["patch"]], pack_pm, [ps])[0][0],
        "K2-pre": lambda: shade_preblended(feats, pack_pm, rp_pm, *targs)}
    for key, fn in single.items():
        out[f"flagship {key}"] = fn().float().cpu()
        times[f"flagship {key} chunk"] = cs.cuda_ms(torch, fn, 20)
    del pack_pm, feats
    rk8 = {"cf_prepared": prep8, "uniform_time": True,
           "rays_phase_major": True}
    for env, name in (("1", "fused"), ("0", "two-kernel")):
        run(f"flagship {name} patch", model8, params, frame_pm, rk8,
            ("HYPERREEL_FUSED_PATCH", env), cs.PATCH_R8[2])
    del model, model8, prep, prep8, params
    torch.cuda.empty_cache()

    frame6 = frame[..., :6].contiguous()
    _, model, params, prep = cs.static_model(dev, "llff")
    k1("llff", model, prep, frame6[0])
    run("llff quad", model, params, frame6, {"cf_prepared": prep},
        ("HYPERREEL_FUSED_PATCH_MULTI", "0"))
    for shape in (cs.PATCH_R8, cs.PATCH_R4):
        _, m, _, pr = cs.static_model(dev, "llff", patch=shape,
                                      params=params)
        if shape == cs.PATCH_R8:
            k5("llff", m, pr, frame6[0], shape[2])
        fr = cs.phase_major(frame6, shape[2]).contiguous()
        for env, name in (("1", "fused"), ("0", "two-kernel")):
            run(f"llff {name} patch R={shape[2]}", m, params, fr,
                {"cf_prepared": pr, "rays_phase_major": True},
                ("HYPERREEL_FUSED_PATCH_MULTI", env), shape[2])
        del m, pr
        torch.cuda.empty_cache()
    del model, params, prep
    torch.cuda.empty_cache()

    _, model, params, prep = cs.n3d(dev)
    k1("n3d", model, prep, frame[0])
    for ut, tag in ((True, "one t"), (False, "t per ray")):
        run(f"n3d quad {tag}", model, params, frame,
            {"cf_prepared": prep, "uniform_time": ut},
            ("HYPERREEL_FUSED_PATCH_MULTI", "0"))
    _, m8, _, pr8 = cs.n3d(dev, patch=cs.N3D_PATCH_R8, params=params)
    k5("n3d", m8, pr8, frame[0], cs.N3D_PATCH_R8[2])
    # K6 at R=4 (4, 3) on the chunk in scanline order (chip_smoke.py's
    # second n3d K6 case)
    _, m4, _, pr4 = cs.n3d(dev, patch=cs.N3D_PATCH_R4, params=params)
    pack4, rp4 = packed(m4, pr4, frame[0])
    spec4 = MultiSpec(S=m4._cf_eval.S, axes=pr4["axes"],
                      deg=m4._cf_eval.net.sh_deg,
                      distance_scale=m4._cf_eval.net.distance_scale)
    ps4 = m4._cf_eval.patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in spec4.axes], False)
    kernel("n3d K6 R=4", lambda: shade_multi_patch(
        pr4["ptabs"], pr4["lines"], pack4, rp4, pr4["wb"], spec4, ps4)[0])
    del m4, pr4, pack4
    R = cs.N3D_PATCH_R8[2]
    fr = cs.phase_major(frame, R).contiguous()
    for env, name in (("1", "fused"), ("0", "two-kernel")):
        run(f"n3d {name} patch R={R}", m8, params, fr,
            {"cf_prepared": pr8, "uniform_time": True,
             "rays_phase_major": True},
            ("HYPERREEL_FUSED_PATCH_MULTI", env), R)
    del model, params, prep, m8, pr8
    torch.cuda.empty_cache()

    _, model, params, prep = cs.static_model(dev, "shiny")
    run("shiny quad", model, params, frame6, {"cf_prepared": prep},
        ("HYPERREEL_FUSED_PATCH_MULTI", "0"))
    _, m8, _, pr8 = cs.static_model(dev, "shiny", patch=cs.PATCH_R8,
                                    params=params)
    k5("shiny", m8, pr8, frame6[0], cs.PATCH_R8[2])
    fr = cs.phase_major(frame6, cs.PATCH_R8[2]).contiguous()
    run(f"shiny two-kernel patch R={cs.PATCH_R8[2]}", m8, params, fr,
        {"cf_prepared": pr8, "rays_phase_major": True},
        ("HYPERREEL_FUSED_PATCH_MULTI", "0"), cs.PATCH_R8[2])
    del model, params, prep, m8, pr8
    torch.cuda.empty_cache()

    # the patch routes at S = k (chip_smoke.py's sample-count models): the
    # flagship with compaction 16 at R=8 (5, 2), n3d with the stride to 16
    # at R=8 (5, 3), shiny with compaction 16 at R=4 (4, 3)
    for family, stage, k, shape, env in (
            ("flagship", "compact", 16, cs.PATCH_R8, "HYPERREEL_FUSED_PATCH"),
            ("n3d", "stride", 16, cs.N3D_PATCH_R8,
             "HYPERREEL_FUSED_PATCH_MULTI"),
            ("shiny", "compact", 16, cs.PATCH_R4,
             "HYPERREEL_FUSED_PATCH_MULTI")):
        if family == "flagship":
            base_cfg, info, _, p0, _ = cs.flagship(dev)
            fr = frame
        elif family == "n3d":
            base_cfg, _, p0, _ = cs.n3d(dev)
            info, fr = cs.n3d_info(), frame
        else:
            base_cfg, _, p0, _ = cs.static_model(dev, family)
            info, fr = None, frame6
        m, p = cs.sample_count_model(base_cfg, info, stage, k, p0,
                                     patch=shape)
        prk = m.prepare_eval(p)
        if family == "flagship":
            # K2 on the scanline chunk, K2-preblended on K4's features of
            # the phase-major chunk, both at S = k
            pk, rpk = packed(m, prk, fr[0])
            pkm, rpm = packed(m, prk, cs.phase_major(fr[:1], shape[2])[0]
                              .contiguous())
            H, W, _, TW, C, nd = prk["dims"]
            spk = ShadeSpec(S=k, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                            deg=m._cf_eval.net.sh_deg,
                            distance_scale=m._cf_eval.net.distance_scale)
            tk = premix_time(prk["ttab"], rpk[0, 7])
            ps, = m._cf_eval.patch_specs([(W, H, C, 0, 1)], True)
            (fk,), _ = blend_planes([prk["patch"]], pkm, [ps])
            tag = f"{family} {stage} {k}"
            kernel(f"{tag} K2", lambda: shade(prk["quad"], pk, rpk, tk,
                                              prk["wb"], spk))
            kernel(f"{tag} K2-pre", lambda: shade_preblended(
                fk, pkm, rpm, tk, prk["wb"], spk))
            del pk, pkm, fk
        fr = cs.phase_major(fr, shape[2]).contiguous()
        rk = {"cf_prepared": prk, "uniform_time": True,
              "rays_phase_major": True}
        for val, name in (("1", "fused"), ("0", "two-kernel")):
            run(f"{family} {stage} {k} {name} patch R={shape[2]}", m, p, fr,
                rk, (env, val), shape[2])
        del m, p, p0, rk
        torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    sig = 0.05 * torch.rand(cs.CHUNK, 32, device=dev, generator=gen)
    dst = torch.sort(0.1 + 2.9 * torch.rand(cs.CHUNK, 32, device=dev,
                                            generator=gen), -1).values
    col = torch.rand(cs.CHUNK, 32, 3, device=dev, generator=gen)
    out["K7 composite"] = torch.cat(
        [t.reshape(cs.CHUNK, -1) for t in composite(sig, dst, col, 16.0)],
        1).cpu()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.save({"out": out, "times": times, "card": card,
                "tree": os.getcwd()}, path)
    print(f"# {os.getcwd()}: saved {len(out)} outputs to {path}")


def compare(paths):
    import torch

    runs = [torch.load(p) for p in paths]
    first = runs[0]["out"]
    print(f"# {runs[0]['card']}; files: " + ", ".join(
        f"{p} ({r['tree']})" for p, r in zip(paths, runs)))
    for name, ref in first.items():
        parts = [(name, lambda x: x)]
        if ref.dim() == 2 and ref.shape[1] == 5:
            parts = [(f"{name} rgb/acc", lambda x: x[:, :4]),
                     (f"{name} depth", lambda x: x[:, 4])]
        for label, part in parts:
            diffs = [(part(r["out"][name]) - part(ref)).abs().max().item()
                     if name in r["out"] else float("nan")
                     for r in runs[1:]]
            print(f"{label}: max |diff| from the first file "
                  + ", ".join(f"{d:.3e}" for d in diffs))
    for name in runs[0]["times"]:
        unit = "ms/chunk" if name.endswith(" chunk") else "ms/frame"
        print(f"{name}: {unit} " + ", ".join(
            f"{r['times'].get(name, float('nan')):.3f}" for r in runs))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs="+")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    if args.save:
        save(args.save, args.frames)
    if args.compare:
        compare(args.compare)


if __name__ == "__main__":
    main()
