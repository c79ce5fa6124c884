"""Where K1's pack and its plain version's pack give a ray different
colours, and why: on one NVIDIA GPU, for the flagship (technicolor_z_plane)
at its tiny test size on the ragged persistent ray count of
tests/test_torch_cuda.py and at full width on chip_smoke.py's 1024^2 bench
frame, under the bf16 and the f32 MLP policies.

    python3 scripts/face_crossing.py [--out chiprun_out/face_crossing.json]

Both packs are shaded by K2's plain version, so that the colour difference
is the packs' alone. For the ray whose colour differs most it prints every
sample whose validity (|xn|, |yn|, |zn| <= 1 and dist > 0) differs between
the packs: its coordinates in both, their distance from the aabb's face in
f32 ulps of 1, and the pack difference. Then, for a band of k ulps, the
rays that have a sample within k ulps of a face in either pack, and the
largest colour difference of the other rays.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.getcwd())

RAGGED_PERSISTENT = 2 * 132 * 128 + 77   # tests/test_torch_cuda.py
BANDS = (1, 2, 8, 64, 1024, 16384)       # in f32 ulps of 1 (2^-23)


def face_ulps(torch, pack):
    """[B*S]: the least distance in f32 ulps of 1 of |xn|, |yn|, |zn|
    from 1 (the aabb's face), counted on the f32 bit patterns."""
    one = torch.tensor(1.0, dtype=torch.float32).view(torch.int32).item()
    bits = pack[:3].abs().contiguous().view(torch.int32).long()
    return (bits - one).abs().amin(0)


def valid(pack):
    return ((pack[0].abs() <= 1) & (pack[1].abs() <= 1)
            & (pack[2].abs() <= 1) & (pack[3] > 0))


def analyse(torch, name, pack, pack_p, shade_p, S):
    """The colour difference of the two packs and its cause, as a dict."""
    out_k, out_p = shade_p(pack), shade_p(pack_p)
    diff = (out_k[:, :4] - out_p[:, :4]).abs().amax(1)
    B = diff.shape[0]
    worst = int(diff.argmax())
    vk, vp = valid(pack), valid(pack_p)
    flips = (vk != vp).reshape(B, S)
    near_k, near_p = face_ulps(torch, pack), face_ulps(torch, pack_p)
    cols = torch.arange(worst * S, worst * S + S, device=pack.device)
    samples = []
    for g in cols.tolist():
        if vk[g] == vp[g]:
            continue
        samples.append({
            "sample": g - worst * S,
            "kernel_xyzd": [float(v) for v in pack[:4, g]],
            "plain_xyzd": [float(v) for v in pack_p[:4, g]],
            "kernel_valid": bool(vk[g]), "plain_valid": bool(vp[g]),
            "face_ulps_kernel": int(near_k[g]),
            "face_ulps_plain": int(near_p[g]),
            "pack_diff": float((pack[:, g] - pack_p[:, g]).abs().max())})
    near = torch.minimum(near_k, near_p).reshape(B, S).amin(1)
    bands = {}
    for k in BANDS:
        keep = near > k
        bands[str(k)] = {
            "rays_left_out": int((~keep).sum()),
            "max_colour_diff_kept": float(diff[keep].max()) if keep.any()
            else 0.0}
    rec = {
        "case": name, "rays": B, "S": S,
        "max_pack_diff": float((pack - pack_p).abs().max()),
        "max_colour_diff": float(diff.max()), "worst_ray": worst,
        "rays_with_a_validity_flip": int(flips.any(1).sum()),
        "max_colour_diff_without_flips": float(
            diff[~flips.any(1)].max()),
        "worst_ray_flipped_samples": samples,
        "worst_ray_face_ulps": int(near[worst]),
        "bands": bands}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/face_crossing.json")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, tiny_dynamic)
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.shade import ShadeSpec, shade_plain

    if not torch.cuda.is_available():
        raise RuntimeError("face_crossing needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    ctx = StepCtx(it=cs.IT)
    records = []

    def packs(model, params, rays, prep=None):
        cf = model._cf_eval
        prep = prep or cf.prepare(params)
        x0 = cf.pred.net_input(rays, ctx).float().contiguous()
        rp = cf.ray_pack(rays)
        pack = pack_build(x0, prep["mlp"], rp, cf.spec, cs.IT)
        pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, cs.IT)
        H, W, TH, TW, C, nd = prep["dims"]
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)

        def shade_p(pk):
            return shade_plain(prep["quad"], pk, rp, prep["ttab"],
                               prep["wb"], spec)
        return pack, pack_p, shade_p, cf.S

    # the ragged persistent test's set-up: tiny_dynamic with bf16 tables,
    # density uniform in [0, 0.3), its random rays (seed 0)
    info = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
    for bf16 in (True, False):
        cfg = convert_epochs_to_iters(tiny_dynamic(), 4000)
        cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
        model = build_model(cfg, dataset_info=info,
                            compute_dtype=torch.bfloat16 if bf16 else None)
        gen = torch.Generator().manual_seed(0)
        params = model.init(gen, dev)
        for k, v in params["color"]["density"].items():
            params["color"]["density"][k] = 0.3 * torch.rand(
                v.shape, generator=gen).to(dev)
        rng = np.random.default_rng(0)
        n = RAGGED_PERSISTENT
        o = rng.uniform(-0.5, 0.5, (n, 3))
        o[:, 2] -= 1.5
        d = rng.uniform(-0.3, 0.3, (n, 3))
        d[:, 2] = 1.0
        rays = np.concatenate([o, d, rng.integers(0, 16, (n, 1)),
                               rng.uniform(0, 1, (n, 1))], -1)
        rays = torch.from_numpy(rays.astype(np.float32)).to(dev)
        records.append(analyse(
            torch, f"tiny ragged {'bf16' if bf16 else 'f32'}",
            *packs(model, params, rays)))

    # the full-width flagship on the bench frame, chunk by chunk
    _, _, model, params, prep = cs.flagship(dev)
    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    for i in range(frame.shape[0]):
        records.append(analyse(torch, f"flagship frame chunk {i}",
                               *packs(model, params, frame[i], prep)))
    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "records": records}, f, indent=1)
    print(f"# {card}; wrote {args.out}")


if __name__ == "__main__":
    main()
