"""K1 against its plain version where the camera sits among the z-planes,
on one NVIDIA GPU: the flagship at full width under the bf16 MLP policy
with invalid_sort_far, random weights from seed 0, the bench chunk's rays
with their origins moved to z in ORIGIN_Z (the planes span z in [-1, 1]),
then onto each ANCHORS plane's anchor, then onto that plane's predicted
z (its anchor plus the mean of its predicted offset over the chunk,
measured from z = -2, below every plane) and STEPS of 4e-7 around it, so
that some samples lie behind the camera and, on the predicted plane,
many within rounding of distance 0 (at random weights a plane's
predicted offset varies little across the rays).
For each, the samples at the far sentinel, pack_error as it is, the
rays that `sentinel_flips` finds (a sample valid on one side and at the
sentinel on the other) and the error it holds them to, and pack_error
with those rays' rows 0-3 left to it.

    python3 scripts/k1_sentinel_flips.py

Run from the root of a checkout (its kernels are built into its build/).
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ORIGIN_Z = (-0.5, 0.0, 0.25, 0.5, 0.75)
ANCHORS = (4, 8, 12, 16, 20, 24, 28)
STEPS = range(-4, 5)


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("k1_sentinel_flips needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels import pack_build as PB

    cfg = convert_epochs_to_iters(technicolor_z_plane(), 4000)
    for st in cfg["embedding"]["embeddings"].values():
        if st.get("type") == "ray_intersect":
            st["intersect"]["invalid_sort_far"] = True
    info = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
    model = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    cf = model._cf_eval
    params = model.init(torch.Generator().manual_seed(cs.SEED), dev)
    ctx = StepCtx(it=cs.IT)
    tabs = cf.prepare(params)["mlp"]
    chunk = torch.from_numpy(cs.bench_frame()[0]).to(dev)
    anchors = [float(cf.spec.samples.reshape(-1)[i]) for i in ANCHORS]

    def packs(z):
        rays = chunk.clone()
        rays[:, 2] = z
        with torch.no_grad():
            x = cf.pred.net_input(rays, ctx).float().contiguous()
            rp = cf.ray_pack(rays)
            return (PB.pack_build(x, tabs, rp, cf.spec, cs.IT),
                    PB.pack_build_plain(x, tabs, rp, cf.spec, cs.IT), rp)

    _, below, rp = packs(-2.0)
    z_pred = (-2.0 + below[3].reshape(rp.shape[0], -1)
              * rp[:, 5:6]).mean(0).tolist()
    on_planes = [z_pred[i] + k * 4e-7 for i in ANCHORS[1::3] for k in STEPS]
    for z in (*ORIGIN_Z, *anchors, *on_planes):
        with torch.no_grad():
            pack, plain, rp = packs(z)
            torch.cuda.synchronize()
            err, rel = PB.pack_error(pack, plain)
            flips, flip_err = PB.sentinel_flips(pack, plain, rp, cf.spec,
                                                cs.PACK_TOL_BF16)
            err_s, rel_s = PB.pack_error(pack, plain, skip=flips)
        sent = (plain[3] == PB.FAR_SENTINEL).float().mean().item()
        print(f"# origin z {z}: {100 * sent:.2f} % of the samples at the "
              f"sentinel; pack_error {err:.3e} (sentinel points relative "
              f"{rel:.2e}); {int(flips.sum())} of {flips.shape[0]} rays "
              f"flipped, held shifted to {flip_err:.3e}; pack_error "
              f"without them {err_s:.3e} (relative {rel_s:.2e}); tol "
              f"{cs.PACK_TOL_BF16}", flush=True)


if __name__ == "__main__":
    main()
