"""What K1's rays per block cost on one NVIDIA GPU: K1 (csrc/pack_build.cu)
as built, against a variant of the same source that takes half as many
rays per block (kRaysOf halved: 32 in bf16, 16 in f32), on one 262,144-ray
chunk of chip_smoke.py's bench frame for the flagship (technicolor_z_plane,
S=32), llff_z_plane (S=32) and neural_3d_z_plane (S=64, whose 960-column
last layer already halves the rays per block as built), bf16 MLP policy.
Both libraries are loaded in one process (ctypes keeps their symbols
apart); each model's K1 is timed in turns (built, half, half, built),
CUDA events over 20 launches, and the two packs are compared.

    python3 scripts/k1_rays_per_block.py
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

RAYS_LINE = ("constexpr int kRaysOf = std::is_same_v<T, __nv_bfloat16> ? "
             "64 : 32;")


def main():
    import torch

    import chip_smoke as cs
    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build

    if not torch.cuda.is_available():
        raise RuntimeError("k1_rays_per_block needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    built = build.load_library()

    # the variant: the same sources with kRaysOf halved
    variant = ROOT / "build" / "variants" / "k1_half_rays"
    shutil.rmtree(variant, ignore_errors=True)
    shutil.copytree(build.CSRC, variant / "csrc")
    src = variant / "csrc" / "pack_build.cu"
    text = src.read_text()
    if RAYS_LINE not in text:
        raise RuntimeError("csrc/pack_build.cu no longer declares kRaysOf "
                           "as this script expects")
    src.write_text(text.replace(RAYS_LINE, RAYS_LINE.replace(
        "? 64 : 32", "? 32 : 16")))
    csrc, build_dir = build.CSRC, build.BUILD_DIR
    build.CSRC, build.BUILD_DIR, build._LOADED = (variant / "csrc",
                                                  variant / "build", None)
    half = build.load_library()
    build.CSRC, build.BUILD_DIR = csrc, build_dir

    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    ctx = StepCtx(it=cs.IT)
    models = {"flagship": (cs.flagship(dev), frame[0]),
              "llff": (cs.llff(dev), frame[0][:, :6].contiguous()),
              "n3d": (cs.n3d(dev), frame[0])}
    for name, (made, chunk) in models.items():
        model, params, prep = made[-3:]
        cf = model._cf_eval
        x0 = cf.pred.net_input(chunk, ctx).float().contiguous()
        rp = cf.ray_pack(chunk)
        flops = 2 * cs.CHUNK * sum(
            p["weight"].numel() for p in
            params["embedding"]["ray_prediction_0"]["net"].values())
        packs, times = {}, {"built": [], "half": []}
        rpb = {}
        for which in ("built", "half", "half", "built"):
            build._LOADED = built if which == "built" else half
            rpb[which] = build._LOADED.lib.pack_rays_per_block(
                cf.spec.params(1, prep["mlp"], cs.IT))
            packs[which] = pack_build(x0, prep["mlp"], rp, cf.spec, cs.IT)
            times[which].append(cs.cuda_ms(torch, lambda: pack_build(
                x0, prep["mlp"], rp, cf.spec, cs.IT), 20))
        diff = (packs["built"] - packs["half"]).abs().max().item()
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        print(f"# {name} (S={cf.S}, MLP {flops / 1e9:.1f} GFLOP): K1 "
              f"{ms['built']:.3f} ms at {rpb['built']} rays per block "
              f"({', '.join(f'{t:.3f}' for t in times['built'])}), "
              f"{ms['half']:.3f} ms at {rpb['half']} "
              f"({', '.join(f'{t:.3f}' for t in times['half'])}); "
              f"{flops / ms['built'] / 1e9:.1f} vs "
              f"{flops / ms['half'] / 1e9:.1f} TFLOP/s of K1's time; "
              f"packs differ by {diff:.3e}", flush=True)
        del made, x0, rp, packs
        torch.cuda.empty_cache()
    build._LOADED = built


if __name__ == "__main__":
    main()
