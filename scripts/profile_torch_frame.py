"""Where the time of the PyTorch/CUDA port's frame goes, on one NVIDIA GPU.

Renders one of chip_smoke.py's configurations (--model flagship:
technicolor_z_plane at full width, bf16 MLP policy, the 1024x1024 bench
frame in 4 chunks at t=0.3; --model llff: llff_z_plane at full width on a
trained checkpoint's grid, the same frame's origins and directions;
--model shiny: shiny_z_plane (RGB colour) likewise; --model n3d:
neural_3d_z_plane at full width, S=64, on a trained checkpoint's grid,
the frame at t=0.3 with uniform_time, or with --per-ray-time without it,
so that K5/K6 mix the time planes per sample; --model stanford:
stanford_llff_z_plane at full width on a trained checkpoint's grid,
whose one route is the general stage chain and its net's own fused route,
K2; --model catacaustics, immersive, donerf: catacaustics_distance,
immersive_sphere_new, donerf_sphere as chip_smoke.py renders them, at
full width on a trained checkpoint's grid from chip_smoke.py's camera,
whose one route is the general stage chain and the colour net's own
fused route, K5; immersive with --per-ray-time at a t per ray) on one
route (--route: quad, K1 then K2 (flagship) or K5 (llff,
shiny, n3d), or stanford's own route;
fused, the coherent patch-gather route with bench.py's phase-major rays
at R=8 (5, 2) (n3d: (5, 3)), K1 then K3 or K6; two, the same route on K1,
K4 and K2-preblended, or K1, K4 (one launch over the three planes) and
K5-preblended) and prints:
  * the card's name and power limit (nvidia-smi);
  * frame time from CUDA events over back-to-back frames, and the host's
    time to enqueue one frame onto an idle card (when the two are close,
    the host holds the card back), and every synchronising call that one
    frame makes (torch.cuda.set_sync_debug_mode);
  * under torch.profiler: device milliseconds per frame for each kernel,
    the device's busy time, the span from its first to its last kernel,
    and the idle share of that span; then the host operators by their
    own CPU time.

    python3 scripts/profile_torch_frame.py
        [--model flagship|llff|shiny|n3d|stanford|catacaustics|immersive|
                 donerf]
        [--route quad|fused|two] [--per-ray-time] [--frames 3]
        [--trace FILE]

--trace writes the profiler's Chrome trace to FILE.
"""

import argparse
import os
import statistics
import subprocess
import sys
import time
import warnings
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def busy_ms(intervals):
    """Length of the union of [start, end) intervals (microseconds in,
    milliseconds out)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("flagship", "llff", "shiny", "n3d",
                                        "stanford", "catacaustics",
                                        "immersive", "donerf"),
                    default="flagship")
    ap.add_argument("--route", choices=("quad", "fused", "two"),
                    default="quad")
    ap.add_argument("--per-ray-time", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from hyperreel_tpu_torch.models.ctx import StepCtx

    if not torch.cuda.is_available():
        raise RuntimeError("profile_torch_frame needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    frame = torch.from_numpy(cs.bench_frame()).to(dev)
    ctx = StepCtx(it=cs.IT)
    fused = "1" if args.route == "fused" else "0"
    patch = args.route != "quad"
    shape = cs.PATCH_R8
    if args.model == "flagship":
        cfg, info, model, params, prep = cs.flagship(dev)
        os.environ["HYPERREEL_FUSED_PATCH"] = fused
        if patch:
            model, prep = cs.patch_model(cfg, info, params, cs.PATCH_R8)
        rk = {"cf_prepared": prep, "uniform_time": True}
    elif args.model in ("llff", "shiny", "stanford"):
        if patch and args.model == "stanford":
            raise ValueError("stanford_llff_z_plane has one route (quad)")
        _, model, params, prep = cs.static_model(
            dev, args.model, patch=cs.PATCH_R8 if patch else None)
        rk = {"cf_prepared": prep}
        frame = frame[..., :6].contiguous()     # a static scene: o, d
        os.environ["HYPERREEL_FUSED_PATCH_MULTI"] = fused
    elif args.model in cs.PRIMITIVES:
        if patch:
            raise ValueError(f"{args.model} has one route (quad)")
        _, model, params = cs.primitive_model(dev, args.model)
        rk = {"cf_prepared": model.prepare_eval(params)}
        frame[..., 2] = cs.PRIMITIVES[args.model][3]     # the camera
        if args.per_ray_time:
            gen = torch.Generator(device=dev).manual_seed(cs.SEED)
            frame[..., 7] = torch.rand(frame.shape[:2], device=dev,
                                       generator=gen)
        if args.model != "immersive":
            frame = frame[..., :6].contiguous()   # a static scene: o, d
    else:
        shape = cs.N3D_PATCH_R8
        _, model, params, prep = cs.n3d(dev, patch=shape if patch else None)
        rk = {"cf_prepared": prep, "uniform_time": not args.per_ray_time}
        os.environ["HYPERREEL_FUSED_PATCH_MULTI"] = fused
    if patch:
        frame = cs.phase_major(frame, shape[2]).contiguous()
        rk["rays_phase_major"] = True
    print(f"# model {args.model}, route {args.route}"
          + (f" {shape}" if patch else "")
          + (", a t per ray" if args.per_ray_time else ""), flush=True)

    def render():
        return [model.apply(params, frame[i], ctx, rk)
                for i in range(frame.shape[0])]

    frame_ms = cs.cuda_ms(torch, render, 10)
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    print(f"# frame {frame_ms:.3f} ms (CUDA events, 10 frames); host "
          f"enqueue of one frame {statistics.median(host):.3f} ms "
          f"(median of 5)", flush=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        render()
        torch.cuda.set_sync_debug_mode("default")
    # the first warning is the debug mode's own notice, not a sync
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "prototype feature" not in str(w.message)]
    print(f"# synchronising calls in one frame: {len(syncs)}")
    for m in sorted(set(syncs)):
        print(f"#   {syncs.count(m)} x {m[:120]}")
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            render()
        torch.cuda.synchronize()
    if args.trace:
        prof.export_chrome_trace(args.trace)

    per_name = defaultdict(float)
    intervals = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        intervals.append((a, b))
        per_name[e.name] += (b - a) / 1e3 / args.frames
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_ms(intervals) / args.frames
    span = (max(b for _, b in intervals)
            - min(a for a, _ in intervals)) / 1e3 / args.frames
    print(f"# device ms per frame over {args.frames} profiled frames "
          f"({card.splitlines()[0]})")
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.3f}  {100 * ms / busy:5.1f} %  {name[:100]}")
    print(f"# busy {busy:.3f} ms of a {span:.3f} ms span per frame: idle "
          f"{100 * (1 - busy / span):.1f} %")
    print(f"# host operators by own CPU time, {args.frames} frames "
          "(profiler overhead included)")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=20, max_name_column_width=60))


if __name__ == "__main__":
    main()
