"""Smoke run of the PyTorch/CUDA port (hyperreel_tpu_torch) on one NVIDIA
GPU: the flagship eval render at full width through the hand-written
kernels, checked against their plain PyTorch versions and against the
port's general path.

    python3 chip_smoke.py

Phases (any failure raises; the process then exits non-zero and prints
no result line):
  1. the card's name and power limit (nvidia-smi); no CUDA card -> error;
  2. build the kernels from hyperreel_tpu_torch/csrc/ (nvcc, sm_90a);
  3. the flagship (technicolor_z_plane, bf16 MLP policy) with weights
     drawn from a seeded torch.Generator, its prepared tables, it=20000;
     on one 262,144-ray chunk of the bench frame, each kernel against its
     plain version (error and CUDA-event times), K1 also under the f32
     MLP policy, and the chunk's colour through both kernels against the
     colour through both plain versions;
  4. the 1024x1024 bench frame (4 chunks, t=0.3) through model.apply:
     finite, in [0, 1], and each kernel launched once per chunk;
  5. fused path vs the port's general path on 4096 rays of
     __graft_entry__.entry()'s recipe;
  6. 10 timed frames after a warm-up frame (CUDA events).
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import subprocess
import time

import numpy as np

SEED = 0
IT = 20000                     # past every ease window of the flagship
CHUNK = 1 << 18                # bench.py:103
SIDE = 1 << 10                 # 1024^2 frame, bench.py:104-115
FRAME_T = 0.3
TIMED_FRAMES = 10
# K1 under the f32 policy: the same f32 math, sums in another order
PACK_TOL = 1e-5
# K1 under the bf16 policy: both sides round the same operands and sum
# exact products in f32 in another order; a hidden value on the other
# side of a bf16 rounding boundary moves one bf16 ulp (2^-8 relative)
# into the next layer, which moves points and distances by up to ~1e-3
PACK_TOL_BF16 = 2e-3
SHADE_TOL = 1e-4               # another order of the per-ray warp sums
PATH_TOL = 2e-4                # tests/test_fused_cf.py gate
F32_RAYS = 16384               # K1's f32-policy check (plain FMA layers)


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of fn over `reps` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_frame():
    """bench.py's 1024^2 pinhole frame: o = (0, 0, -1.5), unit-z
    directions, camera 3, t = 0.3; [4, 262144, 8] f32."""
    n = SIDE * SIDE
    u = (np.arange(SIDE, dtype=np.float32) - (SIDE - 1) / 2) / (SIDE * 1.2)
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
    o = np.zeros_like(d)
    o[:, 2] = -1.5
    cam = np.full((n, 1), 3.0, np.float32)
    t = np.full((n, 1), FRAME_T, np.float32)
    return np.concatenate([o, d, cam, t], -1).astype(np.float32).reshape(
        n // CHUNK, CHUNK, 8)


def entry_rays(n):
    """__graft_entry__.entry()'s random rays (numpy seed 0)."""
    rng = np.random.default_rng(0)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    cam = rng.integers(0, 16, (n, 1)).astype(np.float32)
    t = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    return np.concatenate([o, d, cam, t], -1)


def flagship(dev):
    """technicolor_z_plane at full width under the bf16 MLP policy, with
    weights from torch.Generator seed SEED: (cfg, dataset_info, model,
    params, prepared tables)."""
    import torch

    from hyperreel_tpu.configs.presets import (
        convert_epochs_to_iters, technicolor_z_plane)
    from hyperreel_tpu_torch.models.model import build_model

    cfg = convert_epochs_to_iters(technicolor_z_plane(), iters_per_epoch=4000)
    info = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
    model = build_model(cfg, dataset_info=info, compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED)
    params = model.init(gen, dev)
    # the relu init of the density grids is a constant 1e-2 (an almost
    # transparent scene); redraw them uniform in [0, 0.3) so that rays
    # end partly opaque and the composite is exercised
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.3 * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, info, model, params, model.prepare_eval(params)


def main():
    import torch

    # ---- 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card; none is visible")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    print(f"# torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_plain)

    # ---- 2. build
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"# kernels built in {lib.build_seconds:.1f} s "
          f"(loaded after {time.perf_counter() - t0:.1f} s)", flush=True)
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            print("#", line.strip())

    # ---- 3. the flagship and each kernel against its plain version
    cfg, info, model, params, prep = flagship(dev)
    ctx = StepCtx(it=IT)
    cf = model._cf_eval
    frame = torch.from_numpy(bench_frame()).to(dev)
    chunk = frame[0]

    net_in = cf.pred.net_input(chunk, ctx).float().contiguous()
    rp = cf.ray_pack(chunk)
    tabs = prep["mlp"]
    pack = pack_build(net_in, tabs, rp, cf.spec, IT)
    pack_p = pack_build_plain(net_in, tabs, rp, cf.spec, IT)
    torch.cuda.synchronize()
    k1_err = (pack - pack_p).abs().max().item()
    k1_rows = (pack - pack_p).abs().amax(1).tolist()
    print(f"# K1 pack_build (bf16 MLP) max |kernel - plain| = {k1_err:.3e} "
          f"(tol {PACK_TOL_BF16}); per row "
          + " ".join(f"{e:.1e}" for e in k1_rows), flush=True)
    if not k1_err <= PACK_TOL_BF16:
        raise AssertionError(f"K1 disagrees with its plain version: {k1_err}")
    # the same kernel under the f32 MLP policy, where nothing is rounded
    cf32 = build_model(cfg, dataset_info=info)._cf_eval
    tabs32 = cf32.prepare(params)["mlp"]
    x32, rp32 = net_in[:F32_RAYS].contiguous(), rp[:F32_RAYS].contiguous()
    k1_err32 = (pack_build(x32, tabs32, rp32, cf32.spec, IT)
                - pack_build_plain(x32, tabs32, rp32, cf32.spec, IT)
                ).abs().max().item()
    print(f"# K1 pack_build (f32 MLP, {F32_RAYS} rays) max |kernel - plain| "
          f"= {k1_err32:.3e} (tol {PACK_TOL})", flush=True)
    if not k1_err32 <= PACK_TOL:
        raise AssertionError(f"K1 (f32) disagrees with its plain version: "
                             f"{k1_err32}")
    k1_ms = cuda_ms(torch, lambda: pack_build(net_in, tabs, rp, cf.spec, IT),
                    20)
    k1_plain_ms = cuda_ms(
        torch, lambda: pack_build_plain(net_in, tabs, rp, cf.spec, IT), 5)

    H, W, TH, TW, C, nd = prep["dims"]
    k2_err = 0.0
    specs = {}
    for th in (TH, 0):               # per-sample time mix, frame premix
        ttab = prep["ttab"] if th else premix_time(prep["ttab"], rp[0, 7])
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        specs[th] = (ttab, spec)
        out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        out_p = shade_plain(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        print(f"# K2 shade TH={th}: max |kernel - plain| rgb/acc "
              f"{err:.3e}, depth {derr:.3e} (tol {SHADE_TOL}); "
              f"acc mean {out[:, 3].mean().item():.4f}", flush=True)
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL):
            raise AssertionError(f"K2 disagrees with its plain version "
                                 f"(TH={th}): {err}, {derr}")
        k2_err = max(k2_err, err)
    ttab, spec = specs[0]            # the frame route (uniform t)
    # the chunk's colour: both kernels against both plain versions (the
    # bf16 MLP's rounding flips of K1 included), at the fused-path gate
    out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
    out_p = shade_plain(prep["quad"], pack_p, rp, ttab, prep["wb"], spec)
    chunk_err = (out[:, :4] - out_p[:, :4]).abs().max().item()
    print(f"# chunk rgb/acc, kernels vs plain versions: max |diff| "
          f"{chunk_err:.3e} (tol {PATH_TOL})", flush=True)
    if not chunk_err <= PATH_TOL:
        raise AssertionError(f"kernels and plain versions disagree on the "
                             f"chunk: {chunk_err}")
    k2_ms = cuda_ms(torch, lambda: shade(prep["quad"], pack, rp, ttab,
                                         prep["wb"], spec), 20)
    k2_plain_ms = cuda_ms(torch, lambda: shade_plain(
        prep["quad"], pack, rp, ttab, prep["wb"], spec), 3)
    print(f"# one {CHUNK}-ray chunk: K1 {k1_ms:.3f} ms "
          f"(plain {k1_plain_ms:.3f}), K2 TH=0 {k2_ms:.3f} ms "
          f"(plain {k2_plain_ms:.3f})", flush=True)
    del pack_p, out_p
    torch.cuda.empty_cache()

    # ---- 4. the bench frame through model.apply
    rk = {"cf_prepared": prep, "uniform_time": True}

    def render():
        outs = [model.apply(params, frame[i], ctx, rk)
                for i in range(frame.shape[0])]
        return outs

    pack_build.launches = 0
    shade.launches = 0
    outs = render()
    torch.cuda.synchronize()
    launches = (pack_build.launches, shade.launches)
    rgb = torch.cat([o["rgb"] for o in outs])
    viol = max(float(o["uniform_time_viol"]) for o in outs)
    print(f"# frame {SIDE}x{SIDE}: rgb {tuple(rgb.shape)} "
          f"min {rgb.min().item():.4f} max {rgb.max().item():.4f} "
          f"mean {rgb.mean().item():.4f}; launches K1 {launches[0]} "
          f"K2 {launches[1]}; uniform-time witness {viol}", flush=True)
    n_chunks = frame.shape[0]
    if launches != (n_chunks, n_chunks):
        raise AssertionError(f"kernel launches {launches}, want "
                             f"{n_chunks} each")
    if not (torch.isfinite(rgb).all() and rgb.min() >= 0
            and rgb.max() <= 1 and rgb.shape == (SIDE * SIDE, 3)):
        raise AssertionError("frame rgb is not finite in [0, 1]")
    if viol != 0.0:
        raise AssertionError(f"uniform-time witness {viol} != 0")

    # ---- 5. fused vs general path; the f32 MLP policy, where both
    # routes run the same MLP (under the bf16 policy the general path
    # stores every MLP layer in bf16, as the JAX general path does, where
    # the fused path keeps f32 sums)
    import copy
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"]["fused_render_cf"] = False
    fused = build_model(cfg, dataset_info=info)
    general = build_model(cfg_g, dataset_info=info)
    rays = torch.from_numpy(entry_rays(4096)).to(dev)
    a = fused.apply(params, rays, ctx)["rgb"]
    b = general.apply(params, rays, ctx)["rgb"]
    path_err = (a - b).abs().max().item()
    print(f"# fused vs general, 4096 entry() rays: max |diff| "
          f"{path_err:.3e} (tol {PATH_TOL})", flush=True)
    if not path_err <= PATH_TOL:
        raise AssertionError(f"fused and general paths disagree: "
                             f"{path_err}")

    # ---- 6. frame time
    frame_ms = cuda_ms(torch, render, TIMED_FRAMES)
    print(f"# {card.splitlines()[0]}: {frame_ms:.3f} ms/frame, "
          f"{SIDE * SIDE / frame_ms / 1e3:.3f} Mrays/s "
          f"({TIMED_FRAMES} frames after a warm-up frame)", flush=True)

    record = {"kernels": [
        {"name": "pack_build", "route": "cuda",
         "source": "hyperreel_tpu_torch/csrc/pack_build.cu",
         "replaces": "hyperreel_tpu/ops/pallas/pack_build.py:137",
         "launches": launches[0], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "shade", "route": "cuda",
         "source": "hyperreel_tpu_torch/csrc/shade.cu",
         "replaces": "hyperreel_tpu/ops/pallas/shade.py:238",
         "launches": launches[1], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms}]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
