"""Smoke run of the PyTorch/CUDA port (hyperreel_tpu_torch) on one NVIDIA
GPU: the flagship eval render at full width through the hand-written
kernels, checked against their plain PyTorch versions and against the
port's general path, on the quad route and on the coherent patch-gather
route; and the standalone composite entry point.

    python3 chip_smoke.py

Phases (any failure raises; the process then exits non-zero and prints
no result line):
  1. the card's name and power limit (nvidia-smi); no CUDA card -> error;
  2. build the kernels from hyperreel_tpu_torch/csrc/ (one nvcc per
     source, all at once, sm_90a);
  3. the flagship (technicolor_z_plane, bf16 MLP policy) with weights
     drawn from a seeded torch.Generator, its prepared tables, it=20000;
     on one 262,144-ray chunk of the bench frame, K1 and K2 against their
     plain versions (error and CUDA-event times), K1 also under the f32
     MLP policy, and the chunk's colour through both kernels against the
     colour through both plain versions;
  4. the 1024x1024 bench frame (4 chunks, t=0.3) through model.apply on
     the quad route: finite, in [0, 1], K1 and K2 launched once per chunk;
  5. fused vs general path on 4096 rays of __graft_entry__.entry()'s
     recipe;
  6. the patch route's kernels on the same chunk: K3 (fused blend+shade)
     at R=8 (5, 2) on the chunk in bench.py's phase-major order and at
     R=4 (4, 3) in scanline order, K4 (patch blend) and K2 reading its
     pre-blended features, each against its plain version, and timed in
     turns with K2; K7 (composite) at B=262,144, S=32 through its entry
     point;
  7. the bench frame on the patch route, R=8 (5, 2) as bench.py renders it
     (phase-major rays, rays_phase_major=True) and in scanline order, on
     K3 and on the two-kernel route (HYPERREEL_FUSED_PATCH=0, K4 then
     K2-preblended): the launches, the coverage witness (<= 1e-4, bench.py
     PVIOL_EXACT) and the rgb against the quad route's frame (<= 2e-4);
  8. frame time of the three routes, 10 frames after a warm-up frame
     each, in turns quad, fused, two-kernel, two-kernel, fused, quad,
     twice (CUDA events).
The line before the last is the kernels' JSON record (launches on their
main path, error against the plain version, ms and the plain version's
ms, and the least time the card could take); the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import time

import numpy as np

SEED = 0
IT = 20000                     # past every ease window of the flagship
CHUNK = 1 << 18                # bench.py:103
SIDE = 1 << 10                 # 1024^2 frame, bench.py:104-115
FRAME_T = 0.3
TIMED_FRAMES = 10
PATCH_R8 = (5, 2, 8)           # bench.py's route: (px, py), R (:62-70)
PATCH_R4 = (4, 3, 4)
PVIOL_EXACT = 1e-4             # bench.py:159
# K1 under the f32 policy: the same f32 math, sums in another order
PACK_TOL = 1e-5
# K1 under the bf16 policy: both sides round the same operands and sum
# exact products in f32 in another order; a hidden value on the other
# side of a bf16 rounding boundary moves one bf16 ulp (2^-8 relative)
# into the next layer, which moves points and distances by up to ~1e-3
PACK_TOL_BF16 = 2e-3
SHADE_TOL = 1e-4               # another order of the per-ray warp sums
PATH_TOL = 2e-4                # tests/test_fused_cf.py gate
COMPOSITE_TOL = 1e-5           # f32 scan and sums in another order
F32_RAYS = 16384               # K1's f32-policy check (plain FMA layers)
COMPOSITE_S = 32

# The card's published peaks (NVIDIA H100 SXM data sheet, 700 W): device
# memory bytes/s, f32 operations/s outside the tensor cores, dense bf16
# tensor-core operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
# f32 operations counted from the kernels' sources (csrc/), per sample:
# K1's tail after the MLP (field activations, z and distance, the
# 32-lane sort's compare-exchanges, advection, offsets, normalisation);
# K2/K3's shading of a valid sample after its space features (time taps
# 4C+6, the space x time product C, density nd, basis 54C, SH basis 20,
# SH sums 54, colour 12, validity 8); the bilinear quad blend (8C+10) and
# K3/K4's hat blend of at most four texels (8C+22); the composite of one
# sample with its 5 sums (46) or K7's 4 (40).
K1_TAIL_OPS = 100
COMPOSITE_OPS, COMPOSITE4_OPS = 46, 40


def shade_ops(C, nd):
    return 59 * C + nd + 100


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates; ops = [(count, peak)]."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / peak for n, peak in ops)
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


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


def phase_major(chunks, R):
    """bench.py:125-127, per chunk of a [k, chunk, D] tensor: original ray
    R*j+p at position p*(chunk/R)+j."""
    k, n, D = chunks.shape
    return chunks.reshape(k, n // R, R, D).transpose(1, 2).reshape(k, n, D)


def scanline(chunk_out, R):
    """Per-ray outputs [chunk, D] of phase-major rays -> scanline order."""
    n, D = chunk_out.shape
    return chunk_out.reshape(R, n // R, D).transpose(0, 1).reshape(n, D)


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

    from hyperreel_tpu_torch.configs.presets import (
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


def patch_model(cfg, info, params, shape):
    """The flagship with the coherent patch-gather route (px, py, R) on the
    same weights: (model, prepared tables)."""
    import torch

    from hyperreel_tpu_torch.configs.presets import with_coherent_gather
    from hyperreel_tpu_torch.models.model import build_model

    model = build_model(with_coherent_gather(cfg, *shape), dataset_info=info,
                        compute_dtype=torch.bfloat16)
    return model, model.prepare_eval(params)


class FusedPatch:
    """Set HYPERREEL_FUSED_PATCH for the duration of a with-block."""

    def __init__(self, value):
        self.value, self.old = value, None

    def __enter__(self):
        self.old = os.environ.get("HYPERREEL_FUSED_PATCH")
        os.environ["HYPERREEL_FUSED_PATCH"] = self.value

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("HYPERREEL_FUSED_PATCH", None)
        else:
            os.environ["HYPERREEL_FUSED_PATCH"] = self.old


def bf16_ulp(torch, x):
    """One bf16 ulp of each value (2^(exponent - 7))."""
    return torch.exp2(torch.floor(torch.log2(
        x.abs().clamp_min(2.0 ** -126))) - 7)


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
    t_start = time.perf_counter()

    from hyperreel_tpu_torch.models.ctx import StepCtx
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.ops.kernels import build
    from hyperreel_tpu_torch.ops.kernels.composite import (
        composite, composite_plain)
    from hyperreel_tpu_torch.ops.kernels.pack_build import (
        pack_build, pack_build_plain)
    from hyperreel_tpu_torch.ops.kernels.patch_blend import (
        PatchSpec, patch_blend, patch_blend_plain)
    from hyperreel_tpu_torch.ops.kernels.shade import (
        ShadeSpec, premix_time, shade, shade_plain, shade_preblended,
        shade_preblended_plain)
    from hyperreel_tpu_torch.ops.kernels.shade_patch import (
        shade_patch, shade_patch_plain)

    counted = (pack_build, shade, shade_preblended, shade_patch, patch_blend,
               composite)

    def reset_counts():
        for fn in counted:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in counted}

    # ---- 2. build
    t0 = time.perf_counter()
    lib = build.load_library()
    print(f"# kernels built in {lib.build_seconds:.1f} s "
          f"(loaded after {time.perf_counter() - t0:.1f} s)", flush=True)
    source = ""
    for line in lib.compiler_log.splitlines():
        if line.startswith("== "):
            source = line[3:]
        elif "registers" in line or "spill" in line:
            print(f"# {source}: {line.strip()}")

    # ---- 3. the flagship, K1 and K2 against their plain versions
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
        torch, lambda: pack_build_plain(net_in, tabs, rp, cf.spec, IT), 3)

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
    N = pack.shape[1]
    valid = ((pack[0].abs() <= 1) & (pack[1].abs() <= 1)
             & (pack[2].abs() <= 1) & (pack[3] > 0)).sum().item()
    mlp_ops = 2 * CHUNK * sum(
        p["weight"].numel() for p in
        params["embedding"]["ray_prediction_0"]["net"].values())
    k1_bound = bound(
        nbytes(net_in, rp, pack) + sum(nbytes(l.w, l.b) for l in tabs.layers),
        [(mlp_ops, BF16_OPS_PER_S), (N * K1_TAIL_OPS, F32_OPS_PER_S)])
    k2_bound = bound(
        nbytes(pack, rp, prep["quad"], ttab) + CHUNK * 5 * 4,
        [(valid * (shade_ops(C, nd) + 8 * C + 10) + N * COMPOSITE_OPS,
          F32_OPS_PER_S)])
    print(f"# chunk: {valid} of {N} samples valid; MLP {mlp_ops / 1e9:.1f} "
          f"GFLOP; bounds K1 {k1_bound[0]:.4f} ms ({k1_bound[1]}), K2 "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]})", flush=True)
    del pack_p, out_p
    torch.cuda.empty_cache()

    # ---- 4. the bench frame through model.apply (quad route)
    rk = {"cf_prepared": prep, "uniform_time": True}

    def render(m, frames, rkw):
        return [m.apply(params, frames[i], ctx, rkw)
                for i in range(frames.shape[0])]

    n_chunks = frame.shape[0]
    reset_counts()
    outs = render(model, frame, rk)
    torch.cuda.synchronize()
    quad_counts = read_counts()
    rgb_quad = torch.cat([o["rgb"] for o in outs])
    viol = max(float(o["uniform_time_viol"]) for o in outs)
    print(f"# frame {SIDE}x{SIDE} (quad): rgb {tuple(rgb_quad.shape)} "
          f"min {rgb_quad.min().item():.4f} max {rgb_quad.max().item():.4f} "
          f"mean {rgb_quad.mean().item():.4f}; launches {quad_counts}; "
          f"uniform-time witness {viol}", flush=True)
    want = dict.fromkeys(quad_counts, 0)
    want.update(pack_build=n_chunks, shade=n_chunks)
    if quad_counts != want:
        raise AssertionError(f"kernel launches {quad_counts}, want {want}")
    if not (torch.isfinite(rgb_quad).all() and rgb_quad.min() >= 0
            and rgb_quad.max() <= 1 and rgb_quad.shape == (SIDE * SIDE, 3)):
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
    del fused, general, a, b
    torch.cuda.empty_cache()

    # ---- 6. the patch route's kernels and K7 against their plain versions
    model8, prep8 = patch_model(cfg, info, params, PATCH_R8)
    _, prep4 = patch_model(cfg, info, params, PATCH_R4)
    R8 = PATCH_R8[2]
    frame_pm = phase_major(frame, R8).contiguous()
    chunk_pm = frame_pm[0]
    rp_pm = cf.ray_pack(chunk_pm)
    pack_pm = pack_build(cf.pred.net_input(chunk_pm, ctx).float()
                         .contiguous(), tabs, rp_pm, cf.spec, IT)

    def pspec(shape, pm):
        return PatchSpec(R=shape[2], px=shape[0], py=shape[1], W=W, H=H, C=C,
                         S=cf.S, phase_major=pm)

    ps8, ps4 = pspec(PATCH_R8, True), pspec(PATCH_R4, False)
    k3_err = 0.0
    for name, ptab, pk, rpk, ps in (
            ("R=8 (5,2), phase-major", prep8["patch"], pack_pm, rp_pm, ps8),
            ("R=4 (4,3), scanline", prep4["patch"], pack, rp, ps4)):
        out, vk = shade_patch(ptab, pk, rpk, ttab, prep["wb"], spec, ps)
        out_p, vp = shade_patch_plain(ptab, pk, rpk, ttab, prep["wb"], spec,
                                      ps)
        torch.cuda.synchronize()
        err = (out[:, :4] - out_p[:, :4]).abs().max().item()
        derr = (out[:, 4] - out_p[:, 4]).abs().max().item()
        print(f"# K3 shade_patch {name}: max |kernel - plain| rgb/acc "
              f"{err:.3e}, depth {derr:.3e} (tol {SHADE_TOL}); coverage "
              f"violations {int(vk)} (plain {int(vp)}) of "
              f"{N // ps.R} slots", flush=True)
        if not (err <= SHADE_TOL and derr <= 10 * SHADE_TOL
                and int(vk) == int(vp)):
            raise AssertionError(f"K3 disagrees with its plain version "
                                 f"({name}): {err}, {derr}, {int(vk)} vs "
                                 f"{int(vp)}")
        k3_err = max(k3_err, err)

    feats, vk = patch_blend(prep8["patch"], pack_pm, ps8)
    feats_p, vp = patch_blend_plain(prep8["patch"], pack_pm, ps8)
    fk, fp = feats.float(), feats_p.float()
    # one bf16 ulp of the value (the same f32 sum in another order, then
    # rounded), and 1e-6 where the sum cancels to almost nothing
    f_ratio = ((fk - fp).abs() / (bf16_ulp(torch, torch.maximum(
        fk.abs(), fp.abs())) + 1e-6)).max().item()
    k4_err = (fk - fp).abs().max().item()
    pre = shade_preblended(feats, pack_pm, rp_pm, ttab, prep["wb"], spec)
    pre_p = shade_preblended_plain(feats, pack_pm, rp_pm, ttab, prep["wb"],
                                   spec)
    chain_p = shade_preblended_plain(feats_p, pack_pm, rp_pm, ttab,
                                     prep["wb"], spec)
    torch.cuda.synchronize()
    pre_err = (pre[:, :4] - pre_p[:, :4]).abs().max().item()
    chain_err = (pre[:, :4] - chain_p[:, :4]).abs().max().item()
    print(f"# K4 patch_blend R=8 (5,2): max |kernel - plain| {k4_err:.3e}, "
          f"{f_ratio:.3f} bf16 ulps at most (tol 1); violations "
          f"{int(vk)} (plain {int(vp)}); K2-preblended on the same "
          f"features {pre_err:.3e} (tol {SHADE_TOL}); the chunk through "
          f"K4 + K2-preblended vs both plain versions {chain_err:.3e} "
          f"(tol {PATH_TOL})", flush=True)
    if not (f_ratio <= 1.0 and int(vk) == int(vp) and pre_err <= SHADE_TOL
            and chain_err <= PATH_TOL):
        raise AssertionError(f"K4 / K2-preblended disagree with their "
                             f"plain versions: {f_ratio}, {pre_err}, "
                             f"{chain_err}")

    # the patch kernels and K2 on the same chunk, timed in turns
    # (K2, K3, K4, K2-pre, K2-pre, K4, K3, K2), 20 calls each time
    kernels = {
        "K2": lambda: shade(prep["quad"], pack_pm, rp_pm, ttab, prep["wb"],
                            spec),
        "K3": lambda: shade_patch(prep8["patch"], pack_pm, rp_pm, ttab,
                                  prep["wb"], spec, ps8),
        "K4": lambda: patch_blend(prep8["patch"], pack_pm, ps8),
        "K2-pre": lambda: shade_preblended(feats, pack_pm, rp_pm, ttab,
                                           prep["wb"], spec)}
    turns = {name: [] for name in kernels}
    for name in list(kernels) + list(kernels)[::-1]:
        turns[name].append(cuda_ms(torch, kernels[name], 20))
    print("# one chunk, in turns: " + "; ".join(
        f"{name} " + ", ".join(f"{t:.4f}" for t in ts) + " ms"
        for name, ts in turns.items()), flush=True)
    k3_ms, k4_ms, pre_ms = (sum(turns[n]) / 2 for n in ("K3", "K4",
                                                         "K2-pre"))
    k3_plain_ms = cuda_ms(torch, lambda: shade_patch_plain(
        prep8["patch"], pack_pm, rp_pm, ttab, prep["wb"], spec, ps8), 2)
    k4_plain_ms = cuda_ms(torch, lambda: patch_blend_plain(
        prep8["patch"], pack_pm, ps8), 2)
    pre_plain_ms = cuda_ms(torch, lambda: shade_preblended_plain(
        feats, pack_pm, rp_pm, ttab, prep["wb"], spec), 2)
    valid_pm = ((pack_pm[0].abs() <= 1) & (pack_pm[1].abs() <= 1)
                & (pack_pm[2].abs() <= 1) & (pack_pm[3] > 0)).sum().item()
    out_bytes = CHUNK * 5 * 4
    k3_bound = bound(
        nbytes(pack_pm, rp_pm, prep8["patch"], ttab) + out_bytes + 4,
        [(valid_pm * (shade_ops(C, nd) + 8 * C + 22) + N * COMPOSITE_OPS,
          F32_OPS_PER_S)])
    k4_bound = bound(
        nbytes(pack_pm[:4], prep8["patch"], feats) + 4,
        [(N * (8 * C + 22), F32_OPS_PER_S)])
    pre_bound = bound(
        nbytes(feats, pack_pm, rp_pm, ttab) + out_bytes,
        [(valid_pm * shade_ops(C, nd) + N * COMPOSITE_OPS, F32_OPS_PER_S)])
    print(f"# one chunk: K3 {k3_ms:.3f} ms (plain {k3_plain_ms:.3f}, bound "
          f"{k3_bound[0]:.4f} {k3_bound[1]}), K4 {k4_ms:.3f} ms (plain "
          f"{k4_plain_ms:.3f}, bound {k4_bound[0]:.4f} {k4_bound[1]}), "
          f"K2-preblended {pre_ms:.3f} ms (plain {pre_plain_ms:.3f}, bound "
          f"{pre_bound[0]:.4f} {pre_bound[1]})", flush=True)
    del feats_p, fk, fp, pre_p, chain_p, out_p, prep4
    torch.cuda.empty_cache()

    # K7 through its entry point, inputs from a seeded generator
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sig = 0.05 * torch.rand(CHUNK, COMPOSITE_S, device=dev, generator=gen)
    dst = torch.sort(0.1 + 2.9 * torch.rand(
        CHUNK, COMPOSITE_S, device=dev, generator=gen), -1).values
    col = torch.rand(CHUNK, COMPOSITE_S, 3, device=dev, generator=gen)
    sig[::2, -1] = 0.0     # the last delta is 1e10: half the rays end empty
    reset_counts()
    c_rgb, c_acc = composite(sig, dst, col, cf.net.distance_scale)
    torch.cuda.synchronize()
    k7_launches = read_counts()["composite"]
    p_rgb, p_acc = composite_plain(sig, dst, col, cf.net.distance_scale)
    k7_err = max((c_rgb - p_rgb).abs().max().item(),
                 (c_acc - p_acc).abs().max().item())
    k7_ms = cuda_ms(torch, lambda: composite(sig, dst, col,
                                             cf.net.distance_scale), 20)
    k7_plain_ms = cuda_ms(torch, lambda: composite_plain(
        sig, dst, col, cf.net.distance_scale), 3)
    k7_bound = bound(nbytes(sig, dst, col) + CHUNK * 4 * 4,
                     [(sig.numel() * COMPOSITE4_OPS, F32_OPS_PER_S)])
    print(f"# K7 composite B={CHUNK} S={COMPOSITE_S}: launches "
          f"{k7_launches}, max |kernel - plain| {k7_err:.3e} (tol "
          f"{COMPOSITE_TOL}), acc mean {c_acc.mean().item():.4f}; "
          f"{k7_ms:.4f} ms (plain {k7_plain_ms:.3f}, bound "
          f"{k7_bound[0]:.4f} {k7_bound[1]})", flush=True)
    if k7_launches != 1 or not k7_err <= COMPOSITE_TOL:
        raise AssertionError(f"K7: launches {k7_launches}, error {k7_err}")
    del sig, dst, col, p_rgb, p_acc

    # ---- 7. the bench frame on the patch route
    rk8 = {"cf_prepared": prep8, "uniform_time": True}
    route_counts = {}
    for route, fused_env, kernels in (
            ("fused patch", "1", {"shade_patch": n_chunks}),
            ("two-kernel patch", "0", {"patch_blend": n_chunks,
                                       "shade_preblended": n_chunks})):
        for order, frames in (("phase-major", frame_pm),
                              ("scanline", frame)):
            pm = order == "phase-major"
            with FusedPatch(fused_env):
                reset_counts()
                outs = render(model8, frames, {**rk8,
                                               "rays_phase_major": pm})
                torch.cuda.synchronize()
                got = read_counts()
            want = dict.fromkeys(got, 0)
            want.update(pack_build=n_chunks, **kernels)
            if pm:
                route_counts[route] = got
            rgb = torch.cat([scanline(o["rgb"], R8) if pm else o["rgb"]
                             for o in outs])
            pviol = max(float(o["patch_coverage_viol"]) for o in outs)
            err = (rgb - rgb_quad).abs().max().item()
            print(f"# frame ({route}, {order} rays): launches {got}; "
                  f"coverage witness {pviol:.3e} (gate {PVIOL_EXACT}); rgb "
                  f"vs the quad route's frame {err:.3e} (tol {PATH_TOL})",
                  flush=True)
            if got != want:
                raise AssertionError(f"kernel launches {got}, want {want}")
            if not (pviol <= PVIOL_EXACT and err <= PATH_TOL):
                raise AssertionError(f"patch route ({route}, {order}): "
                                     f"witness {pviol}, rgb error {err}")

    # ---- 8. frame time of the three routes, in turns
    rk_pm = {**rk8, "rays_phase_major": True}
    routes = {"quad": ("1", model, frame, rk),
              "fused patch": ("1", model8, frame_pm, rk_pm),
              "two-kernel patch": ("0", model8, frame_pm, rk_pm)}
    times = {name: [] for name in routes}
    for name in (list(routes) + list(routes)[::-1]) * 2:
        env, m, frames, rkw = routes[name]
        with FusedPatch(env):
            times[name].append(cuda_ms(
                torch, lambda: render(m, frames, rkw), TIMED_FRAMES))
    frame_ms = {}
    for name, ts in times.items():
        frame_ms[name] = sum(ts) / len(ts)
        print(f"# {card.splitlines()[0]}: {name} route {frame_ms[name]:.3f} "
              f"ms/frame, {SIDE * SIDE / frame_ms[name] / 1e3:.3f} Mrays/s "
              f"({TIMED_FRAMES} frames after a warm-up frame, 4 times: "
              + ", ".join(f"{t:.3f}" for t in ts) + ")", flush=True)
    print(f"# chip_smoke took {time.perf_counter() - t_start:.1f} s after "
          "the card check", flush=True)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda",
                "source": f"hyperreel_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    record = {"kernels": [
        entry("pack_build", "pack_build.cu",
              "hyperreel_tpu/ops/pallas/pack_build.py:137",
              quad_counts["pack_build"], k1_err, k1_ms, k1_plain_ms,
              k1_bound),
        entry("shade", "shade.cu", "hyperreel_tpu/ops/pallas/shade.py:238",
              quad_counts["shade"], k2_err, k2_ms, k2_plain_ms, k2_bound),
        entry("shade_preblended", "shade.cu",
              "hyperreel_tpu/ops/pallas/shade.py:259",
              route_counts["two-kernel patch"]["shade_preblended"], pre_err,
              pre_ms, pre_plain_ms, pre_bound),
        entry("shade_patch", "shade_patch.cu",
              "hyperreel_tpu/ops/pallas/shade.py:282",
              route_counts["fused patch"]["shade_patch"], k3_err, k3_ms,
              k3_plain_ms, k3_bound),
        entry("patch_blend", "patch_blend.cu",
              "hyperreel_tpu/ops/pallas/patch_blend.py:51",
              route_counts["two-kernel patch"]["patch_blend"], k4_err, k4_ms,
              k4_plain_ms, k4_bound),
        entry("composite", "composite.cu",
              "hyperreel_tpu/ops/pallas/composite.py:26", k7_launches,
              k7_err, k7_ms, k7_plain_ms, k7_bound)],
        "frame_ms": frame_ms}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
