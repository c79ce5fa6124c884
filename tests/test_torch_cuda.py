"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: without an NVIDIA card every test here skips (CUDA
kernels have no CPU mode; the plain versions are held against the JAX
package by tests/test_torch_pack_build.py, test_torch_shade.py,
test_torch_slice.py, test_torch_patch.py, test_torch_patch_route.py,
test_torch_composite.py, test_torch_static.py, test_torch_multi.py,
test_torch_dynamic_multi.py and test_torch_rgb.py).
Run on the card with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file does not
use and the machine with the card may not have.)
"""

import dataclasses

import numpy as np
import pytest
import torch

from hyperreel_tpu_torch.configs.presets import (
    convert_epochs_to_iters, llff_z_plane, neural_3d_z_plane, shiny_z_plane,
    stanford_llff_z_plane, technicolor_z_plane, tiny_dynamic,
    tiny_immersive_sphere, tiny_neural_3d, tiny_shiny, tiny_stanford_llff,
    tiny_static, with_coherent_gather)
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model
from hyperreel_tpu_torch.ops.kernels import build
from hyperreel_tpu_torch.ops.kernels.composite import (
    composite, composite_plain)
from hyperreel_tpu_torch.ops.kernels.pack_build import (
    mlp_tables, pack_build, pack_build_plain, pack_error)
from hyperreel_tpu_torch.ops.kernels.patch_blend import (
    PatchSpec, patch_blend, patch_blend_plain, patch_params)
from hyperreel_tpu_torch.ops.kernels.shade import (
    ShadeSpec, premix_time, quad_table, shade, shade_folded_plain,
    shade_params, shade_plain, shade_preblended,
    shade_preblended_folded_plain, shade_preblended_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    AxisSpec, MultiSpec, multi_params, shade_multi, shade_multi_plain,
    shade_multi_preblended, shade_multi_preblended_folded_plain,
    shade_multi_preblended_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
    shade_multi_patch, shade_multi_patch_folded_plain,
    shade_multi_patch_plain)
from hyperreel_tpu_torch.ops.kernels.shade_patch import (
    shade_patch, shade_patch_folded_plain, shade_patch_plain)
from hyperreel_tpu_torch.configs.presets import (
    with_compact_samples, with_inference_samples)
from hyperreel_tpu_torch.models.intersect import FAR_SENTINEL

pytestmark = pytest.mark.cuda

INFO = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(tiny, dev, bf16=False, patch=None):
    cfg = convert_epochs_to_iters(
        tiny_dynamic() if tiny else technicolor_z_plane(), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, dataset_info=INFO,
                        compute_dtype=torch.bfloat16 if bf16 else None)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.3 * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, model, params


def _rays(n, dev, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3))
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (n, 3))
    d[:, 2] = 1.0
    cam = rng.integers(0, 16, (n, 1))
    t = rng.uniform(0, 1, (n, 1))
    rays = np.concatenate([o, d, cam, t], -1).astype(np.float32)
    return torch.from_numpy(rays).to(dev)


# K1 under the f32 MLP policy runs the same f32 math as its plain version
# (1e-5); under the bf16 policy both sum exact bf16 products in another
# order, and a rounding flip in a hidden layer moves the pack by up to
# ~1e-3 (chip_smoke.py PACK_TOL_BF16). Ray counts: one ray, one 128-ray
# tile less one, ragged and whole tiles, and (test_n3d_pack_build_...)
# more tiles than a persistent grid of 132 blocks takes in one round, its
# last tile ragged. The chunk-colour gate below holds both kernels to both
# plain versions at 2e-4; over tens of thousands of random rays a sample
# that a bf16 rounding flip moves across the aabb's face changes its ray's
# colour by more (0.058 at 33,869 tiny rays), so the pack alone is held
# there.
RAGGED_PERSISTENT = 2 * 132 * 128 + 77
K1_RAYS = [1, 127, 1000, 4096]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("tiny", [True, False], ids=["S8", "S32"])
@pytest.mark.parametrize("n", K1_RAYS)
def test_kernels_match_plain(dev, tiny, n, bf16):
    _, model, params = _model(tiny, dev, bf16)
    cf = model._cf_eval
    prep = cf.prepare(params)
    ctx = StepCtx(it=20000)
    rays = _rays(n, dev)
    x0 = cf.pred.net_input(rays, ctx).float().contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    assert (pack - pack_p).abs().max() <= (2e-3 if bf16 else 1e-5)
    H, W, TH, TW, C, nd = prep["dims"]
    for th in (TH, 0):
        ttab = prep["ttab"] if th else premix_time(prep["ttab"], rp[0, 7])
        spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        out = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        ref = shade_plain(prep["quad"], pack, rp, ttab, prep["wb"], spec)
        torch.cuda.synchronize()
        # the per-ray sums run in another order (a running sum per ray)
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
        # both kernels against both plain versions: the fused-path gate
        ref = shade_plain(prep["quad"], pack_p, rp, ttab, prep["wb"], spec)
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 2e-4


def test_fused_model_matches_general_on_card(dev):
    import copy
    cfg, model, params = _model(True, dev)
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    general = build_model(cfg_g, dataset_info=INFO)
    rays = _rays(4096, dev, seed=1)
    ctx = StepCtx(it=20000)
    before = (pack_build.launches, shade.launches)
    a = model.apply(params, rays, ctx)["rgb"]
    assert (pack_build.launches, shade.launches) == (before[0] + 1,
                                                     before[1] + 1)
    b = general.apply(params, rays, ctx)["rgb"]
    assert (a - b).abs().max() <= 2e-4


def _frame_rays(side, dev, R=None):
    """A side x side crop of bench.py's 1024^2 camera (its pixel density),
    scanline order, or phase-major for blocks of R (bench.py:125-127)."""
    u = (np.arange(1024) - 511.5)[512 - side // 2:512 + side // 2] / 1228.8
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
    o = np.zeros_like(d)
    o[:, 2] = -1.5
    n = d.shape[0]
    rays = np.concatenate([o, d, np.full((n, 1), 3.0),
                           np.full((n, 1), 0.3)], -1).astype(np.float32)
    if R:
        rays = rays.reshape(n // R, R, 8).transpose(1, 0, 2).reshape(n, 8)
    return torch.from_numpy(np.ascontiguousarray(rays)).to(dev)


def _ulps(a, b):
    """|a - b| in bf16 ulps of the larger value (1e-6 where a sum
    cancels to almost nothing)."""
    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    return ((a - b).abs() / (torch.exp2(torch.floor(torch.log2(big)) - 7)
                             + 1e-6)).max().item()


# K3 and K2-preblended hold the per-ray sums at K2's 1e-4; K4's bf16
# features may differ by one bf16 ulp (the same f32 sum in another order,
# then rounded); the coverage counts are exact.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("tiny,patch", [(True, (4, 3, 4)), (True, (5, 2, 8)),
                                        (False, (5, 2, 8))],
                         ids=["S8_R4", "S8_R8", "S32_R8"])
def test_patch_kernels_match_plain(dev, tiny, patch, pm):
    _, model, params = _model(tiny, dev, bf16=True, patch=patch)
    cf = model._cf_eval
    prep = cf.prepare(params)
    H, W, TH, TW, C, nd = prep["dims"]
    rays = _frame_rays(40, dev, patch[2] if pm else None)    # 1600 rays
    rp = cf.ray_pack(rays)
    pack = pack_build(cf.pred.net_input(rays, StepCtx(it=20000)).float()
                      .contiguous(), prep["mlp"], rp, cf.spec, 20000)
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=0, C=C, nd=nd,
                     deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    ps = PatchSpec(R=patch[2], px=patch[0], py=patch[1], W=W, H=H, C=C,
                   S=cf.S, phase_major=pm)
    ttab = premix_time(prep["ttab"], rp[0, 7])
    out, v = shade_patch(prep["patch"], pack, rp, ttab, prep["wb"], spec, ps)
    ref, vr = shade_patch_plain(prep["patch"], pack, rp, ttab, prep["wb"],
                                spec, ps)
    torch.cuda.synchronize()
    assert int(v) == int(vr)
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    (feats,), v = patch_blend([prep["patch"]], pack, [ps])
    (feats_p,), vr = patch_blend_plain([prep["patch"]], pack, [ps])
    assert int(v) == int(vr) and _ulps(feats, feats_p) <= 1.0
    pre = shade_preblended(feats, pack, rp, ttab, prep["wb"], spec)
    ref = shade_preblended_plain(feats, pack, rp, ttab, prep["wb"], spec)
    assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    # the two routes agree with each other and with the quad route
    quad = shade(prep["quad"], pack, rp, ttab, prep["wb"], spec)
    assert (pre[:, :4] - out[:, :4]).abs().max() <= 2e-4
    assert (quad[:, :4] - out[:, :4]).abs().max() <= 2e-4


# K4 and K3 on synthetic inputs over every (C, R, S) they are built for:
# random bf16 patch tables, J = 41 coherent blocks (a multiple of no
# warp's 32 / R blocks, so the last warp holds dead blocks), the R rays of
# a slot within 0.4 texel of each other but one block in four spread over
# 3 texels (violating slots), points partly outside the aabb and some
# invalid samples, in phase-major and scanline order.
PATCH_SHAPES = {4: (4, 3), 8: (5, 2)}
PLANE_AXES = ((0, 1), (0, 2), (1, 2))
GRID = (37, 23, 29)               # the grid size along x, y, z


def _synthetic_patch(dev, S, R, chans, pm, seed):
    """(patch tables, pack [10, B*S], ray pack [B, 8], PatchSpecs) for one
    plane per entry of `chans` (its coordinates PLANE_AXES[a])."""
    rng = np.random.default_rng(seed)
    J = 41
    B = R * J
    wide = rng.uniform(0, 1, (1, J, 1)) < 0.25
    xyz = np.stack([rng.uniform(-1.05, 1.05, (1, J, S))
                    + rng.uniform(0, 1, (R, J, S))
                    * np.where(wide, 3.0, 0.4) * 2.0 / (size - 1)
                    for size in GRID])                       # [3, R, J, S]
    dist = np.sort(rng.uniform(0.0, 3.0, (R, J, S)), -1)
    dist[..., :2] *= rng.uniform(0, 1, (R, J, 1)) < 0.7
    pack = np.concatenate([xyz, dist[None],
                           rng.normal(0, 0.1, (6, R, J, S))])
    if not pm:                      # ray R*j + p at position R*j + p
        pack = pack.transpose(0, 2, 1, 3)
    vd = rng.normal(0, 1, (B, 3))
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), vd,
                           np.zeros((B, 2))], 1)
    px, py = PATCH_SHAPES[R]
    specs, ptabs = [], []
    for C, (m0, m1) in zip(chans, PLANE_AXES):
        W, H = GRID[m0], GRID[m1]
        specs.append(PatchSpec(R=R, px=px, py=py, W=W, H=H, C=C, S=S,
                               phase_major=pm, m0=m0, m1=m1))
        ptabs.append(torch.from_numpy(rng.normal(
            0, 1, ((H + 1) * (W + 1), px * py * C)).astype(np.float32)).to(
                torch.bfloat16).to(dev))
    return (ptabs, torch.from_numpy(np.ascontiguousarray(
        pack.reshape(10, B * S)).astype(np.float32)).to(dev),
            torch.from_numpy(rays.astype(np.float32)).to(dev), specs)


@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("S", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("chans", [(8,), (16,), (16, 8, 8)],
                         ids=["C8", "C16", "planes_16_8_8"])
def test_patch_blend_grid_matches_plain(dev, chans, R, S, pm):
    """K4 in one launch over one plane or three: each plane's features
    within one bf16 ulp, the count of slots that violate on any plane
    exact and not 0."""
    ptabs, pack, _, specs = _synthetic_patch(dev, S, R, chans, pm, S + R)
    before = patch_blend.launches
    feats, v = patch_blend(ptabs, pack, specs)
    assert patch_blend.launches == before + 1
    feats_p, vp = patch_blend_plain(ptabs, pack, specs)
    torch.cuda.synchronize()
    assert int(v) == int(vp) > 0
    for f, fp, s in zip(feats, feats_p, specs):
        assert f.shape == fp.shape == (pack.shape[1], s.C)
        assert _ulps(f, fp) <= 1.0


@pytest.mark.parametrize("nd", ["half", "quarter"])
@pytest.mark.parametrize("shading", ["sh", "rgb"])
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("S", [4, 8, 16, 32])
@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("C", [8, 16])
def test_shade_patch_grid_matches_plain(dev, C, R, S, pm, shading, nd):
    """K3 against its plain version and its folded plain version, at K2's
    tolerances (1e-4 on rgb/acc, 1e-3 on depth); the witness exact. SH
    colour is built for C / 2 density channels (every preset's): C / 4 is
    refused before a launch."""
    ptabs, pack, rp, (ps,) = _synthetic_patch(dev, S, R, (C,), pm,
                                              10 + S + R)
    gen = torch.Generator().manual_seed(C + R)
    nd, TW = C // 2 if nd == "half" else C // 4, 19
    K = 1 if shading == "rgb" else 9
    wb = torch.cat([torch.zeros(3 * K, nd),
                    0.3 * torch.randn(3 * K, C - nd, generator=gen)], 1)
    ttab = torch.rand(TW, C, generator=gen).to(dev)
    spec = ShadeSpec(S=S, W=ps.W, H=ps.H, TW=TW, TH=0, C=C, nd=nd, deg=2,
                     distance_scale=4.0, shading=shading)
    if shading == "sh" and 2 * nd != C:
        before = shade_patch.launches
        with pytest.raises(NotImplementedError):
            shade_patch(ptabs[0], pack, rp, ttab, wb, spec, ps)
        assert shade_patch.launches == before
        return
    out, v = shade_patch(ptabs[0], pack, rp, ttab, wb, spec, ps)
    for plain in (shade_patch_plain, shade_patch_folded_plain):
        ref, vr = plain(ptabs[0], pack, rp, ttab, wb, spec, ps)
        torch.cuda.synchronize()
        assert int(v) == int(vr) > 0
        assert ref[:, 3].max() > 0.5
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3


def _k6_inputs(dev, S, R, TH, shading, pm, seed, deg=2):
    """Synthetic inputs of K6 and K5-preblended at the [8, 4, 4] layout:
    _synthetic_patch's three planes (C = 16, 8, 8, half of each density;
    B = 41 R rays, a multiple of R but not of 128) with, in coherent block
    3, one slot (sample 0) whose samples are all invalid; each axis's line
    [L, C] or time plane [12, L, C] in [0, 0.4) (TH "mix": a time plane on
    axis 0, lines on the others); a t per ray in [-1, 1]; an SH [27, 16]
    or RGB [3, 16] basis (SH of degree `deg`: [3 (deg + 1)^2, 16]);
    random bf16 pre-blended features [B*S, C]."""
    ptabs, pack, rp, pspecs = _synthetic_patch(dev, S, R, (16, 8, 8), pm,
                                               seed)
    rng = np.random.default_rng(seed + 1)
    B, J = pack.shape[1] // S, pack.shape[1] // S // R
    pos = [p * J + 3 if pm else 3 * R + p for p in range(R)]
    pack.view(10, B, S)[3, pos, 0] = 0.0
    rp[:, 7] = torch.from_numpy(rng.uniform(-1, 1, B).astype(
        np.float32)).to(dev)
    axes, lines = [], []
    for a, (ps, (m0, m1)) in enumerate(zip(pspecs, PLANE_AXES)):
        th = K6_TH if TH == K6_TH or (TH == "mix" and a == 0) else 0
        L = GRID[3 - m0 - m1]
        axes.append(AxisSpec(index=a, W=ps.W, H=ps.H, L=L, C=ps.C,
                             nd=ps.C // 2, TH=th))
        lines.append(torch.from_numpy(rng.uniform(
            0, 0.4, (th, L, ps.C) if th else (L, ps.C)).astype(np.float32))
            .to(dev))
    K = 1 if shading == "rgb" else (deg + 1) ** 2
    wb = torch.from_numpy(rng.normal(0, 0.3, (3 * K, 16)).astype(np.float32))
    spec = MultiSpec(S=S, axes=tuple(axes), deg=deg, distance_scale=4.0,
                     shading=shading)
    feats = [torch.from_numpy(rng.normal(0, 0.5, (B * S, a.C)).astype(
        np.float32)).to(torch.bfloat16).to(dev) for a in axes]
    return ptabs, lines, pack, rp, wb, spec, pspecs, feats


K6_TH = 12


# K6 and K5-preblended at every spec they take: S = 1-64, R = 4 and 8,
# lines, time planes (and, for K6, a mix), SH and RGB, both ray orders;
# against their plain versions and their folded plain versions at the
# multi-axis tolerances (1e-4 on rgb/acc, 1e-3 on depth), the witness
# exact. K5-preblended refuses a mix of lines and time planes (as the
# quad kernel does) before any launch.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("shading", ["sh", "rgb"])
@pytest.mark.parametrize("TH", [0, K6_TH, "mix"], ids=["lines", "time",
                                                      "mix"])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("R", [4, 8])
def test_k6_k5_pre_grid_matches_plain(dev, R, S, TH, shading, pm):
    ptabs, lines, pack, rp, wb, spec, pspecs, feats = _k6_inputs(
        dev, S, R, TH, shading, pm, 20 + S + R)
    before = shade_multi_patch.launches
    out, v = shade_multi_patch(ptabs, lines, pack, rp, wb, spec, pspecs)
    assert shade_multi_patch.launches == before + 1
    for plain in (shade_multi_patch_plain, shade_multi_patch_folded_plain):
        ref, vr = plain(ptabs, lines, pack, rp, wb, spec, pspecs)
        torch.cuda.synchronize()
        assert int(v) == int(vr)
        assert S < 4 or int(v) > 0
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    before = shade_multi_preblended.launches
    if TH == "mix":
        with pytest.raises(NotImplementedError, match="mix"):
            shade_multi_preblended(feats, lines, pack, rp, wb, spec)
        assert shade_multi_preblended.launches == before
        return
    pre = shade_multi_preblended(feats, lines, pack, rp, wb, spec)
    assert shade_multi_preblended.launches == before + 1
    for plain in (shade_multi_preblended_plain,
                  shade_multi_preblended_folded_plain):
        ref = plain(feats, lines, pack, rp, wb, spec)
        torch.cuda.synchronize()
        assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (pre[:, 4] - ref[:, 4]).abs().max() <= 1e-3


def test_k5_pre_and_k6_refuse_the_weights_row(dev):
    """K5-preblended and K6 are built without the weights row (ROADMAP.md
    2a): the wrappers raise before any launch (K6 on its spec: its pack
    has no weights row), and the C entry points return
    cudaErrorInvalidValue and write nothing."""
    ptabs, lines, pack, rp, wb, spec, pspecs, feats = _k6_inputs(
        dev, 8, 4, 0, "sh", True, 5)
    pack_w = torch.cat([pack, torch.ones_like(pack[:1])]).contiguous()
    wspec = dataclasses.replace(spec, weights=True)
    n6, npre = shade_multi_patch.launches, shade_multi_preblended.launches
    with pytest.raises(NotImplementedError, match="weights"):
        shade_multi_patch(ptabs, lines, pack, rp, wb, wspec, pspecs)
    with pytest.raises(NotImplementedError, match="weights"):
        shade_multi_preblended(feats, lines, pack_w, rp, wb, wspec)
    assert shade_multi_patch.launches == n6
    assert shade_multi_preblended.launches == npre
    B = rp.shape[0]
    lib = build.load_library().lib
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((B, 5), float("nan"), device=dev)
    viol = torch.zeros(1, dtype=torch.int32, device=dev)
    rc6 = lib.shade_multi_patch_launch(
        pack.data_ptr(), rp.data_ptr(), out.data_ptr(), viol.data_ptr(),
        multi_params(B, wspec, ptabs, lines, wb),
        patch_params(B, pspecs[0]), stream)
    rcp = lib.shade_multi_preblended_launch(
        pack_w.data_ptr(), rp.data_ptr(), out.data_ptr(),
        multi_params(B, wspec, feats, lines, wb), stream)
    torch.cuda.synchronize()
    assert rc6 == rcp == 1                   # cudaErrorInvalidValue
    assert out.isnan().all() and int(viol) == 0


def _shade_grid_inputs(dev, C, S, TH, nd, shading, weights, B, pre, deg=2):
    """Synthetic inputs of K2 / K2-preblended: a pack [10 or 11, B*S]
    (points partly outside the aabb, sorted distances with a few invalid
    0 samples, the weights row in [0, 2)), a ray pack [B, 8] (unit view
    directions, t in [-1, 1]), a random bf16 quad table of a 33 x 29 plane
    or bf16 features [B*S, C], a time plane [TH, 19, C] or a premixed
    table [19, C] in [0, 1), and a basis [3K, C] zero on the nd density
    columns (K = (deg + 1)^2 for SH of degree `deg`, 1 for RGB)."""
    gen = torch.Generator().manual_seed(C * 1000 + S * 10 + TH)
    W, H, TW = 33, 29, 19
    xyz = 2.2 * torch.rand(3, B, S, generator=gen) - 1.1
    dist = torch.sort(3.0 * torch.rand(B, S, generator=gen), 1).values
    dist[:, :1] *= (torch.rand(B, 1, generator=gen) > 0.3).float()
    rows = [xyz, dist[None], 0.1 * torch.randn(6, B, S, generator=gen)]
    if weights:
        rows.append(2.0 * torch.rand(1, B, S, generator=gen))
    pack = torch.cat(rows).reshape(-1, B * S)
    vd = torch.randn(B, 3, generator=gen)
    vd = vd / vd.norm(dim=1, keepdim=True)
    rp = torch.cat([torch.randn(B, 3, generator=gen), vd,
                    0.1 * torch.randn(B, 1, generator=gen),
                    2.0 * torch.rand(B, 1, generator=gen) - 1.0], 1)
    if pre:
        space = torch.rand(B * S, C, generator=gen).to(torch.bfloat16)
    else:
        space = torch.rand((H + 1) * (W + 1), 4 * C,
                           generator=gen).to(torch.bfloat16)
    ttab = torch.rand(*((TH,) if TH else ()), TW, C, generator=gen)
    nd = C // 2 if nd == "half" else C // 4
    K = 1 if shading == "rgb" else (deg + 1) ** 2
    wb = torch.cat([torch.zeros(3 * K, nd),
                    0.3 * torch.randn(3 * K, C - nd, generator=gen)], 1)
    spec = ShadeSpec(S=S, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd, deg=deg,
                     distance_scale=4.0, shading=shading, weights=weights)
    return (space.to(dev), pack.contiguous().to(dev), rp.to(dev),
            ttab.contiguous().to(dev), wb, spec)


# K2 and K2-preblended on every spec csrc/shade.cu takes: C, every power
# of two S <= 32 (a stage of 1 or 2 samples is loaded by scalars), the
# time plane and a premixed table, both density splits (the SH fold over
# the appearance half where the basis's first C / 2 columns are zero, else
# over all C), SH and RGB colour, the weights row, a whole number of
# 128-ray blocks and a ragged one; against both plain versions at 1e-4 on
# rgb/acc and 1e-3 on depth. K2-preblended with the weights row is refused
# before a launch, by the wrapper and by the C entry point.
@pytest.mark.parametrize("pre", [False, True], ids=["quad", "preblended"])
@pytest.mark.parametrize("B", [4096, 4096 - 37], ids=["B4096", "ragged"])
@pytest.mark.parametrize("weights", [False, True], ids=["no_w", "weights"])
@pytest.mark.parametrize("shading", ["sh", "rgb"])
@pytest.mark.parametrize("nd", ["half", "quarter"])
@pytest.mark.parametrize("TH", [0, 4])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("C", [8, 16])
def test_shade_grid_matches_plain(dev, C, S, TH, nd, shading, weights, B,
                                  pre):
    space, pack, rp, ttab, wb, spec = _shade_grid_inputs(
        dev, C, S, TH, nd, shading, weights, B, pre)
    kernel, plains = (shade_preblended, (
        shade_preblended_plain, shade_preblended_folded_plain)) if pre \
        else (shade, (shade_plain, shade_folded_plain))
    if pre and weights:
        before = shade_preblended.launches
        with pytest.raises(NotImplementedError):
            kernel(space, pack, rp, ttab, wb, spec)
        assert shade_preblended.launches == before
        out = torch.full((B, 5), float("nan"), device=dev)
        rc = build.load_library().lib.shade_preblended_launch(
            space.data_ptr(), pack.data_ptr(), rp.data_ptr(),
            ttab.data_ptr(), out.data_ptr(), shade_params(B, spec, wb),
            torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert rc == 1                       # cudaErrorInvalidValue
        assert out.isnan().all()
        return
    before = kernel.launches
    out = kernel(space, pack, rp, ttab, wb, spec)
    assert kernel.launches == before + 1
    for plain in plains:
        ref = plain(space, pack, rp, ttab, wb, spec)
        torch.cuda.synchronize()
        assert ref[:, 3].max() > 0.5
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3


SH_DEGREES = (0, 1, 3, 4)     # degree 2: the grids above


# The six shade kernels at SH degrees 0, 1, 3 and 4 (the basis count a
# run-time value of the kernels): K2 (time plane and premixed, the weights
# row, both density splits), K2-preblended, K3, K5 (lines and time
# planes), K5-preblended and K6, against their plain versions and their
# folded plain versions at the tolerances above; the C entry points refuse
# a basis count that is no degree's (5) and write nothing.
@pytest.mark.parametrize("deg", SH_DEGREES)
def test_sh_degrees_match_plain(dev, deg):
    for C, S, TH, nd, weights in ((16, 32, 4, "half", False),
                                  (8, 8, 0, "quarter", True),
                                  (16, 16, 0, "half", False)):
        for pre in (False, True) if not weights else (False,):
            space, pack, rp, ttab, wb, spec = _shade_grid_inputs(
                dev, C, S, TH, nd, "sh", weights, 4096 - 37, pre, deg)
            kernel, plains = (shade_preblended, (
                shade_preblended_plain, shade_preblended_folded_plain)) \
                if pre else (shade, (shade_plain, shade_folded_plain))
            out = kernel(space, pack, rp, ttab, wb, spec)
            for plain in plains:
                ref = plain(space, pack, rp, ttab, wb, spec)
                torch.cuda.synchronize()
                assert ref[:, 3].max() > 0.5
                assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
                assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    for C, R, S in ((16, 8, 32), (8, 4, 8)):
        ptabs, pack, rp, (ps,) = _synthetic_patch(dev, S, R, (C,), True,
                                                  10 + S + R + deg)
        gen = torch.Generator().manual_seed(C + R + deg)
        K, TW = (deg + 1) ** 2, 19
        wb = torch.cat([torch.zeros(3 * K, C // 2),
                        0.3 * torch.randn(3 * K, C // 2, generator=gen)], 1)
        ttab = torch.rand(TW, C, generator=gen).to(dev)
        spec = ShadeSpec(S=S, W=ps.W, H=ps.H, TW=TW, TH=0, C=C, nd=C // 2,
                         deg=deg, distance_scale=4.0)
        out, v = shade_patch(ptabs[0], pack, rp, ttab, wb, spec, ps)
        for plain in (shade_patch_plain, shade_patch_folded_plain):
            ref, vr = plain(ptabs[0], pack, rp, ttab, wb, spec, ps)
            torch.cuda.synchronize()
            assert int(v) == int(vr) > 0
            assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
            assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    for TH, S, R in ((0, 32, 8), (K6_TH, 64, 4)):
        ptabs, lines, pack, rp, wb, spec, pspecs, feats = _k6_inputs(
            dev, S, R, TH, "sh", True, 30 + S + deg, deg)
        out, v = shade_multi_patch(ptabs, lines, pack, rp, wb, spec, pspecs)
        for plain in (shade_multi_patch_plain,
                      shade_multi_patch_folded_plain):
            ref, vr = plain(ptabs, lines, pack, rp, wb, spec, pspecs)
            torch.cuda.synchronize()
            assert int(v) == int(vr)
            assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
            assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
        pre = shade_multi_preblended(feats, lines, pack, rp, wb, spec)
        for plain in (shade_multi_preblended_plain,
                      shade_multi_preblended_folded_plain):
            ref = plain(feats, lines, pack, rp, wb, spec)
            torch.cuda.synchronize()
            assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
            assert (pre[:, 4] - ref[:, 4]).abs().max() <= 1e-3
        # K5's quad kernel on random quad tables of the same planes
        gen = torch.Generator().manual_seed(S + deg)
        quads = [torch.rand((a.H + 1) * (a.W + 1), 4 * a.C, generator=gen)
                 .to(torch.bfloat16).to(dev) for a in spec.axes]
        out = shade_multi(quads, lines, pack, rp, wb, spec)
        ref = shade_multi_plain(quads, lines, pack, rp, wb, spec)
        torch.cuda.synchronize()
        assert ref[:, 3].max() > 0.5
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    # a basis count that is no degree's: every launcher refuses it
    space, pack, rp, ttab, wb, spec = _shade_grid_inputs(
        dev, 16, 8, 0, "half", "sh", False, 256, False, deg)
    sp = shade_params(256, spec, wb)
    sp.nb = 5
    lib = build.load_library().lib
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.full((256, 5), float("nan"), device=dev)
    assert lib.shade_launch(space.data_ptr(), pack.data_ptr(), rp.data_ptr(),
                            ttab.data_ptr(), out.data_ptr(), sp,
                            stream) == 1
    ptabs, lines, pack, rp, wb, spec, pspecs, feats = _k6_inputs(
        dev, 8, 4, 0, "sh", True, 5, deg)
    mp = multi_params(rp.shape[0], spec, feats, lines, wb)
    mp.nb = 5
    assert lib.shade_multi_preblended_launch(
        pack.data_ptr(), rp.data_ptr(), out.data_ptr(), mp, stream) == 1
    torch.cuda.synchronize()
    assert out.isnan().all()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# Each route against the same route on the CPU (its kernels' plain
# versions) at the fused-path gate; the fused route also against the quad
# route (exact at the bench's pixel density). The two-kernel route rounds
# its features to bf16 as the JAX route does (2^-9 relative), which moves
# this scene's rgb by up to ~2e-4 from the quad route's.
@pytest.mark.parametrize("fused,kernels", [
    ("1", {"shade_patch": 1}),
    ("0", {"patch_blend": 1, "shade_preblended": 1})], ids=["fused", "two"])
def test_patch_route_launches_on_card(dev, fused, kernels, monkeypatch):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH", fused)
    _, model, params = _model(True, dev, patch=(5, 2, 8))
    _, quad, _ = _model(True, dev)
    fns = (pack_build, shade, shade_patch, patch_blend, shade_preblended)
    before = {f.__name__: f.launches for f in fns}
    rays = _frame_rays(64, dev, 8)
    rk = {"rays_phase_major": True, "uniform_time": True}
    out = model.apply(params, rays, StepCtx(it=20000), rk)
    got = {f.__name__: f.launches - before[f.__name__] for f in fns}
    want = dict.fromkeys(got, 0)
    want.update(pack_build=1, **kernels)
    assert got == want
    assert float(out["patch_coverage_viol"]) <= 1e-4
    plain = model.apply(_to(params, "cpu"), rays.cpu(), StepCtx(it=20000),
                        rk)
    # K1 and its plain version differ by ~1e-7 (f32 sums in another
    # order), which can move a sample across a texel edge
    assert abs(float(plain["patch_coverage_viol"])
               - float(out["patch_coverage_viol"])) <= 1e-3
    assert (out["rgb"].cpu() - plain["rgb"]).abs().max() <= 2e-4
    if fused == "1":
        exact = quad.apply(params, rays, StepCtx(it=20000),
                           {"uniform_time": True})
        assert (out["rgb"] - exact["rgb"]).abs().max() <= 2e-4


@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("B", [1000, 4096])
def test_composite_matches_plain(dev, S, B):
    gen = torch.Generator(device=dev).manual_seed(S)
    sigma = 0.05 * torch.rand(B, S, device=dev, generator=gen)
    sigma[::2, -1] = 0.0
    dist = torch.sort(0.1 + 2.9 * torch.rand(B, S, device=dev,
                                             generator=gen), -1).values
    rgb = torch.rand(B, S, 3, device=dev, generator=gen)
    before = composite.launches
    got = composite(sigma, dist, rgb, 16.0)
    assert composite.launches == before + 1
    want = composite_plain(sigma, dist, rgb, 16.0)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5


def _static_model(dev, S, bf16=False, patch=None):
    """tiny_static with the llff_z_plane family's [8, 4, 4] components (the
    layout the multi-axis kernels are built for), bf16 tables, density
    planes and lines redrawn uniform in [0, 0.4)."""
    cfg = convert_epochs_to_iters(tiny_static(z_channels=S), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True,
                               n_lamb_sigma=[8, 4, 4], n_lamb_sh=[8, 4, 4])
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, compute_dtype=torch.bfloat16 if bf16 else None)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.4 * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, model, params


# K1 with the mipnerf contraction and no flow stage: the same tolerances as
# the flagship's. K5, K5-preblended and K6 hold the per-ray sums at K2's
# 1e-4; K4's bf16 features may differ by one bf16 ulp on each plane; the
# coverage counts are exact.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("S,bf16", [(8, False), (32, True)],
                         ids=["S8_f32", "S32_bf16"])
def test_multi_kernels_match_plain(dev, S, bf16, pm):
    _, model, params = _static_model(dev, S, bf16, patch=(5, 2, 8))
    cf = model._cf_eval
    prep = cf.prepare(params)
    rays = _frame_rays(40, dev, 8 if pm else None)[:, :6].contiguous()
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    assert (pack - pack_p).abs().max() <= (2e-3 if bf16 else 1e-5)
    spec = MultiSpec(S=S, axes=prep["axes"], deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale)
    args = (prep["lines"], pack, rp, prep["wb"], spec)
    out = shade_multi(prep["quads"], *args)
    ref = shade_multi_plain(prep["quads"], *args)
    torch.cuda.synchronize()
    assert ref[:, 3].max() > 0.5              # the scene is not transparent
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    pspecs = cf.patch_specs([(a.W, a.H, a.C, a.m0, a.m1)
                             for a in prep["axes"]], pm)
    feats, v4 = patch_blend(prep["ptabs"], pack, pspecs)
    feats_p, vp4 = patch_blend_plain(prep["ptabs"], pack, pspecs)
    assert int(v4) == int(vp4)
    assert max(_ulps(f, fp) for f, fp in zip(feats, feats_p)) <= 1.0
    pre = shade_multi_preblended(feats, *args)
    ref = shade_multi_preblended_plain(feats, *args)
    assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    fused, v = shade_multi_patch(prep["ptabs"], *args, pspecs)
    ref, vp = shade_multi_patch_plain(prep["ptabs"], *args, pspecs)
    torch.cuda.synchronize()
    assert int(v) == int(vp) == int(v4)
    assert (fused[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (fused[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    # the routes agree with each other at the bench's pixel density
    assert (fused[:, :4] - out[:, :4]).abs().max() <= 2e-4
    assert (pre[:, :4] - out[:, :4]).abs().max() <= 2e-4


L844 = ((0, 16, 8), (1, 8, 4), (2, 8, 4))
L888 = ((0, 16, 8), (1, 16, 8), (2, 16, 8))


def test_multi_kernels_refuse_another_layout(dev):
    # the library reports the layouts of csrc/multi_core.cuh per kernel; a
    # spec with another one raises before any launch
    assert build.load_library().multi_layouts == {
        "shade_multi": (L844, L888), "shade_multi_preblended": (L844,),
        "shade_multi_patch": (L844,)}
    _, model, params = _static_model(dev, 8)
    cf = model._cf_eval
    prep = cf.prepare(params)
    axes = prep["axes"]
    spec = MultiSpec(S=8, axes=(axes[0], axes[2], axes[1]), deg=2,
                     distance_scale=cf.net.distance_scale)
    rays = _frame_rays(8, dev)[:, :6].contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(cf.pred.net_input(rays, StepCtx(it=20000)).float()
                      .contiguous(), prep["mlp"], rp, cf.spec, 20000)
    quads = [prep["quads"][i] for i in (0, 2, 1)]
    lines = [prep["lines"][i] for i in (0, 2, 1)]
    before = shade_multi.launches
    with pytest.raises(NotImplementedError):
        shade_multi(quads, lines, pack, rp, prep["wb"], spec)
    assert shade_multi.launches == before
    # [8, 0, 0]: one plane x line axis (no route takes K5 with it)
    one = dataclasses.replace(spec, axes=axes[:1])
    wb1 = prep["wb"][:, :axes[0].C - axes[0].nd].contiguous()
    with pytest.raises(NotImplementedError, match="layout"):
        shade_multi(prep["quads"][:1], prep["lines"][:1], pack, rp, wb1, one)
    assert shade_multi.launches == before


def test_k5_pre_and_k6_refuse_the_888_layout(dev):
    """K5's quad kernel takes [8, 8, 8]; its pre-blended kernel and K6 are
    built for [8, 4, 4] only (no route reaches them at [8, 8, 8]) and
    refuse it before any launch."""
    B, S = 256, 8
    quads, lines, pack, rays, wb, spec, feats = _k5_inputs(
        dev, S, B, "sh", "lines", layout="888")
    out = shade_multi(quads, lines, pack, rays, wb, spec)
    assert out.shape == (B, 5)
    n_pre = shade_multi_preblended.launches
    with pytest.raises(NotImplementedError, match="layout"):
        shade_multi_preblended(feats, lines, pack, rays, wb, spec)
    assert shade_multi_preblended.launches == n_pre
    ps = [PatchSpec(R=4, px=4, py=3, W=a.W, H=a.H, C=a.C, S=S,
                    phase_major=False, m0=a.m0, m1=a.m1)
          for a in spec.axes]
    ptabs = [torch.zeros(((a.H + 1) * (a.W + 1), 12 * a.C),
                         dtype=torch.bfloat16, device=dev)
             for a in spec.axes]
    n6 = shade_multi_patch.launches
    with pytest.raises(NotImplementedError, match="layout"):
        shade_multi_patch(ptabs, lines, pack, rays, wb, spec, ps)
    assert shade_multi_patch.launches == n6


@pytest.mark.parametrize("route,kernels", [
    ("quad", {"shade_multi": 1}),
    ("two", {"patch_blend": 1, "shade_multi_preblended": 1}),
    ("fused", {"shade_multi_patch": 1})])
def test_multi_routes_launch_on_card(dev, route, kernels, monkeypatch):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI",
                       "1" if route == "fused" else "0")
    _, model, params = _static_model(
        dev, 32, patch=None if route == "quad" else (5, 2, 8))
    fns = (pack_build, shade_multi, shade_multi_preblended,
           shade_multi_patch, patch_blend)
    before = {f.__name__: f.launches for f in fns}
    rays = _frame_rays(64, dev, 8)[:, :6].contiguous()
    rk = {"rays_phase_major": True}
    out = model.apply(params, rays, StepCtx(it=20000), rk)
    got = {f.__name__: f.launches - before[f.__name__] for f in fns}
    want = dict.fromkeys(got, 0)
    want.update(pack_build=1, **kernels)
    assert got == want
    plain = model.apply(_to(params, "cpu"), rays.cpu(), StepCtx(it=20000),
                        rk)
    assert (out["rgb"].cpu() - plain["rgb"]).abs().max() <= 2e-4
    if route != "quad":
        # K1 and its plain version differ by ~1e-7, which can move a
        # sample across a texel edge
        assert abs(float(plain["patch_coverage_viol"])
                   - float(out["patch_coverage_viol"])) <= 1e-3


def test_static_fused_model_matches_general_on_card(dev):
    import copy
    cfg, model, params = _static_model(dev, 32)
    cfg_g = copy.deepcopy(cfg)
    # the general colour net too, not the net's own fused route
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    general = build_model(cfg_g)
    rays = _rays(4096, dev, seed=1)[:, :6].contiguous()
    ctx = StepCtx(it=20000)
    before = (pack_build.launches, shade_multi.launches)
    a = model.apply(params, rays, ctx)["rgb"]
    assert (pack_build.launches, shade_multi.launches) == (before[0] + 1,
                                                           before[1] + 1)
    b = general.apply(params, rays, ctx)["rgb"]
    assert (a - b).abs().max() <= 2e-4


N3D_INFO = {"num_keyframes": 12, "num_frames": 50}


def _n3d_model(dev, S, bf16=False, patch=None, full_mlp=False):
    """tiny_neural_3d with neural_3d_z_plane's [8, 4, 4] components, bf16
    tables, 12 keyframes; with `full_mlp` the preset's 6x256 MLP (K1's
    full width, 960 last-layer columns at S = 64); density grids redrawn
    uniform in [0, 2.4 / S)."""
    cfg = convert_epochs_to_iters(tiny_neural_3d(z_channels=S), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True,
                               n_lamb_sigma=[8, 4, 4], n_lamb_sh=[8, 4, 4])
    if full_mlp:
        cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"] = \
            neural_3d_z_plane()["embedding"]["embeddings"][
                "ray_prediction_0"]["net"]
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, dataset_info=N3D_INFO,
                        compute_dtype=torch.bfloat16 if bf16 else None)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 2.4 / S * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, model, params


# K1 with flow and the contraction at S = 8, 16, 32 and 64: the same
# tolerances as the flagship's; under the bf16 policy a block takes 128
# rays at every width (the last layer drained in strips), under the f32
# policy 64.
@pytest.mark.parametrize("S,bf16,full", [
    (64, False, False), (64, True, True), (8, True, True), (64, True, False),
    (32, True, True), (8, False, False), (16, True, True), (16, False, False)],
    ids=["S64_f32", "S64_bf16_full", "S8_bf16_full", "S64_bf16",
         "S32_bf16_full", "S8_f32", "S16_bf16_full", "S16_f32"])
@pytest.mark.parametrize("n", K1_RAYS + [RAGGED_PERSISTENT])
def test_n3d_pack_build_matches_plain(dev, S, bf16, full, n):
    _, model, params = _n3d_model(dev, S, bf16, full_mlp=full)
    cf = model._cf_eval
    prep = cf.prepare(params)
    rays = _rays(n, dev)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    before = pack_build.launches
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    assert pack_build.launches == before + 1
    pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    torch.cuda.synchronize()
    assert (pack - pack_p).abs().max() <= (2e-3 if bf16 else 1e-5)
    assert (pack[3].reshape(n, S).diff(dim=1) >= 0).all()
    rpb = build.load_library().lib.pack_rays_per_block(
        cf.spec.params(n, prep["mlp"], 20000))
    assert rpb == (128 if bf16 else 64)


@pytest.mark.parametrize("family", ["flagship", "llff", "n3d", "shiny"])
def test_pack_plan_takes_128_rays_at_full_width(dev, family):
    """The bf16 plan's ray tile at the four models' full widths (P*S =
    480, 384, 960 and 384 last-layer columns) is at least 128 rays."""
    cfg = convert_epochs_to_iters(
        {"flagship": technicolor_z_plane, "llff": llff_z_plane,
         "n3d": neural_3d_z_plane, "shiny": shiny_z_plane}[family](), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    model = build_model(cfg, dataset_info={**INFO, **N3D_INFO},
                        compute_dtype=torch.bfloat16)
    cf = model._cf_eval
    tabs = mlp_tables(cf.pred.net, model.init(
        torch.Generator().manual_seed(0), dev)["embedding"][
            "ray_prediction_0"]["net"], torch.arange(cf.S * cf.P), cf.spec)
    lib = build.load_library().lib
    assert lib.pack_rays_per_block(cf.spec.params(1, tabs, 20000)) >= 128


@pytest.mark.parametrize("S,widest", [(32, 128), (64, 96)])
def test_f32_pack_plan_encoded_width(dev, S, widest):
    """The f32 plan at the full 6x256 MLP takes `widest` encoded columns
    and refuses 32 more: its field activations' staging buffer is the
    operand buffer the last layer does not read, so it costs no width."""
    _, model, params = _n3d_model(dev, S, full_mlp=True)
    cf = model._cf_eval
    p = cf.spec.params(256, cf.prepare(params)["mlp"], 20000)
    lib = build.load_library().lib
    for k, rpb in ((widest, 64), (widest + 32, 0)):
        p.layer[0].k = k
        assert lib.pack_rays_per_block(p) == rpb


@pytest.mark.parametrize("change", ["strips", "slabs"])
def test_pack_plan_refuses_another_slab_order(dev, change):
    """A slab layout that differs from the kernel's (the last two strips,
    of the same width, swapped, or a slab's rows moved to its neighbour
    with the total kept) is refused: no rays per block, and the launch
    raises before any kernel runs."""
    _, model, params = _n3d_model(dev, 64, True, full_mlp=True)
    cf = model._cf_eval
    tabs = cf.prepare(params)["mlp"]
    lib = build.load_library().lib
    p = cf.spec.params(256, tabs, 20000)
    assert lib.pack_rays_per_block(p) == 128
    if change == "strips":
        q = p.n_strips - 1
        a, b = list(p.strip_fc[q - 1]), list(p.strip_fc[q])
        for j in range(len(a)):
            p.strip_fc[q - 1][j], p.strip_fc[q][j] = b[j], a[j]
    else:
        p.slab_rows[0] += 32
        p.slab_rows[1] -= 32
    assert lib.pack_rays_per_block(p) == 0
    rays = _rays(256, dev)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    out = torch.empty(10, 256 * 64, device=dev)
    before = pack_build.launches
    with pytest.raises(RuntimeError):
        build.check_launch(lib.pack_build_launch(
            x0.data_ptr(), rp.data_ptr(), out.data_ptr(), p,
            torch.cuda.current_stream().cuda_stream), "pack_build")
    assert pack_build.launches == before


def _time_rays(n, dev, R=None, seed=0):
    """bench.py's camera crop of n = side^2 rays with a random t per ray
    (phase-major for blocks of R)."""
    rays = _frame_rays(int(round(n ** 0.5)), dev, R)
    rng = np.random.default_rng(seed)
    rays[:, 7] = torch.from_numpy(rng.uniform(0, 1, rays.shape[0]).astype(
        np.float32)).to(dev)
    return rays


# K5 and K5-preblended on the time planes (TH = 12) and premixed, K4 on
# each plane, K6 at S = 64 and S = 8: the multi-axis tolerances above.
@pytest.mark.parametrize("S,R", [(64, 8), (64, 4), (8, 8)])
def test_n3d_shade_kernels_match_plain(dev, S, R):
    patch = (5, 3, 8) if R == 8 else (4, 3, 4)
    _, model, params = _n3d_model(dev, S, patch=patch)
    cf = model._cf_eval
    prep = cf.prepare(params)
    axes = prep["axes"]
    assert [a.TH for a in axes] == [12, 12, 12]
    rays = _time_rays(1600, dev, R)
    rp = cf.ray_pack(rays)
    pack = pack_build(cf.pred.net_input(rays, StepCtx(it=20000)).float()
                      .contiguous(), prep["mlp"], rp, cf.spec, 20000)
    spec = MultiSpec(S=S, axes=axes, deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale)
    lines0 = [premix_time(t, rp[0, 7]) for t in prep["lines"]]
    spec0 = dataclasses.replace(spec, axes=tuple(
        dataclasses.replace(a, TH=0) for a in axes))
    for lines, sp in ((prep["lines"], spec), (lines0, spec0)):
        out = shade_multi(prep["quads"], lines, pack, rp, prep["wb"], sp)
        ref = shade_multi_plain(prep["quads"], lines, pack, rp, prep["wb"],
                                sp)
        torch.cuda.synchronize()
        assert ref[:, 3].max() > 0.5
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    args = (prep["lines"], pack, rp, prep["wb"], spec)
    quad = shade_multi(prep["quads"], *args)
    pspecs = cf.patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                            True)
    feats, v4 = patch_blend(prep["ptabs"], pack, pspecs)
    feats_p, vp4 = patch_blend_plain(prep["ptabs"], pack, pspecs)
    assert int(v4) == int(vp4)
    assert max(_ulps(f, fp) for f, fp in zip(feats, feats_p)) <= 1.0
    pre = shade_multi_preblended(feats, *args)
    ref = shade_multi_preblended_plain(feats, *args)
    assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    fused, v = shade_multi_patch(prep["ptabs"], *args, pspecs)
    ref, vp = shade_multi_patch_plain(prep["ptabs"], *args, pspecs)
    torch.cuda.synchronize()
    assert int(v) == int(vp) == int(v4)
    assert (fused[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (fused[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    if int(v) == 0:
        # every block inside its patches: the routes render alike
        assert (fused[:, :4] - quad[:, :4]).abs().max() <= 2e-4
        assert (pre[:, :4] - quad[:, :4]).abs().max() <= 2e-4


@pytest.mark.parametrize("ut", [True, False], ids=["one_t", "t_per_ray"])
@pytest.mark.parametrize("route,kernels", [
    ("quad", {"shade_multi": 1}),
    ("two", {"patch_blend": 1, "shade_multi_preblended": 1}),
    ("fused", {"shade_multi_patch": 1})])
def test_n3d_routes_launch_on_card(dev, route, kernels, ut, monkeypatch):
    """Each route at S = 64 launches its kernels once per call, never the
    general path or a plain version, and renders what the same route
    renders on the CPU (its kernels' plain versions), 2e-4."""
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI",
                       "1" if route == "fused" else "0")
    _, model, params = _n3d_model(
        dev, 64, patch=None if route == "quad" else (5, 3, 8))
    fns = (pack_build, shade_multi, shade_multi_preblended,
           shade_multi_patch, patch_blend)
    before = {f.__name__: f.launches for f in fns}
    rays = _frame_rays(64, dev, 8) if ut else _time_rays(4096, dev, 8)
    rk = {"rays_phase_major": True, "uniform_time": ut}
    out = model.apply(params, rays, StepCtx(it=20000), rk)
    got = {f.__name__: f.launches - before[f.__name__] for f in fns}
    want = dict.fromkeys(got, 0)
    want.update(pack_build=1, **kernels)
    assert got == want
    assert ("uniform_time_viol" in out) == ut
    plain = model.apply(_to(params, "cpu"), rays.cpu(), StepCtx(it=20000),
                        rk)
    assert (out["rgb"].cpu() - plain["rgb"]).abs().max() <= 2e-4
    if route != "quad":
        assert abs(float(plain["patch_coverage_viol"])
                   - float(out["patch_coverage_viol"])) <= 1e-3


def test_n3d_fused_model_matches_general_on_card(dev):
    import copy
    cfg, model, params = _n3d_model(dev, 64)
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    general = build_model(cfg_g, dataset_info=N3D_INFO)
    rays = _rays(4096, dev, seed=1)
    ctx = StepCtx(it=20000)
    before = (pack_build.launches, shade_multi.launches)
    a = model.apply(params, rays, ctx)["rgb"]
    assert (pack_build.launches, shade_multi.launches) == (before[0] + 1,
                                                           before[1] + 1)
    b = general.apply(params, rays, ctx)["rgb"]
    assert (a - b).abs().max() <= 2e-4


def test_unsupported_sample_count_raises_on_card(dev):
    """S = 128: the plain versions take it on the CPU, but on the card K1
    and K5 raise before any launch; nothing falls back."""
    _, model, params = _n3d_model(dev, 128)
    cf = model._cf_eval
    prep = cf.prepare(params)
    rays = _rays(256, dev)
    rp = cf.ray_pack(rays)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    before = (pack_build.launches, shade_multi.launches)
    with pytest.raises(NotImplementedError):
        pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    with pytest.raises(NotImplementedError):
        model.apply(params, rays, StepCtx(it=20000))
    pack = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    spec = MultiSpec(S=128, axes=prep["axes"], deg=2,
                     distance_scale=cf.net.distance_scale)
    with pytest.raises(NotImplementedError):
        shade_multi(prep["quads"], prep["lines"], pack, rp, prep["wb"], spec)
    assert (pack_build.launches, shade_multi.launches) == before
    cpu = model.apply(_to(params, "cpu"), rays.cpu(), StepCtx(it=20000))
    assert torch.isfinite(cpu["rgb"]).all()


# ---- K1 beside its plain version on many rays: the colour

# Over tens of thousands of random rays a sample whose |xn|, |yn| or |zn|
# lies on the aabb's face in one pack can lie an ulp or a few outside it in
# the other (the z-planes at -1 and 1 put samples on the z faces), and the
# reference's hard validity step (hyperreel_tpu/ops/pallas/shade.py
# :175-176) then drops or keeps the sample, which moves its ray's colour by
# up to 0.058 (scripts/face_crossing.py on the card: 33,869 tiny rays under
# the bf16 policy, the worst ray's sample at zn = 1.0 in K1's pack and 4
# ulps above 1 in the plain pack). So the chunk-colour gate, both kernels
# against both plain versions at 2e-4, holds every ray that has no sample
# within 2 ulps of a face in either pack: it leaves out 6 of the 33,869
# tiny rays under the bf16 policy and 9 under the f32 one, and 47 and 58
# at full width (measured on the card), and at most 1 % of the rays here.
FACE_ULPS = 2


def _near_face(pack, S):
    """[B]: rays with a sample whose |xn|, |yn| or |zn| lies within
    FACE_ULPS f32 ulps of 1."""
    one = torch.tensor(1.0).view(torch.int32).item()
    bits = pack[:3].abs().contiguous().view(torch.int32).long()
    return ((bits - one).abs().amin(0) <= FACE_ULPS).reshape(-1, S).any(1)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("tiny", [True, False], ids=["S8", "S32"])
def test_ragged_persistent_chunk_colour(dev, tiny, bf16):
    _, model, params = _model(tiny, dev, bf16)
    cf = model._cf_eval
    prep = cf.prepare(params)
    rays = _rays(RAGGED_PERSISTENT, dev)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    H, W, TH, TW, C, nd = prep["dims"]
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd,
                     deg=cf.net.sh_deg, distance_scale=cf.net.distance_scale)
    out = shade(prep["quad"], pack, rp, prep["ttab"], prep["wb"], spec)
    ref = shade_plain(prep["quad"], pack_p, rp, prep["ttab"], prep["wb"],
                      spec)
    torch.cuda.synchronize()
    near = _near_face(pack, cf.S) | _near_face(pack_p, cf.S)
    print(f"rays within {FACE_ULPS} ulps of a face: {int(near.sum())} of "
          f"{RAGGED_PERSISTENT}")
    assert int(near.sum()) <= RAGGED_PERSISTENT // 100
    assert (out[~near, :4] - ref[~near, :4]).abs().max() <= 2e-4


# ---- the static RGB families (shiny_z_plane, stanford_llff_z_plane)

RGB_DENSITY = {"shiny": 0.2, "stanford": 0.3}    # chip_smoke.py


def _rgb_model(dev, family, bf16=True, patch=None, cf=True):
    """shiny_z_plane or stanford_llff_z_plane at full width on its trained
    checkpoint's grid (N_voxel_init set to N_voxel_final), density planes
    and lines redrawn uniform in [0, RGB_DENSITY); `cf=False` turns the
    channels-first route off."""
    make = {"shiny": shiny_z_plane, "stanford": stanford_llff_z_plane}
    cfg = convert_epochs_to_iters(make[family](), 4000)
    net = cfg["color"]["net"]
    net["N_voxel_init"] = net["N_voxel_final"]
    if not cf:
        net["fused_render_cf"] = False
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, compute_dtype=torch.bfloat16 if bf16 else None)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = RGB_DENSITY[family] * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, model, params


# shiny at full width on one chunk of the bench camera (a 512x512 crop,
# 262,144 rays): K1 on its chain (static, identity contraction, S = 32,
# two-plane + PE inputs) under both MLP policies at the flagship's
# tolerances; K5, K4 x 3 + K5-preblended and K6 with RGB colour, and K5
# with the weights row (random weights in [0, 2)), at the multi-axis
# tolerances.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
def test_shiny_kernels_match_plain_at_full_width(dev, pm):
    _, model, params = _rgb_model(dev, "shiny", patch=(5, 2, 8))
    cf = model._cf_eval
    prep = cf.prepare(params)
    rays = _frame_rays(512, dev, 8 if pm else None)[:, :6].contiguous()
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    pack_p = pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000)
    assert (pack - pack_p).abs().max() <= 2e-3
    cf32 = build_model(model.cfg)._cf_eval
    tabs32 = cf32.prepare(params)["mlp"]
    x32, rp32 = x0[:4096].contiguous(), rp[:4096].contiguous()
    assert (pack_build(x32, tabs32, rp32, cf32.spec, 20000)
            - pack_build_plain(x32, tabs32, rp32, cf32.spec, 20000)
            ).abs().max() <= 1e-5
    del pack_p
    spec = MultiSpec(S=cf.S, axes=prep["axes"], deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale, shading="rgb")
    args = (prep["lines"], pack, rp, prep["wb"], spec)
    out = shade_multi(prep["quads"], *args)
    ref = shade_multi_plain(prep["quads"], *args)
    torch.cuda.synchronize()
    assert ref[:, 3].mean() > 0.5             # the scene is not transparent
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    gen = torch.Generator(device=dev).manual_seed(1)
    pack_w = torch.cat([pack, 2 * torch.rand(1, pack.shape[1], device=dev,
                                             generator=gen)])
    wspec = dataclasses.replace(spec, weights=True)
    wargs = (prep["lines"], pack_w, rp, prep["wb"], wspec)
    out_w = shade_multi(prep["quads"], *wargs)
    ref_w = shade_multi_plain(prep["quads"], *wargs)
    torch.cuda.synchronize()
    assert (out_w[:, :4] - ref_w[:, :4]).abs().max() <= 1e-4
    assert (out_w[:, :4] - out[:, :4]).abs().max() > 0.05
    del pack_w, out_w, ref_w
    pspecs = cf.patch_specs([(a.W, a.H, a.C, a.m0, a.m1)
                             for a in prep["axes"]], pm)
    feats, v4 = patch_blend(prep["ptabs"], pack, pspecs)
    feats_p, vp4 = patch_blend_plain(prep["ptabs"], pack, pspecs)
    assert int(v4) == int(vp4)
    assert max(_ulps(f, fp) for f, fp in zip(feats, feats_p)) <= 1.0
    pre = shade_multi_preblended(feats, *args)
    ref = shade_multi_preblended_plain(feats, *args)
    assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    fused, v = shade_multi_patch(prep["ptabs"], *args, pspecs)
    ref, vp = shade_multi_patch_plain(prep["ptabs"], *args, pspecs)
    torch.cuda.synchronize()
    assert int(v) == int(vp) == int(v4)
    assert (fused[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (fused[:, 4] - ref[:, 4]).abs().max() <= 1e-3


def test_stanford_k2_matches_plain_at_full_width(dev):
    """stanford at full width on one chunk of the bench camera: the
    general chain, then K2 with RGB colour, the weights row and the z line
    as its TH = 0 table against its plain version; through model.apply K2
    launches once and nothing else, and the colour matches the general
    colour net's at the fused-path gate."""
    import copy
    cfg, model, params = _rgb_model(dev, "stanford")
    assert model._cf_eval is None
    net = model.color_net
    prep = model.prepare_eval(params)
    rays = _frame_rays(512, dev)[:, :6].contiguous()
    ctx = StepCtx(it=20000)
    x = model.embedding.apply(params["embedding"],
                              model.ray_param.apply(rays), ctx, {})
    pack, rp = net.fused_pack(x)
    assert pack.shape == (11, rays.shape[0] * 32)
    spec = net.fused_spec(prep, 32)
    args = (prep["quads"][0], pack, rp, prep["lines"][0], prep["wb"], spec)
    out = shade(*args)
    ref = shade_plain(*args)
    torch.cuda.synchronize()
    assert ref[:, 3].mean() > 0.5
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    fns = (pack_build, shade, shade_multi)
    before = {f.__name__: f.launches for f in fns}
    a = model.apply(params, rays, ctx, {"cf_prepared": prep})["rgb"]
    got = {f.__name__: f.launches - before[f.__name__] for f in fns}
    assert got == {"pack_build": 0, "shade": 1, "shade_multi": 0}
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"]["fused_render"] = False
    general = build_model(cfg_g, compute_dtype=torch.bfloat16)
    b = general.apply(params, rays, ctx)["rgb"]
    assert (a - b).abs().max() <= 2e-4


def test_rgb_single_axis_kernels_match_plain(dev):
    """K2, K2-preblended and K3 with RGB colour (a random [3, C] basis with
    zero density columns), and K2 with the weights row, on the tiny
    flagship's time planes, at K2's tolerances."""
    _, model, params = _model(True, dev, patch=(5, 2, 8))
    cf = model._cf_eval
    prep = cf.prepare(params)
    H, W, TH, TW, C, nd = prep["dims"]
    gen = torch.Generator().manual_seed(2)
    wb = torch.cat([torch.zeros(3, nd),
                    torch.randn(3, C - nd, generator=gen)], 1)
    spec = ShadeSpec(S=cf.S, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd, deg=0,
                     distance_scale=cf.net.distance_scale, shading="rgb")
    rays = _frame_rays(64, dev, 8)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    pack = pack_build(x0, prep["mlp"], rp, cf.spec, 20000)
    targs = (prep["ttab"], wb, spec)
    out = shade(prep["quad"], pack, rp, *targs)
    ref = shade_plain(prep["quad"], pack, rp, *targs)
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    w = torch.rand(1, pack.shape[1], device=dev)
    pack_w = torch.cat([pack, 2 * w])
    wspec = dataclasses.replace(spec, weights=True)
    out_w = shade(prep["quad"], pack_w, rp, prep["ttab"], wb, wspec)
    ref_w = shade_plain(prep["quad"], pack_w, rp, prep["ttab"], wb, wspec)
    assert (out_w[:, :4] - ref_w[:, :4]).abs().max() <= 1e-4
    ps = PatchSpec(R=8, px=5, py=2, W=W, H=H, C=C, S=cf.S, phase_major=True)
    (feats,), _ = patch_blend([prep["patch"]], pack, [ps])
    pre = shade_preblended(feats, pack, rp, *targs)
    ref = shade_preblended_plain(feats, pack, rp, *targs)
    assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    fused, v = shade_patch(prep["patch"], pack, rp, *targs, ps)
    ref, vp = shade_patch_plain(prep["patch"], pack, rp, *targs, ps)
    torch.cuda.synchronize()
    assert int(v) == int(vp)
    assert (fused[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    # K3 and K2-preblended have no weights row (ROADMAP.md 2a): refused
    # before a launch
    before = (shade_patch.launches, shade_preblended.launches)
    with pytest.raises((NotImplementedError, ValueError)):
        shade_patch(prep["patch"], pack_w, rp, prep["ttab"], wb, wspec, ps)
    with pytest.raises(NotImplementedError):
        shade_preblended(feats, pack_w, rp, prep["ttab"], wb, wspec)
    assert (shade_patch.launches, shade_preblended.launches) == before


def _tiny_rgb_model(dev, family, S=32, patch=None, cf=True):
    """tiny_shiny (without its sample stages, which keep a model off the
    channels-first route) with the [8, 4, 4] layout the multi-axis kernels
    are built for, or tiny_stanford_llff ([4, 0, 0]: C = 8, a K2 layout),
    bf16 tables, density planes and lines redrawn uniform in [0, 0.4)."""
    cfg = tiny_shiny(z_channels=S, sample_stages=False) if family == "shiny" \
        else tiny_stanford_llff(z_channels=S)
    cfg = convert_epochs_to_iters(cfg, 4000)
    if family == "shiny":
        cfg["color"]["net"].update(n_lamb_sigma=[8, 4, 4],
                                   n_lamb_sh=[8, 4, 4])
    if not cf:
        cfg["color"]["net"]["fused_render_cf"] = False
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.4 * torch.rand(
            v.shape, generator=gen).to(dev)
    return cfg, model, params


# The RGB routes through model.apply on the card: the channels-first
# routes of tiny_shiny, and the nets' own fused routes after the general
# chain (stanford: K2; shiny with fused_render_cf off: K5 with the weights
# row); the launches, and the colour against the same route on the CPU
# (the plain versions) at the fused-path gate.
@pytest.mark.parametrize("family,route,kernels", [
    ("shiny", "quad", {"pack_build": 1, "shade_multi": 1}),
    ("shiny", "two", {"pack_build": 1, "patch_blend": 1,
                      "shade_multi_preblended": 1}),
    ("shiny", "fused", {"pack_build": 1, "shade_multi_patch": 1}),
    ("shiny", "own", {"shade_multi": 1}),
    ("stanford", "own", {"shade": 1})])
def test_rgb_routes_launch_on_card(dev, family, route, kernels,
                                   monkeypatch):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI",
                       "1" if route == "fused" else "0")
    _, model, params = _tiny_rgb_model(
        dev, family, patch=(5, 2, 8) if route in ("two", "fused") else None,
        cf=route != "own")
    fns = (pack_build, shade, shade_multi, shade_multi_preblended,
           shade_multi_patch, patch_blend)
    before = {f.__name__: f.launches for f in fns}
    rays = _frame_rays(64, dev, 8)[:, :6].contiguous()
    rk = {"rays_phase_major": True}
    out = model.apply(params, rays, StepCtx(it=20000), rk)
    got = {f.__name__: f.launches - before[f.__name__] for f in fns}
    want = dict.fromkeys(got, 0)
    want.update(kernels)
    assert got == want
    plain = model.apply(_to(params, "cpu"), rays.cpu(), StepCtx(it=20000),
                        rk)
    assert (out["rgb"].cpu() - plain["rgb"]).abs().max() <= 2e-4


# ---- K5 and K5-preblended at every instantiation, on synthetic inputs at
# the [8, 4, 4] layout: SH, RGB and RGB with the weights row (the quad
# kernel only); lines, and time planes with one t for every ray (between
# two keyframes; on the first and last frames, tn = -1 and 1, where the
# tap past the last keyframe lies off the plane; on a keyframe) or with tn
# spread over all 12 keyframes; S = 8, 16, 32, 64. The multi-axis
# tolerances above.
K5_TH = 12
# each case's time coordinate: None for lines, one t, or "spread"
K5_SECOND = {"lines": None, "time_one_t": 0.37, "time_first": -1.0,
             "time_last": 1.0, "time_on_key": 3 * 2.0 / (K5_TH - 1) - 1.0,
             "time_spread": "spread"}


# the layouts K5 is built for: C per axis (half of it density)
K5_LAYOUTS = {"844": (16, 8, 8), "888": (16, 16, 16)}


def _k5_inputs(dev, S, B, colour, second, seed=0, layout="844"):
    rng = np.random.default_rng(seed)
    tn = K5_SECOND[second]
    TH = 0 if tn is None else K5_TH
    axes, quads, lines = [], [], []
    for i, ((W, H, L), C) in enumerate(zip(
            ((60, 50, 70), (60, 40, 90), (50, 40, 80)), K5_LAYOUTS[layout])):
        axes.append(AxisSpec(index=i, W=W, H=H, L=L, C=C, nd=C // 2, TH=TH))
        quads.append(quad_table(torch.from_numpy(rng.normal(
            0, 0.5, (H, W, C)).astype(np.float32))).to(dev))
        lines.append(torch.from_numpy(rng.uniform(
            0, 0.4, ((TH, L, C) if TH else (L, C))).astype(np.float32))
            .to(dev))
    # rays in scanline order of a 64-pixel-wide image, their samples on S
    # z-planes slightly past the aabb at both ends
    u = (np.arange(B) % 64) / 32.0 - 1.0
    v = (np.arange(B) // 64) / (B / 64 / 2.0) - 1.0
    z = np.linspace(-1.05, 1.05, S)
    x = u[:, None] * (1.0 + 0.1 * z[None])
    y = v[:, None] * (1.0 + 0.1 * z[None])
    dist = np.broadcast_to(0.1 + 0.05 * np.arange(S), (B, S)).copy()
    dist[rng.uniform(0, 1, B) < 0.05, :2] = 0.0       # a few invalid
    pack = np.concatenate([x[None], y[None], np.broadcast_to(z, (B, S))[None],
                           dist[None], rng.normal(0, 0.1, (6, B, S))])
    pack = pack.reshape(10, B * S)
    weights = colour.endswith("_weights")
    if weights:
        pack = np.concatenate([pack, rng.uniform(0, 2, (1, B * S))])
    d = rng.normal(0, 1, (B, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tn = rng.uniform(-1.0, 1.0, B) if tn == "spread" \
        else np.full(B, 0.37 if tn is None else tn)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), d,
                           np.zeros((B, 1)), tn[:, None]], 1)
    rgb = colour.startswith("rgb")
    A = sum(a.C - a.nd for a in axes)
    wb = torch.from_numpy(rng.normal(0, 0.3, (3 if rgb else 27, A)).astype(
        np.float32))
    spec = MultiSpec(S=S, axes=tuple(axes), deg=2, distance_scale=25.0,
                     shading="rgb" if rgb else "sh", weights=weights)
    feats = [torch.from_numpy(rng.normal(0, 0.5, (B * S, a.C)).astype(
        np.float32)).to(torch.bfloat16).to(dev) for a in axes]
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a, dtype=np.float32)).to(dev)
    return quads, lines, f32(pack), f32(rays), wb, spec, feats


@pytest.mark.parametrize("second", list(K5_SECOND))
@pytest.mark.parametrize("colour", ["sh", "rgb", "rgb_weights"])
@pytest.mark.parametrize("S", [8, 16, 32, 64])
def test_k5_instantiations_match_plain(dev, S, colour, second):
    B = 3000                                # not a multiple of a block's run
    quads, lines, pack, rays, wb, spec, feats = _k5_inputs(
        dev, S, B, colour, second, seed=S)
    n = shade_multi.launches
    out = shade_multi(quads, lines, pack, rays, wb, spec)
    ref = shade_multi_plain(quads, lines, pack, rays, wb, spec)
    torch.cuda.synchronize()
    assert shade_multi.launches == n + 1
    assert 0 < shade_multi.last_launch["grid"] <= -(-B // 256)
    assert ref[:, 3].max() > 0.5 and ref[:, 3].min() < 0.5
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    if spec.weights:
        return
    pre = shade_multi_preblended(feats, lines, pack, rays, wb, spec)
    ref = shade_multi_preblended_plain(feats, lines, pack, rays, wb, spec)
    torch.cuda.synchronize()
    assert (pre[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (pre[:, 4] - ref[:, 4]).abs().max() <= 1e-3


def test_k5_quad_refuses_fewer_than_4_samples(dev):
    """The quad kernel stages its pack 4 samples at a time."""
    quads, lines, pack, rays, wb, spec, _ = _k5_inputs(dev, 2, 256, "sh",
                                                       "lines")
    with pytest.raises(NotImplementedError, match="S=2"):
        shade_multi(quads, lines, pack, rays, wb, spec)


# more rays than the persistent grid takes in one round (at most 132 SMs
# x 2 blocks x 256 rays), B odd
RAGGED_K5 = 2 * 132 * 256 + 77


@pytest.mark.parametrize("S", [32, 64])
def test_k5_ragged_persistent_runs_match_plain(dev, S):
    quads, lines, pack, rays, wb, spec, feats = _k5_inputs(
        dev, S, RAGGED_K5, "sh", "time_one_t", seed=1)
    out = shade_multi(quads, lines, pack, rays, wb, spec)
    assert shade_multi.last_launch["grid"] * 256 < RAGGED_K5
    pre = shade_multi_preblended(feats, lines, pack, rays, wb, spec)
    ref = shade_multi_plain(quads, lines, pack, rays, wb, spec)
    ref_pre = shade_multi_preblended_plain(feats, lines, pack, rays, wb,
                                           spec)
    torch.cuda.synchronize()
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3
    assert (pre[:, :4] - ref_pre[:, :4]).abs().max() <= 1e-4
    assert (pre[:, 4] - ref_pre[:, 4]).abs().max() <= 1e-3


@pytest.mark.parametrize("second", ["lines", "time_spread"])
@pytest.mark.parametrize("colour", ["sh", "sh_weights"])
@pytest.mark.parametrize("S", [8, 64])
def test_k5_888_matches_plain(dev, S, colour, second):
    """K5 at the [8, 8, 8] layout (catacaustics_distance: SH, the weights
    row, S = 64, lines; the time planes are built as well) against its
    plain version, at the multi-axis tolerances."""
    B = 3000
    quads, lines, pack, rays, wb, spec, _ = _k5_inputs(
        dev, S, B, colour, second, seed=S, layout="888")
    assert spec.n_app == 24 and tuple(wb.shape) == (27, 24)
    n = shade_multi.launches
    out = shade_multi(quads, lines, pack, rays, wb, spec)
    ref = shade_multi_plain(quads, lines, pack, rays, wb, spec)
    torch.cuda.synchronize()
    assert shade_multi.launches == n + 1
    assert ref[:, 3].max() > 0.5 and ref[:, 3].min() < 0.5
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3


IMMERSIVE_INFO = {"near": 1.0, "far": 10.0, "depth_range": (2.0, 10.0),
                  "num_keyframes": 12, "num_frames": 50}


def test_immersive_own_route_k5_at_s32_on_card(dev):
    """immersive_sphere_new's chain at test widths with its [8, 4, 4]
    components, S = 32, 12 keyframes, a t per ray, the camera inside the
    spheres: the own route launches K5 on the time planes once, K5 agrees
    with its plain version on the route's pack, and the frame with the
    general colour net at the fused-path gate."""
    cfg = convert_epochs_to_iters(tiny_immersive_sphere(z_channels=32), 4000)
    cfg["color"]["net"].update(n_lamb_sigma=[8, 4, 4], n_lamb_sh=[8, 4, 4])
    model = build_model(cfg, dataset_info=IMMERSIVE_INFO)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = 0.3 * torch.rand(
            v.shape, generator=gen).to(dev)
    assert model._cf_eval is None
    rays = _rays(4096, dev, seed=3)
    rays[:, :3] *= 0.2                       # inside the smallest sphere
    ctx = StepCtx(it=20000)
    net = model.color_net
    x = model.embedding.apply(params["embedding"], rays, ctx)
    prep = model.prepare_eval(params)
    pack, rp = net.fused_pack(x)
    spec = net.fused_spec(prep, 32)
    assert [a.TH for a in spec.axes] == [12] * 3 and not spec.weights
    out = shade_multi(prep["quads"], prep["lines"], pack, rp, prep["wb"],
                      spec)
    ref = shade_multi_plain(prep["quads"], prep["lines"], pack, rp,
                            prep["wb"], spec)
    torch.cuda.synchronize()
    assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
    assert ref[:, 3].mean() > 0.1
    n = shade_multi.launches
    a = model.apply(params, rays, ctx, {"cf_prepared": prep})["rgb"]
    assert shade_multi.launches == n + 1
    net.fused_render = False
    try:
        b = model.apply(params, rays, ctx)["rgb"]
    finally:
        net.fused_render = True
    assert shade_multi.launches == n + 1
    assert (a - b).abs().max() <= 2e-4



# ---- the render-time sample counts: K1's compaction (first k, the far
# sentinel) and positional stride branches, the shade kernels at S = k on
# packs that carry sentinel distances


def _count_model(dev, family, S, stage, k, bf16=False, full=False,
                 patch=None):
    """`family` ("flagship": tiny_dynamic, with `full` technicolor_z_plane;
    "n3d": tiny_neural_3d at the [8, 4, 4] layout, with `full` its 6x256
    MLP; "shiny": tiny_shiny at [8, 4, 4]) at S samples, with
    with_compact_samples(k) ("compact") or with_inference_samples(k)
    ("stride"); density grids redrawn uniform in [0, 2.4 / k)."""
    if family == "flagship":
        cfg = technicolor_z_plane(S) if full else tiny_dynamic(S)
    elif family == "n3d":
        cfg = tiny_neural_3d(z_channels=S)
        if full:
            cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"] = \
                neural_3d_z_plane()["embedding"]["embeddings"][
                    "ray_prediction_0"]["net"]
    else:
        cfg = tiny_shiny(z_channels=S, sample_stages=False)
    cfg = convert_epochs_to_iters(cfg, 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    if family != "flagship":
        cfg["color"]["net"].update(n_lamb_sigma=[8, 4, 4],
                                   n_lamb_sh=[8, 4, 4])
    cfg = (with_compact_samples if stage == "compact"
           else with_inference_samples)(cfg, k)
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    model = build_model(cfg, dataset_info={**INFO, **N3D_INFO},
                        compute_dtype=torch.bfloat16 if bf16 else None)
    assert model._cf_eval is not None and model._cf_eval.k == k
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    for key, v in params["color"]["density"].items():
        params["color"]["density"][key] = 2.4 / k * torch.rand(
            v.shape, generator=gen).to(dev)
    return model, params


def _sentinel_rays(n, dev, seed=0, static=False):
    """_rays with half the origins among the z-planes (z in [-0.9, 0.9])
    and one ray in sixteen pointing backwards: samples behind the origin,
    invalid, take the far sentinel under compaction."""
    rays = _rays(n, dev, seed)
    rng = np.random.default_rng(seed + 100)
    rays[::2, 2] = torch.from_numpy(rng.uniform(
        -0.9, 0.9, (n + 1) // 2).astype(np.float32)).to(dev)
    rays[::16, 5] = -1.0
    return rays[:, :6].contiguous() if static else rays


# K1's two branches against pack_build_plain element by element, at the
# tolerances above (the sentinel samples' points relatively, 1e-6, a few
# f32 ulps, `pack_error`; their distance equal): compaction at S = 32 (k =
# 16) and S = 64 (k = 16, the flagship's chain at 64 samples: compaction
# needs the identity contraction), the stride at S = 32 (stride 4 and 2)
# and on n3d's chain at S = 64 (flow and the contraction; stride 4, k =
# 16, where each lane of the sort holds two samples, and stride 2).
K1_COUNTS = [("flagship", 32, "compact", 16), ("flagship", 64, "compact", 16),
             ("flagship", 32, "stride", 8), ("flagship", 32, "stride", 16),
             ("n3d", 64, "stride", 16), ("n3d", 64, "stride", 32)]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_full"])
@pytest.mark.parametrize("family,S,stage,k", K1_COUNTS, ids=[
    f"{f}_S{S}_{st}{k}" for f, S, st, k in K1_COUNTS])
@pytest.mark.parametrize("n", [1000, RAGGED_PERSISTENT])
def test_sample_count_pack_build_matches_plain(dev, family, S, stage, k,
                                               bf16, n):
    model, params = _count_model(dev, family, S, stage, k, bf16, full=bf16)
    cf = model._cf_eval
    spec = cf.spec
    assert spec.k == k and (spec.stride == S // k) == (stage == "stride")
    prep = cf.prepare(params)
    rays = _sentinel_rays(n, dev, seed=S + k)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    before = pack_build.launches
    pack = pack_build(x0, prep["mlp"], rp, spec, 20000)
    assert pack_build.launches == before + 1
    pack_p = pack_build_plain(x0, prep["mlp"], rp, spec, 20000)
    torch.cuda.synchronize()
    assert pack.shape == pack_p.shape == (10, n * k)
    assert torch.isfinite(pack).all()
    # under the bf16 policy a rounding flip that moves a sample across its
    # ray's origin (dist = 0) makes it valid in one pack and a sentinel in
    # the other, on at most a few rays in a thousand; the f32 policy runs
    # the same f32 math, and no sample crosses
    far = pack[3].reshape(n, k) == FAR_SENTINEL
    crossed = (far != (pack_p[3].reshape(n, k) == FAR_SENTINEL)).any(1)
    assert crossed.float().mean() <= (1e-3 if bf16 else 0.0)
    cols = (~crossed)[:, None].expand(n, k).reshape(-1)
    err, rel = pack_error(pack[:, cols], pack_p[:, cols])
    assert err <= (2e-3 if bf16 else 1e-5) and rel <= 1e-6, (err, rel)
    dist = pack[3].reshape(n, k)
    assert (dist.diff(dim=1) >= 0).all()
    if stage == "compact":
        assert far.any() and (~far).any()


# K2, K3, K4 + K2-preblended (the flagship's chain) and K5 (shiny's RGB
# lines with compaction; n3d's time planes with the stride) at S = k = 8
# and 16 on the K1 packs of sentinel-bearing rays, phase-major blocks of
# R = 8: the tolerances above, and no inf or NaN where a sentinel's delta
# (1e9 - d) saturates its predecessor's alpha.
SHADE_COUNTS = [("flagship", 16, "compact", 8), ("flagship", 32, "compact", 16),
                ("flagship", 32, "stride", 8), ("flagship", 32, "stride", 16),
                ("shiny", 16, "compact", 8), ("shiny", 32, "compact", 16),
                ("n3d", 64, "stride", 16), ("n3d", 32, "stride", 8)]


@pytest.mark.parametrize("family,S,stage,k", SHADE_COUNTS, ids=[
    f"{f}_S{S}_{st}{k}" for f, S, st, k in SHADE_COUNTS])
def test_sample_count_shade_kernels_match_plain(dev, family, S, stage, k):
    model, params = _count_model(dev, family, S, stage, k,
                                 patch=(5, 2, 8) if family != "n3d"
                                 else (5, 3, 8))
    cf = model._cf_eval
    prep = cf.prepare(params)
    rays = _frame_rays(40, dev, 8)                  # 1600 rays
    rays[::3, 2] = 0.5                              # among the z-planes
    rays = rays[:, :6].contiguous() if family == "shiny" else rays
    rp = cf.ray_pack(rays)
    pack = pack_build(cf.pred.net_input(rays, StepCtx(it=20000)).float()
                      .contiguous(), prep["mlp"], rp, cf.spec, 20000)
    if stage == "compact":
        assert (pack[3] == FAR_SENTINEL).any()

    def check(out, ref):
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.isfinite(ref).all()
        assert (out[:, :4] - ref[:, :4]).abs().max() <= 1e-4
        assert (out[:, 4] - ref[:, 4]).abs().max() <= 1e-3

    if family == "flagship":
        H, W, TH, TW, C, nd = prep["dims"]
        spec = ShadeSpec(S=k, W=W, H=H, TW=TW, TH=TH, C=C, nd=nd,
                         deg=cf.net.sh_deg,
                         distance_scale=cf.net.distance_scale)
        args = (pack, rp, prep["ttab"], prep["wb"], spec)
        check(shade(prep["quad"], *args), shade_plain(prep["quad"], *args))
        ps, = cf.patch_specs([(W, H, C, 0, 1)], True)
        assert ps.S == k
        out, v = shade_patch(prep["patch"], *args, ps)
        ref, vr = shade_patch_plain(prep["patch"], *args, ps)
        check(out, ref)
        assert int(v) == int(vr)
        (feats,), v = patch_blend([prep["patch"]], pack, [ps])
        (feats_p,), vr = patch_blend_plain([prep["patch"]], pack, [ps])
        assert int(v) == int(vr) and _ulps(feats, feats_p) <= 1.0
        check(shade_preblended(feats, *args),
              shade_preblended_plain(feats, *args))
        return
    spec = MultiSpec(S=k, axes=prep["axes"], deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale,
                     shading=cf.net.shading)
    args = (prep["lines"], pack, rp, prep["wb"], spec)
    check(shade_multi(prep["quads"], *args),
          shade_multi_plain(prep["quads"], *args))


# The sample-count routes through model.apply on the card: K1 and the
# shade kernel once per call, nothing else, and the rgb of the same route
# on the CPU (the plain versions) at the fused-path gate, over the rays
# without a sample within FACE_ULPS of an aabb face in either pack.
@pytest.mark.parametrize("family,S,stage,k,kernel", [
    ("flagship", 32, "compact", 16, "shade"),
    ("flagship", 32, "stride", 8, "shade"),
    ("shiny", 32, "compact", 16, "shade_multi"),
    ("n3d", 64, "stride", 16, "shade_multi")])
def test_sample_count_routes_launch_on_card(dev, family, S, stage, k,
                                            kernel):
    model, params = _count_model(dev, family, S, stage, k)
    fns = (pack_build, shade, shade_multi, shade_patch, patch_blend,
           shade_preblended, shade_multi_preblended, shade_multi_patch)
    before = {f.__name__: f.launches for f in fns}
    rays = _sentinel_rays(4096, dev, seed=5, static=family == "shiny")
    out = model.apply(params, rays, StepCtx(it=20000))
    got = {f.__name__: f.launches - before[f.__name__] for f in fns}
    want = dict.fromkeys(got, 0)
    want.update({"pack_build": 1, kernel: 1})
    assert got == want
    plain = model.apply(_to(params, "cpu"), rays.cpu(), StepCtx(it=20000))
    assert torch.isfinite(out["rgb"]).all()
    cf = model._cf_eval
    prep = cf.prepare(params)
    x0 = cf.pred.net_input(rays, StepCtx(it=20000)).float().contiguous()
    rp = cf.ray_pack(rays)
    far = _near_face(pack_build(x0, prep["mlp"], rp, cf.spec, 20000), k) \
        | _near_face(pack_build_plain(x0, prep["mlp"], rp, cf.spec, 20000),
                     k)
    assert far.float().mean() <= 0.01
    keep = ~far.cpu()
    assert (out["rgb"].cpu()[keep] - plain["rgb"][keep]).abs().max() <= 2e-4
