"""The static VM net's multi-axis kernels and routes in hyperreel_tpu_torch
against the JAX package on the CPU: the plain versions of K5
(shade_multi, and its pre-blended variant), K4 on the planes (0, 2) and
(1, 2), K6 (shade_multi_patch) and the multi-axis coverage witness, each
against its Pallas kernel in interpret mode (fed the same pack in the JAX
kernels' S-major tile order and each package's tables built from the same
weights); the basis table; and the whole eval render through `model.apply`
against the JAX package's on the quad, the two-kernel patch and the fused
patch routes. On the CPU the port runs its kernels' plain versions."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import with_coherent_gather
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.ops.pallas.patch_blend import (
    patch_anchor_idx, patch_blend as jax_patch_blend)
from hyperreel_tpu.ops.pallas.shade import (
    fused_shade_composite_multi, kmajor_perm)
from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS
from hyperreel_tpu_torch.ops.kernels.patch_blend import (
    coverage_count, patch_blend, patch_features_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    MultiSpec, multi_basis_table, shade_multi, shade_multi_preblended,
    shade_multi_preblended_folded_plain, shade_multi_preblended_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
    shade_multi_patch, shade_multi_patch_folded_plain,
    shade_multi_patch_plain)

from torch_parity import (
    check_folded_patch_plains, flagship_cfg, models, scanline_inputs, smajor,
    static_cfg, weights)
from test_torch_patch_route import crop_rays, phase_major

B, TILE = 512, 32                 # B/TILE whole blocks of R in {4, 8}
PATCH = {4: (4, 3), 8: (5, 2)}
IT = 20000


@functools.lru_cache(maxsize=None)
def _tables(S, R):
    """Both packages' tables of one static model (weights seed 1, density
    planes and lines in [0, 0.3): rays from transparent to opaque), on the
    patch route of block size R."""
    cfg = with_coherent_gather(static_cfg(S=S), *PATCH[R], R)
    jm, tm = models(cfg, bf16=False)
    jp, tp = weights(jm, seed=1, density=0.3)
    cf = tm._cf_eval
    prep = cf.prepare(tp)
    tables, lines, wb_t, ptabs = jm._cf_eval._plan_arrays(jp["color"])
    spec = MultiSpec(S=S, axes=prep["axes"], deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale)
    return dict(jm=jm, cf=cf, prep=prep, spec=spec, jtables=tables,
                jlines=lines, wb_t=wb_t, jptabs=ptabs)


def _pack(S, R, axes, seed, coherent=True):
    """A port-layout pack [10, B*S] with the rays phase-major (ray R*j+p at
    position p*(B/R)+j) and a ray pack [B, 8] (dt = tn = 0). With
    `coherent`, per (block, slot) the R rays' points lie within 0.3 texel
    of each other on the first coordinate and 0.05 on the others, except
    one block in five whose rays spread over 3 texels; points partly
    outside the aabb, a few invalid (dist 0) samples, per-ray view
    directions."""
    rng = np.random.default_rng(seed)
    J = B // R
    sizes = (axes[0].W, axes[0].H, axes[1].H)    # grid size per component
    wide = rng.uniform(0, 1, (1, J, 1)) < 0.2
    comps = []
    for size, spread in zip(sizes, (0.3, 0.05, 0.05)):
        base = rng.uniform(-1.05, 1.05, (1, J, S))
        jitter = rng.uniform(0, 1, (R, J, S)) * 2.0 / (size - 1) \
            * np.where(wide, 3.0, spread) if coherent \
            else rng.uniform(-0.05, 0.05, (R, J, S))
        comps.append(base + jitter)
    xyz = np.stack(comps).reshape(3, B, S)
    dist = np.sort(rng.uniform(0.0, 3.0, (B, S)), 1)
    dist[:, :2] *= rng.uniform(0, 1, (B, 1)) < 0.3
    cs = rng.normal(0, 0.1, (6, B, S))
    pack = np.concatenate([xyz, dist[None], cs], 0)
    vd = rng.normal(0, 1, (B, 3))
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), vd,
                           np.zeros((B, 2))], 1)
    return (pack.reshape(PACK_ROWS, B * S).astype(np.float32),
            rays.astype(np.float32))


def _jax_pack16(pack, rays, S):
    """The port's pack -> the JAX kernels' 16-row pack, S-major tiles."""
    p16 = np.zeros((16, B, S), np.float32)
    p16[[0, 1, 2, 4, 5, 6, 7, 8, 9, 10]] = pack.reshape(PACK_ROWS, B, S)
    p16[11:14] = rays[:, 3:6].T[:, :, None]
    return smajor(p16.reshape(16, B * S), S, TILE)


def _jax_multi(d, pk16, rows_list, acc, **kw):
    spec = d["spec"]
    return np.asarray(fused_shade_composite_multi(
        rows_list, jnp.asarray(pk16), d["jlines"], d["wb_t"],
        axes=[a.index for a in spec.axes], S=spec.S,
        grid_dims=[(a.W, a.H) for a in spec.axes],
        line_lens=[a.L for a in spec.axes], time_hs=[0, 0, 0],
        dens_c=[a.nd for a in spec.axes],
        app_c=[a.C - a.nd for a in spec.axes], n_basis=9, density_shift=0.0,
        distance_scale=spec.distance_scale, tile=TILE, s_major=True,
        acc_dtype=acc, **kw))[:5].T


def test_multi_basis_table_matches_jax():
    """[3K, A] with no density columns; the JAX kernel's wb_t is the same
    table with its rows permuted K-major."""
    d = _tables(8, 8)
    wb = d["prep"]["wb"]
    assert wb.shape == (27, 16) and wb.device.type == "cpu"
    assert torch.equal(wb, multi_basis_table(
        torch.from_numpy(np.asarray(d["wb_t"])[np.argsort(kmajor_perm(27))])))
    np.testing.assert_array_equal(wb.numpy()[kmajor_perm(27)],
                                  np.asarray(d["wb_t"]))


# acc="f32" runs the JAX kernel's line lookup at f32, which isolates the
# port's math (1e-5 on rgb/acc, 5e-5 on depth: f32 sums in another
# order); the bf16 default rounds the lines and the line weights to bf16
# in its two-hot matmul, which moves these opaque scenes' rgb by up to
# ~3e-4 (tests/test_torch_shade.py), so 5e-4.
@pytest.mark.parametrize("S,acc", [(8, "f32"), (32, "f32"), (8, "bf16")])
def test_plain_shade_multi_matches_jax_kernel(S, acc):
    d = _tables(S, 8)
    axes = d["spec"].axes
    pack, rays = _pack(S, 8, axes, seed=S, coherent=False)
    pk16 = _jax_pack16(pack, rays, S)
    rows = []
    for a, table in zip(axes, d["jtables"]):
        xi = (np.clip(np.floor((pk16[a.m0] + 1.0) * 0.5 * (a.W - 1)), -1,
                      a.W - 1) + 1).astype(np.int32)
        yi = (np.clip(np.floor((pk16[a.m1] + 1.0) * 0.5 * (a.H - 1)), -1,
                      a.H - 1) + 1).astype(np.int32)
        rows.append(jnp.asarray(np.asarray(table)[yi * (a.W + 1) + xi]))
    want = _jax_multi(d, pk16, rows,
                      jnp.float32 if acc == "f32" else jnp.bfloat16)
    pr = d["prep"]
    got = shade_multi(pr["quads"], pr["lines"], torch.from_numpy(pack),
                      torch.from_numpy(rays), pr["wb"], d["spec"]).numpy()
    assert want[:, 3].max() > 0.5          # the scene is not transparent
    tol = 1e-5 if acc == "f32" else 5e-4
    assert np.abs(got[:, :4] - want[:, :4]).max() <= tol
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * tol


def _phase_major_rows(feats, S, R):
    """The port's features [B*S, C] (phase-major positions) -> the JAX
    blend's [R*C, J] layout."""
    C, J = feats.shape[1], B * S // R
    return smajor(feats.T, S, TILE).reshape(C, R, J).transpose(
        1, 0, 2).reshape(R * C, J)


def _jax_rows(d, pk16, R):
    """Per plane the JAX route's patch rows and anchors for the pack."""
    rows, anchors = [], []
    for a, ptab in zip(d["spec"].axes, d["jptabs"]):
        pidx, anc = patch_anchor_idx(jnp.asarray(pk16[a.m0]),
                                     jnp.asarray(pk16[a.m1]), a.W, a.H, R=R)
        rows.append(ptab[pidx])
        anchors.append(anc)
    return rows, anchors


@pytest.mark.parametrize("R", [4, 8])
def test_plain_patch_blend_on_every_plane_matches_jax_kernel(R):
    """K4 on the planes (0, 1), (0, 2) and (1, 2): f32 features within
    1e-5, as tests/test_torch_patch.py holds the flagship's."""
    S = 8
    d = _tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=R)
    pk16 = _jax_pack16(pack, rays, S)
    rows, anchors = _jax_rows(d, pk16, R)
    pspecs = d["cf"].patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                                 True)
    assert [(ps.m0, ps.m1) for ps in pspecs] == [(0, 1), (0, 2), (1, 2)]
    for a, ps, r, anc, ptab in zip(axes, pspecs, rows, anchors,
                                   d["prep"]["ptabs"]):
        want = np.asarray(jax_patch_blend(
            r, anc, jnp.asarray(pk16), m0=a.m0, m1=a.m1, W=a.W, H=a.H,
            px=ps.px, py=ps.py, C=a.C, blkj=B * S // R // 4,
            out_dtype=jnp.float32, interpret=True, R=R))
        got = patch_features_plain(ptab, torch.from_numpy(pack), ps)
        assert np.abs(_phase_major_rows(got.numpy(), S, R) - want).max() \
            <= 1e-5
        assert np.abs(want).max() > 0.05


@pytest.mark.parametrize("R", [4, 8])
def test_multi_witness_matches_jax(R):
    """The slots that violate on any plane's coordinates (fused_eval.py
    :1096-1120, on the S-major pack) equal the port's count, from the
    count of K4's one call over the three planes and from K6's; the
    caller's ray order changes nothing."""
    S = 8
    d = _tables(S, R)
    axes = d["spec"].axes
    px, py = PATCH[R]
    pack, rays = _pack(S, R, axes, seed=10 + R)
    pk16 = _jax_pack16(pack, rays, S)
    ok = ((np.abs(pk16[0]) <= 1) & (np.abs(pk16[1]) <= 1)
          & (np.abs(pk16[2]) <= 1) & (pk16[4] > 0))
    viol = np.zeros(B * S // R, bool)
    for a in axes:
        for m, size, budget in ((a.m0, a.W, px), (a.m1, a.H, py)):
            f = np.floor((pk16[m] + 1.0) * 0.5 * (size - 1))
            lo = np.where(ok, f, np.float32(3e38)).reshape(R, -1).min(0)
            hi = np.where(ok, f, np.float32(-3e38)).reshape(R, -1).max(0)
            with np.errstate(over="ignore"):
                viol |= hi - lo > budget - 2
    want = int(viol.sum())
    assert 0 < want < viol.size // 2
    scan = pack.reshape(PACK_ROWS, R, B // R, S).transpose(0, 2, 1, 3)
    scan = np.ascontiguousarray(scan).reshape(PACK_ROWS, B * S)
    for pm, pk in ((True, pack), (False, scan)):
        pspecs = d["cf"].patch_specs(
            [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], pm)
        t = torch.from_numpy(pk)
        feats, count = patch_blend(d["prep"]["ptabs"], t, pspecs)
        assert len(feats) == 3 and count.dtype == torch.int32
        assert int(count) == want
        assert int(coverage_count(t, pspecs)) == want


@pytest.mark.parametrize("R", [4, 8])
def test_plain_preblended_and_fused_multi_match_jax_kernels(R):
    """K5 reading K4's bf16 features (preblended="phase_major") and K6
    (preblended="fused_patch") against the JAX kernels, acc_dtype=f32:
    rgb/acc 1e-5, depth 5e-5; out-of-patch blocks included."""
    S = 8
    d = _tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=20 + R)
    pk16 = _jax_pack16(pack, rays, S)
    t, tr = torch.from_numpy(pack), torch.from_numpy(rays)
    pr = d["prep"]
    pspecs = d["cf"].patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                                 True)
    feats = patch_blend(pr["ptabs"], t, pspecs)[0]
    want = _jax_multi(d, pk16, [
        jnp.asarray(_phase_major_rows(f.float().numpy(), S, R)).astype(
            jnp.bfloat16) for f in feats], jnp.float32,
        preblended="phase_major", patch_block=R)
    got = shade_multi_preblended(feats, pr["lines"], t, tr, pr["wb"],
                                 d["spec"]).numpy()
    assert want[:, 3].max() > 0.5
    assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5e-5

    rows, anchors = _jax_rows(d, pk16, R)
    want = _jax_multi(d, pk16, rows, jnp.float32, preblended="fused_patch",
                      anchors_list=anchors, patch_pxy=PATCH[R],
                      patch_block=R)
    got, count = shade_multi_patch(pr["ptabs"], pr["lines"], t, tr, pr["wb"],
                                   d["spec"], pspecs)
    assert int(count) == int(coverage_count(t, pspecs)) > 0
    got = got.numpy()
    assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5e-5


# The folded plain versions (the new kernels' op order: the SH basis folded
# per ray, K6's four clamped taps per plane, a running composite per ray)
# against the JAX kernels (acc_dtype=f32) and the plain versions, the rays
# phase-major and in scanline order: 1e-4 on rgb/acc, 1e-3 on depth (the
# card tests' tolerances), the witness counts equal.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("R", [4, 8])
def test_folded_patch_plains_match_jax_kernels(R, pm):
    S = 8
    d = _tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=60 + R)
    pk16 = _jax_pack16(pack, rays, S)
    t, tr = torch.from_numpy(pack), torch.from_numpy(rays)
    pr = d["prep"]
    feats = patch_blend(pr["ptabs"], t, d["cf"].patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True))[0]
    want_pre = _jax_multi(d, pk16, [
        jnp.asarray(_phase_major_rows(f.float().numpy(), S, R)).astype(
            jnp.bfloat16) for f in feats], jnp.float32,
        preblended="phase_major", patch_block=R)
    rows, anchors = _jax_rows(d, pk16, R)
    want_fused = _jax_multi(d, pk16, rows, jnp.float32,
                          preblended="fused_patch", anchors_list=anchors,
                          patch_pxy=PATCH[R], patch_block=R)
    idx = None
    if not pm:
        t, tr, feats, idx = scanline_inputs(t, tr, feats, S, R)
    pspecs = d["cf"].patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], pm)
    check_folded_patch_plains(
        shade_multi_preblended_folded_plain, shade_multi_preblended_plain,
        want_pre, (feats, pr["lines"], t, tr, pr["wb"], d["spec"]), pm, idx,
        1e-4)
    check_folded_patch_plains(
        shade_multi_patch_folded_plain, shade_multi_patch_plain, want_fused,
        (pr["ptabs"], pr["lines"], t, tr, pr["wb"], d["spec"], pspecs), pm,
        idx, 1e-4)


@functools.lru_cache(maxsize=None)
def _route_models(S, patch):
    cfg = static_cfg(S=S)
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    jm, tm = models(cfg, bf16=False)
    jp, tp = weights(jm, seed=1)
    return jm, tm, jp, tp


ROUTES = [(8, route, pm) for route in ("quad", "two", "fused")
          for pm in (True, False)] + [(32, "fused", True)]


# The whole render against JAX model.apply on a 32x32 crop of bench.py's
# camera (its pixel density; 1,024 rays, so the JAX package takes its patch
# route too). The JAX multi-axis kernels round the lines and their weights
# to bf16 (their acc_dtype default), which the port's f32 taps do not: 2e-4
# (1.1e-5 measured). The coverage witness must be equal.
@pytest.mark.parametrize("S,route,pm", ROUTES, ids=[
    f"S{S}-{r}-{'phase_major' if pm else 'scanline'}" for S, r, pm in ROUTES])
def test_multi_route_matches_jax(S, route, pm, monkeypatch):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI",
                       "1" if route == "fused" else "0")
    jm, tm, jp, tp = _route_models(S, None if route == "quad" else (5, 2, 8))
    rays = crop_rays()[:, :6].copy()
    if pm:
        rays = phase_major(rays, 8)
    rk = {"rays_phase_major": pm}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    ra, rb = np.asarray(a["rgb"]), b["rgb"].numpy()
    assert rb.shape == ra.shape and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= 2e-4
    assert ra.std() > 0.01
    assert ("patch_coverage_viol" in b) == (route != "quad") \
        == ("patch_coverage_viol" in a)
    if route != "quad":
        assert float(a["patch_coverage_viol"]) \
            == float(b["patch_coverage_viol"]) <= 1e-4


def _spy(monkeypatch, name):
    calls = []
    real = getattr(fused_eval, name)

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(fused_eval, name, spy)
    return calls


# Planes whose channel count is not a multiple of 8 take the quad route on
# the patch config, as the JAX package's structural gate decides
# (fused_eval.py:688-695): no coverage witness, the quad kernel, and the
# JAX package's colour (2e-4, the fused-path gate).
@pytest.mark.parametrize("net", ["static_422", "dynamic_2"])
def test_unaligned_channels_take_the_quad_route(net, monkeypatch):
    if net == "static_422":
        cfg = static_cfg(comps=(4, 2, 2))
        rays, quad = crop_rays()[:, :6].copy(), "shade_multi"
    else:
        cfg = flagship_cfg(tiny=True)
        cfg["color"]["net"].update(n_lamb_sigma=[2, 0, 0],
                                   n_lamb_sh=[2, 0, 0])
        rays, quad = crop_rays(), "shade"
    jm, tm = models(with_coherent_gather(cfg, 5, 2, 8), bf16=False)
    assert tm._cf_eval is not None and tm._cf_eval.patch_cfg is None
    jp, tp = weights(jm, seed=3)
    calls = _spy(monkeypatch, quad)
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False))
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT))
    assert calls == [quad]
    assert "patch_coverage_viol" not in a and "patch_coverage_viol" not in b
    assert np.abs(np.asarray(a["rgb"]) - b["rgb"].numpy()).max() <= 2e-4
