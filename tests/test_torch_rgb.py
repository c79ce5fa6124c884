"""RGB shading and the weights row in hyperreel_tpu_torch's shade kernels
against the JAX package on the CPU: the plain versions of K5, K5
reading K4's features and K6 with RGB colour on shiny_z_plane's tiny
layout, K5 with RGB and the weights row (the static net's own multi-axis
route), and K2 with RGB and the weights row on stanford_llff_z_plane's
tiny single axis (its z line as the premixed table), each against its
Pallas kernel in interpret mode (K2's with the JAX route's degenerate TH =
1 time plane), fed the same pack (random non-unit weights in the weights
row) and each package's tables built from the same weights. On the CPU
the port runs its kernels' plain versions."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import with_coherent_gather
from hyperreel_tpu.ops.pallas.shade import (
    fused_shade_composite, fused_shade_composite_multi)
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS
from hyperreel_tpu_torch.ops.kernels.patch_blend import patch_blend
from hyperreel_tpu_torch.ops.kernels.shade import shade
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    MultiSpec, shade_multi, shade_multi_preblended,
    shade_multi_preblended_folded_plain, shade_multi_preblended_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
    shade_multi_patch, shade_multi_patch_folded_plain,
    shade_multi_patch_plain)

from torch_parity import (
    check_folded_patch_plains, models, rgb_cfg, scanline_inputs, smajor,
    weights)
from test_torch_multi import (
    B, PATCH, TILE, _jax_pack16, _jax_rows, _pack, _phase_major_rows)


@functools.lru_cache(maxsize=None)
def _shiny_tables(S, R):
    """Both packages' tables of tiny_shiny on the patch route of block
    size R (weights seed 1, density planes and lines in [0, 0.3))."""
    cfg = with_coherent_gather(rgb_cfg("shiny", S), *PATCH[R], R)
    jm, tm = models(cfg, bf16=False)
    jp, tp = weights(jm, seed=1, density=0.3)
    cf = tm._cf_eval
    prep = cf.prepare(tp)
    tables, lines, wb_t, ptabs = jm._cf_eval._plan_arrays(jp["color"])
    spec = MultiSpec(S=S, axes=prep["axes"], deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale, shading="rgb")
    return dict(cf=cf, prep=prep, spec=spec, jtables=tables, jlines=lines,
                wb_t=wb_t, jptabs=ptabs)


def _jax_multi_rgb(d, pk16, rows_list, acc, **kw):
    spec = d["spec"]
    return np.asarray(fused_shade_composite_multi(
        rows_list, jnp.asarray(pk16), d["jlines"], d["wb_t"],
        axes=[a.index for a in spec.axes], S=spec.S,
        grid_dims=[(a.W, a.H) for a in spec.axes],
        line_lens=[a.L for a in spec.axes], time_hs=[0] * len(spec.axes),
        dens_c=[a.nd for a in spec.axes],
        app_c=[a.C - a.nd for a in spec.axes], n_basis=1, shading="rgb",
        density_shift=0.0, distance_scale=spec.distance_scale, tile=TILE,
        s_major=True, acc_dtype=acc, **kw))[:5].T


def _quad_rows(d, pk16):
    """Per axis the quad rows the JAX route gathers between its kernels."""
    rows = []
    for a, table in zip(d["spec"].axes, d["jtables"]):
        xi = (np.clip(np.floor((pk16[a.m0] + 1.0) * 0.5 * (a.W - 1)), -1,
                      a.W - 1) + 1).astype(np.int32)
        yi = (np.clip(np.floor((pk16[a.m1] + 1.0) * 0.5 * (a.H - 1)), -1,
                      a.H - 1) + 1).astype(np.int32)
        rows.append(jnp.asarray(np.asarray(table)[yi * (a.W + 1) + xi]))
    return rows


def _weights_row(S, seed):
    """Random non-unit per-sample weights in [0, 2)."""
    return np.random.default_rng(seed).uniform(0, 2, (1, B * S)).astype(
        np.float32)


# acc="f32" runs the JAX kernel's line lookup at f32, which isolates the
# port's math: 1e-5 on rgb/acc, 5e-5 on depth (f32 sums in another order).
# acc="bf16" is its default, which rounds the lines and their weights to
# bf16 (the bf16 line lookup, ROADMAP.md 3): in these opaque scenes (acc
# 0.99) rgb/acc move by up to 7.1e-4 and depth by 1.3e-3 (measured), so
# 1e-3 and 5e-3.
@pytest.mark.parametrize("S,acc,wrow", [
    (8, "f32", False), (32, "f32", False), (8, "bf16", False),
    (8, "f32", True), (8, "bf16", True)],
    ids=["S8-f32", "S32-f32", "S8-bf16", "S8-f32-weights",
         "S8-bf16-weights"])
def test_plain_rgb_shade_multi_matches_jax_kernel(S, acc, wrow):
    """K5 with RGB colour, and with the weights row of the net's own
    route (the JAX route's pack row 14)."""
    d = _shiny_tables(S, 8)
    pack, rays = _pack(S, 8, d["spec"].axes, seed=30 + S, coherent=False)
    pk16 = _jax_pack16(pack, rays, S)
    spec = d["spec"]
    if wrow:
        w = _weights_row(S, seed=S)
        pk16[14] = smajor(w, S, TILE)[0]
        pack = np.ascontiguousarray(np.concatenate([pack, w]))
        spec = MultiSpec(S=S, axes=spec.axes, deg=spec.deg,
                         distance_scale=spec.distance_scale, shading="rgb",
                         weights=True)
    want = _jax_multi_rgb(d, pk16, _quad_rows(d, pk16),
                          jnp.float32 if acc == "f32" else jnp.bfloat16,
                          use_weights_row=wrow)
    pr = d["prep"]
    got = shade_multi(pr["quads"], pr["lines"], torch.from_numpy(pack),
                      torch.from_numpy(rays), pr["wb"], spec).numpy()
    assert want[:, 3].max() > 0.5          # the scene is not transparent
    tol = 1e-5 if acc == "f32" else 1e-3
    assert np.abs(got[:, :4] - want[:, :4]).max() <= tol
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * tol
    if wrow:                                # the weights moved the colour
        plain = shade_multi(pr["quads"], pr["lines"],
                            torch.from_numpy(pack[:PACK_ROWS].copy()),
                            torch.from_numpy(rays), pr["wb"],
                            d["spec"]).numpy()
        assert np.abs(plain[:, :4] - got[:, :4]).max() > 0.05


@pytest.mark.parametrize("R", [4, 8])
def test_plain_rgb_preblended_and_fused_multi_match_jax_kernels(R):
    """K5 reading K4's bf16 features and K6 with RGB colour against the
    JAX kernels, acc_dtype=f32: rgb/acc 1e-5, depth 5e-5; out-of-patch
    blocks included."""
    S = 8
    d = _shiny_tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=40 + R)
    pk16 = _jax_pack16(pack, rays, S)
    t, tr = torch.from_numpy(pack), torch.from_numpy(rays)
    pr = d["prep"]
    pspecs = d["cf"].patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                                 True)
    feats = patch_blend(pr["ptabs"], t, pspecs)[0]
    want = _jax_multi_rgb(d, pk16, [
        jnp.asarray(_phase_major_rows(f.float().numpy(), S, R)).astype(
            jnp.bfloat16) for f in feats], jnp.float32,
        preblended="phase_major", patch_block=R)
    got = shade_multi_preblended(feats, pr["lines"], t, tr, pr["wb"],
                                 d["spec"]).numpy()
    assert want[:, 3].max() > 0.5
    assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5e-5

    rows, anchors = _jax_rows(d, pk16, R)
    want = _jax_multi_rgb(d, pk16, rows, jnp.float32,
                          preblended="fused_patch", anchors_list=anchors,
                          patch_pxy=PATCH[R], patch_block=R)
    got, count = shade_multi_patch(pr["ptabs"], pr["lines"], t, tr, pr["wb"],
                                   d["spec"], pspecs)
    assert int(count) > 0
    got = got.numpy()
    assert np.abs(got[:, :4] - want[:, :4]).max() <= 1e-5
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5e-5


# The folded plain versions with RGB colour (the new kernels' op order:
# K6's four clamped taps per plane, a running composite per ray; RGB has
# no basis to fold) against the JAX kernels (acc_dtype=f32) and the plain
# versions, the rays
# phase-major and in scanline order: 1e-4 on rgb/acc, 1e-3 on depth (the
# card tests' tolerances), the witness counts equal.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("R", [4, 8])
def test_folded_patch_plains_match_jax_kernels(R, pm):
    S = 8
    d = _shiny_tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=70 + R)
    pk16 = _jax_pack16(pack, rays, S)
    t, tr = torch.from_numpy(pack), torch.from_numpy(rays)
    pr = d["prep"]
    feats = patch_blend(pr["ptabs"], t, d["cf"].patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True))[0]
    want_pre = _jax_multi_rgb(d, pk16, [
        jnp.asarray(_phase_major_rows(f.float().numpy(), S, R)).astype(
            jnp.bfloat16) for f in feats], jnp.float32,
        preblended="phase_major", patch_block=R)
    rows, anchors = _jax_rows(d, pk16, R)
    want_fused = _jax_multi_rgb(d, pk16, rows, jnp.float32,
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


def _jax_single_axis_tables(jp, nd):
    """The tables of the JAX package's single-axis fused route
    (hyperreel_tpu/models/tensorf.py TensorVMNoSample.apply_fused:
    :557-585): the quad table, the z line as a ring-padded [3C, TW] TH = 1
    time table, and the basis with zero density columns (K = 1, so its
    k-major permutation is the identity)."""
    c = jp["color"]
    space = np.concatenate([c["density"]["plane_0"], c["app"]["plane_0"]],
                           -1)
    H, W, C = space.shape
    p = np.pad(np.asarray(jnp.asarray(space).astype(jnp.bfloat16)),
               ((1, 1), (1, 1), (0, 0)))
    quad = np.concatenate([p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:]],
                          -1).reshape((H + 1) * (W + 1), 4 * C)
    line = np.concatenate([c["density"]["line_0"], c["app"]["line_0"]], -1)
    L = line.shape[0]
    tp = np.pad(line.astype(np.float32)[None], ((1, 1), (1, 1), (0, 0)))
    twp = (L + 2 + 127) // 128 * 128
    ttab = np.pad(np.moveaxis(tp, -1, 1).reshape(3 * C, L + 2),
                  ((0, 0), (0, twp - L - 2)))
    w = np.asarray(c["basis_mat"]["w"], np.float32)
    wb = np.concatenate([np.zeros((w.shape[1], nd), np.float32), w.T], 1)
    return quad, ttab, wb, (W, H, L, C)


# The JAX single-axis route runs its K2 on ray-major lanes with tile 64
# (TensorVMNoSample.apply_fused). acc="f32" isolates the port's math (1e-5
# on rgb/acc, 5e-5 on depth); acc="bf16", the route's own default, rounds
# the line and the z weights to bf16 (the bf16 line lookup, ROADMAP.md 3):
# rgb/acc up to 7.0e-4 and depth 1.7e-3 here (measured), so 1e-3 and
# 5e-3.
@pytest.mark.parametrize("S,acc", [(8, "f32"), (32, "f32"), (8, "bf16")])
def test_plain_rgb_weights_shade_matches_jax_kernel(S, acc):
    """K2 with RGB colour and the weights row, the z line as the premixed
    table (TH = 0), against the JAX kernel on the degenerate TH = 1 time
    plane with use_weights_row."""
    cfg = rgb_cfg("stanford", S)
    jm, tm = models(cfg, bf16=False)
    jp, tp = weights(jm, seed=2, density=0.6)
    net = tm.color_net
    prep = net.prepare_fused(tp["color"])
    a, = prep["axes"]
    quad, ttab, wb_t, (W, H, L, C) = _jax_single_axis_tables(jp, a.nd)
    assert (W, H, L, C) == (a.W, a.H, a.L, a.C)
    pack, rays = _pack(S, 8, (a, a, a), seed=50 + S, coherent=False)
    w = _weights_row(S, seed=S + 1)
    # the JAX route's ray-major pack: rows xn yn zn tn dist cs csh vd w
    p16 = np.zeros((16, B * S), np.float32)
    p16[[0, 1, 2, 4, 5, 6, 7, 8, 9, 10]] = pack
    p16[11:14] = np.repeat(rays[:, 3:6].T, S, 1)
    p16[14] = w
    xi = (np.clip(np.floor((p16[0] + 1.0) * 0.5 * (W - 1)), -1, W - 1)
          + 1).astype(np.int32)
    yi = (np.clip(np.floor((p16[1] + 1.0) * 0.5 * (H - 1)), -1, H - 1)
          + 1).astype(np.int32)
    want = np.asarray(fused_shade_composite(
        jnp.asarray(quad[yi * (W + 1) + xi]), jnp.asarray(p16),
        jnp.asarray(ttab), jnp.asarray(wb_t), S=S, W=W, H=H, TW=L, TH=1,
        n_density=a.nd, n_basis=1, shading="rgb", density_shift=0.0,
        distance_scale=net.distance_scale, tile=64, use_weights_row=True,
        acc_dtype=jnp.float32 if acc == "f32" else jnp.bfloat16))[:5].T
    pack11 = torch.from_numpy(np.ascontiguousarray(np.concatenate([pack, w])))
    spec = net.fused_spec(prep, S)
    assert spec.TH == 0 and spec.weights and spec.shading == "rgb"
    got = shade(prep["quads"][0], pack11, torch.from_numpy(rays),
                prep["lines"][0], prep["wb"], spec).numpy()
    assert want[:, 3].max() > 0.5
    tol = 1e-5 if acc == "f32" else 1e-3
    assert np.abs(got[:, :4] - want[:, :4]).max() <= tol
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * tol
