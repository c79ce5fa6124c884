"""The dynamic multi-axis family (neural_3d_z_plane: three space-plane x
keyframe-time-plane axes with [8, 4, 4] components, pluecker rays, the
mipnerf contraction together with a flow stage, 64 samples per ray) in
hyperreel_tpu_torch against the JAX package on the CPU, every comparison
at S = 8 and at S = 64:
  * the general stage chain against JAX `model.apply`;
  * K1's plain version with flow and contraction against the JAX
    pack-build kernel;
  * K5's plain version on the time planes (TH > 0) against
    `fused_shade_composite_multi(time_hs=...)`, and on the planes premixed
    for one t against the JAX `_premix` tables;
  * K4 on the three planes with K5-preblended, and K6, on the time planes;
  * the port's fused quad route against its general path.
tests/test_torch_dynamic_multi_route.py holds the whole render against
the JAX package's. The JAX Pallas kernels run in interpret mode; the port runs its kernels'
plain versions (the tensors lie on the CPU). Inputs come from numpy seeds,
weights cross with `params_from_jax`.

Tolerances: 1e-5 where both sides run f32 math (f32 tables and MLP, the
JAX kernels with acc_dtype=f32): only the order of f32 sums differs. 2e-4
(the fused-path gate of tests/test_fused_cf.py) under the bench policy,
where the JAX multi-axis kernels round the time planes and their z
weights to bf16 in their two-hot matmul and the port's f32 taps do not.
"""

import copy
import dataclasses
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import (
    convert_epochs_to_iters, neural_3d_z_plane, tiny_neural_3d,
    with_coherent_gather)
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.ops.pallas.pack_build import pack_build as jax_pack_build
from hyperreel_tpu.ops.pallas.patch_blend import (
    patch_anchor_idx, patch_blend as jax_patch_blend)
from hyperreel_tpu.ops.pallas.shade import fused_shade_composite_multi
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.kernels import pack_build as PB
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS, pack_from_smajor
from hyperreel_tpu_torch.ops.kernels.patch_blend import (
    coverage_count, patch_blend, patch_features_plain)
from hyperreel_tpu_torch.ops.kernels.shade import premix_time
from hyperreel_tpu_torch.ops.kernels.shade_multi import (
    MultiSpec, shade_multi, shade_multi_preblended,
    shade_multi_preblended_folded_plain, shade_multi_preblended_plain)
from hyperreel_tpu_torch.ops.kernels.shade_multi_patch import (
    shade_multi_patch, shade_multi_patch_folded_plain,
    shade_multi_patch_plain)

from torch_parity import check_folded_patch_plains, entry_rays, jax_pack, \
    jax_premix, models, scanline_inputs, smajor, weights

B, TILE = 512, 32                 # B/TILE whole blocks of R in {4, 8}
PATCH = {4: (4, 3), 8: (5, 2)}
IT = 20000
SS = [8, 64]
F32_TOL, BENCH_TOL = 1e-5, 2e-4


def n3d_cfg(S, fused=True, bf16_tables=True, patch=None):
    """tiny_neural_3d with neural_3d_z_plane's [8, 4, 4] components (the
    layout the multi-axis kernels are built for) and S samples; `fused`
    and `bf16_tables` as tests/torch_parity.py takes them; with `patch`
    (px, py, R) the coherent patch-gather route."""
    cfg = convert_epochs_to_iters(tiny_neural_3d(z_channels=S), 4000)
    cfg["color"]["net"].update(n_lamb_sigma=[8, 4, 4], n_lamb_sh=[8, 4, 4],
                               fused_render=fused, bf16_tables=bf16_tables)
    if not fused:
        cfg["color"]["net"]["fused_render_cf"] = False
    if patch:
        cfg = with_coherent_gather(cfg, *patch)
    return cfg


def _np(x):
    return np.asarray(x, np.float32)


# ---- the general path


@pytest.mark.parametrize("S", SS)
@pytest.mark.parametrize("bf16_tables,tol", [(False, F32_TOL),
                                             (True, BENCH_TOL)],
                         ids=["f32_tables", "bf16_tables"])
def test_general_path_matches_jax(S, bf16_tables, tol):
    """pluecker + 1-frequency PE, time with a 2-frequency PE, the mipnerf
    contraction, spatial flow, the three-axis TensorVMKeyframeTime; f32
    MLP policy, rgb and depth at f32 tables 1e-5, at bf16 tables 2e-4."""
    jm, tm = models(n3d_cfg(S, fused=False, bf16_tables=bf16_tables),
                    bf16=False)
    assert jm._cf_eval is None and tm._cf_eval is None
    jp, tp = weights(jm, seed=2, density=0.3)
    rays = entry_rays(256, seed=3)
    rk = {"fields": ["distances"]}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    assert np.abs(b["rgb"].numpy() - _np(a["rgb"])).max() <= tol
    assert np.abs(b["distances"].numpy() - _np(a["distances"])).max() <= tol
    assert _np(a["rgb"]).std() > 0.01               # not a flat image


# ---- K1 with flow and contraction


def _jax_pack(jm, mlp, rays, it, mlp_spec=None):
    """The JAX pack-build kernel on the dynamic chain with the mipnerf
    contraction, as models/fused_eval.py calls it on the quad route."""
    cf = jm._cf_eval
    pred, isect = cf.pred, cf.isect
    S = cf.S
    acts = {n: pred.activations[pred.output_names.index(n)]
            for n in cf.field_offsets}
    pack, _ = jax_pack_build(
        None if mlp is None else jnp.asarray(mlp.T), jnp.asarray(rays.T),
        it, S=S, k=S, tile=128,
        samples=np.broadcast_to(np.asarray(isect.samples).reshape(-1), (S,)),
        z_scale=np.broadcast_to(np.asarray(isect.z_scale).reshape(-1), (S,)),
        field_offsets=cf.field_offsets, field_acts=acts,
        isect_act=isect.activation,
        flow_act=cf.flow.spatial_flow_activation, po_act=cf.po.activation,
        has_sigma=True, has_flow=True, po_use_sigma=True,
        po_sigma_field=cf.po.in_density_field, far_sentinel=None,
        aabb=np.asarray(cf.net.aabb, np.float32), axis_specs=[(1, 1, 0, 1)],
        contract_rows=isect.contract.contract_rows,
        inv_cdist=isect.contract.inverse_contract_distance,
        emit_idx=False, mlp=mlp_spec)
    return np.array(pack)


def _ray_rows(n, seed):
    """[n, 8] ray pack rows: entry() origins and directions (a few with
    d_z = 0, the guard), dt in [-0.1, 0.1], tn in [-1, 1]."""
    rng = np.random.default_rng(seed)
    rays = entry_rays(n, seed)
    rays[:4, 5] = 0.0
    return np.concatenate([rays[:, :6],
                           rng.uniform(-0.1, 0.1, (n, 1)),
                           rng.uniform(-1, 1, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize("S", SS)
def test_plain_pack_with_flow_and_contraction_matches_jax_kernel(S):
    """K1's tail alone, fed the same MLP output (256 rays, it=20000): the
    contraction and the advection in the JAX kernel's order, 1e-5; the
    distances come out sorted."""
    jm, tm = models(n3d_cfg(S), bf16=False)
    spec = tm._cf_eval.spec
    assert spec.S == S and spec.P == 15 and "flow" in spec.foff
    assert spec.contract.name == "mipnerf" and spec.contract.contract_samples
    mlp = np.random.default_rng(S).normal(
        0.0, 1.0, (256, spec.P * S)).astype(np.float32)
    rays = _ray_rows(256, seed=S)
    want = pack_from_smajor(torch.from_numpy(_jax_pack(jm, mlp, rays, IT)),
                            S, 128)
    got = PB.tail_plain(torch.from_numpy(mlp), torch.from_numpy(rays), spec,
                        IT)
    assert got.shape == (PACK_ROWS, 256 * S)
    assert (got - want).abs().max().item() <= F32_TOL
    assert (got[3].reshape(256, S).diff(dim=1) >= 0).all()
    assert (got[3] > 0).float().mean() > 0.5


def test_plain_pack_with_mlp_matches_jax_kernel():
    """The whole K1 at neural_3d_z_plane's width (6x256 MLP on 23 encoded
    inputs, 960 outputs at S = 64) under the bf16 policy against the JAX
    kernel's in-kernel MLP: 1e-3, for the reason
    tests/test_torch_pack_build.py gives (a bf16 rounding flip in a hidden
    layer)."""
    cfg = n3d_cfg(64)
    cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"] = \
        neural_3d_z_plane()["embedding"]["embeddings"]["ray_prediction_0"][
            "net"]
    jm, tm = models(cfg, bf16=True)
    jp, tp = weights(jm, seed=5)
    cf = tm._cf_eval
    r = torch.from_numpy(entry_rays(256, seed=11))
    x0 = cf.pred.net_input(r, StepCtx(it=IT)).float().contiguous()
    rp = cf.ray_pack(r)
    assert x0.shape == (256, 23)
    mlp_spec = jm._cf_eval._mlp_kernel_spec(
        jp["embedding"]["ray_prediction_0"]["net"], jnp.asarray(x0.numpy().T))
    want = pack_from_smajor(torch.from_numpy(
        _jax_pack(jm, None, rp.numpy(), IT, mlp_spec)), cf.S, 128)
    got = PB.pack_build(x0, cf.prepare(tp)["mlp"], rp, cf.spec, IT)
    assert (got - want).abs().max().item() <= 1e-3


# ---- K5, K4 + K5-preblended and K6 on the time planes


@functools.lru_cache(maxsize=None)
def _tables(S, R):
    """Both packages' tables of one model (weights seed 1, density grids
    in [0, 0.3): rays from transparent to opaque), on the patch route of
    block size R."""
    jm, tm = models(n3d_cfg(S, patch=(*PATCH[R], R)), bf16=False)
    jp, tp = weights(jm, seed=1, density=0.3)
    cf = tm._cf_eval
    prep = cf.prepare(tp)
    tables, times, wb_t, ptabs = jm._cf_eval._plan_arrays(jp["color"])
    spec = MultiSpec(S=S, axes=prep["axes"], deg=cf.net.sh_deg,
                     distance_scale=cf.net.distance_scale)
    return dict(cf=cf, prep=prep, spec=spec, jtables=tables, jtimes=times,
                wb_t=wb_t, jptabs=ptabs)


def _pack(S, R, axes, seed):
    """A port-layout pack [10, B*S] with the rays phase-major (ray R*j+p
    at position p*(B/R)+j) and a ray pack [B, 8] with a time coordinate
    per ray. Per (block, slot) the R rays' points lie within 0.3 texel of
    each other on the first coordinate and 0.05 on the others, except one
    block in five whose rays spread over 3 texels; points partly outside
    the aabb, a few invalid (dist 0) samples, per-ray view directions."""
    rng = np.random.default_rng(seed)
    J = B // R
    sizes = (axes[0].W, axes[0].H, axes[1].H)    # grid size per component
    wide = rng.uniform(0, 1, (1, J, 1)) < 0.2
    comps = []
    for size, spread in zip(sizes, (0.3, 0.05, 0.05)):
        base = rng.uniform(-1.05, 1.05, (1, J, S))
        jitter = rng.uniform(0, 1, (R, J, S)) * 2.0 / (size - 1) \
            * np.where(wide, 3.0, spread)
        comps.append(base + jitter)
    xyz = np.stack(comps).reshape(3, B, S)
    dist = np.sort(rng.uniform(0.0, 3.0, (B, S)), 1)
    dist[:, :2] *= rng.uniform(0, 1, (B, 1)) < 0.3
    cs = rng.normal(0, 0.1, (6, B, S))
    pack = np.concatenate([xyz, dist[None], cs], 0)
    vd = rng.normal(0, 1, (B, 3))
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), vd,
                           rng.normal(0, 0.1, (B, 1)),
                           rng.uniform(-1.05, 1.05, (B, 1))], 1)
    return (pack.reshape(PACK_ROWS, B * S).astype(np.float32),
            rays.astype(np.float32))


def _jax_multi(d, pk16, rows_list, seconds, time_hs, acc=jnp.float32,
               **kw):
    spec = d["spec"]
    return np.asarray(fused_shade_composite_multi(
        rows_list, jnp.asarray(pk16), seconds, d["wb_t"],
        axes=[a.index for a in spec.axes], S=spec.S,
        grid_dims=[(a.W, a.H) for a in spec.axes],
        line_lens=[a.L for a in spec.axes], time_hs=time_hs,
        dens_c=[a.nd for a in spec.axes],
        app_c=[a.C - a.nd for a in spec.axes], n_basis=9, density_shift=0.0,
        distance_scale=spec.distance_scale, tile=TILE, s_major=True,
        acc_dtype=acc, **kw))[:5].T


def _quad_rows(d, pk16):
    rows = []
    for a, table in zip(d["spec"].axes, d["jtables"]):
        xi = (np.clip(np.floor((pk16[a.m0] + 1.0) * 0.5 * (a.W - 1)), -1,
                      a.W - 1) + 1).astype(np.int32)
        yi = (np.clip(np.floor((pk16[a.m1] + 1.0) * 0.5 * (a.H - 1)), -1,
                      a.H - 1) + 1).astype(np.int32)
        rows.append(jnp.asarray(np.asarray(table)[yi * (a.W + 1) + xi]))
    return rows


# acc f32 isolates the port's math (1e-5 on rgb/acc, 5e-5 on depth: f32
# sums in another order); the JAX default bf16 rounds the time planes and
# their z weights, 5e-4 as tests/test_torch_multi.py holds the lines.
@pytest.mark.parametrize("S,acc", [(8, "f32"), (64, "f32"), (64, "bf16")])
def test_plain_shade_multi_on_time_planes_matches_jax_kernel(S, acc):
    d = _tables(S, 8)
    axes = d["spec"].axes
    assert [a.TH for a in axes] == [4, 4, 4]
    pack, rays = _pack(S, 8, axes, seed=S)
    pk16 = jax_pack(pack, rays, S, TILE)
    want = _jax_multi(d, pk16, _quad_rows(d, pk16), d["jtimes"],
                      [a.TH for a in axes],
                      jnp.float32 if acc == "f32" else jnp.bfloat16)
    pr = d["prep"]
    got = shade_multi(pr["quads"], pr["lines"], torch.from_numpy(pack),
                      torch.from_numpy(rays), pr["wb"], d["spec"]).numpy()
    assert want[:, 3].max() > 0.5          # the scene is not transparent
    tol = F32_TOL if acc == "f32" else 5e-4
    assert np.abs(got[:, :4] - want[:, :4]).max() <= tol
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * tol


@pytest.mark.parametrize("S", SS)
def test_premixed_time_planes_match_jax(S):
    """One t for every ray: each axis's time plane premixed for it equals
    the JAX `_premix` of its ring-padded table (1e-6), and K5 on the
    premixed lines (TH = 0) the JAX kernel on its premixed tables."""
    d = _tables(S, 8)
    axes = d["spec"].axes
    pack, rays = _pack(S, 8, axes, seed=30 + S)
    rays[:, 7] = rays[0, 7]
    tn0 = torch.tensor(rays[0, 7])
    pr = d["prep"]
    lines = [premix_time(t, tn0) for t in pr["lines"]]
    jlines = []
    for a, line, jt in zip(axes, lines, d["jtimes"]):
        jl = jax_premix(np.asarray(jt), a.TH, a.C, rays[0, 7])
        assert np.abs(jl[:, 1:a.L + 1].T - line.numpy()).max() <= 1e-6
        jlines.append(jnp.asarray(jl.astype(np.float32)))
    spec = dataclasses.replace(d["spec"], axes=tuple(
        dataclasses.replace(a, TH=0) for a in axes))
    pk16 = jax_pack(pack, rays, S, TILE)
    want = _jax_multi(d, pk16, _quad_rows(d, pk16), jlines, [0, 0, 0])
    got = shade_multi(pr["quads"], lines, torch.from_numpy(pack),
                      torch.from_numpy(rays), pr["wb"], spec).numpy()
    assert np.abs(got[:, :4] - want[:, :4]).max() <= F32_TOL
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * F32_TOL


def _phase_major_rows(feats, S, R):
    """The port's features [B*S, C] (phase-major positions) -> the JAX
    blend's [R*C, J] layout."""
    C, J = feats.shape[1], B * S // R
    return smajor(feats.T, S, TILE).reshape(C, R, J).transpose(
        1, 0, 2).reshape(R * C, J)


@pytest.mark.parametrize("S,R", [(8, 8), (64, 8), (64, 4)])
def test_plain_patch_kernels_on_time_planes_match_jax(S, R):
    """K4 on each plane (f32 features 1e-5), K5 reading K4's bf16
    features (preblended="phase_major") and K6 (preblended="fused_patch")
    against the JAX kernels with the time planes, acc_dtype=f32: rgb/acc
    1e-5, depth 5e-5; out-of-patch blocks included, the witness count
    equal to the plain one."""
    d = _tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=20 + S + R)
    pk16 = jax_pack(pack, rays, S, TILE)
    t, tr = torch.from_numpy(pack), torch.from_numpy(rays)
    pr = d["prep"]
    pspecs = d["cf"].patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                                 True)
    rows, anchors = [], []
    for a, ps, ptab, jptab in zip(axes, pspecs, pr["ptabs"], d["jptabs"]):
        pidx, anc = patch_anchor_idx(jnp.asarray(pk16[a.m0]),
                                     jnp.asarray(pk16[a.m1]), a.W, a.H, R=R)
        rows.append(jptab[pidx])
        anchors.append(anc)
        want = np.asarray(jax_patch_blend(
            rows[-1], anc, jnp.asarray(pk16), m0=a.m0, m1=a.m1, W=a.W,
            H=a.H, px=ps.px, py=ps.py, C=a.C, blkj=B * S // R // 4,
            out_dtype=jnp.float32, interpret=True, R=R))
        got = patch_features_plain(ptab, t, ps)
        assert np.abs(_phase_major_rows(got.numpy(), S, R) - want).max() \
            <= F32_TOL
    time_hs = [a.TH for a in axes]
    feats = patch_blend(pr["ptabs"], t, pspecs)[0]
    want = _jax_multi(d, pk16, [
        jnp.asarray(_phase_major_rows(f.float().numpy(), S, R)).astype(
            jnp.bfloat16) for f in feats], d["jtimes"], time_hs,
        preblended="phase_major", patch_block=R)
    got = shade_multi_preblended(feats, pr["lines"], t, tr, pr["wb"],
                                 d["spec"]).numpy()
    assert want[:, 3].max() > 0.5
    assert np.abs(got[:, :4] - want[:, :4]).max() <= F32_TOL
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * F32_TOL

    want = _jax_multi(d, pk16, rows, d["jtimes"], time_hs,
                      preblended="fused_patch", anchors_list=anchors,
                      patch_pxy=PATCH[R], patch_block=R)
    got, count = shade_multi_patch(pr["ptabs"], pr["lines"], t, tr, pr["wb"],
                                   d["spec"], pspecs)
    assert int(count) == int(coverage_count(t, pspecs)) > 0
    got = got.numpy()
    assert np.abs(got[:, :4] - want[:, :4]).max() <= F32_TOL
    assert np.abs(got[:, 4] - want[:, 4]).max() <= 5 * F32_TOL


@functools.lru_cache(maxsize=None)
def _jax_patch_outputs(S, R):
    """The JAX kernels' K5-pre (preblended="phase_major", on the port's K4
    features) and K6 (preblended="fused_patch") outputs [B, 5] on the time
    planes, acc_dtype=f32, for _pack(S, R) with the rays phase-major;
    with the pack, the ray pack and the features."""
    d = _tables(S, R)
    axes = d["spec"].axes
    pack, rays = _pack(S, R, axes, seed=50 + S + R)
    pk16 = jax_pack(pack, rays, S, TILE)
    t = torch.from_numpy(pack)
    pspecs = d["cf"].patch_specs([(a.W, a.H, a.C, a.m0, a.m1) for a in axes],
                                 True)
    feats = patch_blend(d["prep"]["ptabs"], t, pspecs)[0]
    time_hs = [a.TH for a in axes]
    pre = _jax_multi(d, pk16, [
        jnp.asarray(_phase_major_rows(f.float().numpy(), S, R)).astype(
            jnp.bfloat16) for f in feats], d["jtimes"], time_hs,
        preblended="phase_major", patch_block=R)
    rows, anchors = [], []
    for a, jptab in zip(axes, d["jptabs"]):
        pidx, anc = patch_anchor_idx(jnp.asarray(pk16[a.m0]),
                                     jnp.asarray(pk16[a.m1]), a.W, a.H, R=R)
        rows.append(jptab[pidx])
        anchors.append(anc)
    fused = _jax_multi(d, pk16, rows, d["jtimes"], time_hs,
                       preblended="fused_patch", anchors_list=anchors,
                       patch_pxy=PATCH[R], patch_block=R)
    return t, torch.from_numpy(rays), feats, pre, fused


# The folded plain versions (the new kernels' op order: the SH basis folded
# per ray, K6's four clamped taps per plane, a running composite per ray)
# against the JAX kernels (acc_dtype=f32) and the plain versions, the rays
# phase-major and in scanline order: 1e-4 on rgb/acc, 1e-3 on depth (the
# card tests' tolerances), the witness counts equal.
@pytest.mark.parametrize("pm", [True, False], ids=["phase_major", "scanline"])
@pytest.mark.parametrize("S,R", [(S, R) for S in (8, 16, 64) for R in (4, 8)])
def test_folded_patch_plains_on_time_planes_match_jax(S, R, pm):
    d = _tables(S, R)
    pack, rays, feats, want_pre, want_fused = _jax_patch_outputs(S, R)
    idx = None
    if not pm:
        pack, rays, feats, idx = scanline_inputs(pack, rays, feats, S, R)
    pr = d["prep"]
    pspecs = d["cf"].patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in d["spec"].axes], pm)
    check_folded_patch_plains(
        shade_multi_preblended_folded_plain, shade_multi_preblended_plain,
        want_pre, (feats, pr["lines"], pack, rays, pr["wb"], d["spec"]),
        pm, idx, 1e-4)
    check_folded_patch_plains(
        shade_multi_patch_folded_plain, shade_multi_patch_plain, want_fused,
        (pr["ptabs"], pr["lines"], pack, rays, pr["wb"], d["spec"], pspecs),
        pm, idx, 1e-4)


def test_fused_path_matches_general_path():
    """The port's fused quad route (the plain versions of K1 and K5 on the
    time planes) against its own general path on the same weights and
    per-ray times, at S = 64 (the JAX package's gate, 2e-4)."""
    cfg = n3d_cfg(64)
    jm, fused = models(cfg, bf16=False)
    cfg_g = copy.deepcopy(cfg)
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    _, general = models(cfg_g, bf16=False)
    assert fused._cf_eval is not None and general._cf_eval is None
    _, tp = weights(jm, seed=4, density=0.3)
    rays = torch.from_numpy(entry_rays(512, seed=5))
    a = fused.apply(tp, rays, StepCtx(it=IT))["rgb"]
    b = general.apply(tp, rays, StepCtx(it=IT))["rgb"]
    assert (a - b).abs().max().item() <= BENCH_TOL
