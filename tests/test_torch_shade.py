"""K2 shade: the port's plain versions (the CPU side of
hyperreel_tpu_torch/ops/kernels/shade.py), with the SH basis folded per
ray as the kernel takes it and without, against the JAX Pallas kernel
`fused_shade_composite` on the quad route and on pre-blended features
(s_major=True, interpret mode on the CPU), fed the same pack and each
package's tables built from the same weights."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.ops.pallas.shade import fused_shade_composite
from hyperreel_tpu_torch.ops.kernels import shade as SH
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS

from torch_parity import (
    flagship_cfg, jax_pack, jax_premix, models, smajor, weights)

B, TILE = 256, 128


def _pack(S, seed):
    """A port-layout pack [10, B*S] and ray pack [B, 8]: points partly
    outside the aabb, sorted distances with a few invalid (0) samples,
    per-ray view directions and times."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1.1, 1.1, (3, B, S))
    dist = np.sort(rng.uniform(0.0, 3.0, (B, S)), 1)
    dist[:, :2] *= rng.uniform(0, 1, (B, 1)) < 0.3     # dist 0: invalid
    cs = rng.normal(0, 0.1, (6, B, S))
    pack = np.concatenate([xyz, dist[None], cs], 0)
    vd = rng.normal(0, 1, (B, 3))
    vd /= np.linalg.norm(vd, axis=1, keepdims=True)
    rays = np.concatenate([rng.normal(0, 1, (B, 3)), vd,
                           rng.normal(0, 0.1, (B, 1)),
                           rng.uniform(-1, 1, (B, 1))], 1)
    return (pack.reshape(PACK_ROWS, B * S).astype(np.float32),
            rays.astype(np.float32))


# acc="f32" runs the JAX kernel's time lookup at f32 (its acc_dtype
# argument), which isolates the port's math: only f32 summation order
# differs. acc="bf16" is the JAX default, which rounds the time table and
# the z weights to bf16 in the two-hot matmul (shade.py:141-142, :500);
# the port's f32 taps do not.
CASES = [(tiny, premix, "f32") for tiny in (True, False)
         for premix in (False, True)] + [
    (False, False, "bf16"), (False, True, "bf16")]


@functools.lru_cache(maxsize=None)
def _flagship(tiny):
    """Both packages' flagship (or tiny_dynamic) nets, weights seed 1:
    (the JAX net's plan arrays (quad table, time table, basis) and its
    colour net, the port's fused-eval stage and its prepared tables)."""
    jm, tm = models(flagship_cfg(tiny=tiny), bf16=False)
    jp, tp = weights(jm, seed=1)
    (qt,), (ttab_t,), wb_t = jm._cf_eval._plan_arrays(jp["color"])
    cf = tm._cf_eval
    return ((np.asarray(qt), np.asarray(ttab_t), wb_t, jm._cf_eval.net), cf,
            cf.prepare(tp))


def _jax_quad_rows(qt, pk16, W, H):
    """The quad-table rows of the JAX pack's samples: the gather
    fused_eval does between the kernels."""
    px = (pk16[0] + 1.0) * 0.5 * (W - 1)
    py = (pk16[1] + 1.0) * 0.5 * (H - 1)
    xi = (np.clip(np.floor(px), -1, W - 1) + 1).astype(np.int32)
    yi = (np.clip(np.floor(py), -1, H - 1) + 1).astype(np.int32)
    return qt[yi * (W + 1) + xi]


@pytest.mark.parametrize("tiny,premix,acc", CASES, ids=[
    f"{'tiny_S8' if t else 'flagship_S32'}-{'TH0' if p else 'TH4'}-{a}"
    for t, p, a in CASES])
def test_plain_shade_matches_jax_kernel(tiny, premix, acc):
    (qt, ttab_t, wb_t, jnet), cf, prep = _flagship(tiny)
    S = cf.S
    H, W, TH, TW, C, nd = prep["dims"]
    assert TH == 4 and (tiny or (H, W, TW, C, nd) == (161, 161, 80, 16, 8))
    pack, rays = _pack(S, seed=S + premix)

    # JAX: its own plan arrays, the quad-row gather fused_eval does
    # between the kernels, then the kernel
    pk16 = jax_pack(pack, rays, S, TILE)
    rows = _jax_quad_rows(qt, pk16, W, H)
    ttab, th = ttab_t, TH
    tn0 = float(rays[0, 7])
    if premix:
        rays[:, 7] = tn0              # a frame: every ray shares one t
        pk16 = jax_pack(pack, rays, S, TILE)
        ttab, th = jax_premix(ttab, TH, C, tn0), 0
    want = np.asarray(fused_shade_composite(
        jnp.asarray(rows), jnp.asarray(pk16), jnp.asarray(ttab), wb_t,
        S=S, W=W, H=H, TW=TW, TH=th, n_density=nd,
        n_basis=(jnet._sh_deg + 1) ** 2, density_shift=0.0,
        distance_scale=jnet.distance_scale, tile=TILE,
        s_major=True,
        acc_dtype=jnp.float32 if acc == "f32" else jnp.bfloat16))[:5].T

    ttab_p = SH.premix_time(prep["ttab"], torch.tensor(tn0)) if premix \
        else prep["ttab"]
    spec = SH.ShadeSpec(S=S, W=W, H=H, TW=TW, TH=0 if premix else TH, C=C,
                        nd=nd, deg=cf.net.sh_deg,
                        distance_scale=cf.net.distance_scale)
    got = SH.shade(prep["quad"], torch.from_numpy(pack),
                   torch.from_numpy(rays), ttab_p, prep["wb"], spec).numpy()
    assert got.shape == (B, 5)
    assert want[:, 3].max() > 0.5         # the scene is not transparent
    # f32: 1e-5 on rgb and acc, 5e-5 on depth (distances up to 3).
    # bf16: a relative 2^-9 on every time feature; at this scene's
    # opacities (density up to 8 per sample) that moves rgb and acc by up
    # to 3.2e-4 (measured), so 5e-4, and depth by up to 3x that.
    tol = 1e-5 if acc == "f32" else 5e-4
    err = np.abs(got[:, :4] - want[:, :4]).max()
    assert err <= tol, err
    derr = np.abs(got[:, 4] - want[:, 4]).max()
    assert derr <= 5 * tol, derr


# The folded plain versions (the SH basis folded with each ray's view
# direction once, as the kernel takes it) and the unfolded ones against
# the JAX kernel with f32 accumulation, on the quad route and on
# pre-blended features (the JAX kernel's preblended=True: channels-first
# [C, N] in the pack's lane order), SH and RGB colour (a random [3, C]
# basis with zero density columns), the time plane (TH = 4) and a table
# premixed for one t (TH = 0), tiny_dynamic at S = 8 and the flagship at
# S = 32: only f32 summation order differs, 1e-5 on rgb/acc and 5e-5 on
# depth (distances up to 3).
FOLD_CASES = [(route, shading, th, S) for route in ("quad", "preblended")
              for shading in ("sh", "rgb") for th in (4, 0) for S in (8, 32)]


@pytest.mark.parametrize("route,shading,th,S", FOLD_CASES, ids=[
    f"{r}-{sh}-TH{th}-S{S}" for r, sh, th, S in FOLD_CASES])
def test_folded_plain_matches_jax_kernel(route, shading, th, S):
    (qt, ttab_t, wb_t, jnet), cf, prep = _flagship(S == 8)
    assert cf.S == S
    H, W, TH, TW, C, nd = prep["dims"]
    pack, rays = _pack(S, seed=3 * S + th)
    tn0 = float(rays[0, 7])
    ttab_j, ttab = ttab_t, prep["ttab"]
    if th == 0:
        rays[:, 7] = tn0              # a frame: every ray shares one t
        ttab_j = jax_premix(ttab_t, TH, C, tn0)
        ttab = SH.premix_time(prep["ttab"], torch.tensor(tn0))
    wb_j, wb = wb_t, prep["wb"]
    if shading == "rgb":
        rng = np.random.default_rng(S + th)
        wb_np = np.concatenate([np.zeros((3, nd), np.float32),
                                rng.normal(0, 1.0, (3, C - nd))
                                .astype(np.float32)], 1)
        wb_j, wb = jnp.asarray(wb_np), torch.from_numpy(wb_np)
    pk16 = jax_pack(pack, rays, S, TILE)
    pack_t, rays_t = torch.from_numpy(pack), torch.from_numpy(rays)
    if route == "quad":
        rows = jnp.asarray(_jax_quad_rows(qt, pk16, W, H))
        space = prep["quad"]
    else:
        # features as K4 writes them: bf16, one row per sample
        space = SH.quad_features(prep["quad"], pack_t[0], pack_t[1], W, H,
                                 C).to(torch.bfloat16)
        rows = jnp.asarray(smajor(space.float().numpy().T, S, TILE)).astype(
            jnp.bfloat16)
    want = np.asarray(fused_shade_composite(
        rows, jnp.asarray(pk16), jnp.asarray(ttab_j), wb_j, S=S, W=W, H=H,
        TW=TW, TH=th, n_density=nd,
        n_basis=1 if shading == "rgb" else (jnet._sh_deg + 1) ** 2,
        shading=shading, density_shift=0.0,
        distance_scale=jnet.distance_scale, tile=TILE, s_major=True,
        acc_dtype=jnp.float32, preblended=route == "preblended"))[:5].T

    spec = SH.ShadeSpec(S=S, W=W, H=H, TW=TW, TH=th, C=C, nd=nd,
                        deg=cf.net.sh_deg, shading=shading,
                        distance_scale=cf.net.distance_scale)
    args = (space, pack_t, rays_t, ttab, wb, spec)
    if route == "quad":
        got = {"folded": SH.shade_folded_plain(*args),
               "unfolded": SH.shade(*args)}
    else:
        got = {"folded": SH.shade_preblended_folded_plain(*args),
               "unfolded": SH.shade_preblended(*args)}
    assert want[:, 3].max() > 0.5         # the scene is not transparent
    for name, out in got.items():
        out = out.numpy()
        assert out.shape == (B, 5), name
        err = np.abs(out[:, :4] - want[:, :4]).max()
        assert err <= 1e-5, (name, err)
        derr = np.abs(out[:, 4] - want[:, 4]).max()
        assert derr <= 5e-5, (name, derr)
