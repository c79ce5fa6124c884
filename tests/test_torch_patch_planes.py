"""K4 over every plane of a chunk in one call, K3's folded colour and the
multi-axis two-kernel route at S = k in hyperreel_tpu_torch against the
JAX package on the CPU (the port's kernels run as their plain versions;
the JAX Pallas kernels in interpret mode):
  * the all-planes plain blend (`patch_blend_plain`, one call over the
    three planes) against the JAX `patch_blend` plane by plane, and its
    count against the JAX route's `patch_coverage_viol` (the OR over the
    planes, models/fused_eval.py:1096-1120), on the static and the
    time-plane nets at S = 8, 16 and 64, R = 4 and 8, with blocks that
    leave the patch;
  * K3's folded plain version (`shade_patch_folded_plain`, the SH basis
    folded with each ray's view direction as the kernel takes it) against
    `_shade_kernel_fused_patch`, SH and RGB colour, at S = 16 and 32;
  * neural_3d_z_plane's two-kernel patch route with the stride (S = 16, k
    = 4) against JAX `model.apply`, one t and a t per ray: one K4 call per
    chunk for the three planes.

Tolerances: the blend's bf16 features within one bf16 ulp of the JAX
kernel's plus 1e-5 (the same f32 terms summed in another order, then
rounded), the counts exact; K3 under the f32 policy (f32 tables,
acc_dtype=f32) 1e-5 on rgb/acc and 5e-5 on depth, as K2's tests hold
them: the fold only reorders f32 sums; the route at the fused-path gate
2e-4 (K4 rounds its features to bf16), the witness equal.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.ops.pallas.patch_blend import (
    patch_anchor_idx, patch_blend as jax_patch_blend)
from hyperreel_tpu.ops.pallas.shade import fused_shade_composite
from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.ops.kernels.patch_blend import patch_blend
from hyperreel_tpu_torch.ops.kernels.shade_patch import (
    shade_patch_folded_plain, shade_patch_plain)

import test_torch_dynamic_multi as dyn
import test_torch_multi as static
import test_torch_patch as single
from test_torch_patch_route import crop_rays, phase_major
from test_torch_sample_count import FUSED_TOL, _both
from torch_parity import (  # noqa: F401
    ITERS_PER_EPOCH, f32_acc, jax_pack, models, weights)

B, TILE = 512, 32


def _bf16_tol(want):
    """One bf16 ulp of each value, plus the f32 tolerance."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7) + 1e-5


def _jax_witness(pk16, axes, R, px, py):
    """The JAX route's violating slots (models/fused_eval.py:1096-1120) on
    the S-major pack: per plane and coordinate, the slots whose valid
    samples' floors span more than p - 2; ORed over every plane."""
    ok = ((np.abs(pk16[0]) <= 1) & (np.abs(pk16[1]) <= 1)
          & (np.abs(pk16[2]) <= 1) & (pk16[4] > 0))
    viol = np.zeros(pk16.shape[1] // R, bool)
    for a in axes:
        for m, size, budget in ((a.m0, a.W, px), (a.m1, a.H, py)):
            f = np.floor((pk16[m] + 1.0) * 0.5 * (size - 1))
            lo = np.where(ok, f, np.float32(3e38)).reshape(R, -1).min(0)
            hi = np.where(ok, f, np.float32(-3e38)).reshape(R, -1).max(0)
            with np.errstate(over="ignore"):      # -3e38 - 3e38 = -inf
                viol |= hi - lo > budget - 2
    return viol


@pytest.mark.parametrize("S", [8, 16, 64])
@pytest.mark.parametrize("R", [4, 8])
@pytest.mark.parametrize("net", ["static", "time_planes"])
def test_all_planes_blend_matches_jax(net, R, S):
    mod = static if net == "static" else dyn
    d = mod._tables(S, R)
    axes = d["spec"].axes
    pack, rays = mod._pack(S, R, axes, seed=50 + S + R)
    pk16 = jax_pack(pack, rays, S, TILE)
    pspecs = d["cf"].patch_specs(
        [(a.W, a.H, a.C, a.m0, a.m1) for a in axes], True)
    feats, count = patch_blend(d["prep"]["ptabs"], torch.from_numpy(pack),
                               pspecs)
    assert len(feats) == 3 and count.dtype == torch.int32
    for a, ps, f, jptab in zip(axes, pspecs, feats, d["jptabs"]):
        assert f.dtype == torch.bfloat16 and f.shape == (B * S, a.C)
        pidx, anc = patch_anchor_idx(jnp.asarray(pk16[a.m0]),
                                     jnp.asarray(pk16[a.m1]), a.W, a.H, R=R)
        want = np.asarray(jax_patch_blend(
            jptab[pidx], anc, jnp.asarray(pk16), m0=a.m0, m1=a.m1, W=a.W,
            H=a.H, px=ps.px, py=ps.py, C=a.C, blkj=B * S // R // 4,
            out_dtype=jnp.bfloat16, interpret=True, R=R).astype(jnp.float32))
        mine = static._phase_major_rows(f.float().numpy(), S, R)
        assert (np.abs(mine - want) <= _bf16_tol(want)).all()
        assert np.abs(want).max() > 0.05
    viol = _jax_witness(pk16, axes, R, pspecs[0].px, pspecs[0].py)
    assert int(count) == int(viol.sum()) > 0


def _rgb_basis(C, nd, seed):
    """A random [3, C] RGB basis, zero on the density channels (the
    layout of both packages' wb)."""
    w = np.random.default_rng(seed).normal(0, 0.5, (3, C)).astype(np.float32)
    w[:, :nd] = 0.0
    return w


@pytest.mark.parametrize("shading", ["sh", "rgb"])
@pytest.mark.parametrize("S", [16, 32])
def test_folded_shade_patch_matches_jax_kernel(S, shading):
    R = 8
    cfg = JP.convert_epochs_to_iters(JP.tiny_dynamic(z_channels=S),
                                     ITERS_PER_EPOCH)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    d = single._setup(True, R, cfg)
    spec, wb, wb_t = d["spec"], d["prep"]["wb"], d["wb_t"]
    assert spec.S == S
    if shading == "rgb":
        w = _rgb_basis(spec.C, spec.nd, S)
        wb, wb_t = torch.from_numpy(w), jnp.asarray(w)
        spec = dataclasses.replace(spec, shading="rgb")
    pk16, rows, anchors = single._jax_rows(d)
    want = np.asarray(fused_shade_composite(
        rows, jnp.asarray(pk16), jnp.asarray(d["ttab_j"]), wb_t, S=S,
        W=spec.W, H=spec.H, TW=spec.TW, TH=0, n_density=spec.nd,
        n_basis=spec.n_basis, density_shift=0.0,
        distance_scale=spec.distance_scale, tile=TILE, s_major=True,
        acc_dtype=jnp.float32, shading=shading, preblended="fused_patch",
        anchors=anchors, patch_pxy=single.PATCH[R], m0=0, m1=1,
        patch_block=R))[:5].T
    args = (d["prep"]["patch"], torch.from_numpy(d["pack"]),
            torch.from_numpy(d["rays"]), d["ttab"], wb, spec, d["pspec"])
    got, count = shade_patch_folded_plain(*args)
    unfolded, count_u = shade_patch_plain(*args)
    assert int(count) == int(count_u) > 0
    assert want[:, 3].max() > 0.5
    for mine in (got.numpy(), unfolded.numpy()):
        assert np.abs(mine[:, :4] - want[:, :4]).max() <= 1e-5
        assert np.abs(mine[:, 4] - want[:, 4]).max() <= 5e-5


@pytest.mark.parametrize("uniform_time", [True, False],
                         ids=["one_t", "t_per_ray"])
def test_n3d_two_kernel_route_at_k_matches_jax(uniform_time, monkeypatch,
                                               f32_acc):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI", "0")
    cfg = JP.with_coherent_gather(
        JP.with_inference_samples(dyn.n3d_cfg(16), 4), 5, 2, 8)
    jm, tm = models(cfg, bf16=False,
                    info={"num_keyframes": 4, "num_frames": 50})
    assert tm._cf_eval is not None and tm._cf_eval.k == 4
    jp, tp = weights(jm, seed=31, density=0.6)
    calls = []
    real = fused_eval.patch_blend

    def spy(ptabs, pack, specs):
        calls.append(len(specs))
        return real(ptabs, pack, specs)

    monkeypatch.setattr(fused_eval, "patch_blend", spy)
    rays = crop_rays()
    if not uniform_time:
        rays[:, 7] = np.random.default_rng(3).uniform(0, 1, rays.shape[0])
    rays = phase_major(rays, 8)
    a, b, err = _both(jm, tm, jp, tp, rays,
                      {"rays_phase_major": True,
                       "uniform_time": uniform_time})
    assert calls == [3]               # one K4 call, the three planes
    assert err <= FUSED_TOL, err
    assert float(a["patch_coverage_viol"]) == float(
        b["patch_coverage_viol"])
    assert np.asarray(a["rgb"]).std() > 0.01
