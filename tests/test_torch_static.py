"""The static chain of the llff_z_plane family in hyperreel_tpu_torch
against the JAX package on the CPU: the pluecker parameterisation, the
mipnerf scene contraction, the z-plane intersect with it, the static VM
net's general path, the weights bridge for its planes and lines, and K1's
plain version with the contraction and no flow stage against the JAX
Pallas kernel (interpret mode). Inputs come from numpy seeds."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import llff_z_plane
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.intersect import IntersectZPlane as JaxZPlane
from hyperreel_tpu.models.ray_param import get_ray_param as jax_ray_param
from hyperreel_tpu.ops.contract import get_contract as jax_contract
from hyperreel_tpu.ops.pallas.pack_build import pack_build as jax_pack_build
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.intersect import IntersectZPlane
from hyperreel_tpu_torch.models.ray_param import get_ray_param
from hyperreel_tpu_torch.ops.contract import get_contract
from hyperreel_tpu_torch.ops.kernels import pack_build as PB
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS, pack_from_smajor

from torch_parity import models, static_cfg, static_rays, weights

IT = 20000
ISECT = llff_z_plane()["embedding"]["embeddings"]["ray_intersect_0"][
    "intersect"]


def _np(x):
    return np.asarray(x, np.float32)


def test_pluecker_matches_jax():
    """(d / |d|, o x d / |d|) at 1e-6, directions with tiny and zero
    components included."""
    rng = np.random.default_rng(0)
    rays = rng.normal(0, 1, (256, 6)).astype(np.float32)
    rays[:8, 3:6] *= 1e-7
    rays[8:12, 5] = 0.0
    cfg = {"fn": "pluecker", "n_dims": 6, "direction_multiplier": 1.0,
           "moment_multiplier": 0.5, "origin": [0.1, -0.2, 0.3]}
    want = _np(jax_ray_param(cfg).apply(jnp.asarray(rays)))
    got = get_ray_param(cfg).apply(torch.from_numpy(rays)).numpy()
    assert got.shape == (256, 6)
    assert np.abs(got - want).max() <= 1e-6


CONTRACTS = [ISECT["contract"],
             {"type": "mipnerf", "contract_samples": False,
              "contract_start_radius": 2.0}]


@pytest.mark.parametrize("cfg", CONTRACTS, ids=["llff", "start2_inf_end"])
def test_mipnerf_contraction_matches_jax(cfg):
    """contract_points, contract_distance, inverse_contract_distance,
    contract_points_and_distance (the general path) and contract_rows (the
    fused path's op order) at 1e-6: the points come out within radius 2,
    the inverse distances up to 1 / inv_end_d."""
    rng = np.random.default_rng(1)
    jc, tc = jax_contract(cfg), get_contract(cfg)
    assert tc.contract_samples == jc.contract_samples
    pts = (rng.normal(0, 1, (64, 8, 3))
           * rng.uniform(0, 20, (64, 8, 1))).astype(np.float32)
    pts[0, 0] = 0.0
    o = rng.normal(0, 0.5, (64, 3)).astype(np.float32)
    d = rng.uniform(-3, 3, (512,)).astype(np.float32)
    d[:3] = (0.0, 1.0, -1.0)
    tp, to, td = (torch.from_numpy(a) for a in (pts, o, d))

    def close(got, want):
        # infinities (an infinite end radius) must match exactly
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=1e-6)

    close(tc.contract_points(tp), jc.contract_points(jnp.asarray(pts)))
    close(tc.contract_distance(td), jc.contract_distance(jnp.asarray(d)))
    close(tc.inverse_contract_distance(td),
          jc.inverse_contract_distance(jnp.asarray(d)))
    pc, dc = tc.contract_points_and_distance(to, tp)
    jpc, jdc = jc.contract_points_and_distance(
        jnp.asarray(o), jnp.asarray(pts), None)
    close(pc, jpc)
    close(dc, jdc)
    rows = tc.contract_rows(*(tp[..., c] for c in range(3)))
    jrows = jc.contract_rows(*(jnp.asarray(pts[..., c]) for c in range(3)))
    for g, w in zip(rows, jrows):
        close(g, w)


@pytest.mark.parametrize("S", [8, 32])
def test_z_plane_intersect_with_contraction_matches_jax(S):
    """The anchors in contracted space, the inverse contraction of the
    predicted z, the sort and the contraction of points and distances
    (hyperreel_tpu/models/intersect.py:144-151, :258-262, :277-286)."""
    jst, tst = JaxZPlane(z_channels=S, cfg=ISECT), IntersectZPlane(S, ISECT)
    np.testing.assert_array_equal(tst.samples, jst.samples)
    np.testing.assert_array_equal(tst.z_scale, jst.z_scale)
    assert (tst.initial, tst.end) == (jst.initial, jst.end)
    rng = np.random.default_rng(S)
    rays = static_rays(128, seed=S).astype(np.float32)
    rays[:4, 5] = 0.0                                # the d_z guard
    z = rng.normal(0, 1, (128, S)).astype(np.float32)
    sigma = rng.uniform(0, 1, (128, S)).astype(np.float32)
    ctx = make_ctx(it=IT, training=False)
    want = jst.apply({}, jnp.asarray(rays), {"z_vals": jnp.asarray(z),
                                             "sigma": jnp.asarray(sigma)},
                     ctx)
    got = tst.apply(torch.from_numpy(rays), {"z_vals": torch.from_numpy(z),
                                             "sigma": torch.from_numpy(sigma)},
                    StepCtx(it=IT))
    for key in ("points", "distances", "z_vals", "raw_points",
                "raw_distance"):
        err = np.abs(got[key].numpy() - _np(want[key])).max()
        assert err <= 1e-5, (key, err)
    assert (got["distances"] == 0).any() and (got["distances"] > 0).any()


# The general path (fused_render off in both packages) at f32 tables: the
# same lookups and f32 sums, some in another order, so 1e-5.
def test_general_path_matches_jax():
    jm, tm = models(static_cfg(fused=False, bf16_tables=False), bf16=False)
    assert jm._cf_eval is None and tm._cf_eval is None
    jp, tp = weights(jm, seed=2)
    rays = static_rays(256, seed=3)
    rk = {"fields": ["distances"]}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    assert np.abs(b["rgb"].numpy() - _np(a["rgb"])).max() <= 1e-5
    assert np.abs(b["distances"].numpy() - _np(a["distances"])).max() <= 1e-5
    assert _np(a["rgb"]).std() > 0.01               # not a flat image


def test_params_from_jax_carries_planes_and_lines():
    """The static net's plane_i and line_i families cross unchanged; the
    basis crosses as its nn.Linear transpose."""
    jm, tm = models(static_cfg(), bf16=False)
    pn = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    tp = params_from_jax(pn, device="cpu")
    for fam in ("density", "app"):
        assert set(tp["color"][fam]) == {f"{k}_{i}" for k in ("plane", "line")
                                         for i in range(3)}
        for k, v in pn["color"][fam].items():
            np.testing.assert_array_equal(tp["color"][fam][k].numpy(), v)
    np.testing.assert_array_equal(tp["color"]["basis_mat"]["weight"].numpy(),
                                  pn["color"]["basis_mat"]["w"].T)
    # the port's own init draws the same shapes
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    for fam in ("density", "app"):
        for k, v in own["color"][fam].items():
            assert tuple(v.shape) == pn["color"][fam][k].shape


B = 256          # two 128-ray tiles of the JAX kernel


def _jax_pack(jm, mlp, rays, it, mlp_spec=None):
    """The JAX pack-build kernel on the static chain, as models/fused_eval.py
    calls it: no flow stage, the mipnerf contract_rows and
    inverse_contract_distance."""
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
        isect_act=isect.activation, flow_act=None, po_act=cf.po.activation,
        has_sigma=True, has_flow=False, po_use_sigma=True,
        po_sigma_field=cf.po.in_density_field, far_sentinel=None,
        aabb=np.asarray(cf.net.aabb, np.float32), axis_specs=[(1, 1, 0, 1)],
        contract_rows=isect.contract.contract_rows,
        inv_cdist=isect.contract.inverse_contract_distance,
        emit_idx=False, mlp=mlp_spec)
    return np.array(pack)


# it=0: sigma and point_sigma ease from 1.0, which zeroes the predicted z
# and offsets (the anchors alone); it=20000 is past both windows.
@pytest.mark.parametrize("S", [8, 32])
@pytest.mark.parametrize("it", [0, IT])
def test_plain_pack_with_contraction_matches_jax_kernel(S, it):
    """K1's tail alone, fed the same MLP output: f32 elementwise math in
    the same operation order on both sides, 1e-5."""
    jm, tm = models(static_cfg(S=S), bf16=False)
    spec = tm._cf_eval.spec
    assert spec.S == S and spec.P == 12 and "flow" not in spec.foff
    assert spec.contract.name == "mipnerf"
    rng = np.random.default_rng(it + S)
    mlp = rng.normal(0.0, 1.0, (B, spec.P * S)).astype(np.float32)
    rays = np.concatenate([static_rays(B, seed=S),
                           np.zeros((B, 2), np.float32)], 1)
    rays[:4, 5] = 0.0                                # the d_z guard
    want = pack_from_smajor(torch.from_numpy(_jax_pack(jm, mlp, rays, it)),
                            S, 128)
    got = PB.tail_plain(torch.from_numpy(mlp), torch.from_numpy(rays), spec,
                        it)
    assert got.shape == (PACK_ROWS, B * S)
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err
    assert (got[3].reshape(B, -1).diff(dim=1) >= 0).all()   # sorted
    assert (got[3] > 0).float().mean() > 0.5


def test_plain_pack_with_mlp_matches_jax_kernel():
    """The whole K1 at llff_z_plane's width (6x256 MLP, 18 encoded inputs,
    S=32) under the bf16 policy against the JAX kernel's in-kernel MLP:
    1e-3, for the reason tests/test_torch_pack_build.py gives."""
    jm, tm = models(static_cfg(S=32, full=True), bf16=True)
    jp, tp = weights(jm, seed=5)
    cf = tm._cf_eval
    r = torch.from_numpy(static_rays(B, seed=11))
    x0 = cf.pred.net_input(r, StepCtx(it=IT)).float().contiguous()
    rp = cf.ray_pack(r)
    assert x0.shape == (B, 18)
    mlp_spec = jm._cf_eval._mlp_kernel_spec(
        jp["embedding"]["ray_prediction_0"]["net"], jnp.asarray(x0.numpy().T))
    want = pack_from_smajor(torch.from_numpy(
        _jax_pack(jm, None, rp.numpy(), IT, mlp_spec)), cf.S, 128)
    got = PB.pack_build(x0, cf.prepare(tp)["mlp"], rp, cf.spec, IT)
    err = (got - want).abs().max().item()
    assert err <= 1e-3, err


def test_fused_path_matches_general_path():
    """The port's fused quad route (K1 and K5 plain versions) against its
    own general path on the same weights (the JAX package's gate, 2e-4,
    tests/test_fused_cf.py TestStaticCFChain)."""
    cfg = static_cfg(S=32)
    cfg_g = copy.deepcopy(cfg)
    # the general colour net too, not the net's own fused route
    cfg_g["color"]["net"].update(fused_render_cf=False, fused_render=False)
    jm, fused = models(cfg, bf16=False)
    _, general = models(cfg_g, bf16=False)
    assert fused._cf_eval is not None and general._cf_eval is None
    _, tp = weights(jm, seed=4)
    for k in tp["color"]["density"]:           # a partly opaque scene
        tp["color"]["density"][k] = tp["color"]["density"][k] * 0.25
    rays = torch.from_numpy(static_rays(1024, seed=5))
    a = fused.apply(tp, rays, StepCtx(it=IT))["rgb"]
    b = general.apply(tp, rays, StepCtx(it=IT))["rgb"]
    assert (a - b).abs().max().item() <= 2e-4
