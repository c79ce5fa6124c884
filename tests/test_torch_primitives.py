"""The non-planar primitive family's modules in hyperreel_tpu_torch against
the JAX package on the CPU: the sphere, cylinder and Pluecker intersect
math, the four intersect stages of donerf_sphere, donerf_cylinder,
catacaustics_distance and immersive_sphere_new with the dataset bounds
that the embedding chain injects, the mipnerf contraction with the
dataset's depth range, and the dynamic chain's base times, which are
constant along each ray (the dynamic net's own fused route reads sample
0's). Inputs come from numpy seeds."""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.intersect import build_intersect as jax_intersect
from hyperreel_tpu.ops import intersect_math as JM
from hyperreel_tpu.ops.contract import get_contract as jax_contract
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.embeddings import RayIntersectEmbedding
from hyperreel_tpu_torch.models.intersect import build_intersect
from hyperreel_tpu_torch.ops import intersect_math as TM
from hyperreel_tpu_torch.ops.contract import get_contract

from torch_parity import ITERS_PER_EPOCH, models, weights

IT = 20000
# the dataset_info of the JAX loaders: catacaustics
# (hyperreel_tpu/data/catacaustics.py:76-78), donerf's near/far with the
# catacaustics depth range, immersive 02_Flames
# (hyperreel_tpu/data/immersive.py:21-24, 56-57, 164-169)
INFO = {"near": 0.1, "far": 10.0, "depth_range": (0.1, 10.0)}
IMMERSIVE_INFO = {"near": 1.0, "far": 10.0, "depth_range": (2.0, 10.0),
                  "num_keyframes": 12, "num_frames": 50}
PRESETS = {"donerf_sphere": INFO, "donerf_cylinder": INFO,
           "catacaustics_distance": INFO,
           "immersive_sphere_new": IMMERSIVE_INFO}


def _np(x):
    return np.asarray(x, np.float32)


def _rays(n, seed, spread=3.0):
    """Origins in a cube of side 2 * spread around the world origin (some
    inside the spheres, some outside), random directions with a few
    components near 0."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (n, 3))
    d = rng.normal(0, 1, (n, 3))
    d[:4, 1] = 0.0
    d[4:8] *= 1e-3
    return np.concatenate([o, d], -1).astype(np.float32)


@pytest.mark.parametrize("fn", ["sphere", "cylinder"])
def test_primitive_intersect_math_matches_jax(fn):
    """intersect_sphere and intersect_cylinder (through
    _quadratic_intersect) at radii that miss, graze, hit from inside and
    are negative (the far-side convention), at 1e-5 relative."""
    rng = np.random.default_rng(1)
    rays = _rays(256, 2)
    radius = rng.uniform(-4, 6, (256, 16)).astype(np.float32)
    jf, tf = getattr(JM, f"intersect_{fn}"), getattr(TM, f"intersect_{fn}")
    want = _np(jf(jnp.asarray(rays)[:, None], jnp.zeros(3),
                  jnp.asarray(radius)))
    got = tf(torch.from_numpy(rays)[:, None], torch.zeros(3),
             torch.from_numpy(radius)).numpy()
    assert got.shape == (256, 16)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (want == 0).any() and (want < 0).any() and (want > 0).any()


def test_pluecker_closest_point_and_min_radii_match_jax():
    rays = _rays(512, 3)
    jr, tr = jnp.asarray(rays), torch.from_numpy(rays)
    origin = np.asarray([0.2, -0.1, 0.3], np.float32)
    for j, t in ((JM.pluecker_closest_point(jr[:, :3], jr[:, 3:6]),
                  TM.pluecker_closest_point(tr[:, :3], tr[:, 3:6])),
                 (JM.min_sphere_radius(jr, jnp.asarray(origin)),
                  TM.min_sphere_radius(tr, torch.from_numpy(origin))),
                 (JM.min_cylinder_radius(jr, jnp.asarray(origin)),
                  TM.min_cylinder_radius(tr, torch.from_numpy(origin)))):
        np.testing.assert_allclose(t.numpy(), _np(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth_range", [(0.1, 10.0), (2.0, 10.0),
                                         (1.0, float("inf"))])
def test_mipnerf_with_dataset_depth_range_matches_jax(depth_range):
    """Under use_dataset_bounds the radii are 1.5x the depth range (the
    start at least 1): the same constants and functions at 1e-6."""
    cfg = {"type": "mipnerf", "contract_samples": True,
           "use_dataset_bounds": True, "_dataset_depth_range": depth_range}
    jc, tc = jax_contract(cfg), get_contract(cfg)
    assert tc.start_r == max(depth_range[0] * 1.5, 1.0)
    assert tc.end_r == depth_range[1] * 1.5
    rng = np.random.default_rng(4)
    pts = (rng.normal(0, 1, (64, 8, 3))
           * rng.uniform(0, 30, (64, 8, 1))).astype(np.float32)
    o = rng.normal(0, 2, (64, 3)).astype(np.float32)
    d = rng.uniform(-3, 3, (512,)).astype(np.float32)
    tp, to, td = (torch.from_numpy(a) for a in (pts, o, d))
    for got, want in (
            (tc.contract_points(tp), jc.contract_points(jnp.asarray(pts))),
            (tc.contract_distance(td), jc.contract_distance(jnp.asarray(d))),
            (tc.inverse_contract_distance(td),
             jc.inverse_contract_distance(jnp.asarray(d))),
            (tc.contract_points_and_distance(to, tp)[1],
             jc.contract_points_and_distance(jnp.asarray(o),
                                             jnp.asarray(pts), None)[1])):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=0,
                                   atol=1e-6)
    # without the depth range the radii keep their defaults
    plain = get_contract({"type": "mipnerf", "use_dataset_bounds": True})
    assert (plain.start_r, plain.end_r) == (1.0, float("inf"))


def _intersect_cfg(name, info):
    """The preset's intersect config with the dataset bounds the JAX chain
    injects (hyperreel_tpu/models/embeddings.py:683-703)."""
    scfg = getattr(JP, name)()["embedding"]["embeddings"]["ray_intersect_0"]
    icfg = copy.deepcopy(scfg["intersect"])
    icfg["_dataset_bounds"] = (info["near"], info["far"])
    icfg["contract"]["_dataset_depth_range"] = info["depth_range"]
    return scfg, icfg


@pytest.mark.parametrize("name", list(PRESETS))
def test_intersect_stage_with_dataset_bounds_matches_jax(name):
    """The preset's intersect stage (32 samples): the port's embedding
    stage injects the same bounds from dataset_info; the anchors, the
    near mask's default, and the points, distances and z values of
    predicted offsets at 1e-5 relative (a few zero: invalid)."""
    info = PRESETS[name]
    scfg, icfg = _intersect_cfg(name, info)
    S = int(scfg["z_channels"])
    jst = jax_intersect(S, icfg)
    tst = RayIntersectEmbedding(scfg, info).intersect
    assert tst.cfg == icfg
    assert type(tst) is build_intersect(S, icfg).__class__
    np.testing.assert_array_equal(tst.samples, jst.samples)
    np.testing.assert_array_equal(tst.z_scale, jst.z_scale)
    assert (tst.initial, tst.end, tst.near, tst.far) == (
        jst.initial, jst.end, jst.near, jst.far)
    assert tst.near == info["near"]
    rng = np.random.default_rng(5)
    rays = _rays(256, 6, spread=1.0 if name.startswith("immersive")
                 else 2.0)
    z = rng.normal(0, 1, (256, S)).astype(np.float32)
    sigma = rng.uniform(0, 1, (256, S)).astype(np.float32)
    want = jst.apply({}, jnp.asarray(rays),
                     {"z_vals": jnp.asarray(z), "sigma": jnp.asarray(sigma)},
                     make_ctx(it=IT, training=False))
    got = tst.apply(torch.from_numpy(rays),
                    {"z_vals": torch.from_numpy(z),
                     "sigma": torch.from_numpy(sigma)}, StepCtx(it=IT))
    for key in ("points", "distances", "z_vals", "raw_points",
                "raw_distance", "weights"):
        np.testing.assert_allclose(got[key].numpy(), _np(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    d = got["distances"].numpy()
    assert (d == 0).any() and (d > 0).mean() > 0.25


def test_blocked_primitive_layouts_raise():
    """A sphere's z values wider than its samples (the reference's blocked
    layouts: origin, resize, offset per sample) are not ported."""
    _, icfg = _intersect_cfg("donerf_sphere", INFO)
    tst = build_intersect(8, icfg)
    x = {"z_vals": torch.zeros(4, 32), "sigma": torch.zeros(4, 32)}
    with pytest.raises(NotImplementedError):
        tst.apply(torch.from_numpy(_rays(4, 0)), x, StepCtx(it=IT))
    with pytest.raises(NotImplementedError):
        build_intersect(8, {"type": "cylinder_new"})


@pytest.mark.parametrize("per_ray_t", [False, True])
def test_base_times_are_constant_along_each_ray(per_ray_t):
    """immersive_sphere_new's chain (tiny, S = 8): the base times that the
    JAX chain hands its fused route per sample (tn2 = normalised
    base_times, packed per sample) equal each ray's sample 0's, which the
    port's dynamic own route packs per ray (ray pack row 7); the port's
    chain gives the same base times."""
    cfg = JP.convert_epochs_to_iters(JP.tiny_immersive_sphere(),
                                     ITERS_PER_EPOCH)
    cfg["color"]["net"]["bf16_tables"] = True
    jm, tm = models(cfg, bf16=False, info=IMMERSIVE_INFO)
    jp, tp = weights(jm, seed=2)
    rng = np.random.default_rng(7)
    rays = np.concatenate([_rays(128, 8, spread=0.5),
                           np.full((128, 1), 3.0),
                           rng.uniform(0, 1, (128, 1)) if per_ray_t
                           else np.full((128, 1), 0.3)],
                          -1).astype(np.float32)
    ctx = make_ctx(it=IT, training=False)
    xj = jm.embedding.apply(jp["embedding"], jnp.asarray(rays), ctx, {})
    bt = _np(xj["base_times"])[..., 0]                  # [B, S]
    assert (bt == bt[:, :1]).all()
    tn2 = _np(jm.color_net.normalize_time_coord(xj["base_times"]))[..., 0]
    xt = tm.embedding.apply(tp["embedding"], torch.from_numpy(rays),
                            StepCtx(it=IT), {})
    np.testing.assert_array_equal(xt["base_times"][..., 0].numpy(), bt)
    _, ray_pack = tm.color_net.fused_pack(xt)
    np.testing.assert_array_equal(
        np.repeat(ray_pack[:, 7:8].numpy(), tn2.shape[1], 1), tn2)
    assert (len(np.unique(bt[:, 0])) > 1) is per_ray_t
