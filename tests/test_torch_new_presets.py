"""The cascaded, voxel, deformable and reflect presets of the port
(hyperreel_tpu_torch/configs/presets.py) against the JAX package's, on
its tiny versions with the same weights (tests/torch_train_parity.py: the
port's init, the density grids redrawn; the blob scenes):

  * the eval forward through the general chain and the general colour
    net, f32 policy: rgb within 1e-5;
  * one training step's loss and every gradient leaf (the JAX step's
    draws injected): the loss within 1e-6 relative, each leaf within 1e-5
    of its largest entry, as tests/test_torch_train_static.py, plus 1e-10
    (the RGB nets' density lines get gradients of ~1e-6, six orders
    below the planes', whose sums in another order then differ by ~1e-11,
    1.3-1.9e-5 of the leaf);
  * the full-size presets build, take no channels-first route in either
    package (their chains are not its patterns), and their nets' own
    fused routes are eligible where the JAX package's are (not
    blender_voxel's softplus net).

tiny_cascaded: two-plane rays with a time, 4 coarse z-planes, the point
prediction to 8 samples, a second z-plane intersect, flow, the point
offset from point_sigma, the flagship's colour net with the predicted
colour scale and shift. tiny_blender_voxel: pluecker rays, point density
before and after a [2, 6]-masked voxel grid of 12 planes, a softplus
[4, 4, 4] net on a white background. tiny_shiny_deformable: the
deformable planes (the basic PE, four z values a sample). tiny_refnerf
(refnerf_sphere at test size) and tiny_refnerf_reflect: spheres over the
dataset bounds, the reflected view directions."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models import fused_eval as jax_fused_eval
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.model import build_model as build_jax
from hyperreel_tpu_torch.configs import presets as TP
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model as build_torch

from torch_train_parity import (
    BATCH, IPE, grad_errors, init_weights, one_step, preset_cfg, start)
from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene

NAMES = ["tiny_cascaded", "tiny_blender_voxel", "tiny_shiny_deformable",
         "tiny_refnerf", "tiny_refnerf_reflect"]
IT = 160


def tiny_refnerf(z_channels=8, grid=32):
    """refnerf_sphere (no reflection) at the size of the tiny presets."""
    return JP._shrink_for_tests(JP.refnerf_sphere(z_channels=z_channels),
                                grid)


@functools.lru_cache(maxsize=None)
def _scene(dynamic):
    return gaussian_blob_scene(n_views=2, wh=(12, 12), dynamic=dynamic,
                               num_frames=4, num_keyframes=2, device="cpu")


def _cfg(name):
    if name == "tiny_refnerf":
        return JP.convert_epochs_to_iters(tiny_refnerf(), IPE)
    cfg = preset_cfg(name)
    if name == "tiny_cascaded":
        # the flagship family's anchors lie on the aabb's z faces
        # (tests/torch_train_parity.py FACES_ON_ANCHORS)
        lo, hi = (list(c) for c in cfg["color"]["net"]["aabb"])
        lo[2], hi[2] = -1.5, 1.5
        cfg["color"]["net"]["aabb"] = [lo, hi]
    return cfg


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    cfg = _cfg(name)
    cfg["color"]["net"].update(fused_render=False, fused_render_cf=False)
    ds = _scene(name == "tiny_cascaded")
    jm = build_jax(copy.deepcopy(cfg), dataset_info=ds.info())
    tm = build_torch(copy.deepcopy(cfg), dataset_info=ds.info())
    pn = init_weights(tm)
    # appearance 10x the init's spread: the RGB nets' colours then differ
    # from ray to ray (sigmoid of the init's is ~0.5 everywhere)
    for k, v in pn["color"]["app"].items():
        pn["color"]["app"][k] = v * 10.0
    jp = jax.tree.map(jnp.asarray, pn)
    tp = params_from_jax(pn, device="cpu")
    rays = ds.all_coords[:288]
    # compiled: the JAX chain's eager first call compiles op by op
    ra = np.asarray(jax.jit(lambda p, r: jm.apply(
        p, r, make_ctx(it=IT, training=False), {})["rgb"])(
            jp, jnp.asarray(rays)))
    rb = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), {})[
        "rgb"].numpy()
    assert rb.shape == ra.shape == (288, 3) and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= 1e-5
    assert ra.std() > 1e-2


@pytest.mark.parametrize("name", NAMES)
def test_one_step_matches_jax(name):
    cfg = _cfg(name)
    ds = _scene(name == "tiny_cascaded")
    jt, js, tt, ts = start(cfg, ds)
    batch = next(ds.batch_iterator(BATCH, seed=3))
    jm, jg, tm, tg = one_step(jt, js, tt, ts, batch, IT)
    for k in ("loss", "image_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    assert all(torch.isfinite(g).all() for g in tg.values())
    reached = 0
    for path, (err, scale) in grad_errors(jg, tg).items():
        assert err <= 1e-5 * scale + 1e-10, (path, err, scale)
        reached += scale > 0
    assert reached >= len(tg) // 2


@pytest.mark.parametrize("name,own", [
    ("technicolor_cascaded", True), ("blender_voxel", False),
    ("shiny_z_deformable", True), ("refnerf_sphere", True),
    ("refnerf_sphere_reflect", True)])
def test_full_presets_route_as_in_jax(name, own):
    cfg = getattr(TP, name)()
    assert cfg == getattr(JP, name)()
    info = {"num_keyframes": 4, "num_frames": 50, "near": 2.0, "far": 6.0}
    tm = build_torch(copy.deepcopy(cfg), dataset_info=info,
                     compute_dtype=torch.bfloat16)
    jm = build_jax(copy.deepcopy(cfg), dataset_info=info,
                   compute_dtype=jnp.bfloat16)
    assert not fused_eval.cf_eligible(tm) and tm._cf_eval is None
    assert not jax_fused_eval.cf_eligible(jm)
    net = tm.color_net
    assert net.fused_eligible == own == jm.color_net._fused_eligible
    S = {"technicolor_cascaded": 32, "blender_voxel": 192}.get(name, 64)
    stages = dict(tm.embedding.stages)
    last = [s for n, s in tm.embedding.stages if n.startswith(
        "ray_intersect")][-1]
    assert last.z_channels == S
    if name == "blender_voxel":
        assert net.fea2dense == "softplus" and net.white_bg == 1
        assert stages["ray_intersect_0"].intersect.near == 2.0


def test_weights_and_moments_carry_the_new_stages():
    """convert.py on tiny_cascaded: the port's init in the JAX layout has
    the JAX init's tree and shapes (jax.eval_shape; the point-prediction
    net's dense layers transposed) and comes back to the bit; the JAX
    optimizer state of those weights gives every leaf its moments."""
    from hyperreel_tpu.train.trainer import Trainer as JaxTrainer
    from hyperreel_tpu_torch.convert import opt_state_from_jax, params_to_jax
    from hyperreel_tpu_torch.train.optim import path_key, tree_leaves
    from torch_train_parity import training_cfg
    cfg = _cfg("tiny_cascaded")
    ds = _scene(True)
    jm = build_jax(copy.deepcopy(cfg), dataset_info=ds.info())
    tm = build_torch(copy.deepcopy(cfg), dataset_info=ds.info())
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    pn = params_to_jax(tp)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(shapes) == jax.tree.structure(pn)
    assert all(jax.tree.leaves(jax.tree.map(lambda a, b: a.shape == b.shape,
                                            shapes, pn)))
    net = pn["embedding"]["point_prediction_0"]["net"]
    assert net["layer_0"]["w"].shape == (24, 64)
    back = dict(tree_leaves(params_from_jax(pn, device="cpu")))
    for path, v in tree_leaves(tp):
        assert torch.equal(back[path], v), path
    jp = jax.tree.map(jnp.asarray, pn)
    opt = JaxTrainer(jm, training_cfg(), iters_per_epoch=IPE)._make_optimizer(
        jp).init(jp)
    st = opt_state_from_jax(opt, tm.param_groups(tp), device="cpu")
    layer = ("embedding", "point_prediction_0", "net", "layer_0", "weight")
    assert set(st["slots"]) == {path_key(p) for p, _ in tree_leaves(tp)}
    assert set(st["slots"][path_key(layer)]) == {"mu", "nu"}
    assert st["slots"][path_key(layer)]["mu"].shape == (64, 24)
