"""The dynamic net's grid events against the JAX package's, and the fused
route after one: compute_alpha_grid (the max over keyframes, the 3^3
max-pool, the occupied box), upsample and shrink; after a shrink the
port's quad route (on the CPU the plain versions of K1 and K2) normalizes
against the new aabb, as its general chain and the JAX package's routes
do."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model as build_torch

from torch_parity import INFO, entry_rays, flagship_cfg, models

# a box inside the preset's aabb [[-2, -2, -1], [2, 2, 1]] whose faces no
# z-plane anchor sits on
SHRUNK = np.array([[-0.6, -0.5, -0.8], [0.55, 0.6, 0.8]], np.float32)


def _rgb(model, params, rays):
    return model.apply(params, torch.from_numpy(rays),
                       StepCtx(it=20000))["rgb"].numpy()


# The two routes are held to each other at the 2e-4 gate of
# tests/test_fused_cf.py (f32 MLP policy); the shrink must move the frame
# by far more. The JAX package's routes agree the same way: its fused
# route reads net.aabb at each call (hyperreel_tpu/models/fused_eval.py:
# 902), and tests/test_torch_train_step.py holds the port's quad route
# against it after a training run whose alpha event shrank the aabb.
def test_quad_route_reads_the_aabb_after_a_shrink():
    cfgs = [flagship_cfg(tiny=True), flagship_cfg(tiny=True, fused=False)]
    quad, general = (build_torch(c, dataset_info=INFO) for c in cfgs)
    assert quad._cf_eval is not None and general._cf_eval is None
    params = quad.init(torch.Generator().manual_seed(5), "cpu")
    gen = torch.Generator().manual_seed(6)
    for k, v in params["color"]["density"].items():
        params["color"]["density"][k] = torch.rand(v.shape, generator=gen)
    rays = entry_rays(256, seed=11)
    before = _rgb(quad, params, rays)
    for m in (quad, general):
        m.color_net.shrink(params["color"], SHRUNK)
    after = _rgb(quad, params, rays)
    assert np.abs(after - before).max() > 0.05
    assert np.abs(after - _rgb(general, params, rays)).max() <= 2e-4


def _trained_like(tm, seed):
    """Init weights (numpy, the port's layout) with the density grids
    redrawn uniform in [0, 1) and a third of the space plane's columns
    empty (exact zeros), so that the alpha grid has an occupied box
    inside the aabb."""
    pn = {"color": params_to_jax(
        tm.color_net.init(torch.Generator().manual_seed(seed), "cpu"))}
    rng = np.random.default_rng(seed)
    for k, v in pn["color"]["density"].items():
        v = rng.uniform(0, 1, v.shape).astype(np.float32)
        if k.startswith("space"):
            v[:, : v.shape[1] // 3] = 0.0
        pn["color"]["density"][k] = v
    return pn


# The alpha grid is exact (the same f32 lattice, lookups and threshold);
# the upsampled grids are the same bilinear weights, 1e-5 (the lattice's
# ulps, tests/test_torch_train_losses.py)
@pytest.mark.parametrize("reso", [(12, 14, 9), (20, 20, 10)])
def test_alpha_grid_shrink_and_upsample_match_jax(reso):
    cfg = flagship_cfg(tiny=True, fused=False, bf16_tables=False)
    cfg["color"]["net"].update(N_voxel_init=16 ** 3)
    info = {"num_keyframes": 3, "num_frames": 12}
    jm, tm = models(cfg, bf16=False, info=info)
    pn = _trained_like(tm, seed=reso[0])
    jc = jax.tree.map(jnp.asarray, pn["color"])
    tc = params_from_jax(pn, device="cpu")["color"]
    jb, jbox = jm.color_net.compute_alpha_grid(jc, reso)
    tb, tbox = tm.color_net.compute_alpha_grid(tc, reso)
    assert tb.shape == (reso[2], reso[1], reso[0])
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tbox.numpy(), np.asarray(jbox))
    assert 0 < tb.mean() < 1 and tbox[0, 0] > -2.0   # a box inside
    jm.color_net.shrink(jc, np.asarray(jbox))
    tm.color_net.shrink(tc, tbox.numpy())
    from hyperreel_tpu.models.tensorf import n_to_reso
    new = n_to_reso(24 ** 3, jm.color_net.aabb)
    jup = jm.color_net.upsample(jc, new)
    tup = tm.color_net.upsample(tc, new)
    assert tm.color_net.grid_size == jm.color_net.grid_size == new
    for fam in ("density", "app"):
        for k, v in jup[fam].items():
            got = tup[fam][k]
            assert tuple(got.shape) == v.shape and not got.requires_grad
            assert np.abs(got.numpy() - np.asarray(v)).max() <= 1e-5


def test_static_net_training_is_refused():
    """TensorVMNoSample's training apply (no longer refused; held against
    the JAX package in tests/test_torch_train_static.py): in training the
    general path runs, records the grids' gradients through the plane and
    line lookups, keeps the background coin and does not clamp."""
    from hyperreel_tpu_torch.configs.presets import (
        convert_epochs_to_iters, tiny_static)
    from hyperreel_tpu_torch.train.trainer import _requiring_grad
    model = build_torch(convert_epochs_to_iters(tiny_static(), 4000))
    params = _requiring_grad(model.init(torch.Generator().manual_seed(0),
                                        "cpu"))
    rays = torch.from_numpy(entry_rays(8)[:, :6].copy())
    ctx = StepCtx(it=0, training=True, draws={"background": 0.3})
    rgb = model.apply(params, rays, ctx)["rgb"]
    assert rgb.requires_grad and torch.isfinite(rgb).all()
    line, = torch.autograd.grad(rgb.sum(), params["color"]["density"][
        "line_1"])
    assert line.abs().max() > 0
    # the coin < 0.5 adds the white background, unclamped
    ctx1 = StepCtx(it=0, training=True, draws={"background": 0.7})
    assert (rgb - model.apply(params, rays, ctx1)["rgb"]).abs().max() > 0
