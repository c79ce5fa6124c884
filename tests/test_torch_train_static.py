"""The static net's training (hyperreel_tpu_torch/models/tensorf.py
TensorVMNoSample) against the JAX package's, on its tiny presets
(tests/torch_train_parity.py: the same weights, the JAX step's draws
injected, the aabb's z faces off the z-plane anchors):

  * one step's loss and every gradient leaf of each static preset
    (tiny_static, tiny_shiny with its sample stages, tiny_stanford_llff,
    tiny_donerf_sphere, tiny_donerf_cylinder, tiny_catacaustics_distance)
    against jax.value_and_grad of Trainer._loss_and_metrics, under the f32
    policy;
  * a step of every ported preset through Trainer.fit (the port alone);
  * the grid events: resize_linear_1d, compute_alpha_grid, shrink (the
    crop of planes and lines, the corrected aabb) and upsample;
  * the L1 and TV terms on planes and lines.
The fits across the grid events: tests/test_torch_train_static_fit.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models import tensorf as jtensorf
from hyperreel_tpu.ops.grid_sample import resize_linear_1d as jresize
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.models import tensorf as ttensorf
from hyperreel_tpu_torch.ops.grid_sample import resize_linear_1d

from torch_parity import models
from torch_train_parity import (
    BATCH, grad_errors, jit_upsample, one_step, preset_cfg, scene, start,
    training_cfg)

STATIC = ["tiny_static", "tiny_shiny", "tiny_stanford_llff",
          "tiny_donerf_sphere", "tiny_donerf_cylinder",
          "tiny_catacaustics_distance"]


# Under the f32 policy (f32 MLP, f32 tables) the same f32 ops, the lookups'
# gradients summed in another order: the loss and metrics within 1e-6
# relative, every gradient leaf within 1e-5 of its largest entry (measured
# <= 8e-6), each leaf reached and finite. The bf16 policy's steps:
# tests/test_torch_train_regularizers.py.
@pytest.mark.parametrize("name", STATIC)
def test_one_step_matches_jax(name):
    cfg = preset_cfg(name)
    ds = scene(name)
    jt, js, tt, ts = start(cfg, ds)
    batch = next(ds.batch_iterator(BATCH, seed=3))
    jm, jg, tm, tg = one_step(jt, js, tt, ts, batch, 160)
    for k in ("loss", "image_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    assert all(torch.isfinite(g).all() for g in tg.values())
    for path, (err, scale) in grad_errors(jg, tg).items():
        assert scale > 0, path
        assert err <= 1e-5 * scale, (path, err, scale)


# Every ported preset (the port's own tiny presets, their bf16 tables
# where they keep them) takes a step through Trainer.fit: the loss finite
# and every param leaf finite, the grids changed.
@pytest.mark.parametrize("name", [
    "tiny_static", "tiny_shiny", "tiny_stanford_llff", "tiny_donerf_sphere",
    "tiny_donerf_cylinder", "tiny_catacaustics_distance", "tiny_dynamic",
    "tiny_neural_3d", "tiny_immersive_sphere"])
def test_every_preset_trains_through_fit(name):
    from hyperreel_tpu_torch.configs import presets as TP
    from hyperreel_tpu_torch.models.model import build_model
    from hyperreel_tpu_torch.train.optim import tree_leaves
    from hyperreel_tpu_torch.train.trainer import Trainer
    ds = scene(name)
    model = build_model(TP.convert_epochs_to_iters(getattr(TP, name)(), 50),
                        dataset_info=ds.info())
    trainer = Trainer(model, training_cfg(), iters_per_epoch=50,
                      device="cpu")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    before = {p: v.clone() for p, v in tree_leaves(state.params)}
    state, hist = trainer.fit(state, ds.batch_iterator(BATCH, seed=0), 1,
                              log_every=1)
    assert state.it == 1 and np.isfinite(hist[0]["loss"])
    leaves = dict(tree_leaves(state.params))
    assert all(torch.isfinite(v).all() for v in leaves.values())
    grid = ("color", "density", next(iter(state.params["color"]["density"])))
    assert (leaves[grid] != before[grid]).any()


# the same linear weights on lattices XLA may fold one f32 ulp apart:
# 1e-5 of unit-scale texels (as resize_bilinear_2d's test)
@pytest.mark.parametrize("L,new", [(7, 12), (1, 5), (20, 31), (6, 1)])
def test_resize_linear_matches_jax(L, new):
    g = np.random.default_rng(3).normal(size=(L, 3)).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(g), new))
    got = resize_linear_1d(torch.from_numpy(g), new).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def _static_models():
    cfg = preset_cfg("tiny_static")
    cfg["color"]["net"].update(N_voxel_init=16 ** 3, n_lamb_sigma=[8, 4, 4],
                               n_lamb_sh=[8, 4, 4])
    return cfg, models(cfg, bf16=False)


# The alpha grid exactly (the same f32 lattice, lookups and threshold);
# the shrink's crop and aabb exactly (float64 index arithmetic as JAX's);
# the upsampled planes and lines within 1e-5 (the lattice's ulps; the JAX
# upsample compiled, `jit_upsample`).
def test_alpha_grid_shrink_and_upsample_match_jax():
    reso = (16, 17, 15)
    cfg, (jm, tm) = _static_models()
    pn = {"color": params_to_jax(tm.color_net.init(
        torch.Generator().manual_seed(reso[0]), "cpu"))}
    rng = np.random.default_rng(reso[1])
    for k, v in pn["color"]["density"].items():
        v = rng.uniform(0, 1, v.shape).astype(np.float32)
        if k in ("plane_0", "plane_1"):
            v[:, : v.shape[1] // 3] = 0.0
        elif k == "line_2":
            v[: v.shape[0] // 3] = 0.0
        elif k == "line_0":
            v[-v.shape[0] // 4:] = 0.0
        pn["color"]["density"][k] = v
    jc = jax.tree.map(jnp.asarray, pn["color"])
    tc = params_from_jax(pn, device="cpu")["color"]
    jb, jbox = jm.color_net.compute_alpha_grid(jc, reso)
    tb, tbox = tm.color_net.compute_alpha_grid(tc, reso)
    assert tb.shape == (reso[2], reso[1], reso[0])
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tbox.numpy(), np.asarray(jbox))
    assert 0 < tb.mean() < 1 and tbox[0, 0] > -1.5    # a box inside
    old = list(tm.color_net.grid_size)
    js = jm.color_net.shrink(jc, np.asarray(jbox))
    ts = tm.color_net.shrink(tc, tbox.numpy())
    assert tm.color_net.grid_size == jm.color_net.grid_size != old
    assert tm.color_net.aabb.dtype == np.float32
    np.testing.assert_array_equal(tm.color_net.aabb, jm.color_net.aabb)
    for fam in ("density", "app"):
        for k, v in js[fam].items():
            np.testing.assert_array_equal(ts[fam][k].numpy(), np.asarray(v))
    new = jtensorf.n_to_reso(24 ** 3, jm.color_net.aabb)
    jit_upsample(jm.color_net)
    jup = jm.color_net.upsample(js, new)
    tup = tm.color_net.upsample(ts, new)
    assert tm.color_net.grid_size == jm.color_net.grid_size == new
    for fam in ("density", "app"):
        for k, v in jup[fam].items():
            got = tup[fam][k]
            assert tuple(got.shape) == v.shape and not got.requires_grad
            assert np.abs(got.numpy() - np.asarray(v)).max() <= 1e-5


# the L1 term over planes and lines and the TV terms over the planes: the
# same f32 means in another order, 1e-6 relative; the L1 gradient of a
# line with exact zeros as jnp.abs's
def test_l1_and_tv_terms_match_jax():
    _, (jm, tm) = _static_models()
    tc = tm.color_net.init(torch.Generator().manual_seed(4), "cpu")
    gen = torch.Generator().manual_seed(5)
    for k in ("plane_0", "line_1"):
        tc["density"][k] = torch.randn(tc["density"][k].shape, generator=gen)
    tc["density"]["line_1"][:3] = 0.0
    tc["density"]["line_1"].requires_grad_(True)
    jc = jax.tree.map(jnp.asarray, params_to_jax(tc))
    for name in ("density_l1", "tv_loss_density", "tv_loss_app"):
        want = float(getattr(jm.color_net, name)(jc))
        got = getattr(tm.color_net, name)(tc).item()
        assert got == pytest.approx(want, rel=1e-6), name
    gj = jax.grad(jm.color_net.density_l1)(jc)["density"]["line_1"]
    gt, = torch.autograd.grad(tm.color_net.density_l1(tc),
                              tc["density"]["line_1"])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6)
    # the lines count in the L1 term and not in the TV terms
    assert ttensorf.TensorVMNoSample.GRIDS == ("plane", "line")
