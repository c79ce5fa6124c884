"""The training pieces without a model: the losses, the learning-rate
schedules, the grouped optimizer against optax step by step (across a
re-initialization, as at a grid event), psnr and ssim, and the dynamic
net's grid helpers (resize_bilinear_2d, _tv2d, density_l1,
upsample_schedule) against the JAX package's."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from hyperreel_tpu.models import tensorf as jtensorf
from hyperreel_tpu.ops.grid_sample import resize_bilinear_2d as jresize
from hyperreel_tpu.train import losses as jlosses
from hyperreel_tpu.train import metrics as jmetrics
from hyperreel_tpu.train.optim import build_optimizer as jbuild
from hyperreel_tpu.train.optim import make_lr_schedule as jschedule
from hyperreel_tpu.train.regularizers import schedule_weight as jweight
from hyperreel_tpu_torch.convert import params_to_jax
from hyperreel_tpu_torch.models import tensorf as ttensorf
from hyperreel_tpu_torch.ops.grid_sample import resize_bilinear_2d
from hyperreel_tpu_torch.train import losses as tlosses
from hyperreel_tpu_torch.train import metrics as tmetrics
from hyperreel_tpu_torch.train.optim import (
    GroupedOptimizer, apply_weight_init, make_lr_schedule, tree_leaves)
from hyperreel_tpu_torch.train.regularizers import schedule_weight

from torch_parity import flagship_cfg, models

LOSS_CFGS = [("mse", None), ("mae", None), ("huber", {"delta": 0.3}),
             ("weighted_mse", None), ("weighted_mae", None),
             ("mse_top_n", {"frac": 0.25}), ("mae_top_n", {"frac": 0.1}),
             ("complex_mse", None), ("complex_mae", None), ("tv", None)]


# each loss is the same f32 reduction in another order: 1e-6 relative
@pytest.mark.parametrize("name,extra", LOSS_CFGS, ids=[n for n, _ in
                                                       LOSS_CFGS])
def test_losses_match_jax(name, extra):
    rng = np.random.default_rng(0)
    cfg = dict(extra or {}, type=name)
    x = rng.normal(size=(64, 3)).astype(np.float32)
    y = rng.normal(size=(64, 3)).astype(np.float32)
    w = rng.uniform(0, 1, (64, 1)).astype(np.float32)
    if name.startswith("complex"):
        x = x + 1j * rng.normal(size=x.shape).astype(np.float32)
        y = y + 1j * rng.normal(size=y.shape).astype(np.float32)
        x, y = x.astype(np.complex64), y.astype(np.complex64)
    kw = {"weights": w} if name.startswith("weighted") else {}
    want = float(jlosses.get_loss(cfg)(
        jnp.asarray(x), jnp.asarray(y),
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = float(tlosses.get_loss(cfg)(
        torch.from_numpy(x), torch.from_numpy(y),
        **{k: torch.from_numpy(v) for k, v in kw.items()}))
    assert got == pytest.approx(want, rel=1e-6)


SCHEDULES = [
    {"lr": 0.02, "lr_scheduler": "exp", "decay_epoch": 100,
     "decay_gamma": 0.125},
    {"lr": 0.02, "lr_scheduler": "exp", "decay_epoch": 3, "decay_gamma": 0.5,
     "stop_epoch": 6},
    {"lr": 1.0, "lr_scheduler": "steplr", "decay_epoch": 3,
     "decay_gamma": 0.1},
    {"lr": 0.5, "lr_scheduler": "poly", "num_epochs": 9, "poly_exp": 2.0},
    {"lr": 0.5, "lr_scheduler": "cosine", "num_epochs": 9},
    {"lr": 0.1, "lr_scheduler": "exp", "decay_epoch": 4, "decay_gamma": 0.3,
     "warmup_epochs": 3, "warmup_multiplier": 10.0},
]


# both evaluate the schedule in f32 on the same operands: 1e-6 relative
@pytest.mark.parametrize("cfg", SCHEDULES,
                         ids=["exp", "exp_stop", "steplr", "poly", "cosine",
                              "warmup"])
def test_lr_schedules_match_jax(cfg):
    want, got = jschedule(cfg, 10), make_lr_schedule(cfg, 10)
    for it in list(range(0, 130, 7)) + [10, 29, 30, 31, 60, 61, 90, 1000]:
        assert got(it) == pytest.approx(float(want(jnp.asarray(it))),
                                        rel=1e-6, abs=1e-12), it


# the regularizers' wait/warmup/stop window, f32 on both sides
@pytest.mark.parametrize("cfg", [
    {"weight": 0.3},
    {"weight": 2.0, "wait_iters": 10, "warmup_iters": 25, "stop_iters": 90},
    {"weight": 0.5, "warmup_iters": 7}])
def test_schedule_weight_matches_jax(cfg):
    for it in [0, 3, 9, 10, 11, 20, 34, 35, 36, 89, 90, 200]:
        assert schedule_weight(cfg, it) == pytest.approx(
            float(jweight(cfg, jnp.asarray(it, jnp.int32))), rel=1e-6), it


GROUPS = {
    "adam": {"optimizer": "adam", "lr": 0.02, "lr_scheduler": "exp",
             "decay_epoch": 2, "decay_gamma": 0.5},
    "adam_clip_wd": {"optimizer": "adam", "lr": 0.01, "clip": True,
                     "clip_amount": 0.5, "weight_decay": 0.1,
                     "lr_scheduler": "steplr", "decay_epoch": 1,
                     "decay_gamma": 0.3},
    "sgd": {"optimizer": "sgd", "momentum": 0.9, "lr": 0.1,
            "lr_scheduler": "exp", "decay_epoch": 1, "decay_gamma": 0.5},
    "rmsprop": {"optimizer": "rmsprop", "alpha": 0.95, "lr": 0.003,
                "lr_scheduler": "cosine", "num_epochs": 3},
}


# Adam's update divides by sqrt(nu), so a gradient's f32 rounding moves
# the update relatively; the params after 9 updates are held to 1e-6 of
# their scale (the updates are ~1e-2)
@pytest.mark.parametrize("group", list(GROUPS))
def test_optimizer_matches_optax_across_a_reset(group):
    """Two labelled groups and a frozen label, 5 steps, a fresh state (a
    grid event: the counters and the schedule start again), 4 steps."""
    rng = np.random.default_rng(3)
    params = {"a": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                    "b": rng.normal(size=(3,)).astype(np.float32)},
              "c": rng.normal(size=(5,)).astype(np.float32),
              "d": rng.normal(size=(2,)).astype(np.float32)}
    labels = {"a": {"w": "one", "b": "one"}, "c": "two", "d": "frozen"}
    cfgs = {"one": GROUPS[group], "two": GROUPS["adam"]}
    jopt = jbuild(cfgs, labels, iters_per_epoch=3)
    topt = GroupedOptimizer(cfgs, labels, iters_per_epoch=3)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, copy.deepcopy(params))
    for phase in range(2):
        js, ts = jopt.init(jp), topt.init(tp)
        for _ in range(5 - phase):
            g = jax.tree.map(
                lambda v: rng.normal(size=v.shape).astype(np.float32),
                params)
            upd, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
            jp = optax.apply_updates(jp, upd)
            topt.step(tp, {p: torch.from_numpy(v)
                           for p, v in tree_leaves(g)}, ts)
    assert ts["count"] == {"one": 4, "two": 4}
    for path, v in tree_leaves(jax.tree.map(np.asarray, jp)):
        got = dict(tree_leaves(tp))[path].numpy()
        assert np.abs(got - v).max() <= 1e-6 * max(np.abs(v).max(), 1.0)
    np.testing.assert_array_equal(dict(tree_leaves(tp))[("d",)].numpy(),
                                  params["d"])


# psnr: one f32 log; ssim: a 11x11 f32 convolution in another order
def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert float(tmetrics.psnr(ta, tb)) == pytest.approx(
        float(jmetrics.psnr(ja, jb)), rel=1e-6)
    assert float(tmetrics.ssim(ta, tb)) == pytest.approx(
        float(jmetrics.ssim(ja, jb)), abs=1e-6)
    assert float(tmetrics.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-5)


# the same bilinear weights on lattices that XLA may fold one f32 ulp apart
# (jnp.linspace(-1, 1) and the unnormalisation under its simplifier): 1e-5
# of unit-scale texels
@pytest.mark.parametrize("shape,new", [((5, 7, 3), (9, 12)),
                                       ((1, 6, 2), (4, 11)),
                                       ((4, 20, 2), (4, 31)),
                                       ((6, 5, 1), (1, 3))])
def test_resize_bilinear_matches_jax(shape, new):
    g = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = np.asarray(jresize(jnp.asarray(g), *new))
    got = resize_bilinear_2d(torch.from_numpy(g), *new).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


def test_upsample_schedule_and_n_to_reso_match_jax():
    for args in [(2097152, 512000000, 5), (16 ** 3, 24 ** 3, 1),
                 (4096, 4096, 3), (1000, 10 ** 7, 7)]:
        assert ttensorf.upsample_schedule(*args) == \
            jtensorf.upsample_schedule(*args)
    for n, aabb in [(24 ** 3, [[-2, -2, -2], [2, 2, 2]]),
                    (6300000, [[-1.5, -2, -1], [2, 1.7, 0.9]])]:
        assert ttensorf.n_to_reso(n, aabb) == jtensorf.n_to_reso(n, aabb)


# the regularizer terms: the same f32 means in another order, 1e-6
# relative; the gradients of density_l1 match jnp.abs's at exact zeros
def test_tv_and_l1_terms_match_jax():
    jm, tm = models(flagship_cfg(tiny=True, fused=False,
                                 bf16_tables=False), bf16=False)
    tc = tm.color_net.init(torch.Generator().manual_seed(4), "cpu")
    tc["density"]["space_0"] = torch.randn(
        tc["density"]["space_0"].shape,
        generator=torch.Generator().manual_seed(5))
    tc["density"]["space_0"][:3] = 0.0
    tc["density"]["space_0"].requires_grad_(True)
    jc = jax.tree.map(jnp.asarray, params_to_jax(tc))
    for name in ("density_l1", "tv_loss_density", "tv_loss_app"):
        want = float(getattr(jm.color_net, name)(jc))
        got = getattr(tm.color_net, name)(tc).item()
        assert got == pytest.approx(want, rel=1e-6), name
    plane = np.array(jc["app"]["space_0"])
    assert float(ttensorf._tv2d(torch.from_numpy(plane))) == pytest.approx(
        float(jtensorf._tv2d(jnp.asarray(plane))), rel=1e-6)
    gj = jax.grad(jm.color_net.density_l1)(jc)["density"]["space_0"]
    gt, = torch.autograd.grad(tm.color_net.density_l1(tc),
                              tc["density"]["space_0"])
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6)


# the port draws from a torch.Generator where the JAX package folds keys,
# so the draws differ; held: which leaves change, their shapes and bounds
@pytest.mark.parametrize("kind", ["uniform", "xavier", "kaiming"])
def test_weight_init_redraws_dense_weights(kind):
    params = {"net": {"layer_0": {"weight": torch.zeros(64, 9),
                                  "bias": torch.zeros(64)}},
              "grid": torch.zeros(4, 4)}
    out = apply_weight_init(params, {"type": kind, "a": 0.2},
                            torch.Generator().manual_seed(0))
    w = out["net"]["layer_0"]["weight"]
    assert w.shape == (64, 9) and w.std() > 0
    assert torch.equal(out["net"]["layer_0"]["bias"], torch.zeros(64))
    assert torch.equal(out["grid"], torch.zeros(4, 4))
    bound = {"uniform": 0.2, "xavier": (6.0 / 73) ** 0.5}.get(kind)
    if bound:
        assert w.abs().max() <= bound
    else:
        assert abs(w.std().item() / (2.0 / 9) ** 0.5 - 1) < 0.15
    assert apply_weight_init(params, {"type": "none"}, None) is params
