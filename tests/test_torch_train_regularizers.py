"""The regularizers beyond tensorf, the render fields they read, and the
bench policy's training step, against the JAX package's
(tests/torch_train_parity.py: the same weights, the JAX step's draws
injected):

  * render_weight, geometry and voxel_sparsity: each one's value and the
    gradient of every param leaf (the static net, and voxel_sparsity on
    the dynamic net at the normalized time 0), and one training step of
    tiny_static with all four regularizers;
  * the render fields of the general path (render_weights, a field not
    composited, one composited under the predicted weights, the others
    under the render weights) on the static and the dynamic net;
  * one training step of tiny_static under the bench's bf16 policy (bf16
    MLP and tables; tiny_neural_3d's: tests/test_torch_train_stages.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models.ctx import StepCtx as JaxCtx
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.train.optim import tree_leaves
from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
from hyperreel_tpu_torch.train.trainer import Trainer, _requiring_grad

from torch_train_parity import (
    BATCH, compiled, draws_of, grad_errors, one_step, preset_cfg, scene,
    start)

N_POINTS = 512
REGS = {
    "render_weight": {"type": "render_weight", "weight": 0.5,
                      "wait_iters": 10, "warmup_iters": 300},
    "geometry": {"type": "geometry", "weight": 0.3},
    "voxel_sparsity": {"type": "voxel_sparsity", "weight": 0.2,
                       "num_points": N_POINTS},
}


def _batch(ds, seed=3):
    """A batch with ground-truth depth (a third of it 0: no supervision)
    and points, as a depth dataset gives them."""
    b = next(ds.batch_iterator(BATCH, seed=seed))
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 3.0, (BATCH, 1)).astype(np.float32)
    depth[: BATCH // 3] = 0.0
    b["depth"] = depth
    b["points"] = rng.normal(0, 0.5, (BATCH, 3)).astype(np.float32)
    return b


# One regularizer alone: its value 1e-6 relative and each gradient leaf
# within 1e-5 of its largest entry (the same f32 ops summed in another
# order); the leaves it does not reach are 0 in both. At it = 160 the
# render weight's warmup gives 0.5 * 150 / 300. The density grids have no
# exact zeros: at a zero feature the relu's gradient 0.5 times the last
# sample's 1e10 delta makes gradients of ~1e6 that no f32 sum order holds
# to 1e-5.
@pytest.mark.parametrize("name,preset", [
    ("render_weight", "tiny_static"), ("geometry", "tiny_static"),
    ("voxel_sparsity", "tiny_static"), ("voxel_sparsity", "tiny_neural_3d")])
def test_regularizer_value_and_gradients_match_jax(name, preset):
    cfg = preset_cfg(preset)
    ds = scene(preset)
    jt, js, tt, ts = start(cfg, ds, regs={name: REGS[name]}, blank=False)
    (_, jreg), = jt.regularizers
    (_, treg), = tt.regularizers
    assert type(treg).__name__ == type(jreg).__name__
    batch = _batch(ds)
    key = jax.random.PRNGKey(7)
    ctx = JaxCtx(it=jnp.asarray(160, jnp.int32), rng=key, training=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want, jg = compiled(jax.value_and_grad(
        lambda p: jreg.loss(jt.model, p, jb, ctx)), js.params)
    params = _requiring_grad(ts.params)
    got = treg.loss(tt.model, params, tt.to_device(batch), StepCtx(
        it=160, training=True, draws=draws_of(key, N_POINTS)))
    assert float(want) != 0.0
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    tg = Trainer.backward(got, tree_leaves(params))
    jg = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    reached = 0
    for path, (err, scale) in grad_errors(jg, tg).items():
        assert err <= 1e-5 * scale, (path, err, scale)
        reached += scale > 0
    assert reached > 0


# The whole step with tensorf, render_weight, geometry and voxel_sparsity
# on a depth batch: the loss 1e-6 relative, every gradient leaf within
# 2e-5 of its largest entry. At it = 400 the appearance plane 0's gradient
# is small (largest entry 6.9e-5) and sums cancelling terms: against the
# same step in float64 (the port's step run in float64) JAX's f32 gradient
# is off by 1.25e-5 of that entry and the port's by 0.94e-5 (measured),
# so the two f32 results are 1.12e-5 apart.
def test_step_with_every_regularizer_matches_jax():
    cfg = preset_cfg("tiny_static")
    ds = scene("tiny_static")
    regs = dict(tv_4000_defaults(), **REGS)
    jt, js, tt, ts = start(cfg, ds, regs=regs, blank=False)
    assert [n for n, _ in tt.regularizers] == list(regs)
    jm, jg, tm, tg = one_step(jt, js, tt, ts, _batch(ds, seed=5), 400,
                              seed=9, n_points=N_POINTS)
    for k in ("loss", "image_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    for path, (err, scale) in grad_errors(jg, tg).items():
        assert scale > 0, path
        assert err <= 2e-5 * scale, (path, err, scale)


FIELDS = {"fields": ["render_weights", "weights", "points", "distances",
                     "viewdirs"],
          "no_over_fields": ["weights"],
          "pred_weights_fields": ["points"]}


# The render fields at eval: every output within 1e-5 of JAX's (the same
# f32 chain and composite); the fields keep both packages off their fused
# routes (the general colour net runs).
@pytest.mark.parametrize("preset", ["tiny_static", "tiny_neural_3d"])
def test_render_fields_match_jax(preset):
    cfg = preset_cfg(preset)
    ds = scene(preset)
    jt, js, tt, ts = start(cfg, ds)
    rays = np.ascontiguousarray(ds.all_coords[::3][:BATCH])
    ctx = make_ctx(it=400, training=False)
    want = jax.jit(lambda p, r: jt.model.apply(p, r, ctx, FIELDS))(
        js.params, jnp.asarray(rays))
    got = tt.model.apply(ts.params, torch.from_numpy(rays), StepCtx(it=400),
                         FIELDS)
    assert sorted(got) == sorted(want) == sorted(FIELDS["fields"] + ["rgb"])
    S = cfg["embedding"]["embeddings"]["ray_prediction_0"]["z_channels"]
    assert tuple(got["render_weights"].shape) == (rays.shape[0], S)
    assert tuple(got["weights"].shape) == (rays.shape[0], S)
    assert tuple(got["points"].shape) == (rays.shape[0], 3)
    for k, v in want.items():
        v = np.asarray(v)
        assert tuple(got[k].shape) == v.shape, k
        assert np.abs(got[k].numpy() - v).max() <= 1e-5, k
    assert got["render_weights"].sum(-1).max() > 0.1


# Under the bench's bf16 policy (bf16 MLP and tables) an f32 sum in another
# order can land on the other side of a bf16 rounding and move what it
# feeds by a bf16 ulp: the loss 1e-4 relative, each gradient leaf 2e-2 of
# its largest entry (tests/test_torch_train_step.py)
@pytest.mark.parametrize("preset", ["tiny_static"])
def test_one_step_under_the_bf16_policy_matches_jax(preset):
    cfg = preset_cfg(preset, bf16_tables=True)
    ds = scene(preset)
    jt, js, tt, ts = start(cfg, ds, bf16=True)
    batch = next(ds.batch_iterator(BATCH, seed=3))
    jm, jg, tm, tg = one_step(jt, js, tt, ts, batch, 160)
    for k in ("loss", "image_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    for path, (err, scale) in grad_errors(jg, tg).items():
        assert scale > 0, path
        assert err <= 2e-2 * scale, (path, err, scale)
