"""The general chain's new modules against the JAX package: neural_3d's
tiny chain (tiny_neural_3d) with an angular flow (the predicted field
angular_flow: rotation rates and an anchor, ops/rotation.py), ray outputs
(per-ray fields after the per-sample ones), a learnable PE on the time
range (as both packages call it, without its params) and a PE inside the
prediction net, in eval and in one training step against the JAX
Trainer, the JAX params of that chain through convert.py; and the JAX
package's NaN gradient of an angular flow at a zero time offset.
Tolerances as tests/torch_train_parity.py: the f32 chain's fields 1e-5,
every gradient leaf within 1e-5 of its largest entry, the loss 1e-6
relative."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx

from torch_parity import models
from torch_train_parity import (
    BATCH, grad_errors, one_step, preset_cfg, scene, start)

torch.set_num_threads(1)

IT = 160


def chain_cfg():
    """tiny_neural_3d with an angular flow, two ray outputs, a learnable
    time PE and a basic PE in the prediction net."""
    cfg = preset_cfg("tiny_neural_3d")
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    pred["outputs"]["angular_flow"] = {"channels": 6,
                                       "activation": {"type": "tanh",
                                                      "outer_fac": 0.5}}
    pred["ray_outputs"] = {"ray_scale": {"channels": 3,
                                         "activation": "sigmoid"},
                           "ray_shift": {"channels": 1}}
    pred["params"]["time"]["pe"] = {"type": "learnable", "n_freqs": 2}
    pred["net"]["pe"] = {"type": "basic", "n_freqs": 1}
    emb["flow_0"].update(use_angular_flow=True,
                         angular_flow_rotation_activation={
                             "type": "identity", "fac": 2.0},
                         angular_flow_anchor_activation="tanh")
    return cfg


def _offset_rays(ds, n, seed):
    """n of the scene's rays whose time is not a keyframe's: there the
    time offset is 0 and the JAX package's angular-flow gradient is NaN
    (test_jax_angular_flow_gradient_is_nan_at_a_keyframe)."""
    from hyperreel_tpu_torch.models.embeddings import get_base_time
    rays = ds.all_coords
    t = torch.from_numpy(rays[:, -1])
    off = (t - get_base_time(t, 2, 4)).numpy() != 0
    idx = np.random.default_rng(seed).permutation(np.flatnonzero(off))[:n]
    return np.ascontiguousarray(rays[idx])


def test_angular_flow_and_ray_outputs_match_jax_in_eval():
    """The chain's fields and rgb in eval, on the JAX package's own init
    converted by convert.params_from_jax (the tree holds no learnable PE
    bank: no JAX stage draws one)."""
    ds = scene("tiny_neural_3d")
    cfg = chain_cfg()
    jm, tm = models(cfg, bf16=False, info=ds.info())
    assert jm._cf_eval is None and tm._cf_eval is None
    jp = jax.jit(jm.init)(jax.random.PRNGKey(3))
    assert "'B'" not in str(jax.tree_util.tree_structure(jp))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rays = _offset_rays(ds, 64, 0)
    fields = ["angular_flow_rot", "angular_flow_anchor", "ray_scale",
              "ray_shift", "points", "offset"]
    ctx = make_ctx(it=IT, training=False)
    want = jax.jit(lambda p, r: (jm.embedding.apply(
        p["embedding"], r, ctx, {"fields": fields}), jm.apply(p, r, ctx)[
        "rgb"]))(jp, jnp.asarray(rays))
    got = tm.embedding.apply(tp["embedding"], torch.from_numpy(rays),
                             StepCtx(it=IT), {"fields": fields})
    for k in fields:
        assert np.abs(got[k].numpy() - np.asarray(want[0][k])).max() \
            <= 1e-5, k
    assert got["ray_scale"].shape == (64, 3)
    assert got["angular_flow_rot"].abs().max() > 0
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT))["rgb"]
    assert np.abs(b.numpy() - np.asarray(want[1])).max() <= 1e-5


def test_angular_flow_and_ray_outputs_one_step_matches_jax():
    ds = scene("tiny_neural_3d")
    jt, js, tt, ts = start(chain_cfg(), ds)
    rng = np.random.default_rng(1)
    rows = _offset_rays(ds, BATCH, 1)
    batch = next(ds.batch_iterator(BATCH, seed=3))
    batch = dict(batch, rays=rows, rgb=rng.uniform(
        0, 1, (BATCH, 3)).astype(np.float32))
    jmet, jg, tmet, tg = one_step(jt, js, tt, ts, batch, IT)
    for k in ("loss", "image_loss", "psnr"):
        assert float(tmet[k]) == pytest.approx(float(jmet[k]), rel=1e-6), k
    errs = grad_errors(jg, tg)
    assert ("embedding", "ray_prediction_0", "net", "layer_0",
            "weight") in errs
    for path, (err, scale) in errs.items():
        assert scale > 0 and err <= 1e-5 * scale, (path, err, scale)


def test_jax_angular_flow_gradient_is_nan_at_a_keyframe():
    """At a keyframe's time the time offset is 0, the rotation's angle
    rate * 0 = 0, and jnp.linalg.norm's gradient at 0 is NaN: the JAX
    package's step is NaN there; the port's (torch's norm passes 0 at 0)
    is finite (ROADMAP.md 3)."""
    from hyperreel_tpu.ops.rotation import axis_angle_to_matrix as jrot
    from hyperreel_tpu_torch.ops.rotation import axis_angle_to_matrix
    g = jax.jit(jax.grad(lambda v: jrot(v * 0.0).sum()))(jnp.ones(3))
    assert np.isnan(np.asarray(g)).all()
    v = torch.ones(3, requires_grad=True)
    axis_angle_to_matrix(v * 0.0).sum().backward()
    assert torch.isfinite(v.grad).all()
