"""The per-sample stages of the cascaded and voxel chains
(hyperreel_tpu_torch/models/embeddings.py PointPredictionEmbedding and
PointDensityEmbedding) against the JAX package's, on the same weights
and inputs made with numpy from a seed:

  * point_prediction as technicolor_cascaded configures it (points,
    viewdirs and times concatenated, `time: 3:4` reading viewdirs.x, the
    basic PE, 4 coarse samples expanded to 8 or 32, the ease activations
    at several iterations), and with a residual output: every output
    field within 1e-5 (f32 MLP, another order of the sums);
  * point_density with and without its warm-in window, at iterations
    inside and outside it: within 1e-6.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.embeddings import (
    PointDensityEmbedding as JaxDensity,
    PointPredictionEmbedding as JaxPrediction)
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.embeddings import (
    PointDensityEmbedding, PointPredictionEmbedding)

B, S_IN = 16, 4


def _prediction_cfg(out_z, residual=False, tiny=True):
    cfg = JP.convert_epochs_to_iters(
        JP.technicolor_cascaded(coarse_z=S_IN, z_channels=out_z), 50)
    stage = copy.deepcopy(cfg["embedding"]["embeddings"][
        "point_prediction_0"])
    if tiny:
        stage["net"].update(depth=4, hidden_channels=32, skips=[2])
    if residual:
        stage["outputs"]["sigma"]["residual"] = True
    return stage


def _state(rng, width=8):
    rays = rng.normal(size=(B, width)).astype(np.float32)
    rays[:, 7 if width == 8 else -1] = rng.uniform(0, 1, B)
    return {"rays": rays,
            "points": rng.uniform(-1, 1, (B, S_IN, 3)).astype(np.float32),
            "sigma": rng.uniform(0, 1, (B, S_IN * 2, 1)).astype(np.float32)}


@pytest.mark.parametrize("out_z,residual,it", [
    (8, False, 0), (8, False, 120), (32, False, 400), (8, True, 60)])
def test_point_prediction_matches_jax(out_z, residual, it):
    cfg = _prediction_cfg(out_z, residual)
    j = JaxPrediction(cfg=copy.deepcopy(cfg))
    t = PointPredictionEmbedding(copy.deepcopy(cfg))
    assert t.expand_factor == out_z // S_IN == j.expand_factor
    assert t.in_channels == j.in_channels == 3 * 5 + 1 * 9
    assert t.group == j.group == "embedding"
    jp = j.init(jax.random.PRNGKey(3))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    x = _state(np.random.default_rng(out_z + it))
    if residual:
        x["sigma"] = x["sigma"][:, :1].repeat(out_z, 1)
    a = j.apply(jp, {k: jnp.asarray(v) for k, v in x.items()},
                make_ctx(it=it, training=False))
    b = t.apply(tp, {k: torch.from_numpy(v) for k, v in x.items()},
                StepCtx(it=it))
    for name in cfg["outputs"]:
        want, got = np.asarray(a[name]), b[name].detach().numpy()
        assert got.shape == want.shape == (B, out_z, cfg["outputs"][name][
            "channels"]), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)
    # the ranges index the concatenated inputs: `time: 3:4` is viewdirs.x
    assert [(s, e) for s, e, _, _ in t.in_fields] == [(0, 3), (3, 4)]


@pytest.mark.parametrize("window,it", [
    ({}, 0), ({"window_start_iters": 10, "window_iters": 20}, 5),
    ({"window_start_iters": 10, "window_iters": 20}, 17),
    ({"window_start_iters": 10, "window_iters": 20}, 40),
    ({"window_start_iters": 10}, 9), ({"window_start_iters": 10}, 10)])
def test_point_density_matches_jax(window, it):
    cfg = dict(JP.blender_voxel()["embedding"]["embeddings"][
        "point_density_0"], **window)
    x = np.random.default_rng(it).normal(size=(B, 12, 2)).astype(
        np.float32)
    a = JaxDensity(cfg=dict(cfg)).apply(
        {}, {"sigma": jnp.asarray(x)}, make_ctx(it=it, training=False))
    b = PointDensityEmbedding(dict(cfg)).apply(
        {}, {"sigma": torch.from_numpy(x)}, StepCtx(it=it))
    want, got = np.asarray(a["sigma"]), b["sigma"].numpy()
    assert got.shape == want.shape == (B, 12, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
