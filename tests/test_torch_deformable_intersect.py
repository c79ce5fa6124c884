"""The deformable voxel-grid intersect (hyperreel_tpu_torch/models/
intersect.py IntersectDeformableVoxelGrid: four z values per sample, the
plane's normal start_normal + scale * offset normalised, its distance
against the anchors) against the JAX package's, on the same rays and
predicted z values made with numpy from a seed: shiny_z_deformable's stage
(one axis, start normal +z, raw points and distances kept) and the
three-axis default. The points, distances and processed z values within
1e-5; the radius stages still refuse a z width other than S."""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.intersect import build_intersect as jax_build
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.intersect import (
    IntersectDeformableVoxelGrid, build_intersect)

B = 64


def _cfg(variant):
    cfg = copy.deepcopy(JP.shiny_z_deformable(z_channels=8)["embedding"][
        "embeddings"]["ray_intersect_0"]["intersect"])
    if variant == "three_axes":
        for k in ("start_normal", "initial", "end", "normal_scale_factor",
                  "out_points", "out_distance"):
            cfg.pop(k)
    return cfg


@pytest.mark.parametrize("variant,S", [("shiny", 8), ("shiny", 64),
                                       ("three_axes", 12)])
def test_deformable_matches_jax(variant, S):
    cfg = _cfg(variant)
    j = jax_build(S, dict(cfg))
    t = build_intersect(S, dict(cfg))
    assert isinstance(t, IntersectDeformableVoxelGrid)
    np.testing.assert_array_equal(t.samples, j.samples)
    np.testing.assert_array_equal(t.z_scale, j.z_scale)
    rng = np.random.default_rng(S)
    o = rng.uniform(-0.3, 0.3, (B, 3))
    d = rng.normal(size=(B, 3)) * 0.3
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d], 1).astype(np.float32)
    z = rng.uniform(-1, 1, (B, S, 4)).astype(np.float32)
    a = j.apply({}, jnp.asarray(rays), {"z_vals": jnp.asarray(z)},
                make_ctx(it=0, training=False))
    b = t.apply(torch.from_numpy(rays), {"z_vals": torch.from_numpy(z)},
                StepCtx())
    keys = ["points", "distances", "z_vals"]
    if variant == "shiny":
        keys += ["raw_points", "raw_distance"]
    for k in keys:
        want, got = np.asarray(a[k]), b[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
    assert b["distances"].shape == (B, S, 1)
    assert (b["distances"] > 0).float().mean().item() > 0.2


def test_radius_stages_still_refuse_blocked_layouts():
    cfg = copy.deepcopy(JP.donerf_sphere(z_channels=8)["embedding"][
        "embeddings"]["ray_intersect_0"]["intersect"])
    cfg.pop("contract")
    t = build_intersect(8, cfg)
    rays = torch.zeros(2, 6)
    rays[:, 5] = 1.0
    with pytest.raises(NotImplementedError, match="blocked layout"):
        t.apply(rays, {"z_vals": torch.zeros(2, 8, 4)}, StepCtx())
