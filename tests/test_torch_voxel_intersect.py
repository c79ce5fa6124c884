"""The voxel-grid intersect (hyperreel_tpu_torch/models/intersect.py
IntersectVoxelGrid: z/3 planes per axis, the [near, far] mask, the sort)
against the JAX package's IntersectVoxelGrid on the same rays and
predicted z values, made with numpy from a seed: blender_voxel's stage
([2, 6] near/far, use_sigma), with the anchors from a dataset bbox
(use_dataset_bounds, `fac`), outward facing, and max_axis. The points,
distances and processed z values within 1e-5 of the scene's scale (the
same f32 divisions; a distance that lands within an ulp of the near or far
bound may flip its mask, and then its sorted row, so the rays are kept
off the bounds by the draw)."""

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
    IntersectVoxelGrid, build_intersect)

B, Z = 64, 12
BBOX = (np.array([-1.2, -0.8, -1.5], np.float32),
        np.array([1.0, 1.3, 0.9], np.float32))


def _cfg(variant):
    cfg = copy.deepcopy(JP.blender_voxel(z_channels=Z)["embedding"][
        "embeddings"]["ray_intersect_0"]["intersect"])
    if variant == "bbox":
        for k in ("initial", "end", "near", "far"):
            cfg.pop(k)
        cfg.update(use_dataset_bounds=True, fac=1.5, _dataset_bbox=BBOX,
                   _dataset_bounds=(0.5, 8.0))
    elif variant == "outward":
        cfg["outward_facing"] = True
    elif variant == "max_axis":
        cfg["max_axis"] = True
    return cfg


def _inputs(seed):
    rng = np.random.default_rng(seed)
    o = np.array([0.3, -0.2, 4.0]) + rng.uniform(-0.5, 0.5, (B, 3))
    d = rng.normal(size=(B, 3)) * 0.4
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d], 1).astype(np.float32)
    z = rng.uniform(-1, 1, (B, Z, 1)).astype(np.float32)
    sigma = rng.uniform(0, 0.9, (B, Z, 1)).astype(np.float32)
    return rays, z, sigma


@pytest.mark.parametrize("variant", ["blender", "bbox", "outward",
                                     "max_axis"])
def test_voxel_grid_matches_jax(variant):
    cfg = _cfg(variant)
    j = jax_build(Z, dict(cfg))
    t = build_intersect(Z, dict(cfg))
    assert isinstance(t, IntersectVoxelGrid)
    np.testing.assert_array_equal(t.samples, j.samples)
    np.testing.assert_array_equal(t.z_scale, j.z_scale)
    assert t.near == j.near and t.far == j.far
    rays, z, sigma = _inputs(len(variant))
    a = j.apply({}, jnp.asarray(rays), {"z_vals": jnp.asarray(z),
                                        "sigma": jnp.asarray(sigma)},
                make_ctx(it=0, training=False))
    b = t.apply(torch.from_numpy(rays), {"z_vals": torch.from_numpy(z),
                                         "sigma": torch.from_numpy(sigma)},
                StepCtx())
    for k in ("points", "distances", "z_vals", "weights"):
        want, got = np.asarray(a[k]), b[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=k)
    valid = (b["distances"] > 0).float().mean().item()
    assert 0.05 < valid < 1.0, valid


def test_voxel_grid_needs_three_axes():
    with pytest.raises(ValueError, match="multiple of 3"):
        build_intersect(8, _cfg("blender"))
