"""The reflect stage (hyperreel_tpu_torch/models/embeddings_extra.py
ReflectEmbedding) against the JAX package's on the same inputs made with
numpy from a seed: refnerf_sphere_reflect's configuration
(direction_init, the points marched into "points_temp", viewdirs
overwritten by the reflection), forward_facing, and a predicted direction
offset with the stage's default fields; every output within 1e-6."""

import copy

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.embeddings_extra import (
    ReflectEmbedding as JaxReflect)
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.embeddings_extra import ReflectEmbedding

B, S = 16, 8


def _cfg(variant):
    if variant == "refnerf":
        return copy.deepcopy(JP.refnerf_sphere_reflect()["embedding"][
            "embeddings"]["reflect_0"])
    if variant == "forward_facing":
        return {"type": "reflect", "forward_facing": True}
    return {"type": "reflect"}


@pytest.mark.parametrize("variant", ["refnerf", "forward_facing",
                                     "offset"])
def test_reflect_matches_jax(variant):
    cfg = _cfg(variant)
    rng = np.random.default_rng(len(variant))
    x = {"rays": rng.normal(size=(B, 6)).astype(np.float32),
         "points": rng.normal(size=(B, S, 3)).astype(np.float32),
         "normal": rng.normal(size=(B, S, 3)).astype(np.float32),
         "ref_distance": rng.normal(size=(B, S, 1)).astype(np.float32)}
    if variant == "offset":
        x["viewdirs"] = rng.normal(size=(B, S, 3)).astype(np.float32)
        x["ref_viewdirs_offset"] = rng.normal(
            size=(B, S, 3)).astype(np.float32)
    a = JaxReflect(cfg=dict(cfg)).apply(
        {}, {k: jnp.asarray(v) for k, v in x.items()},
        make_ctx(it=0, training=False))
    b = ReflectEmbedding(dict(cfg)).apply(
        {}, {k: torch.from_numpy(v) for k, v in x.items()}, StepCtx())
    assert set(b) == set(a)
    for k in a:
        want, got = np.asarray(a[k]), b[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=k)
    out_dir = cfg.get("out_direction_field", "ref_viewdirs")
    np.testing.assert_allclose(np.linalg.norm(b[out_dir].numpy(), axis=-1),
                               np.linalg.norm(x.get("viewdirs", np.repeat(
                                   x["rays"][:, None, 3:6], S, 1)), axis=-1)
                               if variant != "offset" else 1.0, rtol=1e-5)
