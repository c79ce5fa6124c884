"""tiny_dynamic and tiny_static with data_dim_color 3, 12, 48 and 75 (SH of
degree 0, 1, 3 and 4) under fused_render, against the JAX model.apply on
the CPU. The JAX model runs the general chain and then its colour net's
own fused route, the Pallas shade kernel at that degree in interpret mode
(with f32 accumulation, the f32_acc fixture); the port runs the same route
(K2 / K5 plain) and its channels-first quad route (K1 + K2 / K5 plain).
Both are held to the JAX output at the fused-path gate, 2e-4 (f32 MLP)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.models.ctx import StepCtx

from torch_parity import (
    entry_rays, f32_acc, flagship_cfg, models, port_weights, static_cfg)

APP_DIMS = {0: 3, 1: 12, 3: 48, 4: 75}
IT = 20000

torch.set_num_threads(1)


def _cfg(family, deg, cf):
    cfg = flagship_cfg(tiny=True) if family == "dynamic" \
        else static_cfg(S=8)
    net = cfg["color"]["net"]
    net.update(data_dim_color=APP_DIMS[deg], fused_render=True,
               bf16_tables=True)
    if not cf:
        net["fused_render_cf"] = False
    return cfg


@functools.lru_cache(maxsize=None)
def _port_models(family, deg):
    return {cf: models(_cfg(family, deg, cf), bf16=False)
            for cf in (False, True)}


@pytest.mark.parametrize("deg", sorted(APP_DIMS))
@pytest.mark.parametrize("family", ["dynamic", "static"])
def test_routes_at_degree_match_jax(family, deg, f32_acc):
    ms = _port_models(family, deg)
    jm, tm = ms[False]
    assert tm.color_net.sh_deg == deg and tm._cf_eval is None
    assert ms[True][1]._cf_eval is not None
    jp, tp = port_weights(tm, seed=deg,
                          density=0.3 if family == "static" else 1.0)
    rays = entry_rays(64, seed=deg, t=0.3)
    if family == "static":
        rays = np.ascontiguousarray(rays[:, :6])
    want = np.asarray(jax.jit(lambda p, r: jm.apply(
        p, r, make_ctx(IT, training=False)))(jp, jnp.asarray(rays))["rgb"])
    assert want.std() > 1e-3
    for cf in (False, True):
        got = ms[cf][1].apply(tp, torch.from_numpy(rays), StepCtx(it=IT))
        assert np.abs(got["rgb"].numpy() - want).max() <= 2e-4
