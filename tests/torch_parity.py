"""Shared set-up of the JAX-vs-PyTorch parity tests (tests/test_torch_*.py):
the same configs, weights and rays for hyperreel_tpu and
hyperreel_tpu_torch, made with numpy from fixed seeds."""

import copy

import numpy as np

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import (
    convert_epochs_to_iters, technicolor_z_plane, tiny_dynamic)
from hyperreel_tpu.models.model import build_model as build_jax
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.model import build_model as build_torch

# the flagship's dataset as __graft_entry__.entry() builds it
INFO = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
ITERS_PER_EPOCH = 4000


def flagship_cfg(tiny=False, fused=True, bf16_tables=True):
    """technicolor_z_plane at full width, or tiny_dynamic; `fused=False`
    selects the general stage chain in both packages (fused_render and
    fused_render_cf off, as tests/test_fused_cf.py builds it). The fused
    path requires bf16 tables."""
    cfg = convert_epochs_to_iters(
        tiny_dynamic() if tiny else technicolor_z_plane(), ITERS_PER_EPOCH)
    net = cfg["color"]["net"]
    net["fused_render"] = fused
    net["bf16_tables"] = bf16_tables
    if not fused:
        net["fused_render_cf"] = False
    return cfg


def models(cfg, bf16):
    """(JAX model, port model) for one config and precision policy."""
    return (build_jax(copy.deepcopy(cfg), dataset_info=INFO,
                      compute_dtype=jnp.bfloat16 if bf16 else None),
            build_torch(copy.deepcopy(cfg), dataset_info=INFO,
                        compute_dtype=torch.bfloat16 if bf16 else None))


def weights(jax_model, seed=0):
    """JAX init weights with the density grids redrawn uniform in [0, 1)
    (the relu init is a constant 1e-2, an almost transparent scene that
    would leave the compositing untested). Returns (jax params, port
    params)."""
    pn = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    for k, v in pn["color"]["density"].items():
        pn["color"]["density"][k] = rng.uniform(0, 1, v.shape).astype(
            np.float32)
    return jax.tree.map(jnp.asarray, pn), params_from_jax(pn)


def entry_rays(n, seed=0, t=None):
    """__graft_entry__.entry()'s ray recipe: origins around z=-1.5,
    directions with d_z = 1, a camera index and a time in [0, 1) (or the
    one time `t` for every ray)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    o[:, 2] -= 1.5
    d = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d[:, 2] = 1.0
    cam = rng.integers(0, 16, (n, 1)).astype(np.float32)
    times = rng.uniform(0, 1, (n, 1)).astype(np.float32) if t is None \
        else np.full((n, 1), t, np.float32)
    return np.concatenate([o, d, cam, times], -1)
