"""K7 composite: the port's plain version (the CPU side of
hyperreel_tpu_torch/ops/kernels/composite.py) against the JAX Pallas
kernel `_composite_kernel` in interpret mode (composite_pallas's call) and
against `composite_reference`, on inputs made with numpy from a seed."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
import torch

from hyperreel_tpu.ops.pallas import composite as JC
from hyperreel_tpu_torch.ops.kernels.composite import composite

TILE = 256


def _jax_kernel(sigma, dist, rgb, scale):
    """composite_pallas (hyperreel_tpu/ops/pallas/composite.py:57) with
    interpret=True: the TPU kernel's math on the CPU."""
    B, S = sigma.shape
    kern = functools.partial(JC._composite_kernel, scale=float(scale), S=S)
    out = pl.pallas_call(
        kern, grid=(B // TILE,),
        in_specs=[pl.BlockSpec((TILE, S), lambda i: (i, 0))] * 5,
        out_specs=pl.BlockSpec((TILE, 4), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((B, 4), jnp.float32),
        interpret=True,
    )(sigma, dist, rgb[..., 0], rgb[..., 1], rgb[..., 2])
    return np.asarray(out[:, :3]), np.asarray(out[:, 3])


def _inputs(B, S, seed):
    rng = np.random.default_rng(seed)
    sigma = 0.05 * np.abs(rng.standard_normal((B, S))).astype(np.float32)
    sigma[rng.uniform(0, 1, (B, S)) < 0.1] *= 50.0     # a few opaque steps
    # the last delta is 1e10: half the rays end empty, so not every ray
    # saturates
    sigma[rng.uniform(0, 1, B) < 0.5, -1] = 0.0
    dist = np.sort(rng.uniform(0.1, 3.0, (B, S)), -1).astype(np.float32)
    rgb = rng.uniform(0, 1, (B, S, 3)).astype(np.float32)
    return sigma, dist, rgb


# 1e-5: f32 sums of the same terms in another order (the JAX kernel's
# log-step shift-add scan against torch's cumsum)
@pytest.mark.parametrize("S", [8, 32])
def test_plain_composite_matches_jax(S):
    sigma, dist, rgb = _inputs(512, S, seed=S)
    scale = 16.0
    got_rgb, got_acc = composite(torch.from_numpy(sigma),
                                 torch.from_numpy(dist),
                                 torch.from_numpy(rgb), scale)
    assert got_rgb.shape == (512, 3) and got_acc.shape == (512,)
    want_rgb, want_acc = _jax_kernel(jnp.asarray(sigma), jnp.asarray(dist),
                                     jnp.asarray(rgb), scale)
    ref_rgb, ref_acc = JC.composite_reference(
        jnp.asarray(sigma), jnp.asarray(dist), jnp.asarray(rgb), scale)
    for w_rgb, w_acc in ((want_rgb, want_acc),
                         (np.asarray(ref_rgb), np.asarray(ref_acc))):
        assert np.abs(got_rgb.numpy() - w_rgb).max() <= 1e-5
        assert np.abs(got_acc.numpy() - w_acc).max() <= 1e-5
    assert want_acc.max() > 0.9 and want_acc.min() < 0.9


def test_opaque_and_empty_rays():
    """An opaque first sample takes the whole weight; an empty ray none."""
    S = 16
    sigma = np.zeros((TILE, S), np.float32)
    sigma[0, 0] = 1e8
    dist = np.broadcast_to(np.linspace(0.1, 2.0, S, dtype=np.float32),
                           (TILE, S)).copy()
    rgb = np.full((TILE, S, 3), 0.5, np.float32)
    got_rgb, got_acc = composite(torch.from_numpy(sigma),
                                 torch.from_numpy(dist),
                                 torch.from_numpy(rgb), 16.0)
    want_rgb, want_acc = _jax_kernel(jnp.asarray(sigma), jnp.asarray(dist),
                                     jnp.asarray(rgb), 16.0)
    np.testing.assert_allclose(got_acc.numpy(), want_acc, atol=1e-6)
    np.testing.assert_allclose(got_rgb.numpy(), want_rgb, atol=1e-6)
    assert abs(float(got_acc[0]) - 1.0) <= 1e-6
    assert float(got_acc[1:].abs().max()) == 0.0


def test_composite_checks_its_inputs():
    sigma, dist, rgb = (torch.from_numpy(a) for a in _inputs(64, 8, seed=0))
    with pytest.raises(ValueError):
        composite(sigma, dist[:, :-1].contiguous(), rgb, 16.0)
    with pytest.raises(ValueError):
        composite(sigma, dist, rgb.double(), 16.0)
    with pytest.raises(ValueError):
        composite(sigma, dist.t().contiguous().t(), rgb, 16.0)
