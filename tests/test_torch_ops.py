"""The port's small ops against their JAX originals, on the same numpy
inputs: SH bases, compositing math, the plane lookup, the windowed PE,
the activations and the two-plane parameterization. All f32; the
tolerances allow for f32 evaluation-order differences only."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.models import activations as JA
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.pe import get_pe as jax_pe
from hyperreel_tpu.models.ray_param import get_ray_param as jax_rp
from hyperreel_tpu.ops import grid_sample as JG
from hyperreel_tpu.ops import render_math as JR
from hyperreel_tpu.ops import sh as JS
from hyperreel_tpu_torch.models import activations as TA
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.pe import get_pe as torch_pe
from hyperreel_tpu_torch.models.ray_param import get_ray_param as torch_rp
from hyperreel_tpu_torch.ops import grid_sample as TG
from hyperreel_tpu_torch.ops import render_math as TR
from hyperreel_tpu_torch.ops import sh as TS

RNG = np.random.default_rng(0)


def _close(a, b, tol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol, err


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_bases(deg):
    d = RNG.normal(size=(500, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    _close(TS.eval_sh_bases(deg, torch.from_numpy(d)),
           JS.eval_sh_bases(deg, jnp.asarray(d)))
    feats = RNG.normal(size=(500, 3 * (deg + 1) ** 2)).astype(np.float32)
    _close(TS.sh_render(torch.from_numpy(d), torch.from_numpy(feats), deg),
           JS.sh_render(jnp.asarray(d), jnp.asarray(feats), deg))


def test_raw2alpha_and_alpha2weights():
    sigma = RNG.uniform(0, 20, (64, 32)).astype(np.float32)
    dist = RNG.uniform(0, 0.2, (64, 32)).astype(np.float32)
    dist[:, -1] = 1e10
    for t, j in zip(TR.raw2alpha(torch.from_numpy(sigma),
                                 torch.from_numpy(dist)),
                    JR.raw2alpha(jnp.asarray(sigma), jnp.asarray(dist))):
        _close(t, j)
    alpha = RNG.uniform(0, 1, (64, 32)).astype(np.float32)
    _close(TR.alpha2weights(torch.from_numpy(alpha)),
           JR.alpha2weights(jnp.asarray(alpha)))


@pytest.mark.parametrize("bf16", [False, True])
def test_grid_sample_2d(bf16):
    grid = RNG.normal(size=(7, 9, 6)).astype(np.float32)
    coords = RNG.uniform(-1.2, 1.2, (400, 2)).astype(np.float32)
    coords[:8] = [[-1, -1], [1, 1], [-1, 1], [1, -1], [0, 0],
                  [1.0001, 0], [-1.0001, 0.5], [0.5, -1.0001]]
    tdt, jdt = (torch.bfloat16, jnp.bfloat16) if bf16 \
        else (torch.float32, jnp.float32)
    got = TG.grid_sample_2d(torch.from_numpy(grid).to(tdt),
                            torch.from_numpy(coords))
    want = JG.grid_sample_2d_cf(jnp.asarray(grid).astype(jdt),
                                jnp.asarray(coords)).T
    _close(got, want)
    # the torch op it mirrors
    ref = torch.nn.functional.grid_sample(
        torch.from_numpy(grid).to(tdt).float().permute(2, 0, 1)[None],
        torch.from_numpy(coords)[None, None], align_corners=True,
        padding_mode="zeros")[0, :, 0].t()
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("it", [0, 250, 1000, 1600, 5000])
def test_windowed_pe(it):
    cfg = {"type": "windowed", "n_freqs": 3, "wait_iters": 200,
           "max_freq_iter": 1500}
    x = RNG.uniform(-1, 1, (50, 4)).astype(np.float32)
    _close(torch_pe(4, cfg).apply(torch.from_numpy(x), StepCtx(it=it)),
           jax_pe(4, cfg).apply(jnp.asarray(x), make_ctx(it=it)), 2e-6)


@pytest.mark.parametrize("cfg", [
    {"type": "identity", "fac": 0.5},
    {"type": "tanh", "outer_fac": 0.25},
    {"type": "sigmoid", "shift": 4.0, "inner_fac": 2.0},
    {"type": "ease_value", "start_value": 1.0, "window_iters": 12000,
     "wait_iters": 4000, "activation": {"type": "sigmoid", "shift": 4.0}},
    "leaky_relu"], ids=["identity", "tanh", "sigmoid", "ease", "leaky"])
@pytest.mark.parametrize("it", [0, 9000, 20000])
def test_activations(cfg, it):
    x = RNG.normal(0, 3, (200, 3)).astype(np.float32)
    _close(TA.get_activation(cfg)(torch.from_numpy(x), StepCtx(it=it)),
           JA.get_activation(cfg)(jnp.asarray(x), make_ctx(it=it)))


def test_two_plane_param():
    cfg = {"n_dims": 4, "fn": "two_plane"}
    rays = RNG.uniform(-1, 1, (100, 6)).astype(np.float32)
    rays[:5, 5] = 0.0                 # d_z = 0: the 1e-5 guard
    _close(torch_rp(cfg).apply(torch.from_numpy(rays)),
           jax_rp(cfg).apply(jnp.asarray(rays)), 1e-5)
