"""The dynamic multi-axis family's whole fused render
(neural_3d_z_plane's chain at test widths: [8, 4, 4] keyframe grids,
pluecker rays, the mipnerf contraction with a flow stage) through
hyperreel_tpu_torch `model.apply` against hyperreel_tpu `model.apply`, at
S = 8 and S = 64, on the quad, the two-kernel patch and the fused patch
routes, with one t per frame (`uniform_time`: the time planes premixed)
and with a t per ray (the time-plane kernels), the witnesses included. On
the CPU the port runs the plain versions of its kernels (K1, K5, K4,
K5-preblended, K6); the JAX Pallas kernels run in interpret mode. rgb is
held to the fused-path gate, 2e-4 (tests/test_fused_cf.py), because the
JAX multi-axis kernels round the time planes and their z weights to bf16
where the port's f32 taps do not."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.models.ctx import StepCtx

from torch_parity import models, weights
from test_torch_dynamic_multi import BENCH_TOL, IT, SS, n3d_cfg
from test_torch_patch_route import crop_rays, phase_major


def _np(x):
    return np.asarray(x, np.float32)


@functools.lru_cache(maxsize=None)
def _route_models(S, patch):
    """Both packages' models and weights; the density grids drawn in [0,
    2.4 / S), so that the rays are partly opaque at either sample count."""
    jm, tm = models(n3d_cfg(S, patch=patch), bf16=False)
    jp, tp = weights(jm, seed=1, density=2.4 / S)
    return jm, tm, jp, tp


ROUTES = [(S, route, ut) for S in SS for route in ("quad", "two", "fused")
          for ut in (True, False)]


# A 32x32 crop of bench.py's camera (1,024 rays, phase-major for R = 8),
# one t for the frame (uniform_time: the time planes premixed, TH = 0) or
# a random t per ray (uniform_time off: the time-plane kernels, TH = 4).
# rgb at the fused-path gate, 2e-4; the witnesses equal. With a t per ray
# the flow moves neighbouring rays' points apart, so the patch routes'
# blocks leave their patches (witness ~0.16) and both packages degrade
# alike.
@pytest.mark.parametrize("S,route,ut", ROUTES, ids=[
    f"S{S}-{r}-{'uniform_t' if ut else 'per_ray_t'}" for S, r, ut in ROUTES])
def test_dynamic_multi_route_matches_jax(S, route, ut, monkeypatch):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI",
                       "1" if route == "fused" else "0")
    jm, tm, jp, tp = _route_models(S, None if route == "quad" else (5, 2, 8))
    assert tm._cf_eval is not None and not tm._cf_eval.dyn1
    rays = phase_major(crop_rays(), 8)
    if not ut:
        rays[:, 7] = np.random.default_rng(S).uniform(0, 1, rays.shape[0])
    rk = {"rays_phase_major": True, "uniform_time": ut}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    ra, rb = _np(a["rgb"]), b["rgb"].numpy()
    assert rb.shape == ra.shape and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= BENCH_TOL
    assert ra.std() > 0.01
    assert ("uniform_time_viol" in b) == ut == ("uniform_time_viol" in a)
    if ut:
        assert float(b["uniform_time_viol"]) == float(
            a["uniform_time_viol"]) == 0.0
    assert ("patch_coverage_viol" in b) == (route != "quad") \
        == ("patch_coverage_viol" in a)
    if route != "quad":
        assert float(a["patch_coverage_viol"]) \
            == float(b["patch_coverage_viol"])
        assert float(b["patch_coverage_viol"]) <= (1e-4 if ut else 0.5)


def test_uniform_time_witness_on_per_ray_times():
    """uniform_time on rays whose t differ: the premixed render is the
    caller's contract broken, and both packages report the same witness
    max |tn - tn[0]| > 0."""
    jm, tm, jp, tp = _route_models(8, None)
    rays = crop_rays()
    rays[:, 7] = np.random.default_rng(0).uniform(0, 1, rays.shape[0])
    rk = {"uniform_time": True}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    assert float(b["uniform_time_viol"]) > 0.1
    assert abs(float(b["uniform_time_viol"])
               - float(a["uniform_time_viol"])) <= 1e-6
