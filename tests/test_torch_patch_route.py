"""The coherent patch-gather route end to end: hyperreel_tpu_torch
`model.apply` against hyperreel_tpu `model.apply` on
`with_coherent_gather(...)`, the same weights and a 32x32 crop of
bench.py's camera (focal 1024*1.2, so the pixel density is the bench's;
1,024 rays, a multiple of R*128, so the JAX package takes its patch route
too). rgb is held to the fused-path gate (2e-4, tests/test_fused_cf.py);
the coverage witness outputs["patch_coverage_viol"] must be equal at the
tiny f32 config, and within 1e-3 at the flagship's bf16 MLP policy, where
a rounding flip in the MLP can move one block across a texel edge. On
the CPU the port runs the plain versions of its kernels."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import with_coherent_gather
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.kernels.patch_blend import patch_blend
from hyperreel_tpu_torch.ops.kernels.shade import shade, shade_preblended
from hyperreel_tpu_torch.ops.kernels.shade_patch import shade_patch

from torch_parity import flagship_cfg, models, weights

IT = 20000
SIDE = 32
BENCH_FOCAL = 1024 * 1.2         # bench.py:107, in pixels of its 1024^2


def crop_rays(focal=BENCH_FOCAL, side=SIDE):
    """The central side x side pixels of bench.py's 1024^2 pinhole frame
    (o = (0, 0, -1.5), unit-z directions, camera 3, t = 0.3), scanline
    order; `focal` in pixels sets the pixel density."""
    u = (np.arange(1024, dtype=np.float32) - 511.5) / focal
    u = u[512 - side // 2:512 + side // 2]
    uu, vv = np.meshgrid(u, u)
    d = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
    o = np.zeros_like(d)
    o[:, 2] = -1.5
    n = d.shape[0]
    return np.concatenate([o, d, np.full((n, 1), 3.0),
                           np.full((n, 1), 0.3)], -1).astype(np.float32)


def phase_major(rays, R):
    """bench.py:125-127: original ray R*j+p at position p*(B/R)+j."""
    return np.ascontiguousarray(
        rays.reshape(-1, R, rays.shape[1]).transpose(1, 0, 2)).reshape(
        rays.shape)


@functools.lru_cache(maxsize=None)
def _setup(tiny, px, py, R):
    cfg = with_coherent_gather(flagship_cfg(tiny=tiny), px, py, R)
    jm, tm = models(cfg, bf16=not tiny)
    jp, tp = weights(jm, seed=1)
    return jm, tm, jp, tp


def _both(key, rays, rk):
    jm, tm, jp, tp = _setup(*key)
    counts = (shade.launches, shade_patch.launches, patch_blend.launches,
              shade_preblended.launches)
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    assert counts == (shade.launches, shade_patch.launches,
                      patch_blend.launches, shade_preblended.launches)
    ra, rb = np.asarray(a["rgb"]), b["rgb"].numpy()
    assert rb.shape == ra.shape and np.isfinite(rb).all()
    return a, b, np.abs(ra - rb).max()


TINY = [((True, px, py, R), fused, pm)
        for px, py, R in ((4, 3, 4), (5, 2, 8))
        for fused in ("1", "0") for pm in (True, False)]
FLAGSHIP = [((False, 5, 2, 8), fused, True) for fused in ("1", "0")]


@pytest.mark.parametrize("key,fused,pm", TINY + FLAGSHIP, ids=[
    f"{'tiny_f32' if k[0] else 'flagship_bf16'}-{k[1]}x{k[2]}_R{k[3]}-"
    f"{'fused' if f == '1' else 'two_kernel'}-"
    f"{'phase_major' if pm else 'scanline'}" for k, f, pm in TINY + FLAGSHIP])
def test_patch_route_matches_jax(key, fused, pm, monkeypatch):
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH", fused)
    rays = crop_rays()
    if pm:
        rays = phase_major(rays, key[3])
    # the phase-major cases are frames as bench.py renders them (uniform
    # time premix); the scanline ones mix the keyframes per sample
    a, b, err = _both(key, rays, {"rays_phase_major": pm,
                                  "uniform_time": pm})
    assert err <= 2e-4, err
    assert "patch_coverage_viol" in a
    va, vb = float(a["patch_coverage_viol"]), float(b["patch_coverage_viol"])
    if key[0]:
        assert va == vb
    else:
        assert abs(va - vb) <= 1e-3, (va, vb)
    assert vb <= 1e-4                  # bench.py PVIOL_EXACT at its density


def test_out_of_patch_blocks_degrade_alike():
    """At a thirtieth of the bench's pixel density a quarter of the
    (block, slot) footprints exit the (5, 2) patch, and in a thin scene
    (density grids x 0.05, so the far samples that exit show) the blended
    features' zero degradation moves the rgb away from the quad route's;
    both packages degrade alike: equal witness, rgb within the gate."""
    rays = crop_rays(focal=BENCH_FOCAL / 30)
    jm, tm = models(with_coherent_gather(flagship_cfg(tiny=True), 5, 2, 8),
                    bf16=False)
    jp, tp = weights(jm, seed=1)
    for k in tp["color"]["density"]:
        jp["color"]["density"][k] = jp["color"]["density"][k] * 0.05
        tp["color"]["density"][k] = tp["color"]["density"][k] * 0.05
    rk = {"uniform_time": True}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    va, vb = float(a["patch_coverage_viol"]), float(b["patch_coverage_viol"])
    assert va == vb and vb > 0.1, (va, vb)
    err = np.abs(np.asarray(a["rgb"]) - b["rgb"].numpy()).max()
    assert err <= 2e-4, err
    _, quad = models(flagship_cfg(tiny=True), bf16=False)
    exact = quad.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    assert (exact["rgb"] - b["rgb"]).abs().max() > 1e-3


def test_ragged_chunk_takes_the_quad_route():
    """B % R != 0: the port falls back to the exact quad route (the JAX
    package too: its tile cannot divide), with no coverage witness."""
    rays = crop_rays()[:1020]
    a, b, err = _both((True, 5, 2, 8), rays, {})
    assert "patch_coverage_viol" not in a and "patch_coverage_viol" not in b
    assert err <= 2e-4, err
