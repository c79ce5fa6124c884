"""The dynamic net's own fused route end to end: hyperreel_tpu_torch
`model.apply` against hyperreel_tpu `model.apply` on the same weights and
a 32x32 crop of bench.py's camera, with one t for every ray and with a t
per ray. tiny_immersive_sphere (sphere_new intersect with the miss
fallback, flow, mipnerf with the dataset bounds of 02_Flames, [4, 4, 4]
components on three space-plane x time-plane axes) renders through the
general stage chain, then the general colour net or the net's own route:
K5 on the time planes without the weights row. tiny_dynamic (the
flagship's family, one axis) with `fused_render_cf` off renders through
the general chain and the single-axis own route: K2 on its time plane.
On the CPU the port runs its kernels' plain versions."""

import copy
import functools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models import fused_eval as jax_fused_eval
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.configs import presets as TP
from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.kernels import shade, shade_multi

from torch_parity import (  # noqa: F401
    ITERS_PER_EPOCH, f32_acc, flagship_cfg, models, weights)
from test_torch_patch_route import crop_rays
from test_torch_rgb_route import _bf16_lines, _spy

IT = 20000
# hyperreel_tpu/data/immersive.py:21-24, 56-57, 164-169 (02_Flames, a
# 50-frame window with keyframe_step 4)
IMMERSIVE_INFO = {"near": 1.0, "far": 10.0, "depth_range": (2.0, 10.0),
                  "num_keyframes": 12, "num_frames": 50}
FLAGSHIP_INFO = {"num_keyframes": 4, "num_frames": 50, "num_views": 16}
# as tests/test_torch_primitive_routes.py: the own route against the JAX
# route with its shade kernels accumulating in f32 (`f32_acc`), as the
# port's do; under the f32 MLP policy the same f32 math but for the order
# of the sums, under the bf16 policy the fused-path gate.
TOL_F32 = 1e-5
TOL_BF16 = 2e-4
# Against the JAX kernels at their default bf16 accumulation, their bf16
# time lookup adds its own error, up to 3.2e-4 of rgb (ROADMAP.md 3; the
# flagship's own route with a t per ray reads 2.6e-4 here under either
# policy, immersive's 9.5e-5).
TOL_BF16_LOOKUP = 3.2e-4


def _cfg(family, fused):
    if family == "immersive":
        cfg = JP.tiny_immersive_sphere()
        cfg["color"]["net"]["bf16_tables"] = True
        assert TP.tiny_immersive_sphere() == cfg
        cfg = JP.convert_epochs_to_iters(cfg, ITERS_PER_EPOCH)
    else:
        cfg = flagship_cfg(tiny=True)
    net = cfg["color"]["net"]
    net["fused_render"] = fused
    net["fused_render_cf"] = False
    return cfg


@functools.lru_cache(maxsize=None)
def _models(family, fused, bf16):
    info = IMMERSIVE_INFO if family == "immersive" else FLAGSHIP_INFO
    jm, tm = models(_cfg(family, fused), bf16=bf16, info=info)
    jp, tp = weights(jm, seed=4, density=0.6)
    return jm, tm, jp, tp


def _rays(per_ray_t):
    rays = crop_rays()
    if per_ray_t:
        rays[:, 7] = np.random.default_rng(9).uniform(0, 1, rays.shape[0])
    return rays



def test_full_preset_takes_the_own_route():
    """immersive_sphere_new: no channels-first route in either package;
    the dynamic net's own route is eligible at the [8, 4, 4] layout."""
    cfg = JP.convert_epochs_to_iters(JP.immersive_sphere_new(),
                                     ITERS_PER_EPOCH)
    assert cfg == TP.convert_epochs_to_iters(TP.immersive_sphere_new(),
                                             ITERS_PER_EPOCH)
    jm, tm = models(cfg, bf16=True, info=IMMERSIVE_INFO)
    assert not jax_fused_eval.cf_eligible(jm)
    assert not fused_eval.cf_eligible(tm) and tm._cf_eval is None
    net = tm.color_net
    assert net.fused_render and net.fused_eligible
    assert net.density_n_comp == [8, 4, 4] and net.num_keyframes == 12


ROUTES = [(f, fused, bf16, t) for f in ("immersive", "flagship")
          for fused, bf16 in ((False, False), (True, False), (True, True))
          for t in (False, True)]


@pytest.mark.parametrize("family,fused,bf16,per_ray_t", ROUTES, ids=[
    f"{f}-{'own' if u else 'general'}-{'bf16' if b else 'f32'}-"
    f"{'t_per_ray' if t else 'one_t'}" for f, u, b, t in ROUTES])
def test_route_matches_jax(family, fused, bf16, per_ray_t, request):
    """The general chain, then the general colour net or the own route:
    K5 on the time planes (immersive) or K2 on the time plane (the
    flagship's family), launched once."""
    if fused:
        request.getfixturevalue("f32_acc")
    jm, tm, jp, tp = _models(family, fused, bf16)
    assert tm._cf_eval is None
    module, kernel = (shade_multi, "shade_multi") if family == "immersive" \
        else (shade, "shade")
    calls = _spy(request.getfixturevalue("monkeypatch"), module, kernel)
    rays = _rays(per_ray_t)
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), {})
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), {})
    ra, rb = np.asarray(a["rgb"]), b["rgb"].numpy()
    assert calls == ([kernel] if fused else [])
    assert rb.shape == ra.shape == (1024, 3) and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= (TOL_BF16 if bf16 else TOL_F32)
    assert ra.std() > 0.01


DEFAULT_ACC = [(f, bf16) for f in ("immersive", "flagship")
               for bf16 in (False, True)]


@pytest.mark.parametrize("family,bf16", DEFAULT_ACC, ids=[
    f"{f}-{'bf16' if b else 'f32'}" for f, b in DEFAULT_ACC])
def test_own_route_matches_jax_default_kernels(family, bf16):
    """The own route with a t per ray against the JAX route with its
    shade kernels as they ship (bf16 accumulation): within the error of
    their bf16 time lookup."""
    jm, tm, jp, tp = _models(family, True, bf16)
    rays = _rays(True)
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), {})
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), {})
    ra, rb = np.asarray(a["rgb"]), b["rgb"].numpy()
    assert rb.shape == ra.shape == (1024, 3) and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= TOL_BF16_LOOKUP


@pytest.mark.parametrize("family", ["immersive", "flagship"])
def test_own_route_matches_the_general_colour_net(family):
    """`color_net.apply` on the chain's fields with a t per ray: the own
    route against the port's general colour net on time planes that bf16
    represents, the same f32 math but for the order of the sums; and
    prepare_eval's tables change nothing."""
    _, tm, _, tp = _models(family, True, False)
    ctx = StepCtx(it=IT)
    x = tm.embedding.apply(tp["embedding"],
                           tm.ray_param.apply(torch.from_numpy(
                               _rays(True))), ctx)
    net = tm.color_net
    general = copy.deepcopy(net)
    general.fused_render = False
    cp = _bf16_lines(tp["color"])
    own = net.apply(cp, x, ctx)["rgb"]
    assert (general.apply(cp, x, ctx)["rgb"] - own).abs().max() <= TOL_F32
    prep = tm.prepare_eval(dict(tp, color=cp))
    assert [a.TH for a in prep["axes"]] == [net.num_keyframes] * len(
        net.active_density)
    assert torch.equal(net.apply(cp, x, ctx, {"cf_prepared": prep})["rgb"],
                       own)
