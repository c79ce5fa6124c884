"""The colour nets' own fused routes on the cascaded, deformable and
reflect presets: hyperreel_tpu_torch `model.apply` (the general chain,
then the route's kernel, run here as its plain version because the
tensors lie on the CPU) against hyperreel_tpu `model.apply` (the JAX
route's Pallas kernel in interpret mode, accumulating in f32 as the
port's kernels do: the `f32_acc` fixture), on the same weights and 256
rays of the blob scenes, f32 MLP policy, bf16 tables (which the routes
need):

  * tiny_cascaded: K2 on the time plane, with the predicted colour scale
    and shift in the pack; launched once;
  * tiny_shiny_deformable: K5 with RGB colour and the weights row;
  * tiny_refnerf_reflect and refnerf_sphere at test size: K5 with RGB
    colour and the weights row, the view directions reflected.

rgb within 1e-5 of the JAX route (the same f32 math, sums in another
order), and within 1e-5 of the port's general colour net on the same
fields with the lines and time planes rounded to bf16 (the general net
reads them at table precision, the routes in f32)."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.model import build_model as build_jax
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model as build_torch
from hyperreel_tpu_torch.ops.kernels import shade, shade_multi

from torch_parity import f32_acc  # noqa: F401
from torch_train_parity import init_weights
from test_torch_new_presets import IT, _scene, tiny_refnerf
from test_torch_rgb_route import _bf16_lines, _spy

TOL = 1e-5
FAMILIES = {"cascaded": (JP.tiny_cascaded, shade, "shade"),
            "deformable": (JP.tiny_shiny_deformable, shade_multi,
                           "shade_multi"),
            "refnerf_reflect": (JP.tiny_refnerf_reflect, shade_multi,
                                "shade_multi"),
            "refnerf": (tiny_refnerf, shade_multi, "shade_multi")}


@functools.lru_cache(maxsize=None)
def _models(family):
    make = FAMILIES[family][0]
    cfg = JP.convert_epochs_to_iters(make(), 50)
    cfg["color"]["net"].update(bf16_tables=True, fused_render=True)
    ds = _scene(family == "cascaded")
    jm = build_jax(copy.deepcopy(cfg), dataset_info=ds.info())
    tm = build_torch(copy.deepcopy(cfg), dataset_info=ds.info())
    pn = init_weights(tm)
    for k, v in pn["color"]["app"].items():
        pn["color"]["app"][k] = v * 10.0
    rays = ds.all_coords[:256]
    return jm, tm, jax.tree.map(jnp.asarray, pn), \
        params_from_jax(pn, device="cpu"), rays


@pytest.mark.parametrize("family", list(FAMILIES))
def test_own_route_matches_jax(family, f32_acc, monkeypatch):  # noqa: F811
    jm, tm, jp, tp, rays = _models(family)
    assert tm._cf_eval is None and tm.color_net.fused_eligible
    _, module, kernel = FAMILIES[family]
    calls = _spy(monkeypatch, module, kernel)
    # compiled: the JAX chain's eager first call compiles op by op
    ra = np.asarray(jax.jit(lambda p, r: jm.apply(
        p, r, make_ctx(it=IT, training=False), {})["rgb"])(
            jp, jnp.asarray(rays)))
    rb = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), {})[
        "rgb"].numpy()
    assert calls == [kernel]
    assert rb.shape == ra.shape == (256, 3) and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= TOL
    assert ra.std() > 1e-2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_own_route_matches_the_general_colour_net(family):
    _, tm, _, tp, rays = _models(family)
    ctx = StepCtx(it=IT)
    x = tm.embedding.apply(tp["embedding"],
                           tm.ray_param.apply(torch.from_numpy(rays)), ctx)
    if family == "cascaded":
        assert "color_scale" in x and "color_shift" in x
    net = tm.color_net
    general = copy.deepcopy(net)
    general.fused_render = False
    cp = _bf16_lines(tp["color"])
    own = net.apply(cp, dict(x), ctx)["rgb"]
    ref = general.apply(cp, dict(x), ctx)["rgb"]
    assert (own - ref).abs().max().item() <= TOL
