"""The static non-planar primitive presets end to end: hyperreel_tpu_torch
`model.apply` against hyperreel_tpu `model.apply` on the same weights and
a 32x32 crop of bench.py's camera, with the dataset_info of the JAX
loaders. tiny_donerf_sphere, tiny_donerf_cylinder and
tiny_catacaustics_distance ([4, 4, 4] components) and the small-grid
catacaustics_distance that keeps its [8, 8, 8] components and 64 samples
render through the general stage chain (sphere, cylinder or euclidean
distance intersect, mipnerf with the dataset bounds), then the general
colour net or the net's own fused route (K5 with the weights row;
catacaustics also with the global colour scale and shift). On the CPU
the port runs its kernels' plain versions."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models import fused_eval as jax_fused_eval
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu_torch.configs import presets as TP
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model
from hyperreel_tpu_torch.ops.kernels import shade_multi

from torch_parity import ITERS_PER_EPOCH, f32_acc, models, weights  # noqa: F401
from test_torch_patch_route import crop_rays
from test_torch_rgb_route import _bf16_lines, _spy

IT = 20000
# the JAX loaders' dataset_info (hyperreel_tpu/data/catacaustics.py:76-78)
INFO = {"near": 0.1, "far": 10.0, "depth_range": (0.1, 10.0)}
# The general chain with the general colour net, or the own fused route
# against the JAX route with its shade kernel accumulating in f32
# (`f32_acc`; by default it rounds the lines and line weights to bf16,
# ROADMAP.md 3), as the port's kernels do: under the f32 MLP policy the
# same f32 math, some sums in another order; under the bf16 policy the
# fused-path gate.
TOL_F32 = 1e-5
TOL_BF16 = 2e-4
FAMILIES = ("donerf_sphere", "donerf_cylinder", "catacaustics_distance",
            "small_grid_catacaustics")


def _cfg(family, fused):
    """The family's test config, held equal to the one made from the JAX
    package's preset: the tiny version with bf16 tables (the fused routes
    need them), or the small-grid catacaustics."""
    if family == "small_grid_catacaustics":
        cfg = JP.catacaustics_distance(z_channels=64)
        cfg["color"]["net"].update(N_voxel_init=32 ** 3,
                                   N_voxel_final=32 ** 3, upsamp_list=[],
                                   update_AlphaMask_list=[])
        cfg["embedding"]["embeddings"]["ray_prediction_0"]["net"].update(
            {"depth": 4, "hidden_channels": 64, "skips": [2]})
    else:
        cfg = getattr(JP, f"tiny_{family}")()
        cfg["color"]["net"]["bf16_tables"] = True
    tname = family if family == "small_grid_catacaustics" \
        else f"tiny_{family}"
    assert getattr(TP, tname)() == cfg
    cfg = JP.convert_epochs_to_iters(cfg, ITERS_PER_EPOCH)
    cfg["color"]["net"]["fused_render"] = fused
    return cfg


@functools.lru_cache(maxsize=None)
def _models(family, fused, bf16):
    jm, tm = models(_cfg(family, fused), bf16=bf16, info=INFO)
    jp, tp = weights(jm, seed=3, density=0.6)
    return jm, tm, jp, tp


def _rays():
    return crop_rays()[:, :6].copy()


def _apply(jm, tm, jp, tp, rays, rk=None):
    rk = rk or {}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    return np.asarray(a["rgb"]), b["rgb"].numpy()



@pytest.mark.parametrize("name", ["donerf_sphere", "donerf_cylinder",
                                  "catacaustics_distance"])
def test_full_presets_take_the_own_route(name):
    """No channels-first route in either package (not a z-plane chain);
    the colour net's own fused route is eligible, with K5's layout."""
    cfg = JP.convert_epochs_to_iters(getattr(JP, name)(), ITERS_PER_EPOCH)
    assert cfg == TP.convert_epochs_to_iters(getattr(TP, name)(),
                                             ITERS_PER_EPOCH)
    jm, tm = models(cfg, bf16=True, info=INFO)
    assert not jax_fused_eval.cf_eligible(jm)
    assert not fused_eval.cf_eligible(tm) and tm._cf_eval is None
    net = tm.color_net
    assert net.fused_render and net.fused_eligible
    comps = [8, 8, 8] if name == "catacaustics_distance" else [8, 4, 4]
    assert net.density_n_comp == comps == net.app_n_comp
    assert net.shading == ("sh" if name == "catacaustics_distance"
                           else "rgb")


ROUTES = [(f, fused, bf16) for f in FAMILIES for fused in (False, True)
          for bf16 in (False, True)]


@pytest.mark.parametrize("family,fused,bf16", ROUTES, ids=[
    f"{f}-{'own' if u else 'general'}-{'bf16' if b else 'f32'}"
    for f, u, b in ROUTES])
def test_route_matches_jax(family, fused, bf16, request):
    """The general chain, then the general colour net or the own fused
    route (K5 with the weights row, launched once)."""
    if fused:
        request.getfixturevalue("f32_acc")
    jm, tm, jp, tp = _models(family, fused, bf16)
    assert tm._cf_eval is None
    calls = _spy(request.getfixturevalue("monkeypatch"), shade_multi,
                 "shade_multi")
    ra, rb = _apply(jm, tm, jp, tp, _rays())
    assert calls == (["shade_multi"] if fused else [])
    assert rb.shape == ra.shape == (1024, 3) and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= (TOL_BF16 if bf16 else TOL_F32)
    assert ra.std() > 0.01


@pytest.mark.parametrize("family", FAMILIES)
def test_own_route_matches_jax_default_kernels(family):
    """The own route against the JAX route with its shade kernel as it
    ships (bf16 line lookup, ROADMAP.md 3), under the bf16 policy: at
    these sizes the lookup stays inside the fused-path gate (2.1e-5 at
    most here)."""
    ra, rb = _apply(*_models(family, True, True), _rays())
    assert rb.shape == ra.shape == (1024, 3) and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= TOL_BF16


def test_global_colour_scale_and_shift_reach_the_rgb():
    """catacaustics predicts a per-ray colour scale and shift (sample 0's
    color_scale_global, color_shift_global) applied after the composite:
    both routes apply them; with them zeroed the rgb changes."""
    _, tm, _, tp = _models("catacaustics_distance", True, False)
    ctx = StepCtx(it=IT)
    x = tm.embedding.apply(tp["embedding"], torch.from_numpy(_rays()), ctx)
    assert x["color_scale_global"].abs().max() > 0.01
    net = tm.color_net
    general = copy.deepcopy(net)
    general.fused_render = False
    cp = _bf16_lines(tp["color"])
    own = net.apply(cp, x, ctx)["rgb"]
    assert (general.apply(cp, x, ctx)["rgb"] - own).abs().max() <= TOL_F32
    x0 = dict(x, color_scale_global=torch.zeros_like(x["color_scale_global"]),
              color_shift_global=torch.zeros_like(x["color_shift_global"]))
    assert (net.apply(cp, x0, ctx)["rgb"] - own).abs().max() > 0.01


@pytest.mark.parametrize("key", ["color_transform", "color_transform_global"])
@pytest.mark.parametrize("fused", [False, True])
def test_colour_transform_is_refused(key, fused, monkeypatch):
    """A predicted colour transform: the own fused route refuses a
    per-sample one (the net takes the general colour net: no kernel
    launch) and applies a global one after its kernel; either way the rgb
    is the general colour net's with the transform, which differs from
    the rgb without it. (The transform is applied only where the chain
    predicts no colour scale, as in the JAX package: the test drops
    catacaustics' predicted scale and shift.)"""
    _, tm, _, tp = _models("catacaustics_distance", True, False)
    ctx = StepCtx(it=IT)
    x = tm.embedding.apply(tp["embedding"], torch.from_numpy(_rays()), ctx)
    for k in ("color_scale", "color_shift", "color_scale_global",
              "color_shift_global"):
        x.pop(k, None)
    n = x["points"].reshape(-1, 3).shape[0]
    gen = torch.Generator().manual_seed(0)
    shift = key.replace("transform", "shift")
    x[key] = 0.3 * torch.randn(n, 9, generator=gen)
    x[shift] = 0.1 * torch.randn(n, 3, generator=gen)
    net = copy.deepcopy(tm.color_net)
    net.fused_render = fused
    general = copy.deepcopy(tm.color_net)
    general.fused_render = False
    cp = _bf16_lines(tp["color"])
    calls = _spy(monkeypatch, shade_multi, "shade_multi")
    got = net.apply(cp, x, ctx)["rgb"]
    assert calls == (["shade_multi"] if fused and key.endswith("global")
                     else [])
    want = general.apply(cp, x, ctx)["rgb"]
    assert (got - want).abs().max() <= TOL_F32
    x0 = {k: v for k, v in x.items() if k not in (key, shift)}
    assert (general.apply(cp, x0, ctx)["rgb"] - want).abs().max() > 0.01


def test_prepared_tables_give_the_same_frame():
    """model.prepare_eval returns the own route's tables ([8, 8, 8], 64
    samples), and rendering with them changes nothing."""
    _, tm, _, tp = _models("small_grid_catacaustics", True, False)
    prep = tm.prepare_eval(tp)
    assert set(prep) == {"axes", "quads", "lines", "wb"}
    assert [(a.C, a.nd) for a in prep["axes"]] == [(16, 8)] * 3
    assert tuple(prep["wb"].shape) == (27, 24)
    rays = torch.from_numpy(_rays())
    a = tm.apply(tp, rays, StepCtx(it=IT))["rgb"]
    b = tm.apply(tp, rays, StepCtx(it=IT), {"cf_prepared": prep})["rgb"]
    assert torch.equal(a, b)


# immersive's dataset_info (hyperreel_tpu/data/immersive.py:21-24, 56-57,
# 164-169): 12 keyframes of a 50-frame window
ROUND_TRIP = {"donerf_sphere": INFO, "catacaustics_distance": INFO,
              "immersive_sphere_new": {**INFO, "num_keyframes": 12,
                                       "num_frames": 50}}


@pytest.mark.parametrize("name", list(ROUND_TRIP))
def test_params_round_trip(name):
    """convert.py carries the full presets' parameters (init grids: the
    [27, 24] SH basis of catacaustics' [8, 8, 8] layout, immersive's time
    planes) to the port and back unchanged, with the port's own names."""
    info = ROUND_TRIP[name]
    cfg = JP.convert_epochs_to_iters(getattr(JP, name)(), ITERS_PER_EPOCH)
    jm, _ = models(cfg, bf16=False, info=info)
    pn = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(pn, device="cpu")
    net = cfg["color"]["net"]
    assert tuple(tp["color"]["basis_mat"]["weight"].shape) == (
        net["data_dim_color"], sum(net["n_lamb_sh"]))
    back = params_to_jax(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(pn)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], v)
    model = build_model(copy.deepcopy(cfg), dataset_info=info)
    init = model.init(torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in init["color"]["density"].items()} \
        == {k: tuple(v.shape) for k, v in tp["color"]["density"].items()}

