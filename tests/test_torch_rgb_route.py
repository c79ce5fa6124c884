"""The static RGB families end to end: hyperreel_tpu_torch `model.apply`
against hyperreel_tpu `model.apply` on the same weights and a 32x32 crop
of bench.py's camera. tiny_shiny renders on the channels-first route (K1
then K5, or K4 x 3 + K5-preblended, or K6, with RGB colour);
tiny_stanford_llff, which that route does not take (its intersect masks
near/far), renders through the general stage chain and the net's own
fused route (K2 with RGB, the weights row and its z line as the premixed
table); tiny_shiny and tiny_static (the llff_z_plane family) with
`fused_render_cf` off take the general chain and the net's own
multi-axis route (K5 with the weights row). Each under the f32 and the
bf16 MLP policies; `color_net.apply` on the same fields with random
weights holds the nets' own routes alone. On the CPU the port runs its
kernels' plain versions."""

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

from torch_parity import ITERS_PER_EPOCH, models, rgb_cfg, static_cfg, \
    weights
from test_torch_patch_route import crop_rays, phase_major

IT = 20000
# The routes' rgb against the JAX package's, under the f32 and the bf16
# MLP policies alike: the fused-path gate, 2e-4. The JAX shade kernels
# round their lines and line weights to bf16 (their acc_dtype default, the
# bf16 line lookup of ROADMAP.md 3), which the port's f32 taps do not:
# measured at most 1.8e-4 (shiny's quad route at S = 32), 7.1e-5 at S = 8
# on every channels-first route and the own multi-axis routes, 8.1e-5 on
# stanford's own route, under either policy.
TOL = 2e-4


@functools.lru_cache(maxsize=None)
def _models(family, S, bf16, cf=True, patch=None):
    cfg = rgb_cfg(family, S, cf=cf) if family != "llff" \
        else static_cfg(S=S)
    if family == "llff" and not cf:
        cfg["color"]["net"]["fused_render_cf"] = False
    if patch:
        cfg = JP.with_coherent_gather(cfg, *patch)
    jm, tm = models(cfg, bf16=bf16)
    jp, tp = weights(jm, seed=3, density=0.6)
    return jm, tm, jp, tp


def _apply(jm, tm, jp, tp, rays, rk=None):
    rk = rk or {}
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False), rk)
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), rk)
    return a, b, np.asarray(a["rgb"]), b["rgb"].numpy()


@pytest.mark.parametrize("family,cf_ok", [("shiny", True),
                                          ("stanford", False)])
def test_cf_eligible_agrees_on_the_full_presets(family, cf_ok):
    """shiny_z_plane takes the channels-first route in both packages;
    stanford_llff_z_plane (its intersect's mask.stop_iters is -1) takes
    neither, and its net's own fused route instead."""
    make = {"shiny": "shiny_z_plane", "stanford": "stanford_llff_z_plane"}
    cfg = getattr(JP, make[family])()
    assert cfg == getattr(TP, make[family])()
    cfg = JP.convert_epochs_to_iters(cfg, ITERS_PER_EPOCH)
    jm, tm = models(cfg, bf16=True)
    assert jax_fused_eval.cf_eligible(jm) is cf_ok
    assert fused_eval.cf_eligible(tm) is cf_ok
    assert (tm._cf_eval is not None) is cf_ok
    assert tm.color_net.shading == "rgb"
    assert tm.color_net.fused_render and tm.color_net.fused_eligible


SHINY_ROUTES = [(route, bf16) for route in ("quad", "two", "fused")
                for bf16 in (False, True)] + [("quad32", False)]


@pytest.mark.parametrize("route,bf16", SHINY_ROUTES, ids=[
    f"{r}-{'bf16' if b else 'f32'}" for r, b in SHINY_ROUTES])
def test_shiny_route_matches_jax(route, bf16, monkeypatch):
    """tiny_shiny (S = 8, and 32 on the quad route) on the channels-first
    route: quad (K1, K5), two-kernel patch (K4 x 3, K5-preblended) and
    fused patch (K6) at R=8 (5, 2), rays phase-major; the witnesses
    equal."""
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI",
                       "1" if route == "fused" else "0")
    S = 32 if route == "quad32" else 8
    patch = None if route.startswith("quad") else (5, 2, 8)
    jm, tm, jp, tp = _models("shiny", S, bf16, patch=patch)
    assert tm._cf_eval is not None and jm._cf_eval is not None
    rays = phase_major(crop_rays()[:, :6].copy(), 8)
    rk = {"rays_phase_major": True}
    a, b, ra, rb = _apply(jm, tm, jp, tp, rays, rk)
    assert rb.shape == ra.shape and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= TOL
    assert ra.std() > 0.01
    assert ("patch_coverage_viol" in b) == (patch is not None) \
        == ("patch_coverage_viol" in a)
    if patch:
        assert float(a["patch_coverage_viol"]) \
            == float(b["patch_coverage_viol"])


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(name)
        return real(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


OWN_ROUTES = [("stanford", 8, False), ("stanford", 32, False),
              ("stanford", 8, True), ("shiny", 8, False),
              ("shiny", 8, True), ("llff", 8, False), ("llff", 8, True)]


@pytest.mark.parametrize("family,S,bf16", OWN_ROUTES, ids=[
    f"{f}-S{S}-{'bf16' if b else 'f32'}" for f, S, b in OWN_ROUTES])
def test_own_fused_route_matches_jax(family, S, bf16, monkeypatch):
    """The general stage chain, then the net's own fused route: K2 on
    stanford's single axis, K5 with the weights row on shiny's (RGB) and
    llff's (SH) three axes with the channels-first route off."""
    from hyperreel_tpu_torch.ops.kernels import shade, shade_multi
    jm, tm, jp, tp = _models(family, S, bf16, cf=False)
    assert tm._cf_eval is None and jm._cf_eval is None
    kernel = "shade" if family == "stanford" else "shade_multi"
    calls = _spy(monkeypatch,
                 shade if kernel == "shade" else shade_multi, kernel)
    rays = crop_rays()[:, :6].copy()
    _, _, ra, rb = _apply(jm, tm, jp, tp, rays)
    assert calls == [kernel]
    assert rb.shape == ra.shape and np.isfinite(rb).all()
    assert np.abs(ra - rb).max() <= TOL
    assert ra.std() > 0.01


def _fields(B, S, seed):
    """Random fields of the general chain's output: points around the
    aabb, sorted distances (a few 0: invalid), view directions, random
    non-unit weights, colour scale and shift."""
    rng = np.random.default_rng(seed)
    vd = rng.normal(0, 1, (B, 1, 3))
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    dist = np.sort(rng.uniform(0, 3, (B, S, 1)), 1)
    dist[:, :1] *= rng.uniform(0, 1, (B, 1, 1)) < 0.8
    x = {"points": rng.uniform(-2.2, 2.2, (B, S, 3)),
         "distances": dist,
         "viewdirs": np.repeat(vd, S, 1),
         "weights": rng.uniform(0, 2, (B, S, 1)),
         "color_scale": rng.normal(0, 0.1, (B, S, 3)),
         "color_shift": rng.normal(0, 0.1, (B, S, 3))}
    return {k: v.astype(np.float32) for k, v in x.items()}


def _bf16_lines(color):
    """The colour params with every line and time plane rounded to bf16
    (the general colour net reads them at table precision, the fused
    routes in f32)."""
    out = copy.deepcopy(color)
    for fam in ("density", "app"):
        for k, v in out[fam].items():
            if k.startswith(("line_", "time_")):
                out[fam][k] = v.to(torch.bfloat16).float()
    return out


@pytest.mark.parametrize("family", ["stanford", "shiny", "llff"])
def test_color_net_own_route_matches_jax_and_general(family):
    """`color_net.apply` on the same fields with random non-unit weights
    (rays mostly opaque): the port's own fused route against the JAX
    package's, whose kernels round the lines and the line weights to bf16
    (the bf16 line lookup: up to 6.7e-4 here, measured), so 1e-3; and
    against the port's general colour net on lines that bf16 represents
    (the general net reads them at table precision), the same f32 math
    but for the order of the sums, so 1e-5."""
    jm, tm, jp, tp = _models(family, 8, False, cf=False)
    x = _fields(256, 8, seed=7)
    ctx = make_ctx(it=IT, training=False)
    a = np.asarray(jm.color_net.apply(
        jp["color"], {k: jnp.asarray(v) for k, v in x.items()}, ctx)["rgb"])
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    b = tm.color_net.apply(tp["color"], xt, StepCtx(it=IT))["rgb"].numpy()
    assert a.std() > 0.01 and np.isfinite(b).all()
    assert np.abs(a - b).max() <= 1e-3
    general = copy.deepcopy(tm.color_net)
    general.fused_render = False
    cp = _bf16_lines(tp["color"])
    g = general.apply(cp, xt, StepCtx(it=IT))["rgb"]
    b = tm.color_net.apply(cp, xt, StepCtx(it=IT))["rgb"]
    assert (g - b).abs().max() <= 1e-5
    # the weights reach the colour
    xt["weights"] = torch.ones_like(xt["weights"])
    ones = tm.color_net.apply(cp, xt, StepCtx(it=IT))["rgb"]
    assert (ones - b).abs().max() > 0.05


def test_prepared_tables_give_the_same_frame():
    """model.prepare_eval returns the own route's tables when the
    channels-first route is absent, and rendering with them changes
    nothing."""
    _, tm, _, tp = _models("stanford", 8, False, cf=False)
    rays = torch.from_numpy(crop_rays()[:, :6].copy())
    prep = tm.prepare_eval(tp)
    assert set(prep) == {"axes", "quads", "lines", "wb"}
    a = tm.apply(tp, rays, StepCtx(it=IT))["rgb"]
    b = tm.apply(tp, rays, StepCtx(it=IT), {"cf_prepared": prep})["rgb"]
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["shiny_z_plane", "stanford_llff_z_plane"])
def test_params_round_trip(name):
    """convert.py carries the full presets' parameters (init grids), the
    RGB basis [3, A] included, to the port and back unchanged."""
    cfg = JP.convert_epochs_to_iters(getattr(JP, name)(), ITERS_PER_EPOCH)
    jm, _ = models(cfg, bf16=False)
    pn = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tp = params_from_jax(pn, device="cpu")
    assert tuple(tp["color"]["basis_mat"]["weight"].shape) == (
        3, sum(cfg["color"]["net"]["n_lamb_sh"]))
    back = params_to_jax(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(pn)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, v in flat_a:
        np.testing.assert_array_equal(flat_b[path], v)
    model = build_model(copy.deepcopy(cfg))
    assert set(model.init(torch.Generator().manual_seed(0), "cpu")[
        "color"]) == set(tp["color"])
