"""The render-time sample-count routes (configs/presets.py
with_compact_samples: intersect invalid_sort_far + select_points mode
"first"; with_inference_samples: select_points' positional stride) in
hyperreel_tpu_torch against hyperreel_tpu, on the same numpy-seeded
weights (convert.params_from_jax) and rays:

  * the select_points stage and the intersect's far sentinel alone;
  * the general path with each stage, and the nets' own fused routes
    after the general chain where compaction leaves the channels-first
    path (under the mipnerf contraction);
  * K1's plain version with k / stride / far_sentinel against the JAX
    Pallas kernel (interpret mode);
  * the fused path against the JAX FusedCFEval: K1's two branches, then
    the shade kernels at S = k on the quad and patch routes;
  * cf_eligible on the combinations the fused path refuses.

On the CPU the port runs its kernels' plain versions. Rays come with
their origins among the z-planes, so that some samples lie behind the
origin: invalid, they take the far sentinel under compaction."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models import fused_eval as jax_fused_eval
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.embeddings_extra import (
    SelectPointsEmbedding as JaxSelectPoints)
from hyperreel_tpu.ops.pallas import pack_build as jax_pack_build_mod
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models import fused_eval
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.embeddings_extra import SelectPointsEmbedding
from hyperreel_tpu_torch.models.intersect import FAR_SENTINEL
from hyperreel_tpu_torch.ops.kernels import pack_build as PB
from hyperreel_tpu_torch.ops.kernels.layout import PACK_ROWS, pack_from_smajor

from torch_parity import (  # noqa: F401
    ITERS_PER_EPOCH, entry_rays, f32_acc, flagship_cfg, models, rgb_cfg,
    static_cfg, weights)
from test_torch_dynamic_multi import n3d_cfg
from test_torch_pack_build import _inputs, _jax_pack
from test_torch_patch_route import crop_rays, phase_major

IT = 20000
N_RAYS = 256
# The general path under the f32 policy with f32 tables: the same f32 math
# on both sides but for the order of the sums.
F32_TOL = 1e-5
# The fused paths and the nets' own routes against the JAX package with
# its shade kernels accumulating in f32 (`f32_acc`), as the port's do
# (tests/test_torch_dynamic_own_route.py): under the f32 MLP policy the
# same f32 math but for the order of the sums (F32_TOL; these cases read
# ~4e-6), under the bench's bf16 policy the fused-path gate of
# tests/test_fused_cf.py. At the JAX kernels' default bf16 accumulation
# their bf16 time and line lookups alone move rgb by up to 5.1e-4 on these
# rays, whose origins lie among the planes (ROADMAP.md 3).
FUSED_TOL = 2e-4


def fused_tol(bf16):
    return FUSED_TOL if bf16 else F32_TOL


def tiny_flagship(S):
    """flagship_cfg(tiny=True) at S samples per ray."""
    cfg = JP.convert_epochs_to_iters(JP.tiny_dynamic(z_channels=S),
                                     ITERS_PER_EPOCH)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    assert S != 8 or cfg == flagship_cfg(tiny=True)
    return cfg


def sentinel_rays(n, seed=0, static=False):
    """entry_rays with half the origins among the z-planes (o_z in [-0.9,
    0.9]) and one ray in sixteen pointing backwards (d_z = -1), so that
    rays have samples behind their origin, or none in front."""
    rays = entry_rays(n, seed)
    rng = np.random.default_rng(seed + 100)
    rays[::2, 2] = rng.uniform(-0.9, 0.9, n // 2)
    rays[::16, 5] = -1.0
    return np.ascontiguousarray(rays[:, :6]) if static else rays


def _np(x):
    return np.asarray(x, np.float32)


def _both(jm, tm, jp, tp, rays, rk=None):
    a = jm.apply(jp, jnp.asarray(rays), make_ctx(it=IT, training=False),
                 dict(rk or {}))
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT), dict(rk or {}))
    ra, rb = _np(a["rgb"]), b["rgb"].numpy()
    assert rb.shape == ra.shape and np.isfinite(rb).all()
    return a, b, float(np.abs(ra - rb).max())


# ---- the stages alone


@pytest.mark.parametrize("mode,n", [("first", 2), ("first", 4),
                                    ("stride", 2), ("stride", 4),
                                    ("stride", 3), ("first", 8)])
def test_select_points_matches_jax(mode, n):
    """Every tensor with a channel axis and S on axis 1 is sliced (the
    first n, or every (S // n)-th); [B, S] and per-ray tensors are not;
    n >= S passes the state unchanged."""
    S, B = 8, 16
    rng = np.random.default_rng(n)
    state = {"points": rng.normal(size=(B, S, 3)),
             "distances": rng.normal(size=(B, S, 1)),
             "weights": rng.normal(size=(B, S, 1)),
             "spatial_flow": rng.normal(size=(B, S, 3)),
             "z_vals": rng.normal(size=(B, S)),
             "rays": rng.normal(size=(B, 8))}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    cfg = {"type": "select_points", "mode": mode, "inference_samples": n}
    ja = JaxSelectPoints(dict(cfg)).apply(
        {}, {k: jnp.asarray(v) for k, v in state.items()},
        make_ctx(it=IT, training=False))
    ta = SelectPointsEmbedding(dict(cfg)).apply(
        {}, {k: torch.from_numpy(v) for k, v in state.items()},
        StepCtx(it=IT))
    assert set(ta) == set(k for k in ja if k != "inference_samples_static")
    for k, v in ta.items():
        np.testing.assert_array_equal(v.numpy(), _np(ja[k]))
    if n < S:
        assert ta["points"].shape[1] < S and ta["z_vals"].shape[1] == S


def test_select_points_training_is_not_ported():
    """The training regime (ported since; the drawn count's gather:
    tests/test_torch_train_stages.py): without a drawn count the state
    passes unchanged; always_slice slices as at eval; both as the JAX
    package's."""
    x = np.random.default_rng(1).normal(size=(2, 8, 3)).astype(np.float32)
    for cfg, S in (({"inference_samples": 4}, 8),
                   ({"inference_samples": 4, "mode": "first",
                     "always_slice": True}, 4)):
        ja = JaxSelectPoints(dict(cfg)).apply(
            {}, {"points": jnp.asarray(x)}, make_ctx(it=0, training=True))
        ta = SelectPointsEmbedding(cfg).apply(
            {}, {"points": torch.from_numpy(x)},
            StepCtx(it=0, training=True))
        assert ta["points"].shape[1] == S
        np.testing.assert_array_equal(ta["points"].numpy(),
                                      _np(ja["points"]))


def _intersect_state(jm, tm, jp, tp, rays):
    """Both packages' states after their ray_prediction and ray_intersect
    stages."""
    jx, tx = {"rays": jnp.asarray(rays)}, {"rays": torch.from_numpy(rays)}
    jctx, tctx = make_ctx(it=IT, training=False), StepCtx(it=IT)
    for (name, js), (_, ts) in list(zip(jm.embedding.stages,
                                        tm.embedding.stages))[:2]:
        jx = js.apply(jp["embedding"][name], jx, jctx, {})
        tx = ts.apply(tp["embedding"][name], tx, tctx, {})
    return jx, tx


@pytest.mark.parametrize("family", ["dynamic", "static_mipnerf"])
def test_invalid_sort_far_matches_jax(family):
    """Masked distances become the far sentinel before the values-only
    sort and stay after it, behind every valid distance of their ray;
    under the mipnerf contraction the sentinel's point and distance are
    contracted (onto the radius-2 sphere, which is why the fused path
    refuses compaction there), as in JAX."""
    if family == "dynamic":
        cfg = flagship_cfg(tiny=True, fused=False, bf16_tables=False)
    else:
        cfg = static_cfg(fused=False, bf16_tables=False)
    cfg = JP.with_compact_samples(cfg, 4)
    jm, tm = models(cfg, bf16=False)
    jp, tp = weights(jm, seed=2)
    rays = sentinel_rays(64, seed=3, static=family != "dynamic")
    jx, tx = _intersect_state(jm, tm, jp, tp, rays)
    raw = tx["raw_distance"][..., 0]
    if family == "dynamic":
        assert (raw == FAR_SENTINEL).any() and (raw < FAR_SENTINEL).any()
        assert (raw.diff(dim=1) >= 0).all() and not (raw == 0).any()
    for key in ("raw_distance", "distances", "raw_points", "points"):
        np.testing.assert_allclose(tx[key].numpy(), _np(jx[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


# ---- the general path


def _general_cfg(case):
    """(config, rays, dataset_info or None) of a general-path case."""
    if case.startswith("dynamic"):
        cfg = flagship_cfg(tiny=True, fused=False, bf16_tables=False)
        rays = sentinel_rays(N_RAYS, seed=5)
    elif case.startswith("static"):
        cfg = static_cfg(S=16, fused=False, bf16_tables=False)
        rays = sentinel_rays(N_RAYS, seed=6, static=True)
    else:
        cfg = n3d_cfg(16, fused=False, bf16_tables=False)
        rays = sentinel_rays(N_RAYS, seed=7)
    if case.endswith("compact"):
        cfg = JP.with_compact_samples(cfg, 4)
    else:
        cfg = JP.with_inference_samples(cfg, 4)
    return cfg, rays


GENERAL = ["dynamic_compact", "static_compact", "n3d_compact",
           "dynamic_stride", "static_stride", "n3d_stride"]


@pytest.mark.parametrize("case", GENERAL)
def test_general_path_matches_jax(case):
    """Each stage on the general stage chain and the general colour net,
    f32 policy and tables: rgb and depth within F32_TOL; no inf or NaN
    where sentinel distances meet the composite."""
    cfg, rays = _general_cfg(case)
    from hyperreel_tpu_torch.models.model import build_model
    jm, tm = models(cfg, bf16=False,
                    info={"num_keyframes": 4, "num_frames": 50})
    assert jm._cf_eval is None and tm._cf_eval is None
    jp, tp = weights(jm, seed=8, density=0.5)
    a, b, err = _both(jm, tm, jp, tp, rays, {"fields": ["distances"]})
    assert err <= F32_TOL, err
    da, db = _np(a["distances"]), b["distances"].numpy()
    assert np.isfinite(db).all()
    assert np.abs(da - db).max() <= F32_TOL * max(1.0, np.abs(da).max())
    assert build_model is not None


def test_general_colour_net_with_sentinels():
    """The validity mask drops the sentinel samples (their points lie far
    outside the aabb), and the last valid sample's delta is sentinel - d:
    the colour net's composite on the compacted fields equals the one on
    the same fields with the sentinel samples cut off and the reference's
    1e10 last delta, to f32 rounding."""
    cfg, rays = _general_cfg("dynamic_compact")
    jm, tm = models(cfg, bf16=False,
                    info={"num_keyframes": 4, "num_frames": 50})
    _, tp = weights(jm, seed=8, density=0.5)
    ctx = StepCtx(it=IT)
    x = tm.embedding.apply(tp["embedding"], tm.ray_param.apply(
        torch.from_numpy(rays)), ctx)
    d = x["distances"][..., 0]
    sent = d == FAR_SENTINEL
    assert sent.any() and (~sent).any()
    net = tm.color_net
    assert not net.valid_mask(x["points"])[sent].any()
    out = net.apply(tp["color"], x, ctx, {"fields": ["distances"]})
    assert torch.isfinite(out["rgb"]).all()
    assert torch.isfinite(out["distances"]).all()
    # a ray whose kept samples are all valid but its last: cut the
    # sentinel off and the composite must not move
    n_valid = (~sent).sum(1)
    rows = torch.nonzero((n_valid >= 2) & (n_valid < d.shape[1]))[:, 0]
    assert rows.numel() > 0
    for r in rows[:8].tolist():
        k = int(n_valid[r])
        xr = {key: v[r:r + 1, :k] if v.dim() >= 3 and v.shape[1] == d.shape[1]
              else v[r:r + 1] for key, v in x.items()}
        cut = net.apply(tp["color"], xr, ctx)["rgb"]
        full = net.apply(tp["color"], {key: v[r:r + 1] for key, v in
                                       x.items()}, ctx)["rgb"]
        assert (cut - full).abs().max().item() <= F32_TOL


# ---- compaction under the mipnerf contraction: the general chain, then
# the nets' own fused routes (K5 with the weights row; K5 on time planes)


@pytest.mark.parametrize("family", ["llff", "n3d"])
def test_own_route_with_sentinels_matches_jax(family, f32_acc):
    if family == "llff":
        cfg = static_cfg(S=8)
        rays = sentinel_rays(N_RAYS, seed=11, static=True)
    else:
        cfg = n3d_cfg(8)
        rays = sentinel_rays(N_RAYS, seed=12)
    cfg = JP.with_compact_samples(cfg, 4)
    jm, tm = models(cfg, bf16=False,
                    info={"num_keyframes": 4, "num_frames": 50})
    assert not jax_fused_eval.cf_eligible(jm) and jm._cf_eval is None
    assert not fused_eval.cf_eligible(tm) and tm._cf_eval is None
    assert tm.color_net.fused_render and tm.color_net.fused_eligible
    jp, tp = weights(jm, seed=13, density=0.5)
    _, _, err = _both(jm, tm, jp, tp, rays)
    assert err <= F32_TOL, err


# ---- K1's plain version against the JAX kernel


@pytest.mark.parametrize("S,k,stride", [(8, 4, None), (16, 4, 4)],
                         ids=["compact_4_of_8", "stride_4_of_16"])
def test_plain_pack_keeps_the_jax_kernels_samples(S, k, stride):
    """The tail alone (the same MLP output on both sides): compaction
    keeps the first k sorted distances with the sentinel, stride every
    stride-th; the flow, offset and colour fields come from the
    prediction rows at the kept positions (the sort carries no payload).
    The predicted z offsets leave the distances out of their anchors'
    order on some rays, so that sorted position and sample differ."""
    cfg = JP.with_compact_samples(tiny_flagship(S), k) if stride is None \
        else JP.with_inference_samples(tiny_flagship(S), k)
    jm, tm = models(cfg, bf16=False)
    spec = tm._cf_eval.spec
    assert (spec.S, spec.k, spec.stride) == (S, k, stride)
    assert (spec.far_sentinel == FAR_SENTINEL) == (stride is None)
    mlp, rays = _inputs(S, spec.P, seed=S + k)
    rays[::2, 2] = np.random.default_rng(1).uniform(
        -0.9, 0.9, rays.shape[0] // 2)
    cf = jm._cf_eval
    want = _jax_pack(jm, mlp, rays, IT, k=k, stride=stride,
                     far_sentinel=FAR_SENTINEL if stride is None else None)
    want = pack_from_smajor(torch.from_numpy(want), k, 128)
    got = PB.tail_plain(torch.from_numpy(mlp), torch.from_numpy(rays),
                        spec, IT)
    assert got.shape == (PACK_ROWS, rays.shape[0] * k)
    # f32 elementwise math on both sides, the same operation order
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err
    dist = got[3].reshape(-1, k)
    assert (dist.diff(dim=1) >= 0).all()
    if stride is None:
        assert (dist == FAR_SENTINEL).any() and (dist < FAR_SENTINEL).any()
    # the unsorted distances, from the plain version's own arithmetic
    dsc = spec.terms(IT)
    rows3 = torch.from_numpy(mlp).reshape(-1, spec.P, S)
    z = PB.apply_terms(PB.apply_terms(rows3[:, spec.foff["z"]], dsc["z"]),
                       dsc["isect"])
    z = z * (1 - PB.apply_terms(rows3[:, spec.foff["sigma"]],
                                dsc["sigma"]))
    z = z * torch.from_numpy(spec.z_scale) + torch.from_numpy(spec.samples)
    r = torch.from_numpy(rays)
    raw = (z - r[:, 2:3]) / torch.where(r[:, 5:6].abs() < 1e-5,
                                        torch.full_like(r[:, 5:6], 1e12),
                                        r[:, 5:6])
    order = torch.where(raw <= 0, torch.full_like(raw, FAR_SENTINEL),
                        raw).argsort(dim=1)
    assert (order[:, spec.kept()] != torch.arange(S)[spec.kept()]).any()
    assert cf.S == S


# ---- the fused path against the JAX FusedCFEval


def _spy_jax_pack_build(monkeypatch):
    calls = []
    real = jax_pack_build_mod.pack_build

    def spy(*args, **kw):
        calls.append(kw.get("stride"))
        return real(*args, **kw)

    monkeypatch.setattr(jax_pack_build_mod, "pack_build", spy)
    return calls


@functools.lru_cache(maxsize=None)
def _fused_models(case, bf16):
    """(jax model, port model, jax params, port params) of a fused case."""
    info = {"num_keyframes": 4, "num_frames": 50}
    if case == "shiny_compact":
        cfg = JP.with_compact_samples(rgb_cfg("shiny", S=8), 4)
    elif case == "n3d_stride":
        cfg = JP.with_inference_samples(n3d_cfg(16), 4)
    elif case.startswith("flagship_stride"):
        S = 8 if case == "flagship_stride2" else 16
        cfg = JP.with_inference_samples(tiny_flagship(S), 4)
    elif case == "flagship_compact_bf16":
        cfg = JP.with_compact_samples(flagship_cfg(), 16)
    else:
        cfg = JP.with_compact_samples(flagship_cfg(tiny=True), 4)
        if case != "flagship_compact":
            cfg = JP.with_coherent_gather(cfg, 5, 2, 8)
    jm, tm = models(cfg, bf16=bf16, info=info)
    jp, tp = weights(jm, seed=21, density=0.6)
    return jm, tm, jp, tp


# (case, bf16 MLP policy, rays, render_kwargs, expected K1 stride on the
# JAX side: "legacy" for its XLA tail)
FUSED = [
    ("flagship_compact", False, "sentinel", {}, None),
    ("flagship_compact_bf16", True, "sentinel", {}, None),
    ("flagship_stride2", False, "sentinel", {}, "legacy"),
    ("flagship_stride4", False, "sentinel", {}, 4),
    ("shiny_compact", False, "sentinel_static", {}, None),
    ("n3d_stride", False, "sentinel", {}, 4),
    ("n3d_stride", False, "sentinel", {"uniform_time": True}, 4),
]


@pytest.mark.parametrize("case,bf16,rays,rk,jax_route", FUSED, ids=[
    f"{c}-{'uniform_t' if rk else 't_per_ray'}" for c, _, _, rk, _ in FUSED])
def test_fused_route_matches_jax(case, bf16, rays, rk, jax_route,
                                 monkeypatch, f32_acc):
    """K1 with compaction or the stride, then the shade kernel at S = k
    (K2 for the flagship, K5 for shiny and n3d) against the JAX
    FusedCFEval: rgb within fused_tol, depth (up to ~3 in these scenes)
    within ten times it. Stride 2 is held
    against the JAX package's XLA tail, where it sends that stride."""
    jm, tm, jp, tp = _fused_models(case, bf16)
    assert jm._cf_eval is not None and tm._cf_eval is not None
    calls = _spy_jax_pack_build(monkeypatch)
    rays = sentinel_rays(N_RAYS, seed=23, static=rays.endswith("static"))
    a, b, err = _both(jm, tm, jp, tp, rays, {**rk, "fields": ["distances"]})
    assert calls == ([] if jax_route == "legacy" else [jax_route])
    assert err <= fused_tol(bf16), err
    derr = np.abs(_np(a["distances"]) - b["distances"].numpy()).max()
    assert np.isfinite(b["distances"].numpy()).all()
    assert derr <= fused_tol(bf16) * 10, derr
    assert _np(a["rgb"]).std() > 0.01


PATCH = [("flagship_compact_patch", fused, pm, oz)
         for fused in ("1", "0") for pm, oz in ((True, -1.5), (True, 0.5),
                                                (False, 0.5))]


@pytest.mark.parametrize("case,fused,pm,oz", PATCH, ids=[
    f"{'fused' if f == '1' else 'two_kernel'}-"
    f"{'phase_major' if pm else 'scanline'}-oz{oz}" for _, f, pm, oz in PATCH])
def test_compact_patch_route_matches_jax(case, fused, pm, oz, monkeypatch,
                                        f32_acc):
    """Compaction on the flagship's patch routes (K3; K4 + K2-preblended)
    at S = k over a 32x32 crop of the bench camera, f32 MLP policy: rgb
    within F32_TOL on K3, at the fused-path gate on K4 + K2-preblended (K4
    rounds the blended features to bf16, where a sum in another order can
    land on the other side of a rounding boundary; 2.2e-5 here), and the
    coverage witness equal. With the camera at z = 0.5, inside the plane
    stack, half of the kept samples are sentinels, whose coordinates the
    patch anchors see (they take every ray of a block, valid or not)."""
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH", fused)
    jm, tm, jp, tp = _fused_models(case, False)
    rays = crop_rays()
    rays[:, 2] = oz
    if pm:
        rays = phase_major(rays, 8)
    a, b, err = _both(jm, tm, jp, tp, rays,
                      {"rays_phase_major": pm, "uniform_time": True})
    assert err <= (F32_TOL if fused == "1" else FUSED_TOL), err
    va, vb = float(a["patch_coverage_viol"]), float(b["patch_coverage_viol"])
    assert va == vb, (va, vb)
    d = tm._cf_eval
    assert d.k == 4 and d.spec.far_sentinel == FAR_SENTINEL


MULTI_PATCH = [(fused, pm) for fused in ("1", "0") for pm in (True, False)]


@pytest.mark.parametrize("fused,pm", MULTI_PATCH, ids=[
    f"{'K6' if f == '1' else 'K4x3_K5pre'}-"
    f"{'phase_major' if pm else 'scanline'}" for f, pm in MULTI_PATCH])
def test_multi_axis_patch_routes_at_k_match_jax(fused, pm, monkeypatch,
                                                f32_acc):
    """Compaction on shiny's multi-axis patch routes at S = k (K6, or K4
    per plane then K5-preblended) with the camera among the planes, f32
    MLP policy: rgb within F32_TOL on K6, at the fused-path gate on the
    two-kernel route (K4's bf16 features), the witness equal."""
    monkeypatch.setenv("HYPERREEL_FUSED_PATCH_MULTI", fused)
    cfg = JP.with_coherent_gather(
        JP.with_compact_samples(rgb_cfg("shiny", S=8), 4), 5, 2, 8)
    jm, tm = models(cfg, bf16=False)
    assert tm._cf_eval is not None and tm._cf_eval.k == 4
    jp, tp = weights(jm, seed=41, density=0.6)
    rays = crop_rays()[:, :6].copy()
    rays[:, 2] = 0.5
    if pm:
        rays = phase_major(rays, 8)
    a, b, err = _both(jm, tm, jp, tp, rays, {"rays_phase_major": pm})
    assert err <= (F32_TOL if fused == "1" else FUSED_TOL), err
    assert float(a["patch_coverage_viol"]) == float(
        b["patch_coverage_viol"])


# ---- what the fused path refuses


def _refused(name):
    dyn = flagship_cfg(tiny=True)
    if name == "stride_and_compact":
        return JP.with_compact_samples(JP.with_inference_samples(dyn, 4), 4)
    if name == "compact_not_pow2":
        return JP.with_compact_samples(dyn, 3)
    if name == "stride_not_pow2":
        return JP.with_inference_samples(dyn, 3)
    if name == "compact_mode_stride":
        cfg = JP.with_compact_samples(dyn, 4)
        cfg["embedding"]["embeddings"]["select_points_compact"]["mode"] = \
            "stride"
        return cfg
    if name == "stride_mode_first":
        cfg = JP.with_inference_samples(dyn, 4)
        cfg["embedding"]["embeddings"]["select_points_inference"][
            "mode"] = "first"
        return cfg
    if name == "compact_without_sort_far":
        cfg = JP.with_compact_samples(dyn, 4)
        cfg["embedding"]["embeddings"]["ray_intersect_0"]["intersect"][
            "invalid_sort_far"] = False
        return cfg
    if name == "compact_mipnerf_static":
        return JP.with_compact_samples(static_cfg(S=8), 4)
    return JP.with_compact_samples(n3d_cfg(8), 4)


REFUSED = ["stride_and_compact", "compact_not_pow2", "stride_not_pow2",
           "compact_mode_stride", "stride_mode_first",
           "compact_without_sort_far", "compact_mipnerf_static",
           "compact_mipnerf_n3d"]


@pytest.mark.parametrize("name", REFUSED)
def test_refused_chains_take_the_general_path_as_in_jax(name, f32_acc):
    """Both packages refuse the channels-first route for the same chains;
    the port's general chain and the net's own route then match JAX's."""
    jm, tm = models(_refused(name), bf16=False,
                    info={"num_keyframes": 4, "num_frames": 50})
    assert not jax_fused_eval.cf_eligible(jm)
    assert not fused_eval.cf_eligible(tm) and tm._cf_eval is None
    jp, tp = weights(jm, seed=31, density=0.5)
    rays = sentinel_rays(N_RAYS, seed=32,
                         static=name == "compact_mipnerf_static")
    _, _, err = _both(jm, tm, jp, tp, rays)
    assert err <= F32_TOL, err


@pytest.mark.parametrize("name,make", [
    ("flagship_compact", lambda P: P.with_compact_samples(
        P.tiny_dynamic(), 4)),
    ("flagship_stride", lambda P: P.with_inference_samples(
        P.tiny_dynamic(), 4)),
    ("shiny_compact", lambda P: P.with_compact_samples(
        P.tiny_shiny(sample_stages=False), 4)),
    ("n3d_stride", lambda P: P.with_inference_samples(
        P.tiny_neural_3d(16), 4))])
def test_cf_eligible_takes_what_jax_takes(name, make):
    from hyperreel_tpu_torch.configs import presets as TP
    cfg = JP.convert_epochs_to_iters(make(JP), 4000)
    cfg["color"]["net"].update(fused_render=True, bf16_tables=True)
    if name.startswith("n3d"):
        cfg["color"]["net"].update(n_lamb_sigma=[8, 4, 4],
                                   n_lamb_sh=[8, 4, 4])
    jm, tm = models(cfg, bf16=False)
    assert jax_fused_eval.cf_eligible(jm) and fused_eval.cf_eligible(tm)
    if name != "shiny_compact":
        assert make(TP) == make(JP)


def test_params_carry_the_stage():
    """The stage has empty params in both packages; the weights bridge
    carries them and the port's own init has the same tree."""
    cfg = JP.with_compact_samples(flagship_cfg(tiny=True), 4)
    jm, tm = models(cfg, bf16=False)
    pn = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    assert pn["embedding"]["select_points_compact"] == {}
    tp = params_from_jax(pn, device="cpu")
    assert tp["embedding"]["select_points_compact"] == {}
    own = tm.init(torch.Generator().manual_seed(0), "cpu")
    assert own["embedding"]["select_points_compact"] == {}
    assert set(own["embedding"]) == set(tp["embedding"])
