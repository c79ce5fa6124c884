"""The sample stages and the chain's training-time behaviours against the
JAX package's, and the dynamic presets' training steps:

  * generate_samples and select_points in training (the drawn count n, the
    JAX package's fold_in(rng, 404) injected as the draw "num_samples";
    each sample replaced by the next kept one), on tiny_shiny's chain and
    on a state of 32 samples; always_slice; the eval count from
    generate_samples' inference_samples_static;
  * per-stage wait/stop gating at `it` inside and outside the window,
    point_offset's dropout on and off its frequency and past stop_iter,
    save_points_field of point_offset and advect_points;
  * the sample-stage tiny_shiny's eval route (the general chain and the
    net's own fused route, in both packages) and its rgb;
  * one training step of tiny_neural_3d and tiny_immersive_sphere (the
    loss and every gradient leaf), tiny_neural_3d's also under the bench's
    bf16 policy.
tiny_shiny's fit with its sample stages: tests/test_torch_train_static_fit.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.embeddings_extra import (
    SelectPointsEmbedding as JaxSelect)
from hyperreel_tpu_torch.convert import params_from_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.embeddings_extra import SelectPointsEmbedding

from torch_parity import f32_acc, models, static_rays
from torch_train_parity import (
    BATCH, grad_errors, init_weights, one_step, preset_cfg, scene, start)

assert f32_acc      # the fixture, imported for the tests' use

IT = 20000
# the chains' fields: the same f32 MLP and intersect in both packages
CHAIN_TOL = 1e-5


_PAIRS = {}     # (JAX model, port model, JAX params, port params, JAX
                # chains compiled) by config, made once


def _chains(cfg, info=None):
    """The pair of models of `cfg` and their weights (`init_weights`) in
    both layouts."""
    key = repr((cfg, info))
    if key not in _PAIRS:
        jm, tm = models(cfg, bf16=False, info=info or {})
        pn = init_weights(tm)
        _PAIRS[key] = (jm, tm, jax.tree.map(jnp.asarray, pn),
                       params_from_jax(pn, device="cpu"), {})
    return _PAIRS[key]


def _embed(pair, rays, it, training, key=None, draws=None, rk=None):
    """Both chains' outputs on `rays` at `it` (the JAX chain compiled with
    its ctx an argument, as its trainer runs it): (JAX dict, port
    dict)."""
    jm, tm, jp, tp, compiled = pair
    if repr(rk) not in compiled:
        compiled[repr(rk)] = jax.jit(lambda p, r, ctx: jm.embedding.apply(
            p, jm.ray_param.apply(r), ctx, rk))
    key = jax.random.PRNGKey(0) if key is None else key
    a = compiled[repr(rk)](jp["embedding"], jnp.asarray(rays),
                           make_ctx(it=it, rng=key, training=training))
    b = tm.embedding.apply(tp["embedding"], tm.ray_param.apply(
        torch.from_numpy(rays)), StepCtx(it=it, training=training,
                                         draws=dict(draws or {})), rk)
    return a, b


def _same_state(a, b, tol=CHAIN_TOL):
    assert sorted(a) == sorted(b)
    for k, v in a.items():
        got = b[k]
        want = np.asarray(v)
        assert tuple(got.shape) == want.shape, k
        assert np.abs(got.detach().numpy() - want).max() <= tol, k


def _num_samples_key(n, lo, hi):
    """A key whose fold_in(key, 404) uniform draws the count n in [lo,
    hi], and that uniform."""
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        u = float(jax.random.uniform(jax.random.fold_in(key, 404), ()))
        if round(u * (hi - lo) + lo) == n:
            return key, u
    raise AssertionError(n)


# tiny_shiny's chain at S = 8, its count drawn in [4, 8]: n = 5 keeps
# every round(8 / 5) = 2nd sample, 6 every sample, 4 every 2nd, 8 all
@pytest.mark.parametrize("n", [4, 5, 6, 8])
def test_generate_and_select_points_in_training_match_jax(n):
    cfg = preset_cfg("tiny_shiny")
    pair = _chains(cfg)
    jm, tm = pair[:2]
    key, u = _num_samples_key(n, 4, 8)
    rays = static_rays(64, seed=n)
    a, b = _embed(pair, rays, 160, True, key, {"num_samples": u})
    _same_state(a, b)
    # the stages' own state (before extract_fields drops it)
    jstate = dict(jm.embedding.stages)["generate_samples_0"].apply(
        {}, {"rays": jnp.asarray(rays)}, make_ctx(it=160, rng=key))
    tstate = dict(tm.embedding.stages)["generate_samples_0"].apply(
        {}, {"rays": torch.from_numpy(rays)},
        StepCtx(it=160, training=True, draws={"num_samples": u}))
    assert float(tstate["num_samples"]) == float(jstate["num_samples"]) == n
    np.testing.assert_array_equal(tstate["rays"].numpy(),
                                  np.asarray(jstate["rays"]))


# the training regime on a state of 32 samples: the gather indices exactly
# (the same f32 stride arithmetic), fields that are not per-sample kept
@pytest.mark.parametrize("n", [3, 5, 7, 11, 16, 32])
def test_select_points_training_gather_matches_jax(n):
    rng = np.random.default_rng(n)
    x = {"points": rng.normal(size=(4, 32, 3)).astype(np.float32),
         "distances": np.sort(rng.uniform(size=(4, 32, 1)), 1).astype(
             np.float32),
         "rays": rng.normal(size=(4, 7)).astype(np.float32),
         "num_samples": np.float32(n), "total_samples": 32}
    a = JaxSelect({}).apply({}, {k: jnp.asarray(v) if k != "total_samples"
                                 else v for k, v in x.items()},
                            make_ctx(it=3))
    b = SelectPointsEmbedding({}).apply(
        {}, {k: torch.tensor(v) if k != "total_samples" else v
             for k, v in x.items()}, StepCtx(it=3, training=True))
    for k in ("points", "distances", "rays"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    d = b["distances"][..., 0]
    kept = np.unique(d.numpy()[0]).size
    stride = max(round(32 / n), 1)
    assert kept == len(range(0, 32, stride))
    assert (d[:, 1:] >= d[:, :-1]).all()        # duplicates: delta 0


# always_slice slices in training as at eval (the compaction preset's
# first-k); at eval the count comes from generate_samples' static one
@pytest.mark.parametrize("case", ["always_slice", "eval_static_count"])
def test_select_points_slicing_matches_jax(case):
    if case == "always_slice":
        cfg = JP.with_compact_samples(preset_cfg("tiny_static"), 4,
                                      always=True)
        training = True
    else:
        cfg = preset_cfg("tiny_shiny")
        st = cfg["embedding"]["embeddings"]["generate_samples_0"]
        st["inference_samples"] = 4
        training = False
    a, b = _embed(_chains(cfg), static_rays(64, seed=2), 160, training,
                  draws={"num_samples": 0.3})
    _same_state(a, b)
    assert b["points"].shape[1] == 4


def _offset_cfg(**stage):
    cfg = preset_cfg("tiny_static")
    cfg["embedding"]["embeddings"]["point_offset_0"].update(stage)
    return cfg


# a gated point_offset (wait 300, stop 600: past the point sigma's ease
# window, which zeroes the offset until 200) that saves the points it
# moves: inside the window its output; outside, the points and
# point_offset it changed keep their earlier values and the fields it adds
# are zeros
@pytest.mark.parametrize("it", [250, 400, 700])
def test_stage_gating_matches_jax(it):
    cfg = _offset_cfg(wait_iters=300, stop_iters=600,
                      save_points_field="raw_pts")
    pair = _chains(cfg)
    assert pair[0]._cf_eval is None and pair[1]._cf_eval is None
    rk = {"fields": ["raw_pts", "offset", "point_offset"]}
    a, b = _embed(pair, static_rays(64, seed=3), it, True, rk=rk)
    _same_state(a, b)
    active = 300 <= it < 600
    assert (b["offset"].abs().max() > 0) == active
    assert (b["raw_pts"].abs().max() > 0) == active


# dropout every 3rd iteration until 600: it 402 zeroes the offset, 403
# and 603 keep it
@pytest.mark.parametrize("it", [402, 403, 603])
def test_point_offset_dropout_matches_jax(it):
    cfg = _offset_cfg(dropout={"frequency": 3, "stop_iter": 600},
                      save_points_field="raw_pts")
    pair = _chains(cfg)
    rk = {"fields": ["raw_pts", "offset"]}
    a, b = _embed(pair, static_rays(64, seed=4), it, True, rk=rk)
    _same_state(a, b)
    assert (b["offset"].abs().max() == 0) == (it == 402)
    # at eval the dropout never applies
    _, e = _embed(pair, static_rays(64, seed=4), 402, False, rk=rk)
    assert e["offset"].abs().max() > 0


def test_advect_points_saves_the_points_before_the_flow():
    cfg = preset_cfg("tiny_neural_3d")
    cfg["embedding"]["embeddings"]["flow_0"]["save_points_field"] = \
        "pre_flow"
    ds = scene("tiny_neural_3d")
    rays = np.ascontiguousarray(ds.all_coords[:64])
    rk = {"fields": ["pre_flow"]}
    a, b = _embed(_chains(cfg, info=ds.info()), rays, 160, True, rk=rk)
    _same_state(a, b)
    assert (b["pre_flow"] - b["points"]).abs().max() > 0


# The sample-stage model at eval: neither package's channels-first route
# takes generate_samples_0 / select_points_0, so both run the general
# chain (every sample kept: inference_samples = S) and the net's own fused
# route (K5 with RGB colour and the weights row; on the CPU its plain
# version), the JAX kernels accumulating in f32: 2e-4, the fused routes'
# gate (tests/test_fused_cf.py)
def test_sample_stage_shiny_eval_route_matches_jax(f32_acc):
    from hyperreel_tpu_torch.configs import presets as TP
    cfg = JP.convert_epochs_to_iters(JP.tiny_shiny(), 4000)
    cfg["color"]["net"]["bf16_tables"] = True
    tcfg = TP.convert_epochs_to_iters(TP.tiny_shiny(), 4000)
    assert tcfg == cfg
    jm, tm, jp, tp, _ = _chains(cfg)
    assert jm._cf_eval is None and tm._cf_eval is None
    assert tm.color_net.fused_ok({}, {})
    rays = static_rays(256, seed=5)
    ctx = make_ctx(it=IT, training=False)
    a = np.asarray(jax.jit(lambda p, r: jm.apply(p, r, ctx)["rgb"])(
        jp, jnp.asarray(rays)))
    b = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT))["rgb"].numpy()
    assert np.isfinite(b).all() and a.std() > 0.01
    assert np.abs(a - b).max() <= 2e-4


# as tests/test_torch_train_static.py: under the f32 policy every gradient
# leaf within 1e-5 of its largest entry (measured <= 6e-6), the loss 1e-6
# relative; under the bf16 policy (bf16 MLP and tables) 2e-2 and 1e-4
# (tests/test_torch_train_regularizers.py)
@pytest.mark.parametrize("name,bf16", [("tiny_neural_3d", False),
                                       ("tiny_immersive_sphere", False),
                                       ("tiny_neural_3d", True)])
def test_dynamic_one_step_matches_jax(name, bf16):
    cfg = preset_cfg(name, bf16_tables=bf16)
    ds = scene(name)
    jt, js, tt, ts = start(cfg, ds, bf16=bf16)
    batch = next(ds.batch_iterator(BATCH, seed=3))
    jm, jg, tm, tg = one_step(jt, js, tt, ts, batch, 160)
    for k in ("loss", "image_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(
            float(jm[k]), rel=1e-4 if bf16 else 1e-6), k
    assert all(torch.isfinite(g).all() for g in tg.values())
    for path, (err, scale) in grad_errors(jg, tg).items():
        assert scale > 0, path
        assert err <= (2e-2 if bf16 else 1e-5) * scale, (path, err, scale)
