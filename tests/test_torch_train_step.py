"""The flagship's training step and loop (hyperreel_tpu_torch/train/)
against the JAX package's Trainer on the tiny dynamic model
(tiny_dynamic, the f32 MLP policy and f32 tables, epochs of 50
iterations as tests/test_training.py runs it), on the blob scene:

  * one step's loss and every gradient leaf against jax.value_and_grad of
    Trainer._loss_and_metrics, the background coin computed from the same
    key (fold_in(key, 202)) and injected into the port's ctx;
  * the port continuing the JAX trainer's optimizer state (convert.py);
  * a 30-step fit across an alpha-mask event that shrinks the aabb (at 10)
    and an upsample 16^3 -> 24^3 voxels (at 20), with steps_per_call 1
    and 5: the history at every log point, the params, grid_size, aabb
    and the optimizer's counters after; then the trained model's rgb
    through the port's quad route against JAX model.apply;
  * save, restore into a fresh model and trainer, resume: equal to the
    uninterrupted run;
  * the blob scene itself.

The training comparisons move the aabb's z faces to +-1.5: with the
preset's [-1, 1] the outermost z-plane anchors lie on the faces, where
the validity test keeps or drops a sample by its last ulp, and XLA's
compiled step rounds those points differently from its own eager
evaluation (ROADMAP.md 3, samples on the aabb's face), so no two
implementations follow one trajectory there.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs.presets import (
    convert_epochs_to_iters, tiny_dynamic)
from hyperreel_tpu.data.synthetic import gaussian_blob_scene as jax_scene
from hyperreel_tpu.models.ctx import StepCtx as JaxCtx
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.model import build_model as build_jax
from hyperreel_tpu.train.regularizers import tv_4000_defaults as jax_tv
from hyperreel_tpu.train.trainer import Trainer as JaxTrainer
from hyperreel_tpu.train.trainer import TrainState as JaxState
from hyperreel_tpu_torch.convert import opt_state_from_jax, params_from_jax
from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model as build_torch
from hyperreel_tpu_torch.ops.kernels.pack_build import pack_build
from hyperreel_tpu_torch.ops.kernels.shade import shade
from hyperreel_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from hyperreel_tpu_torch.train.optim import tree_leaves
from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
from hyperreel_tpu_torch.train.trainer import Trainer, TrainState

from torch_parity import f32_acc
from torch_train_parity import (
    BATCH, IPE, jax_batches, max_param_err, training_cfg)

assert f32_acc      # the fixture, imported for the tests' use

def model_cfg(events=False, bf16_tables=False):
    cfg = convert_epochs_to_iters(tiny_dynamic(), iters_per_epoch=IPE)
    net = cfg["color"]["net"]
    net.update(aabb=[[-2.0, -2.0, -1.5], [2.0, 2.0, 1.5]],
               bf16_tables=bf16_tables)
    if events:
        net.update(upsamp_list=[20], update_AlphaMask_list=[10],
                   N_voxel_init=16 ** 3, N_voxel_final=24 ** 3)
    return cfg


def scene():
    return gaussian_blob_scene(n_views=2, wh=(12, 12), dynamic=True,
                               num_frames=4, num_keyframes=2, device="cpu")


_INIT = {}     # JAX init weights by (config, seed), made once


def start(cfg, ds, spc=1, seed=0):
    """(JAX trainer, its state, port trainer, its state) from one set of
    weights: JAX's init with the density grids redrawn uniform in [0, 1)
    and a third of each space plane's columns empty, so that the alpha
    event finds an occupied box inside the aabb."""
    jm = build_jax(copy.deepcopy(cfg), dataset_info=ds.info())
    tm = build_torch(copy.deepcopy(cfg), dataset_info=ds.info())
    jt = JaxTrainer(jm, training_cfg(spc), regularizer_cfgs=jax_tv(),
                    iters_per_epoch=IPE)
    tt = Trainer(tm, training_cfg(spc), regularizer_cfgs=tv_4000_defaults(),
                 iters_per_epoch=IPE, device="cpu")
    key = (repr(cfg), seed)
    if key not in _INIT:
        _INIT[key] = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(seed)))
    pn = copy.deepcopy(_INIT[key])
    rng = np.random.default_rng(seed + 1)
    for k, v in pn["color"]["density"].items():
        v = rng.uniform(0, 1, v.shape).astype(np.float32)
        if k.startswith("space"):
            v[:, : v.shape[1] // 3] = 0.0
        pn["color"]["density"][k] = v
    jp = jax.tree.map(jnp.asarray, pn)
    js = JaxState(params=jp, opt_state=jt._make_optimizer(jp).init(jp), it=0)
    tp = params_from_jax(pn, device="cpu")
    ts = TrainState(tp, tt.make_optimizer(tp).init(tp), 0)
    return jt, js, tt, ts


def coin(key):
    return float(jax.random.uniform(jax.random.fold_in(key, 202), ()))


# One step under the f32 policy (f32 MLP, f32 tables): the same f32 ops,
# the lookups' gradients summed in another order; every gradient leaf
# within 1e-5 of its largest entry, the loss and metrics within 1e-6
# relative. Under the bench's bf16 policy (bf16 MLP and tables) both sides
# store each MLP layer in bf16 and round the grid gradients to bf16 once:
# an f32 sum in another order can land on the other side of a rounding
# boundary and move what it feeds by a bf16 ulp (2^-8), so the loss is held
# to 1e-4 relative and each gradient leaf to 2e-2 of its largest entry.
@pytest.mark.parametrize("policy,it,tol", [("f32", 0, 1e-5),
                                           ("f32", 160, 1e-5),
                                           ("bf16", 160, 2e-2)])
def test_one_step_loss_and_gradients_match_jax(policy, it, tol):
    ds = scene()
    bf16 = policy == "bf16"
    cfg = model_cfg(bf16_tables=bf16)
    jt, js, tt, ts = start(cfg, ds)
    if bf16:
        jt.model = build_jax(copy.deepcopy(cfg), dataset_info=ds.info(),
                             compute_dtype=jnp.bfloat16)
        tt.model = build_torch(copy.deepcopy(cfg), dataset_info=ds.info(),
                               compute_dtype=torch.bfloat16)
    batch = next(ds.batch_iterator(BATCH, seed=3))
    key = jax.random.PRNGKey(it + 1)
    ctx = JaxCtx(it=jnp.asarray(it, jnp.int32), rng=key, training=True)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        jt._loss_and_metrics, has_aux=True))(
        js.params, {k: jnp.asarray(v) for k, v in batch.items()}, ctx)
    _, tm, tg = tt.grads(ts.params, tt.to_device(batch), StepCtx(
        it=it, training=True, draws={"background": coin(key)}))
    for k in ("loss", "image_loss", "psnr"):
        assert float(tm[k]) == pytest.approx(
            float(jm[k]), rel=1e-4 if bf16 else 1e-6), k
    want = params_from_jax(jax.tree.map(np.asarray, jg), device="cpu")
    for path, w in tree_leaves(want):
        scale = w.abs().max().item()
        assert scale > 0, path
        assert (tg[path] - w).abs().max().item() <= tol * scale, path


# Three JAX steps, then the port continues from JAX's params and optimizer
# state (Adam at count 3): one more step on each side, the params within
# 1e-6 (a few f32 ulps of the updates).
def test_port_continues_the_jax_optimizer_state():
    ds = scene()
    jt, js, tt, _ = start(model_cfg(), ds)
    step, _ = jt.get_train_step(js.params)
    batches = ds.batch_iterator(BATCH, seed=4)
    params, ost = js.params, js.opt_state
    for i in range(3):
        params, ost, _ = step(params, ost, {k: jnp.asarray(v) for k, v in
                                            next(batches).items()},
                              jnp.asarray(i, jnp.int32),
                              jax.random.PRNGKey(10 + i))
    pn = jax.tree.map(np.asarray, params)
    tp = params_from_jax(pn, device="cpu")
    tstate = TrainState(tp, opt_state_from_jax(
        jax.tree.map(np.asarray, ost), tt.model.param_groups(tp), "cpu"), 3)
    assert tstate.opt_state["count"] == {"color": 3, "color_impl": 3,
                                         "embedding": 3, "embedding_impl": 3}
    b = next(batches)
    key = jax.random.PRNGKey(13)
    params, ost, _ = step(params, ost, {k: jnp.asarray(v) for k, v in
                                        b.items()},
                          jnp.asarray(3, jnp.int32), key)
    tstate, _ = tt.step(tstate, tt.to_device(b),
                        tt.make_optimizer(tstate.params),
                        draws={"background": coin(key)})
    assert max(max_param_err(params, tstate.params).values()) <= 1e-6


def record_jax_draws(jt):
    """Wrap the JAX trainer's compiled steps to record each step's
    background coin by iteration, and clear its compiled-step cache at
    every grid event: the cache is keyed on the param shapes, so after the
    dynamic net's shrink (which changes only the aabb) it would keep
    running the step traced with the old aabb baked in until the next
    shape change (ROADMAP.md 3)."""
    coins = {}
    one, scan, event = jt.get_train_step, jt.get_train_step_scan, \
        jt.apply_event

    def get_one(params):
        fn, opt = one(params)

        def run(p, o, batch, it, rng):
            coins[int(it)] = coin(rng)
            return fn(p, o, batch, it, rng)
        return run, opt

    def get_scan(params, k):
        fn, opt = scan(params, k)

        def run(p, o, batches, its, rngs):
            for i, r in zip(np.asarray(its), rngs):
                coins[int(i)] = coin(r)
            return fn(p, o, batches, its, rngs)
        return run, opt

    def apply_event(state, it):
        jt._step_cache.clear()
        return event(state, it)

    jt.get_train_step, jt.get_train_step_scan = get_one, get_scan
    jt.apply_event = apply_event
    return coins


# 30 steps: the history within 1e-5 relative at every log point, the params
# within 1e-4 (Adam's normalized update turns f32 rounding differences of
# near-zero gradients into differences of the updates; measured ~1e-5),
# grid_size and aabb equal.
@pytest.mark.parametrize("spc", [1, 5])
def test_fit_across_grid_events_matches_jax(spc, f32_acc):
    ds = scene()
    cfg = model_cfg(events=True)
    jt, js, tt, ts = start(cfg, ds, spc=spc)
    coins = record_jax_draws(jt)
    js, jh = jt.fit(js, jax_batches(ds), 30, jax.random.PRNGKey(1),
                    log_every=5)
    ts, th = tt.fit(ts, ds.batch_iterator(BATCH, seed=0), 30, log_every=5,
                    draws=lambda it: {"background": coins[it]})
    assert [h["it"] for h in th] == [h["it"] for h in jh] == \
        list(range(5, 31, 5))
    for a, b in zip(jh, th):
        for k in ("loss", "image_loss", "psnr"):
            assert b[k] == pytest.approx(a[k], rel=1e-5), (a["it"], k)
    jnet, tnet = jt.model.color_net, tt.model.color_net
    assert tnet.grid_size == jnet.grid_size != [20, 20, 15]
    np.testing.assert_array_equal(tnet.aabb, jnet.aabb)
    assert max(max_param_err(js.params, ts.params).values()) <= 1e-4
    assert ts.opt_state["count"] == {"color": 10, "embedding_impl": 10}
    if spc != 1:
        return
    # the alpha event shrank the aabb (the empty third of the space plane)
    assert tnet.aabb[0][0] > -2.0
    # the trained model through the port's quad route (the plain versions
    # of K1 and K2 on the CPU) against JAX model.apply (its fused route)
    # on bf16 tables: the 2e-4 gate of tests/test_fused_cf.py
    ecfg = copy.deepcopy(cfg)
    ecfg["color"]["net"]["bf16_tables"] = True
    jm = build_jax(copy.deepcopy(ecfg), dataset_info=ds.info())
    tm = build_torch(copy.deepcopy(ecfg), dataset_info=ds.info())
    for m in (jm, tm):
        m.color_net.aabb = np.array(jnet.aabb)
        m.color_net.grid_size = list(jnet.grid_size)
    assert jm._cf_eval is not None and tm._cf_eval is not None
    rays = ds.image(3)["rays"][::2]
    want = np.asarray(jm.apply(js.params, jnp.asarray(rays),
                               make_ctx(it=30, training=False))["rgb"])
    launches = (pack_build.launches, shade.launches)
    got = tm.apply(params_from_jax(jax.tree.map(np.asarray, js.params),
                                   device="cpu"),
                   torch.from_numpy(rays), StepCtx(it=30))["rgb"].numpy()
    assert (pack_build.launches, shade.launches) == launches   # CPU: plain
    assert np.abs(got - want).max() <= 2e-4


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """Save after the upsample (a grid and aabb other than the preset's),
    restore into a fresh model and trainer, go on: the params, history and
    optimizer state equal those of one run without the break."""
    ds = scene()
    cfg = model_cfg(events=True)
    draws = lambda it: {"background": (it * 0.37) % 1.0}     # noqa: E731
    _, _, tt, ts = start(cfg, ds)
    batches = ds.batch_iterator(BATCH, seed=0)
    ts, hist = tt.fit(ts, batches, 26, log_every=1, draws=draws)
    # the steps differentiate copies: the state's params stay plain
    # tensors, and the trained model applied to them records nothing
    assert not any(v.requires_grad for _, v in tree_leaves(ts.params))
    rays = torch.from_numpy(ds.image(0)["rays"][:64])
    assert not tt.model.apply(ts.params, rays,
                              StepCtx(it=26))["rgb"].requires_grad
    _, _, t1, s1 = start(cfg, ds)
    batches = ds.batch_iterator(BATCH, seed=0)
    s1, h1 = t1.fit(s1, batches, 22, log_every=1, draws=draws)
    save_checkpoint(tmp_path / "ckpt", s1, t1.model)
    t2 = Trainer(build_torch(copy.deepcopy(cfg), dataset_info=ds.info()),
                 training_cfg(), regularizer_cfgs=tv_4000_defaults(),
                 iters_per_epoch=IPE, device="cpu")
    assert t2.model.color_net.grid_size != t1.model.color_net.grid_size
    s2 = restore_checkpoint(tmp_path / "ckpt", t2)
    assert s2.it == 22
    assert t2.model.color_net.grid_size == t1.model.color_net.grid_size
    np.testing.assert_array_equal(t2.model.color_net.aabb,
                                  t1.model.color_net.aabb)
    s2, h2 = t2.fit(s2, batches, 4, log_every=1, draws=draws)
    assert h1 + h2 == hist
    for path, v in tree_leaves(ts.params):
        assert torch.equal(dict(tree_leaves(s2.params))[path], v), path
    assert s2.opt_state["count"] == ts.opt_state["count"]


def test_blob_scene_matches_jax():
    """The rays and the sampler are the JAX package's to the bit; the
    march in torch gives its numpy march's colours within 1e-5 (f32
    rounding of the exponentials and the transmittance product)."""
    kw = dict(n_views=2, wh=(10, 8), dynamic=True, num_frames=3,
              num_keyframes=2)
    want, got = jax_scene(**kw), gaussian_blob_scene(**kw, device="cpu")
    np.testing.assert_array_equal(got.all_coords, want.all_coords)
    assert np.abs(got.all_rgb - want.all_rgb).max() <= 1e-5
    assert got.info() == want.info()
    for a, b in zip(got.batch_iterator(16, seed=2),
                    want.batch_iterator(16, seed=2)):
        np.testing.assert_array_equal(a["rays"], b["rays"])
        break
    np.testing.assert_array_equal(got.image(1)["rays"],
                                  want.image(1)["rays"])
