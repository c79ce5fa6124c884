"""Shared set-up of the training parity tests (tests/test_torch_train_*.py):
the JAX package's Trainer and the port's on one tiny preset, started from
the same weights and optimizer state, with the JAX step's random draws
computed from its key and injected into the port's StepCtx.

The training comparisons move the aabb's z faces of the z-plane presets
whose outer anchors lie on them (llff, shiny, stanford: [-1, 1]; the
flagship) to +-1.5: there the validity test keeps or drops a sample by its
last ulp, and XLA's compiled step rounds those points differently from
its own eager evaluation (ROADMAP.md 3, samples on the aabb's face), so no
two implementations follow one trajectory there.
"""

import copy

import numpy as np

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.configs import presets as JP
from hyperreel_tpu.models.ctx import StepCtx as JaxCtx
from hyperreel_tpu.models.model import build_model as build_jax
from hyperreel_tpu.train.regularizers import tv_4000_defaults as jax_tv
from hyperreel_tpu.train.trainer import Trainer as JaxTrainer
from hyperreel_tpu.train.trainer import TrainState as JaxState
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.data.synthetic import gaussian_blob_scene
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.model import build_model as build_torch
from hyperreel_tpu_torch.train.optim import tree_leaves
from hyperreel_tpu_torch.train.regularizers import tv_4000_defaults
from hyperreel_tpu_torch.train.trainer import Trainer, TrainState

IPE = 50            # iterations per epoch, as tests/test_training.py
BATCH = 256
DYNAMIC = ("tiny_dynamic", "tiny_neural_3d", "tiny_immersive_sphere")
# the presets whose outer z-plane anchors lie on the aabb's z faces
FACES_ON_ANCHORS = ("tiny_dynamic", "tiny_static", "tiny_shiny",
                    "tiny_stanford_llff")


def training_cfg(spc=1):
    group = {"optimizer": "adam", "lr": 0.02, "lr_scheduler": "exp",
             "decay_epoch": 100, "decay_gamma": 0.125, "warmup_epochs": 0}
    return {"loss": {"type": "mse"}, "batch_size": BATCH,
            "steps_per_call": spc,
            "optimizers": {"color": dict(group),
                           "color_impl": dict(group, lr=0.001),
                           "embedding": dict(group, lr=0.01),
                           "embedding_impl": dict(group, lr=0.00075)}}


def preset_cfg(name, bf16_tables=False, events=False):
    """The JAX package's tiny preset `name` at IPE iterations per epoch,
    with the tables' dtype of the policy and the z faces moved where the
    anchors lie on them; `events`: an alpha
    event at 10 and an upsample 16^3 -> 24^3 voxels at 20, the alpha
    threshold 1e-2, so that the occupied box of `blank_third`'s grids
    after 10 steps is inside the aabb (at 1e-3 tiny_static's 10 steps
    fill it)."""
    cfg = JP.convert_epochs_to_iters(getattr(JP, name)(), IPE)
    net = cfg["color"]["net"]
    net["bf16_tables"] = bf16_tables
    if name in FACES_ON_ANCHORS:
        lo, hi = (list(c) for c in net["aabb"])
        lo[2], hi[2] = -1.5, 1.5
        net["aabb"] = [lo, hi]
    if events:
        net.update(upsamp_list=[20], update_AlphaMask_list=[10],
                   N_voxel_init=16 ** 3, N_voxel_final=24 ** 3,
                   alpha_mask_thre=1e-2)
    return cfg


_SCENES = {}


def scene(name):
    """The blob scene (2 views of 12 x 12 rays; the dynamic presets' at 4
    frames over 2 keyframes), marched once per kind."""
    dynamic = name in DYNAMIC
    if dynamic not in _SCENES:
        _SCENES[dynamic] = gaussian_blob_scene(
            n_views=2, wh=(12, 12), dynamic=dynamic, num_frames=4,
            num_keyframes=2, device="cpu")
    return _SCENES[dynamic]


def blank_third(pn, blank=True):
    """Density grids uniform in [0, 1) with (`blank`) the first third of x
    empty (exact zeros) on every factor over x (the dynamic net's space
    planes; the static net's planes of axes 0 and 1 and the line of axis
    2), so that the alpha event finds an occupied box inside the aabb."""
    rng = np.random.default_rng(1)
    dens = pn["color"]["density"]
    for k, v in dens.items():
        v = rng.uniform(0, 1, v.shape).astype(np.float32)
        if not blank:
            pass
        elif k.startswith("space") or k in ("plane_0", "plane_1"):
            v[:, : v.shape[1] // 3] = 0.0
        elif k == "line_2":
            v[: v.shape[0] // 3] = 0.0
        dens[k] = v


def init_weights(tm, blank=True):
    """Weights (numpy, the JAX package's layout, which has the same tree):
    the port's init from a seeded torch.Generator (the JAX package's
    compiled init takes seconds on the CPU) with the density grids redrawn
    (`blank_third`)."""
    pn = params_to_jax(tm.init(torch.Generator().manual_seed(0), "cpu"))
    blank_third(pn, blank)
    return pn


def start(cfg, ds, bf16=False, regs=None, blank=True):
    """(JAX trainer, its state, port trainer, its state) from one set of
    weights (`init_weights`); the bf16 policy builds both models with bf16
    MLPs. `regs`: the regularizer configs of both (tv_4000 by
    default)."""
    kw = {"compute_dtype": jnp.bfloat16} if bf16 else {}
    jm = build_jax(copy.deepcopy(cfg), dataset_info=ds.info(), **kw)
    tm = build_torch(copy.deepcopy(cfg), dataset_info=ds.info(),
                     compute_dtype=torch.bfloat16 if bf16 else None)
    jt = JaxTrainer(jm, training_cfg(),
                    regularizer_cfgs=regs or jax_tv(), iters_per_epoch=IPE)
    tt = Trainer(tm, training_cfg(),
                 regularizer_cfgs=regs or tv_4000_defaults(),
                 iters_per_epoch=IPE, device="cpu")
    pn = init_weights(tm, blank)
    jp = jax.tree.map(jnp.asarray, pn)
    js = JaxState(params=jp, opt_state=jt._make_optimizer(jp).init(jp), it=0)
    tp = params_from_jax(pn, device="cpu")
    ts = TrainState(tp, tt.make_optimizer(tp).init(tp), 0)
    return jt, js, tt, ts


def jax_batches(ds, seed=0):
    for b in ds.batch_iterator(BATCH, seed=seed):
        yield {k: jnp.asarray(v) for k, v in b.items()}


def draws_of(key, n_points=None):
    """The JAX step's named draws from its key: the background coin
    (fold_in 202), the sample count's uniform (fold_in 404) and, for
    `n_points`, the voxel-sparsity points (the key itself)."""
    out = {"background": float(jax.random.uniform(
        jax.random.fold_in(key, 202), ())),
        "num_samples": float(jax.random.uniform(
            jax.random.fold_in(key, 404), ()))}
    if n_points:
        out["voxel_sparsity"] = np.array(
            jax.random.uniform(key, (n_points, 3)))
    return out


def compiled(fn, *args):
    """fn(*args) through XLA without excess precision: by default XLA's
    fusions keep bf16 values at f32, and under the bf16 MLP policy ~55 %
    of the MLP's outputs then differ by a bf16 ulp from the JAX package's
    own eager math, which the port's general MLP reproduces to the bit
    (ROADMAP.md 3)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def one_step(jt, js, tt, ts, batch, it, seed=1, n_points=None):
    """One step's (JAX metrics, JAX gradients as the port's tree, port
    metrics, port gradients) at `it` on the numpy `batch`."""
    key = jax.random.PRNGKey(seed)
    ctx = JaxCtx(it=jnp.asarray(it, jnp.int32), rng=key, training=True)
    (_, jm), jg = compiled(jax.value_and_grad(
        jt._loss_and_metrics, has_aux=True), js.params,
        {k: jnp.asarray(v) for k, v in batch.items()}, ctx)
    _, tm, tg = tt.grads(ts.params, tt.to_device(batch), StepCtx(
        it=it, training=True, draws=draws_of(key, n_points)))
    return jm, params_from_jax(jax.tree.map(np.asarray, jg), device="cpu"), \
        tm, tg


def grad_errors(want, got):
    """{path: (max |got - want|, max |want|)} over the gradient leaves."""
    return {path: ((got[path] - w).abs().max().item(),
                   w.abs().max().item())
            for path, w in tree_leaves(want)}


def record_jax_draws(jt):
    """Wrap the JAX trainer's compiled step (one step per call) to record
    each step's draws (`draws_of`) by iteration, and clear its
    compiled-step cache at every grid event: the cache is keyed on the
    param shapes, and a step traced before a shrink keeps the old aabb
    baked in until the next shape change (ROADMAP.md 3)."""
    draws = {}
    one, event = jt.get_train_step, jt.apply_event

    def get_one(params):
        fn, opt = one(params)

        def run(p, o, batch, it, rng):
            draws[int(it)] = draws_of(rng)
            return fn(p, o, batch, it, rng)
        return run, opt

    def apply_event(state, it):
        jt._step_cache.clear()
        return event(state, it)

    jt.get_train_step, jt.apply_event = get_one, apply_event
    return draws


def max_param_err(jax_params, port_params):
    """{path: max |port - JAX|} over the param leaves (their shapes
    equal)."""
    want = params_from_jax(jax.tree.map(np.asarray, jax_params),
                           device="cpu")
    got = dict(tree_leaves(port_params))
    errs = {}
    for path, w in tree_leaves(want):
        assert tuple(got[path].shape) == tuple(w.shape), path
        errs["/".join(path)] = (got[path].detach() - w).abs().max().item()
    return errs


def jit_upsample(net):
    """The JAX net's upsample compiled (eager, its twelve resizes take ~9 s
    on the CPU): the same bilinear weights on lattices that XLA may fold
    one f32 ulp apart (tests/test_torch_train_losses.py), the grid_size
    set as the trace runs."""
    upsample = net.upsample
    net.upsample = lambda params, new: jax.jit(
        lambda p: upsample(p, new))(params)


def fit_both(cfg, ds):
    """Both trainers fitted 30 steps from one start, logged every 5, the
    port given the JAX steps' draws: (jt, js, JAX history, tt, ts, port
    history)."""
    jt, js, tt, ts = start(cfg, ds)
    jit_upsample(jt.model.color_net)
    draws = record_jax_draws(jt)
    js, jh = jt.fit(js, jax_batches(ds), 30, jax.random.PRNGKey(1),
                    log_every=5)
    ts, th = tt.fit(ts, ds.batch_iterator(BATCH, seed=0), 30, log_every=5,
                    draws=lambda it: draws[it])
    return jt, js, jh, tt, ts, th
