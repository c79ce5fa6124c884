"""Shared set-up of the colour-net parity tests (test_torch_colour_heads.py,
test_torch_tensorf_extra.py): a colour net built by each package from one
config (tests/test_net_variants.py's BASE), weights from the port's init
carried over by convert.py, the same sample fields made with numpy, and
the eval output and one training step's gradients held against each
other."""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.tensorf import build_color_net as build_jax
from hyperreel_tpu_torch.convert import params_from_jax, params_to_jax
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.tensorf import build_color_net as build_port
from hyperreel_tpu_torch.train.optim import tree_leaves

BASE = {
    "aabb": [[-2, -2, -2], [2, 2, 2]],
    "N_voxel_init": 16 ** 3, "N_voxel_final": 16 ** 3, "upsamp_list": [],
    "update_AlphaMask_list": [], "fea2denseAct": "relu",
    "distance_scale": 16.0, "density_shift": 0.0,
    "shadingMode": "SH", "data_dim_color": 27,
    "rm_weight_mask_thre": 0, "bf16_tables": False,
    "n_lamb_sigma": [2, 2, 2], "n_lamb_sh": [2, 2, 2],
}
# the dynamic net's dataset: 4 keyframes of 12 frames (frames_per_keyframe 3)
INFO = {"num_keyframes": 4, "num_frames": 12}
IT = 100
# eval: f32 sums in another order; gradients: each leaf within 1e-5 plus
# 1e-4 of its largest entry
TOL = 1e-5
GRAD_RTOL = 1e-4


def sample_fields(B=6, S=8, seed=0, dynamic=False, transform=None):
    """The colour net's input fields (numpy): points inside the aabb,
    sorted distances, view directions, predicted weights in [0, 1); the
    dynamic net's base times, times and time offsets; with `transform`
    "sample" a per-sample 3x3 transform and shift, "global" a per-ray one
    broadcast over the samples (a color_transform stage's fields)."""
    rng = np.random.default_rng(seed)
    x = {"points": rng.uniform(-0.9, 0.9, (B, S, 3)),
         "distances": np.sort(rng.uniform(0.1, 2, (B, S, 1)), axis=1),
         "viewdirs": rng.standard_normal((B, S, 3)),
         "weights": rng.uniform(0, 1, (B, S, 1))}
    if dynamic:
        t = rng.uniform(0, 1, (B, 1, 1))
        x.update(base_times=np.broadcast_to(t, (B, S, 1)),
                 times=np.broadcast_to(t + 0.02, (B, S, 1)),
                 time_offset=np.broadcast_to(
                     rng.uniform(-0.1, 0.1, (B, 1, 1)), (B, S, 1)))
    if transform == "sample":
        x.update(color_transform=rng.normal(0, 0.2, (B, S, 9)),
                 color_shift=rng.normal(0, 0.1, (B, S, 3)))
    elif transform == "global":
        x.update(color_transform_global=np.broadcast_to(
            rng.normal(0, 0.2, (B, 1, 9)), (B, S, 9)),
            color_shift_global=np.broadcast_to(
                rng.normal(0, 0.1, (B, 1, 3)), (B, S, 3)))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in x.items()}


def jax_coin(rng):
    """The JAX nets' background coin draw of a training step."""
    return float(jax.random.uniform(jax.random.fold_in(rng, 202), ()))


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def port_grads(net, params, loss_of):
    """{path: gradient} of loss_of(params) for every leaf."""
    params = _requiring_grad(params)
    leaves = tree_leaves(params)
    loss = loss_of(params)
    gs = torch.autograd.grad(loss, [leaf for _, leaf in leaves],
                             allow_unused=True)
    return {p: torch.zeros_like(l) if g is None else g
            for (p, l), g in zip(leaves, gs)}


def check_grads(jax_grads, grads):
    """The JAX gradients (converted to the port's layout) against the
    port's, leaf by leaf."""
    want = dict(tree_leaves(params_from_jax(
        jax.tree.map(np.asarray, jax_grads), device="cpu")))
    assert set(want) == set(grads)
    for path, g in grads.items():
        w = want[path].numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TOL + GRAD_RTOL * scale, (path, err, scale)


def _jax_net(cfg, info):
    """The JAX net of cfg. Its dynamic net refuses the time shading heads:
    TensorVMKeyframeTime.__post_init__ calls the static net's, which
    raises on a shadingMode it does not know before the dynamic net
    installs its head. So such a net is built with RGB shading and the
    data_dim_color the head forces, and the JAX head is installed as the
    rest of its __post_init__ does."""
    mode = cfg.get("shadingMode")
    if mode not in ("RGBtLinear", "RGBtFourier"):
        return build_jax(dict(cfg), info)
    from hyperreel_tpu.models import tensorf as T
    fpk = max(info["num_frames"] // info["num_keyframes"], 1)
    dim = 6 if mode == "RGBtLinear" else (2 * fpk + 1) * 3
    net = build_jax(dict(cfg, shadingMode="RGB", data_dim_color=dim), info)
    net.shading_mode = mode
    net.render_fn = (T._shading_rgbt_linear if mode == "RGBtLinear"
                     else T._shading_rgbt_fourier)()[0]
    return net


def net_pair(cfg, info=None, seed=0):
    """(JAX net, port net, JAX params, port params) for one config, the
    weights from the port's init (a seeded torch.Generator; the JAX init
    takes seconds on the CPU), the density grids redrawn, in both
    layouts."""
    jnet = _jax_net(cfg, info)
    tnet = build_port(dict(cfg), info)
    gen = torch.Generator().manual_seed(seed)
    tp = tnet.init(gen, "cpu")
    # the relu density init is a constant 1e-2, an almost transparent
    # scene: redrawn uniform in [0, 1) so that the composite is exercised
    for sub in [tp] + [v for k, v in tp.items() if k.startswith("net_")]:
        for k, v in sub.get("density", {}).items():
            sub["density"][k] = torch.rand(v.shape, generator=gen)
    jp = jax.tree.map(jnp.asarray, params_to_jax(tp))
    return jnet, tnet, jp, tp


def check_net(cfg, x, info=None, it=IT, apply="apply", draws=None):
    """Hold the port's net against the JAX net on the fields x (numpy):
    the eval rgb (and every output both give), then the gradients of the
    mean squared training rgb. `apply` names the entry point ("march" for
    the standalone net, then x is the rays); `draws` adds injected draws
    (name -> the JAX draw as a function of the step's key)."""
    jnet, tnet, jp, tp = net_pair(cfg, info)
    rng = jax.random.PRNGKey(0)
    jx = jax.tree.map(jnp.asarray, x)
    tx = jax.tree.map(torch.from_numpy, x)
    jfn, tfn = getattr(jnet, apply), getattr(tnet, apply)

    def jcall(p, training):
        inp = dict(jx) if isinstance(jx, dict) else jx
        return jfn(p, inp, make_ctx(it, rng=rng, training=training), {})

    def tcall(p, training, drawn=None):
        inp = dict(tx) if isinstance(tx, dict) else tx
        return tfn(p, inp, StepCtx(it=it, training=training,
                                   draws=drawn or {}), {})

    def both(p):
        return jcall(p, False), jax.grad(
            lambda q: jnp.mean(jcall(q, True)["rgb"] ** 2))(p)

    want, jg = jax.jit(both)(jp)
    got = tcall(tp, False)
    assert np.asarray(want["rgb"]).std() > 1e-3
    for key in want:
        if key in got:
            assert np.abs(got[key].detach().numpy()
                          - np.asarray(want[key])).max() <= TOL, key

    drawn = {"background": jax_coin(rng)}
    drawn.update({k: np.array(f(rng)) for k, f in (draws or {}).items()})
    grads = port_grads(tnet, tp, lambda p: (tcall(p, True, dict(drawn))[
        "rgb"] ** 2).mean())
    check_grads(jg, grads)
    return jnet, tnet, jp, tp
