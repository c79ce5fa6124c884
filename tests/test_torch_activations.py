"""The port's activations, positional encodings and ray parameterizations
(hyperreel_tpu_torch/models/activations.py, pe.py, ray_param.py) against
the JAX package's: every entry of `activation_map`, `pe_dict` and
`ray_param_dict`, the windowed PE's options, use_local_param, a BaseMLP
with its own PE and the relu_abs density activation. Values in f32 within
1e-6 (the PEs' and params' f32 math), gradients within 1e-5, ties
included (x = 0, identity_tanh's edge)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models import activations as JA
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.mlp import BaseMLP as JaxMLP
from hyperreel_tpu.models.pe import pe_dict as jax_pes
from hyperreel_tpu.models.ray_param import ray_param_dict as jax_params
from hyperreel_tpu.ops.pallas.pack_build import act_cfg_supported
from hyperreel_tpu_torch.convert import params_to_jax
from hyperreel_tpu_torch.models import activations as TA
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.models.mlp import build_net
from hyperreel_tpu_torch.models.pe import PE_TYPES, get_pe
from hyperreel_tpu_torch.models.ray_param import RAY_PARAMS, get_ray_param

torch.set_num_threads(1)

WINDOW = {"wait_iters": 100, "window_iters": 400}
ACTS = {
    "identity": {"type": "identity", "fac": 0.5},
    "sigmoid": {"type": "sigmoid", "shift": 1.0, "inner_fac": 2.0,
                "outer_fac": 0.5},
    "softplus": {"type": "softplus", "shift": -1.0, "inner_fac": 3.0},
    "tanh": {"type": "tanh", "outer_fac": 0.25},
    "identity_tanh": {"type": "identity_tanh", "fac": 0.25},
    "relu": "relu", "leaky_relu": {"type": "leaky_relu", "a": 0.2},
    "abs": "abs", "zero": "zero", "power": {"type": "power", "power": 1.5},
    "gaussian": {"type": "gaussian", "sigma": 0.7},
    "softmax": "softmax", "l1_norm": "l1_norm", "l2_norm": "l2_norm",
    "row_l2_norm": "row_l2_norm", "row_l1_norm": "row_l1_norm",
    "row_linf_norm": "row_linf_norm",
    "row_l2_norm_z_only": "row_l2_norm_z_only", "probs": "probs",
    "sparse_magnitude": {"type": "sparse_magnitude", "inner_fac": 2.0,
                         "outer_fac": 0.5},
    "twist_to_matrix": "twist_to_matrix",
    "axis_angle_translation": {"type": "axis_angle_translation",
                               "fac": 0.5},
    "alpha": "alpha", "rgba": "rgba",
    "ease_value": dict(WINDOW, type="ease_value", start_value=0.3,
                       activation={"type": "sigmoid", "shift": 1.0}),
    "interp_value": dict(WINDOW, type="interp_value", act1="zero",
                         act2={"type": "identity", "fac": 0.25}),
    "interp_tanh_relu": dict(WINDOW, type="interp_value", act1="tanh",
                             act2="relu"),
    "ease_interp": dict(WINDOW, type="ease_value", start_value=-0.5,
                        activation=dict(WINDOW, type="interp_value",
                                        act1="softplus", act2="abs"))}
# the registry's entries are all covered
assert {v if isinstance(v, str) else v["type"] for v in ACTS.values()} \
    == set(JA.activation_map)


def _x(shape=(16, 6), seed=0):
    x = np.random.default_rng(seed).normal(0, 1.5, shape).astype(np.float32)
    x[0, :] = 0.0                       # the ties
    x[1, :3] = 1.91501 / 2              # identity_tanh's edge (u = 2x)
    x[1, 3:] = -1.91501 / 2
    return x


SCHEDULED = ("ease_value", "interp_value", "interp_tanh_relu", "ease_interp")
# the scheduled activations before, in and after their window and without
# a context; the others once
CASES = [(n, it) for n in ACTS
         for it in ((None, 50, 300, 1000) if n in SCHEDULED else (300,))]


@pytest.mark.parametrize("name,it", CASES)
def test_activation_values_and_gradients(name, it):
    """Value and gradient (of a random weighting of the output) on x with
    a row of zeros and identity_tanh's edge. A row kind's JAX gradient is
    NaN on the zero row (jnp.linalg.norm's at 0, axis_angle_to_matrix's
    at angle 0), where the port's is finite: that row is compared for the
    elementwise kinds only."""
    cfg = ACTS[name]
    x = _x()
    jctx = None if it is None else make_ctx(it=it)
    tctx = None if it is None else StepCtx(it=it)
    ja, ta = JA.get_activation(cfg), TA.get_activation(cfg)
    want = np.asarray(jax.jit(lambda v: ja(v, jctx))(jnp.asarray(x)))
    w = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    want_g = np.asarray(jax.jit(jax.grad(
        lambda v: (ja(v, jctx) * w).sum()))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ta(xt, tctx)
    if out.requires_grad:
        (out * torch.from_numpy(w)).sum().backward()
    got_g = xt.grad.numpy() if xt.grad is not None else np.zeros_like(x)
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=1e-6)
    assert np.isfinite(got_g).all()
    rows = slice(None) if ta.elementwise else slice(1, None)
    assert np.isfinite(want_g[rows]).all()
    np.testing.assert_allclose(got_g[rows], want_g[rows], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,it", [
    (n, it) for n, it in CASES
    if TA.kernel_act(TA.get_activation(ACTS[n]))])
def test_kernel_terms_are_the_activation(name, it):
    """K1's form of an elementwise activation (the schedules folded into
    the coefficients of at most two functions) is the activation."""
    from hyperreel_tpu_torch.ops.kernels.pack_build import apply_terms
    act = TA.get_activation(ACTS[name])
    x = torch.from_numpy(_x())
    ctx = None if it is None else StepCtx(it=it)
    got = apply_terms(x, act.kernel_terms(it))
    assert (got - act(x, ctx)).abs().max().item() <= 1e-6


def test_the_kernel_takes_elementwise_activations_only():
    """K1 takes an activation that is elementwise, an ease_value or an
    interp_value over such, of at most two functions; the JAX gate
    (act_cfg_supported) looks inside an interp_value for keys that
    make_interp_value does not read (act1 / act2), so it passes every
    interp_value, even one over a vector kind, which the port's route
    refuses (ROADMAP.md 3)."""
    vec = {"type": "interp_value", "act1": "softmax", "act2": "relu"}
    nested = {"type": "interp_value", "act1": ACTS["interp_tanh_relu"],
              "act2": ACTS["interp_value"]}
    assert act_cfg_supported(vec) and act_cfg_supported(nested)
    assert not TA.kernel_act(TA.get_activation(vec))
    assert not TA.kernel_act(TA.get_activation(nested))     # 4 functions
    for name in ("power", "gaussian", "interp_value", "ease_interp",
                 "alpha", "rgba"):
        assert TA.kernel_act(TA.get_activation(ACTS[name])), name
    for name in ("row_l2_norm", "softmax", "twist_to_matrix"):
        assert not TA.kernel_act(TA.get_activation(ACTS[name])), name


def test_relu_abs_density_matches_jax():
    from hyperreel_tpu.models.tensorf import TensorVMNoSample as JaxNet
    from hyperreel_tpu_torch.models.tensorf import TensorVMNoSample
    cfg = {"fea2denseAct": "relu_abs", "aabb": [[-1, -1, -1], [1, 1, 1]],
           "N_voxel_init": 8 ** 3, "n_lamb_sigma": [2, 2, 2],
           "n_lamb_sh": [2, 2, 2], "shadingMode": "RGB"}
    x = _x()
    want_v, want_g = jax.value_and_grad(
        lambda v: JaxNet(cfg).feature2density(v).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TensorVMNoSample(cfg).feature2density(xt)
    got.sum().backward()
    assert np.abs(got.detach().numpy()
                  - np.asarray(JaxNet(cfg).feature2density(
                      jnp.asarray(x)))).max() == 0.0
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))


PES = [
    {"type": "identity"},
    {"type": "basic", "n_freqs": 3},
    {"type": "windowed", "n_freqs": 4, "wait_iters": 100,
     "max_freq_iter": 800},
    {"type": "windowed", "n_freqs": 3, "window_iters": [[0, 100],
                                                        [50, 400],
                                                        [300, 900]]},
    {"type": "windowed", "n_freqs": 3, "max_freq_iter": 600,
     "window_identity": True, "ceil": True},
    {"type": "windowed", "n_freqs": 2, "exclude_identity": True,
     "base_multiplier": 0.5},
    {"type": "windowed", "n_freqs": 0, "exclude_identity": True},
    {"type": "random", "n_freqs": 8, "sigma": 0.5, "seed": 3},
    {"type": "windowed_random", "n_freqs": 6, "sigma": 0.5, "seed": 4,
     "wait_iters": 100, "max_freq_iter": 600},
    {"type": "windowed_random", "n_freqs": 5, "sigma": 0.5, "seed": 5},
    {"type": "select", "select_start": 1, "select_end": 3,
     "pe": {"type": "basic", "n_freqs": 2}},
    {"type": "select", "select_start": 0, "select_end": 2, "discard": True,
     "pe": {"type": "random", "n_freqs": 3, "sigma": 0.5}},
    {"type": "learnable", "n_freqs": 4}]
assert {c["type"] for c in PES} == set(jax_pes) == set(PE_TYPES)


@pytest.mark.parametrize("cfg,it", [
    (c, it) for c in PES
    for it in ((None, 0, 250, 2000) if "windowed" in c["type"] else (250,))],
    ids=lambda v: v["type"] if isinstance(v, dict) else str(v))
def test_pe_matches_jax(cfg, it):
    """Every PE of the registry (the random banks drawn by both packages
    from numpy's default_rng(seed)); the learnable PE as both packages'
    stages call it, without its params: zeros for its sin/cos columns
    (ROADMAP.md 3)."""
    x = np.random.default_rng(2).uniform(-1, 1, (40, 4)).astype(np.float32)
    jpe = jax_pes[cfg["type"]](4, cfg)
    tpe = get_pe(4, cfg)
    assert tpe.out_channels == jpe.out_channels
    jctx = None if it is None else make_ctx(it=it)
    want = np.asarray(jax.jit(lambda v: jpe.apply(v, jctx))(jnp.asarray(x)))
    got = tpe.apply(torch.from_numpy(x),
                    None if it is None else StepCtx(it=it)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0.0) <= 1e-6 + _bank_tol(tpe, x)
    if cfg["type"] == "learnable":
        assert not got[:, 4:].any()


def _bank_tol(pe, x, B=None):
    """A random bank's sin and cos of 2 pi (x @ B): the f32 dot product
    sums its terms in another order in XLA and torch (one ulp of x @ B
    apart), which moves the argument by 2 pi ulps; two of them allowed."""
    pe = getattr(pe, "inner", pe)
    B = getattr(pe, "B", B)
    if B is None:
        return 0.0
    proj = np.abs(x[:, :B.shape[0]] @ np.asarray(B)).max()
    return 2 * np.pi * proj * 2.0 ** -22


def test_learnable_pe_with_params_matches_jax():
    B = np.random.default_rng(3).normal(0, 0.5, (4, 3)).astype(np.float32)
    x = np.random.default_rng(4).uniform(-1, 1, (20, 4)).astype(np.float32)
    want = jax_pes["learnable"](4, {"n_freqs": 3}).apply(
        jnp.asarray(x), None, {"B": jnp.asarray(B)})
    got = get_pe(4, {"type": "learnable", "n_freqs": 3}).apply(
        torch.from_numpy(x), None, {"B": torch.from_numpy(B)})
    assert np.abs(got.numpy() - np.asarray(want)).max() <= \
        1e-6 + _bank_tol(None, x, B)


RAYS = [
    {"fn": "identity"}, {"fn": "take", "input_channels": [3, 4, 5, 0]},
    {"fn": "position"}, {"fn": "two_plane", "near": -1.0, "far": 0.5},
    {"fn": "two_plane", "use_local_param": True, "voxel_size": 0.5,
     "st_multiplier": 2.0},
    {"fn": "multi_plane", "z_channels": 5}, {"fn": "two_plane_matrix",
                                             "matrix": (np.eye(4) + 0.1
                                                        ).tolist()},
    {"fn": "two_cylinder", "near": 0.5, "far": 2.0},
    {"fn": "ray_plus_time", "param": {"fn": "pluecker"}},
    {"fn": "voxel_center", "voxel_size": 0.25}, {"fn": "z_slice", "z": 0.3},
    {"fn": "contract_points", "param": {"fn": "position"},
     "contract": {"type": "mipnerf", "contract_start_radius": 0.8}},
    {"fn": "pluecker", "direction_multiplier": 2.0},
    {"fn": "pluecker", "use_local_param": True,
     "voxel_size": [0.5, 0.25, 1.0], "origin": [0.1, 0.0, -0.2]},
    {"fn": "spherical", "radius": 2.0}, {"fn": "xy"}, {"fn": "rays"},
    {"fn": "pluecker_pos"}]
assert {c["fn"] for c in RAYS} == set(jax_params) == set(RAY_PARAMS)


@pytest.mark.parametrize("cfg", RAYS, ids=lambda c: c["fn"])
def test_ray_param_matches_jax(cfg):
    rng = np.random.default_rng(5)
    rays = np.concatenate([rng.uniform(-1, 1, (64, 3)),
                           rng.uniform(-0.5, 0.5, (64, 3)),
                           rng.uniform(0, 1, (64, 1))], -1).astype(np.float32)
    rays[:, 5] += 1.0
    rays[:4, 5] = 0.0                         # d_z = 0: the 1e-5 guard
    rays[4:8, 2] = 0.25                       # origins on a voxel's edge
    if cfg["fn"] != "ray_plus_time":
        rays = rays[:, :6]
    jp, tp = jax_params[cfg["fn"]](cfg), get_ray_param(cfg)
    assert (tp.in_channels, tp.out_channels) == (jp.in_channels,
                                                 jp.out_channels)
    want = np.asarray(jax.jit(jp.apply)(jnp.asarray(rays)))
    got = tp.apply(torch.from_numpy(rays)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6


def test_mlp_with_its_own_pe_matches_jax():
    """BaseMLP's own PE (JAX mlp.py:60-65): the skip layer takes the
    encoded input; f32 policy, leaky relu, values within 1e-5."""
    cfg = {"depth": 3, "hidden_channels": 32, "skips": [2],
           "pe": {"type": "windowed", "n_freqs": 2}}
    jn = JaxMLP(5, 7, 3, 32, skips=[2], pe_cfg=cfg["pe"])
    tn = build_net(5, 7, cfg)
    assert tn.net_in == jn.net_in == 25
    tp = tn.init(torch.Generator().manual_seed(0), "cpu")
    x = np.random.default_rng(6).uniform(-1, 1, (30, 5)).astype(np.float32)
    ctx = make_ctx(it=50)
    want = np.asarray(jax.jit(lambda p, v: jn.apply(p, v, ctx))(
        jax.tree.map(jnp.asarray, params_to_jax(tp)), jnp.asarray(x)))
    got = tn.apply(tp, torch.from_numpy(x), StepCtx(it=50)).numpy()
    assert np.abs(got - want).max() <= 1e-5
