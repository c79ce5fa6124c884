"""K1's activations and encoded widths, and the route gate (the port's
plain version of hyperreel_tpu_torch/ops/kernels/pack_build.py against
the JAX Pallas kernel hyperreel_tpu/ops/pallas/pack_build.py in interpret
mode, with the harness of tests/test_torch_pack_build.py), on the tiny
flagship (tiny_dynamic: a 4 x 64 MLP, S = 8):

  * the whole kernel with the MLP inside it at every layer activation of
    the JAX kernel's _SAFE_ACTS that it takes (its row_l2_norm, a vector
    kind, takes the general chain), an ease_value and an interp_value;
  * the tail with the field activations of every elementwise kind, an
    ease_value and an interp_value on the z, isect, sigma, flow,
    flow-stage, point-sigma, offset, offset-stage and colour slots;
  * the whole kernel at 48 and 96 encoded columns;
  * the gate: which chains take K1, in the port and in the JAX package,
    and the one difference (a vector field activation: the JAX fused
    paths apply it to a channel's [S, B] rows, which mixes rays);
  * the slice's chain (the long-tail flagship, tiny) end to end against
    the JAX FusedCFEval and the JAX general model.apply.

Tolerances: f32 1e-5 (the same f32 operations, sums in another order),
bf16 2e-3 (chip_smoke.py PACK_TOL_BF16: a hidden value on the other side
of a bf16 rounding boundary moves the pack by up to ~1e-3), routes 2e-4
(tests/test_fused_cf.py's gate: the JAX shade kernel rounds the time
table to bf16)."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperreel_tpu.models import activations as JA
from hyperreel_tpu.models.ctx import make_ctx
from hyperreel_tpu.models.fused_eval import cf_eligible as jax_cf_eligible
from hyperreel_tpu.ops.pallas.pack_build import pack_build as jax_pack_build
from hyperreel_tpu_torch.models import activations as TA
from hyperreel_tpu_torch.models.ctx import StepCtx
from hyperreel_tpu_torch.ops.kernels import pack_build as PB
from hyperreel_tpu_torch.ops.kernels.layout import pack_from_smajor

from torch_parity import entry_rays, flagship_cfg, models, port_weights
from torch_train_parity import compiled

torch.set_num_threads(1)

B = 256          # two 128-ray tiles of the JAX kernel
IT = 20000       # the schedules below sit at weight 0.5 here
HALF = {"wait_iters": IT // 2, "window_iters": IT}
LAYER_ACTS = {
    "identity": "identity", "sigmoid": "sigmoid", "tanh": "tanh",
    "softplus": "softplus", "relu": "relu", "leaky_relu": "leaky_relu",
    "abs": "abs", "zero": "zero",
    "identity_tanh": {"type": "identity_tanh", "fac": 1.0},
    "ease_value": dict(HALF, type="ease_value", start_value=0.1,
                       activation="sigmoid"),
    "interp_value": dict(HALF, type="interp_value", act1="relu",
                         act2="tanh")}
# chip_smoke.py FIELD_GROUPS: (the outputs' activations, the stages')
FIELD_GROUPS = {
    "A": ({"z_vals": {"type": "softplus", "shift": -1.0},
           "sigma": {"type": "gaussian", "sigma": 2.0},
           "point_sigma": dict(HALF, type="ease_value", start_value=1.0,
                               activation="sigmoid"),
           "spatial_flow": dict(HALF, type="interp_value", act1="zero",
                                act2={"type": "identity", "fac": 0.25}),
           "point_offset": {"type": "identity_tanh", "fac": 0.25},
           "color_scale": "relu", "color_shift": "abs"},
          {"isect": {"type": "power", "power": 1.5},
           "po_stage": {"type": "leaky_relu", "a": 0.2},
           "flow_stage": "tanh"}),
    "B": ({"z_vals": "tanh", "point_sigma": "zero",
           "spatial_flow": {"type": "leaky_relu", "a": 0.1},
           "point_offset": {"type": "power", "power": 2.0},
           "color_scale": {"type": "gaussian", "sigma": 0.5},
           "color_shift": {"type": "softplus", "inner_fac": 2.0}},
          {"isect": {"type": "identity_tanh", "fac": 1.0},
           "po_stage": "relu", "flow_stage": "abs"})}


def with_acts(cfg, outputs=None, stages=None, layer=None):
    """chip_smoke.py with_acts: the chain's activations replaced."""
    cfg = copy.deepcopy(cfg)
    emb = cfg["embedding"]["embeddings"]
    pred = emb["ray_prediction_0"]
    if layer is not None:
        pred["net"]["layer_activation"] = layer
    for k, a in (outputs or {}).items():
        pred["outputs"][k]["activation"] = a
    stages = stages or {}
    if "isect" in stages:
        emb["ray_intersect_0"]["intersect"]["activation"] = stages["isect"]
    if "po_stage" in stages:
        emb["point_offset_0"]["activation"] = stages["po_stage"]
    if "flow_stage" in stages:
        emb["flow_0"]["spatial_flow_activation"] = stages["flow_stage"]
    return cfg


_BASE = {}


def _base():
    """One pair of tiny bf16 models and weights for the file: (JAX model,
    port model, JAX params, port params, x0, ray pack). Each layer
    activation case swaps the nets' layer activation in place."""
    if not _BASE:
        jm, tm = models(flagship_cfg(tiny=True), bf16=True)
        jp, tp = port_weights(tm, seed=3)
        rays = torch.from_numpy(entry_rays(B, seed=1))
        cf = tm._cf_eval
        x0 = cf.pred.net_input(rays, StepCtx(it=IT)).float().contiguous()
        _BASE.update(jm=jm, tm=tm, jp=jp, tp=tp, x0=x0,
                     rp=cf.ray_pack(rays))
    return _BASE


def _jax_pack(jcf, rays, mlp_out=None, mlp_spec=None):
    """The JAX kernel as models/fused_eval.py calls it on the quad route,
    on the field-major MLP output [B, P*S] or with its in-kernel MLP;
    -> the port's pack layout."""
    S, isect = jcf.S, jcf.isect
    acts = {n: jcf.pred.activations[jcf.pred.output_names.index(n)]
            for n in jcf.field_offsets}
    pack, _ = jax_pack_build(
        None if mlp_out is None else jnp.asarray(mlp_out.T),
        jnp.asarray(rays.T), IT, S=S, k=S, tile=128,
        samples=np.broadcast_to(np.asarray(isect.samples).reshape(-1), (S,)),
        z_scale=np.broadcast_to(np.asarray(isect.z_scale).reshape(-1), (S,)),
        field_offsets=jcf.field_offsets, field_acts=acts,
        isect_act=isect.activation,
        flow_act=jcf.flow.spatial_flow_activation, po_act=jcf.po.activation,
        has_sigma=True, has_flow=True, po_use_sigma=True,
        po_sigma_field=jcf.po.in_density_field, far_sentinel=None,
        aabb=np.asarray(jcf.net.aabb, np.float32), axis_specs=[(1, 1, 0, 1)],
        emit_idx=False, mlp=mlp_spec)
    return pack_from_smajor(torch.from_numpy(np.array(pack)), S, 128)


def _with_mlp(jm, tm, jp, tp, x0, rp):
    """(the JAX kernel with its in-kernel MLP, the port's plain K1) on the
    same encoded rays and weights."""
    spec = jm._cf_eval._mlp_kernel_spec(
        jp["embedding"]["ray_prediction_0"]["net"], jnp.asarray(x0.numpy().T))
    want = _jax_pack(jm._cf_eval, rp.numpy(), mlp_spec=spec)
    cf = tm._cf_eval
    return want, PB.pack_build(x0, cf.prepare(tp)["mlp"], rp, cf.spec, IT)


@pytest.mark.parametrize("name", list(LAYER_ACTS))
def test_layer_activation_matches_jax_kernel(name):
    """The whole K1 under the bf16 policy (the JAX in-kernel MLP, _mlp_rows,
    applies the layer activation to the f32 sums before the next layer's
    bf16 rounding), at every layer activation the JAX kernel takes."""
    b = _base()
    jm, tm = b["jm"], b["tm"]
    jm._cf_eval.pred.net.layer_act = JA.get_activation(LAYER_ACTS[name])
    tm._cf_eval.pred.net.layer_act = TA.get_activation(LAYER_ACTS[name])
    want, got = _with_mlp(jm, tm, b["jp"], b["tp"], b["x0"], b["rp"])
    assert got.shape == want.shape
    err = (got - want).abs().max().item()
    assert err <= 2e-3, err
    generic = tm._cf_eval.spec.generic(tm._cf_eval.prepare(b["tp"])["mlp"],
                                       IT)
    assert generic == (name not in ("identity", "relu", "leaky_relu", "abs"))


@pytest.mark.parametrize("group", list(FIELD_GROUPS))
def test_field_activations_match_jax_kernel(group):
    """K1's tail on the same MLP output under the f32 policy, with the
    field activations of FIELD_GROUPS (every elementwise kind, an
    ease_value and an interp_value at weight 0.5); the JAX package
    computes power and gaussian in its XLA tail on the TPU (not Mosaic
    kinds), the port in K1: the Pallas kernel in interpret mode computes
    them as that tail does."""
    outputs, stages = FIELD_GROUPS[group]
    jm, tm = models(with_acts(flagship_cfg(tiny=True), outputs, stages),
                    bf16=False)
    spec = tm._cf_eval.spec
    assert spec.generic(PB.mlp_tables(
        tm._cf_eval.pred.net, port_weights(tm)[1]["embedding"][
            "ray_prediction_0"]["net"], torch.arange(spec.S * spec.P),
        spec), IT)
    rng = np.random.default_rng(7)
    mlp = rng.normal(0.0, 1.0, (B, spec.P * spec.S)).astype(np.float32)
    rays = _base()["rp"].numpy()
    want = _jax_pack(jm._cf_eval, rays, mlp_out=mlp)
    got = PB.tail_plain(torch.from_numpy(mlp), torch.from_numpy(rays), spec,
                        IT)
    err = (got - want).abs().max().item()
    assert err <= 1e-5, err


# the ray range's windowed PE (fn, channels, frequencies) and the time
# range's windowed PE without its identity: chip_smoke.py ENCODED
ENCODED = {48: (("two_plane", 4, 5), 2), 96: (("pluecker", 6, 7), 3)}


@pytest.mark.parametrize("width", list(ENCODED))
def test_encoded_width_matches_jax_kernel(width):
    """The whole K1 (bf16) at 48 and 96 encoded columns: the bf16 kernel's
    slabs take the encoded rows in 64-row slabs (one, two), which untile
    to the layer's weights."""
    (fn, ch, n), tf = ENCODED[width]
    cfg = flagship_cfg(tiny=True)
    pred = cfg["embedding"]["embeddings"]["ray_prediction_0"]
    pred["params"]["ray"]["param"] = {"n_dims": ch, "fn": fn}
    pred["params"]["ray"]["pe"] = {"type": "windowed", "n_freqs": n}
    pred["params"]["time"]["pe"] = {"type": "windowed", "n_freqs": tf,
                                    "exclude_identity": True}
    jm, tm = models(cfg, bf16=True)
    jp, tp = port_weights(tm, seed=4)
    cf = tm._cf_eval
    rays = torch.from_numpy(entry_rays(B, seed=2))
    x0 = cf.pred.net_input(rays, StepCtx(it=IT)).float().contiguous()
    assert x0.shape[1] == width
    tabs = cf.prepare(tp)["mlp"]
    assert tabs.layers[0].w.shape[0] == width and tabs.tiled is not None
    H = tabs.layers[0].w.shape[1]
    xs = -(-width // PB.SLAB_K)
    skips = len(cf.pred.net.skips)
    assert len(tabs.slab_rows) == (1 + skips) * xs + (
        len(tabs.layers) - 2) * (H // PB.SLAB_K) + len(
        PB.strip_columns(cf.spec)) * (H // PB.SLAB_K)
    want, got = _with_mlp(jm, tm, jp, tp, x0, cf.ray_pack(rays))
    err = (got - want).abs().max().item()
    assert err <= 2e-3, err


def _gate(cfg_fn):
    cfg = cfg_fn(flagship_cfg(tiny=True))
    jm, tm = models(cfg, bf16=False)
    return jax_cf_eligible(jm), tm._cf_eval is not None


def _row_norm_offset(cfg):
    cfg["embedding"]["embeddings"]["ray_prediction_0"]["outputs"][
        "point_offset"]["activation"] = "row_l2_norm"
    return cfg


def test_route_gate_follows_jax():
    """A model-level ray param, ray outputs, a PE inside the prediction net
    or an angular flow take the general chain in both packages; any
    elementwise activation (and ease_value / interp_value over them) takes
    K1 in the port, and the fused path in JAX; a vector field activation
    keeps JAX's fused path (its CF rows) and takes the port's general
    chain."""
    def pred(c):
        return c["embedding"]["embeddings"]["ray_prediction_0"]

    def param(c):
        c["param"] = {"n_dims": 6, "fn": "voxel_center"}
        return c

    def ray_outputs(c):
        pred(c)["ray_outputs"] = {"r": {"channels": 2}}
        return c

    def net_pe(c):
        pred(c)["net"]["pe"] = {"type": "basic", "n_freqs": 1}
        return c

    def angular(c):
        pred(c)["outputs"]["angular_flow"] = {"channels": 6}
        c["embedding"]["embeddings"]["flow_0"]["use_angular_flow"] = True
        return c

    for fn in (param, ray_outputs, net_pe, angular):
        assert _gate(fn) == (False, False), fn.__name__
    acts = lambda c: with_acts(c, *FIELD_GROUPS["A"],   # noqa: E731
                               layer=LAYER_ACTS["interp_value"])
    assert _gate(acts) == (True, True)
    assert _gate(_row_norm_offset) == (True, False)


def test_vector_field_activation_mixes_rays_in_jax_fused_path():
    """JAX's FusedCFEval applies a field's activation to the channel's
    [S, B] rows (its XLA tail; at B = 96 the tile is 32 and the pack
    kernel is off), so row_l2_norm on the point offset normalises groups
    of three rays, not a sample's three channels: its rgb departs from
    the JAX general chain's, which the port's general chain (the port
    takes no fused route here) follows."""
    cfg = _row_norm_offset(flagship_cfg(tiny=True))
    jm, tm = models(cfg, bf16=False)
    assert jm._cf_eval is not None and tm._cf_eval is None
    gcfg = copy.deepcopy(cfg)
    gcfg["color"]["net"].update(fused_render_cf=False, fused_render=False)
    gj, gt = models(gcfg, bf16=False)
    jp, tp = port_weights(tm, seed=5)
    rays = entry_rays(96, seed=6)
    ctx = make_ctx(it=IT, training=False)
    fused = np.asarray(jax.jit(lambda p, r: jm.apply(p, r, ctx)["rgb"])(
        jp, jnp.asarray(rays)))
    general = np.asarray(jax.jit(lambda p, r: gj.apply(p, r, ctx)["rgb"])(
        jp, jnp.asarray(rays)))
    port = gt.apply(tp, torch.from_numpy(rays), StepCtx(it=IT))["rgb"].numpy()
    assert np.abs(fused - general).max() > 1e-2
    assert np.abs(port - general).max() <= 1e-5


def longtail_cfg(cfg):
    """chip_smoke.py longtail_cfg on a tiny chain: pluecker rays with
    use_local_param and a 16-frequency windowed_random PE, a random time
    PE, relu layers, identity_tanh offsets, an interp_value flow (weight
    0.5 at IT)."""
    pred = cfg["embedding"]["embeddings"]["ray_prediction_0"]
    pred["params"]["ray"].update(
        param={"n_dims": 6, "fn": "pluecker", "use_local_param": True,
               "voxel_size": [1.0, 1.0, 1.0]},
        pe={"type": "windowed_random", "n_freqs": 16, "sigma": 1.0,
            "seed": 1, "wait_iters": 0, "max_freq_iter": 2 * IT})
    pred["params"]["time"]["pe"] = {"type": "random", "n_freqs": 4,
                                    "sigma": 1.0, "seed": 2}
    pred["net"]["layer_activation"] = "relu"
    pred["outputs"]["point_offset"]["activation"] = {
        "type": "identity_tanh", "fac": 0.25}
    pred["outputs"]["spatial_flow"]["activation"] = dict(
        HALF, type="interp_value", act1="zero",
        act2={"type": "identity", "fac": 0.25})
    return cfg


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_longtail_chain_matches_jax(bf16):
    """The slice's chain end to end: the port's fused route (K1 and K2,
    their plain versions on the CPU) against the JAX FusedCFEval (2e-4,
    the routes' gate) and, under the f32 policy, the JAX general chain;
    the port's general chain against JAX's (1e-5 under f32, 2e-4 under
    bf16: sums in another order on either side of a bf16 rounding)."""
    cfg = longtail_cfg(flagship_cfg(tiny=True))
    jm, tm = models(cfg, bf16=bf16)
    assert jm._cf_eval is not None and tm._cf_eval is not None
    jp, tp = port_weights(tm, seed=6)
    rays = entry_rays(128, seed=8)
    ctx = make_ctx(it=IT, training=False)
    assert tm._cf_eval.pred.net_input(torch.from_numpy(rays),
                                      StepCtx(it=IT)).shape[1] == 47
    got = tm.apply(tp, torch.from_numpy(rays), StepCtx(it=IT))["rgb"]
    fused = np.asarray(jax.jit(lambda p, r: jm.apply(p, r, ctx)["rgb"])(
        jp, jnp.asarray(rays)))
    gcfg = copy.deepcopy(cfg)
    gcfg["color"]["net"].update(fused_render_cf=False, fused_render=False)
    gj, gt = models(gcfg, bf16=bf16)
    # compiled without XLA's excess precision, which keeps the bf16 MLP's
    # values at f32 (ROADMAP.md 3)
    general = np.asarray(compiled(lambda p, r: gj.apply(p, r, ctx)["rgb"],
                                  jp, jnp.asarray(rays)))
    assert general.std() > 1e-2
    port_general = gt.apply(tp, torch.from_numpy(rays),
                            StepCtx(it=IT))["rgb"].numpy()
    assert np.abs(got.numpy() - fused).max() <= 2e-4
    assert np.abs(port_general - general).max() <= (2e-4 if bf16 else 1e-5)
    if not bf16:
        # under the bf16 policy the JAX package's two paths differ
        # (ROADMAP.md 3: its general MLP stores each layer in bf16, its
        # kernel keeps f32 sums); under f32 they agree
        assert np.abs(got.numpy() - general).max() <= 2e-4
